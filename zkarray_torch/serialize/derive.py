"""Struct "derive" for canonical serialization — the analog of arkworks'
``#[derive(CanonicalSerialize, CanonicalDeserialize)]``.

Reference analog: ``serialize-derive/src/lib.rs`` — the proc-macro walks a
struct's fields in declaration order and emits

* ``serialize_with_mode``  = concatenation of each field's bytes,
* ``serialized_size``      = sum of the field sizes,
* ``deserialize_with_mode``= field-by-field reads (validation per field),

with NO per-struct header, so a derived struct's wire format is exactly the
concatenation of its members' canonical encodings.  The Python analog is a
class decorator over a ``dataclass``: each field names a :class:`Codec`
(via ``dataclasses.field(metadata={"codec": ...})`` or an explicit
``codecs={...}`` mapping), primitives are inferred from type annotations,
and a decorated class is itself a ``Codec`` so structs nest.

zkarray twist: the natural leaf here is a *batch* (a ``Vec<F>`` or
``Vec<G>`` serialized through one array call), not a scalar element — see
:func:`fp_vec` / :func:`sw_points`.

Counterpart of zkarray/serialize/derive.py on the port's
serialize/canonical.py and ec/point_serde.py: the same bytes; a decoded
batch lands on the leaf codec's ``device`` (``DEFAULT_DEVICE`` unless
given).
"""

from __future__ import annotations

import dataclasses
import io
from typing import Any, Callable, Optional

import numpy as np

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.ec import point_serde as P
from zkarray_torch.serialize import canonical as _canon
from zkarray_torch.serialize import containers as C
from zkarray_torch.serialize.containers import SerializationError
from zkarray_torch.serialize.wrappers import (
    COMPRESSED_CHECKED,
    COMPRESSED_UNCHECKED,
    UNCOMPRESSED_CHECKED,
    UNCOMPRESSED_UNCHECKED,
    Mode,
)


@dataclasses.dataclass(frozen=True)
class Codec:
    """A (serialize, deserialize) pair threaded with the Compress x Validate
    mode — the unit the derive composes (reference: the per-field
    ``CanonicalSerialize``/``CanonicalDeserialize`` impls the macro calls)."""

    ser: Callable[[Any, Mode], bytes]
    de: Callable[[io.BytesIO, Mode], Any]


def _modeless(ser: Callable[[Any], bytes], de: Callable[[io.BytesIO], Any]) -> Codec:
    return Codec(lambda v, _m: ser(v), lambda r, _m: de(r))


# ---- primitive codecs (mode-independent, wire = containers.py) ----

BOOL = _modeless(C.ser_bool, C.de_bool)
U8 = _modeless(C.ser_u8, C.de_u8)
U16 = _modeless(C.ser_u16, C.de_u16)
U32 = _modeless(C.ser_u32, C.de_u32)
U64 = _modeless(C.ser_u64, C.de_u64)
USIZE = U64  # reference: usize serialized as u64 LE
BIGUINT = _modeless(C.ser_biguint, C.de_biguint)
STRING = _modeless(C.ser_string, C.de_string)
BYTES = _modeless(
    lambda v: C.ser_vec(list(v), C.ser_u8),
    lambda r: bytes(C.de_vec(r, C.de_u8)),
)


# ---- combinators (collections.rs / misc.rs / tuples.rs) ----

def vec(item: Codec) -> Codec:
    """``Vec<T>``: u64 length + items (each in the ambient mode)."""
    return Codec(
        lambda v, m: C.ser_vec(v, lambda x: item.ser(x, m)),
        lambda r, m: C.de_vec(r, lambda s: item.de(s, m)),
    )


def array(item: Codec, n: int) -> Codec:
    """``[T; n]``: items only, no length prefix."""
    return Codec(
        lambda v, m: C.ser_array(v, lambda x: item.ser(x, m)),
        lambda r, m: C.de_array(r, lambda s: item.de(s, m), n),
    )


def option(item: Codec) -> Codec:
    return Codec(
        lambda v, m: C.ser_option(v, lambda x: item.ser(x, m)),
        lambda r, m: C.de_option(r, lambda s: item.de(s, m)),
    )


def tuple_(*items: Codec) -> Codec:
    return Codec(
        lambda v, m: C.ser_tuple(tuple(v), [lambda x, it=it: it.ser(x, m) for it in items]),
        lambda r, m: C.de_tuple(r, [lambda s, it=it: it.de(s, m) for it in items]),
    )


def map_(key: Codec, val: Codec) -> Codec:
    return Codec(
        lambda v, m: C.ser_map(v, lambda k: key.ser(k, m), lambda x: val.ser(x, m)),
        lambda r, m: C.de_map(r, lambda s: key.de(s, m), lambda s: val.de(s, m)),
    )


# ---- zkarray array leaves: batched field / point vectors ----

def fp_vec(spec, mont: bool = True, device=DEFAULT_DEVICE) -> Codec:
    """``Vec<F>`` as ONE batched call: u64 length + n canonical field
    encodings (compression is a no-op for field elements, as in the
    reference)."""
    nb = _canon.field_byte_size(spec)

    def ser(a, _m: Mode) -> bytes:
        out = _canon.serialize_fp(spec, a, mont=mont)
        return C.ser_u64(out.shape[0]) + out.tobytes()

    def de(r: io.BytesIO, m: Mode):
        n = C.de_u64(r)
        raw = r.read(n * nb)
        if len(raw) != n * nb:
            raise SerializationError("truncated Vec<F>")
        data = np.frombuffer(raw, dtype=np.uint8).reshape(n, nb)
        a, _flags, ok = _canon.deserialize_fp(spec, data, mont=mont, validate=m.validate,
                                              device=device)
        if m.validate and not bool(np.all(ok)):
            raise SerializationError("non-canonical field element")
        return a

    return Codec(ser, de)


def _points_codec(ser_fn, de_fn, nbc: int, nbu: int) -> Codec:
    """Shared ``Vec<GAffine>`` shape: u64 length + n fixed-width point rows;
    honors both mode axes (compress chooses the wire, validate gates the
    curve+subgroup checks — reference serialize/src/serde.rs:12-24 via the
    ec point impls)."""

    def ser(pts, m: Mode) -> bytes:
        out = ser_fn(pts, compress=m.compress)
        return C.ser_u64(out.shape[0]) + out.tobytes()

    def de(r: io.BytesIO, m: Mode):
        n = C.de_u64(r)
        nb = nbc if m.compress else nbu
        raw = r.read(n * nb)
        if len(raw) != n * nb:
            raise SerializationError("truncated Vec<G>")
        data = np.frombuffer(raw, dtype=np.uint8).reshape(n, nb)
        pts, ok = de_fn(data, compress=m.compress, validate=m.validate)
        if m.validate and not bool(np.all(ok)):
            raise SerializationError("invalid curve point")
        return pts

    return Codec(ser, de)


def sw_points(curve, device=DEFAULT_DEVICE) -> Codec:
    """``Vec<GAffine>`` over a short Weierstrass curve, one batched call."""
    nbc = _canon.field_byte_size(curve.base, 2)
    nbu = _canon.field_byte_size(curve.base) + nbc
    return _points_codec(
        lambda pts, compress: P.serialize_sw(curve, pts, compress=compress),
        lambda data, compress, validate: P.deserialize_sw(
            curve, data, compress=compress, validate=validate, device=device
        ),
        nbc,
        nbu,
    )


def te_points(curve, device=DEFAULT_DEVICE) -> Codec:
    """``Vec<GAffine>`` over a twisted Edwards curve (y bytes + sign-of-x)."""
    nbc = _canon.field_byte_size(curve.base, 1)
    nbu = _canon.field_byte_size(curve.base) + nbc
    return _points_codec(
        lambda pts, compress: P.serialize_te(curve, pts, compress=compress),
        lambda data, compress, validate: P.deserialize_te(
            curve, data, compress=compress, validate=validate, device=device
        ),
        nbc,
        nbu,
    )


def sw_points_ext(curve, device=DEFAULT_DEVICE) -> Codec:
    """``Vec<GAffine>`` over an extension field (e.g. BLS12-381 G2): flags
    ride the LAST coefficient's top bits (quadratic_extension.rs:687-695)."""
    spec, deg = curve.ops.spec, curve.ops.deg
    fb0 = _canon.field_byte_size(spec)
    nbc = (deg - 1) * fb0 + _canon.field_byte_size(spec, 2)
    nbu = deg * fb0 + nbc
    return _points_codec(
        lambda pts, compress: P.serialize_sw_ext(curve, pts, compress=compress),
        lambda data, compress, validate: P.deserialize_sw_ext(
            curve, data, compress=compress, validate=validate, device=device
        ),
        nbc,
        nbu,
    )


_PRIMITIVE_BY_TYPE = {bool: BOOL, int: USIZE, str: STRING, bytes: BYTES}
# under `from __future__ import annotations` dataclasses store the
# annotation as a string — accept the primitive names too
_PRIMITIVE_BY_NAME = {t.__name__: c for t, c in _PRIMITIVE_BY_TYPE.items()}


def _resolve_codec(f: dataclasses.Field, cls_codecs: dict, owner_module) -> Codec:
    c = f.metadata.get("codec") or cls_codecs.get(f.name)
    if c is None and isinstance(f.type, type):
        c = getattr(f.type, "__codec__", None) or _PRIMITIVE_BY_TYPE.get(f.type)
    if c is None and isinstance(f.type, str):
        # string annotation (`from __future__ import annotations`): resolve
        # primitives by name, nested @canonical classes via the owner module
        c = _PRIMITIVE_BY_NAME.get(f.type)
        if c is None:
            named = getattr(owner_module, f.type, None)
            c = getattr(named, "__codec__", None)
    if isinstance(c, type):  # a nested @canonical class given explicitly
        c = c.__codec__
    if not isinstance(c, Codec):
        raise TypeError(
            f"field {f.name!r}: no codec (use field(metadata={{'codec': ...}}), "
            f"codecs={{...}}, a primitive annotation, or a @canonical class)"
        )
    return c


def canonical(cls=None, /, *, codecs: Optional[dict] = None):
    """Class decorator deriving canonical serde over a dataclass's fields in
    declaration order (reference serialize-derive impl_serialize /
    impl_deserialize). Adds::

        serialize_with_mode(mode) -> bytes      serialized_size(mode) -> int
        serialize_compressed() / serialize_uncompressed()
        ClassName.deserialize_with_mode(bytes_or_stream, mode)
        .deserialize_compressed[_unchecked]() / .deserialize_uncompressed[_unchecked]()

    and ``__codec__`` so decorated classes nest as fields of other
    decorated classes.
    """

    def wrap(cls):
        if not dataclasses.is_dataclass(cls):
            cls = dataclasses.dataclass(cls)
        import sys

        owner = sys.modules.get(cls.__module__)
        specs = [
            (f.name, _resolve_codec(f, codecs or {}, owner))
            for f in dataclasses.fields(cls)
        ]

        def serialize_with_mode(self, mode: Mode = COMPRESSED_CHECKED) -> bytes:
            return b"".join(c.ser(getattr(self, name), mode) for name, c in specs)

        def serialized_size(self, mode: Mode = COMPRESSED_CHECKED) -> int:
            return len(serialize_with_mode(self, mode))

        def deserialize_with_mode(data, mode: Mode = COMPRESSED_CHECKED):
            r = data if isinstance(data, io.BytesIO) else C.reader(data)
            return cls(**{name: c.de(r, mode) for name, c in specs})

        cls.serialize_with_mode = serialize_with_mode
        cls.serialized_size = serialized_size
        cls.serialize_compressed = lambda self: serialize_with_mode(self, COMPRESSED_CHECKED)
        cls.serialize_uncompressed = lambda self: serialize_with_mode(self, UNCOMPRESSED_CHECKED)
        cls.deserialize_with_mode = staticmethod(deserialize_with_mode)
        cls.deserialize_compressed = staticmethod(
            lambda d: deserialize_with_mode(d, COMPRESSED_CHECKED)
        )
        cls.deserialize_compressed_unchecked = staticmethod(
            lambda d: deserialize_with_mode(d, COMPRESSED_UNCHECKED)
        )
        cls.deserialize_uncompressed = staticmethod(
            lambda d: deserialize_with_mode(d, UNCOMPRESSED_CHECKED)
        )
        cls.deserialize_uncompressed_unchecked = staticmethod(
            lambda d: deserialize_with_mode(d, UNCOMPRESSED_UNCHECKED)
        )
        cls.__codec__ = Codec(
            lambda v, m: v.serialize_with_mode(m),
            lambda r, m: deserialize_with_mode(r, m),
        )
        return cls

    return wrap if cls is None else wrap(cls)
