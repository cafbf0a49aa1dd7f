"""Container serialization — arkworks-compatible wire formats for host
values (Vec/Option/tuple/String/map/ints/bool), composable with the array
serializers in canonical.py / point_serde.py.

Counterpart of zkarray/serialize/containers.py, host bytes only: the port
keeps its own copy, word for word the same wire format.

Reference analog: serialize/src/impls/{int_like.rs, collections.rs,
misc.rs, tuples.rs}: bool = 1 byte (0/1 validated), uN/iN = N/8 bytes LE,
usize = u64 LE, Vec<T> = u64 length + items, [T; N] = items (no prefix),
String = Vec<u8> of UTF-8, Option<T> = bool tag + payload, tuples = field
concatenation, () = empty, BTreeMap = u64 length + (k, v) pairs.

This layer is host-side IO (bytes in Python), matching the reference's
Read/Write streams; device arrays enter through an element codec — a pair
(ser(value) -> bytes, de(stream) -> value) such as the ones canonical.py
exposes for field elements.
"""

from __future__ import annotations

import io
from typing import Any, Callable, Optional, Sequence, Tuple


class SerializationError(ValueError):
    """Invalid wire data (reference serialize/src/error.rs)."""


# ---- primitive codecs (int_like.rs) ----

def ser_bool(v: bool) -> bytes:
    return bytes([1 if v else 0])


def de_bool(r: io.BytesIO) -> bool:
    b = r.read(1)
    if len(b) != 1 or b[0] > 1:
        raise SerializationError("invalid bool")
    return b[0] == 1


def _mk_uint(nbytes: int, signed: bool = False):
    def ser(v: int) -> bytes:
        return int(v).to_bytes(nbytes, "little", signed=signed)

    def de(r: io.BytesIO) -> int:
        b = r.read(nbytes)
        if len(b) != nbytes:
            raise SerializationError("eof")
        return int.from_bytes(b, "little", signed=signed)

    return ser, de


ser_u8, de_u8 = _mk_uint(1)
ser_u16, de_u16 = _mk_uint(2)
ser_u32, de_u32 = _mk_uint(4)
ser_u64, de_u64 = _mk_uint(8)
ser_i8, de_i8 = _mk_uint(1, True)
ser_i16, de_i16 = _mk_uint(2, True)
ser_i32, de_i32 = _mk_uint(4, True)
ser_i64, de_i64 = _mk_uint(8, True)
ser_usize, de_usize = ser_u64, de_u64  # usize = u64 LE (int_like.rs:110-120)


def ser_biguint(v: int) -> bytes:
    """BigUint = Vec<u8> of LE bytes (int_like.rs:202-230)."""
    nb = (int(v).bit_length() + 7) // 8
    return ser_vec(int(v).to_bytes(nb, "little"), ser_u8)


def de_biguint(r: io.BytesIO) -> int:
    data = de_vec(r, de_u8)
    return int.from_bytes(bytes(data), "little")


# ---- containers (collections.rs / misc.rs / tuples.rs) ----

def ser_vec(items: Sequence, ser_item: Callable[[Any], bytes]) -> bytes:
    """Vec<T>: u64 LE length + items (collections.rs:136-180)."""
    out = [ser_u64(len(items))]
    out += [ser_item(it) for it in items]
    return b"".join(out)


def de_vec(r: io.BytesIO, de_item: Callable[[io.BytesIO], Any]) -> list:
    n = de_u64(r)
    return [de_item(r) for _ in range(n)]


def ser_array(items: Sequence, ser_item) -> bytes:
    """[T; N]: items only, no length prefix (collections.rs:97-134)."""
    return b"".join(ser_item(it) for it in items)


def de_array(r: io.BytesIO, de_item, n: int) -> list:
    return [de_item(r) for _ in range(n)]


def ser_string(s: str) -> bytes:
    """String = Vec<u8> of UTF-8 (collections.rs:182-215)."""
    return ser_vec(s.encode("utf-8"), ser_u8)


def de_string(r: io.BytesIO) -> str:
    data = bytes(de_vec(r, de_u8))
    try:
        return data.decode("utf-8")
    except UnicodeDecodeError as e:
        raise SerializationError("invalid utf-8") from e


def ser_option(v: Optional[Any], ser_item) -> bytes:
    """Option<T> = bool + payload (misc.rs:12-36)."""
    if v is None:
        return ser_bool(False)
    return ser_bool(True) + ser_item(v)


def de_option(r: io.BytesIO, de_item):
    return de_item(r) if de_bool(r) else None


def ser_tuple(vs: Tuple, sers: Sequence[Callable]) -> bytes:
    """(A, B, ...) = concatenation (tuples.rs:27-72); () = empty."""
    if len(vs) != len(sers):
        raise ValueError(f"ser_tuple: {len(vs)} values for {len(sers)} codecs")
    return b"".join(s(v) for v, s in zip(vs, sers))


def de_tuple(r: io.BytesIO, des: Sequence[Callable]) -> Tuple:
    return tuple(d(r) for d in des)


def ser_map(d: dict, ser_k, ser_v) -> bytes:
    """BTreeMap = u64 length + sorted (k, v) pairs (collections.rs:217-302).

    Keys are emitted in sorted order to match BTreeMap iteration."""
    out = [ser_u64(len(d))]
    for k in sorted(d):
        out.append(ser_k(k))
        out.append(ser_v(d[k]))
    return b"".join(out)


def de_map(r: io.BytesIO, de_k, de_v) -> dict:
    n = de_u64(r)
    return {de_k(r): de_v(r) for _ in range(n)}


def reader(data: bytes) -> io.BytesIO:
    return io.BytesIO(data)
