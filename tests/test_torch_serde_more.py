"""Port parity for serialize/containers.py, serialize/derive.py and
serialize/random_bytes.py: the bytes a derived struct writes equal the JAX
package's byte for byte (they are the state that crosses the wire), a
decoded batch holds the same words, and from_random_bytes gives the JAX
package's words, flags and masks and the reference's rules by Python ints
(tests/test_random_bytes.py's oracle), at the shapes the JAX package's own
tests compile. Tolerance: zero."""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ec_oracle import ec_mul  # noqa: E402
from test_random_bytes import _oracle_field  # noqa: E402
from test_te import te_mul  # noqa: E402
from zkarray.curves import bls12_381 as jb381  # noqa: E402
from zkarray.curves import bn254 as jbn  # noqa: E402
from zkarray.curves import ed_on_bls12_381 as jjj  # noqa: E402
from zkarray.ec import sw_ext as jsw_ext  # noqa: E402
from zkarray.ff import fp as jfp  # noqa: E402
from zkarray.serialize import containers as JC  # noqa: E402
from zkarray.serialize import derive as JD  # noqa: E402
from zkarray.serialize import random_bytes as jrb  # noqa: E402
from zkarray.serialize.wrappers import COMPRESSED_CHECKED as J_CC  # noqa: E402
from zkarray.serialize.wrappers import UNCOMPRESSED_CHECKED as J_UC  # noqa: E402
from zkarray_torch import interop  # noqa: E402
from zkarray_torch.curves import bls12_381 as tb381  # noqa: E402
from zkarray_torch.curves import bn254 as tbn  # noqa: E402
from zkarray_torch.curves import ed_on_bls12_381 as tjj  # noqa: E402
from zkarray_torch.ec.te import TEAffine  # noqa: E402
from zkarray_torch.ff import fp as tfp  # noqa: E402
from zkarray_torch.serialize import containers as TC  # noqa: E402
from zkarray_torch.serialize import derive as TD  # noqa: E402
from zkarray_torch.serialize import random_bytes as trb  # noqa: E402
from zkarray_torch.serialize.canonical import field_byte_size  # noqa: E402
from zkarray_torch.serialize.wrappers import (COMPRESSED_CHECKED, COMPRESSED_UNCHECKED,  # noqa: E402
                                              UNCOMPRESSED_CHECKED, UNCOMPRESSED_UNCHECKED)

MODES = [COMPRESSED_CHECKED, COMPRESSED_UNCHECKED, UNCOMPRESSED_CHECKED, UNCOMPRESSED_UNCHECKED]


def _j_mode(m):
    from zkarray.serialize import wrappers as W
    return W.Mode(m.compress, m.validate)


def _lt(arr):
    return interop.limbs_from_numpy(np.asarray(arr), "cpu")


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

PRIMITIVES = [("bool", [True, False]), ("u8", [0, 255]), ("u16", [0, 65535, 258]),
              ("u32", [0, 1, 2 ** 32 - 1]), ("u64", [0, 2 ** 64 - 1, 12345678901]),
              ("i8", [-128, 127, -1]), ("i16", [-32768, 32767]), ("i32", [-2 ** 31, 2 ** 31 - 1]),
              ("i64", [-2 ** 63, 2 ** 63 - 1, -5]), ("usize", [7, 2 ** 40]),
              ("biguint", [0, 1, 2 ** 200 + 17]), ("string", ["", "zk", "héllo ✓"])]


@pytest.mark.parametrize("kind,vals", PRIMITIVES, ids=[k for k, _ in PRIMITIVES])
def test_container_primitives_bytes_match_jax(kind, vals):
    for v in vals:
        raw = getattr(TC, f"ser_{kind}")(v)
        assert raw == getattr(JC, f"ser_{kind}")(v)
        assert getattr(TC, f"de_{kind}")(TC.reader(raw)) == v


def test_container_combinators_bytes_match_jax():
    items = [3, 1, 4, 1, 5]
    for mod in (TC, JC):
        assert isinstance(mod.reader(b""), io.BytesIO)
    assert TC.ser_vec(items, TC.ser_u32) == JC.ser_vec(items, JC.ser_u32)
    assert TC.de_vec(TC.reader(TC.ser_vec(items, TC.ser_u32)), TC.de_u32) == items
    assert TC.ser_array(items, TC.ser_u16) == JC.ser_array(items, JC.ser_u16)
    assert TC.de_array(TC.reader(TC.ser_array(items, TC.ser_u16)), TC.de_u16, 5) == items
    for v in (None, "x"):
        raw = TC.ser_option(v, TC.ser_string)
        assert raw == JC.ser_option(v, JC.ser_string)
        assert TC.de_option(TC.reader(raw), TC.de_string) == v
    tup = (7, "a", False)
    raw = TC.ser_tuple(tup, [TC.ser_u64, TC.ser_string, TC.ser_bool])
    assert raw == JC.ser_tuple(tup, [JC.ser_u64, JC.ser_string, JC.ser_bool])
    assert TC.de_tuple(TC.reader(raw), [TC.de_u64, TC.de_string, TC.de_bool]) == tup
    d = {"b": 2, "a": 1, "c": 3}
    raw = TC.ser_map(d, TC.ser_string, TC.ser_u8)
    assert raw == JC.ser_map(d, JC.ser_string, JC.ser_u8)
    assert TC.de_map(TC.reader(raw), TC.de_string, TC.de_u8) == d


def test_container_errors():
    with pytest.raises(TC.SerializationError):
        TC.de_bool(TC.reader(b"\x02"))
    with pytest.raises(TC.SerializationError):
        TC.de_u32(TC.reader(b"\x01\x02"))
    with pytest.raises(TC.SerializationError):
        TC.de_string(TC.reader(TC.ser_vec([0xFF, 0xFE], TC.ser_u8)))
    with pytest.raises(ValueError):
        TC.ser_tuple((1, 2), [TC.ser_u8])
    assert issubclass(TC.SerializationError, ValueError)


# ---------------------------------------------------------------------------
# derive
# ---------------------------------------------------------------------------

@TD.canonical
class THeader:
    version: int
    label: str
    strict: bool


@JD.canonical
class JHeader:
    version: int
    label: str
    strict: bool


@TD.canonical(codecs={"ids": TD.vec(TD.U32), "note": TD.option(TD.STRING),
                      "pair": TD.tuple_(TD.U8, TD.BYTES), "tags": TD.map_(TD.STRING, TD.U16),
                      "fixed": TD.array(TD.U64, 2), "big": TD.BIGUINT})
class TPayload:
    header: THeader
    ids: list
    note: object
    pair: tuple
    tags: dict
    fixed: list
    big: int


@JD.canonical(codecs={"ids": JD.vec(JD.U32), "note": JD.option(JD.STRING),
                      "pair": JD.tuple_(JD.U8, JD.BYTES), "tags": JD.map_(JD.STRING, JD.U16),
                      "fixed": JD.array(JD.U64, 2), "big": JD.BIGUINT})
class JPayload:
    header: JHeader
    ids: list
    note: object
    pair: tuple
    tags: dict
    fixed: list
    big: int


def test_derive_primitive_structs_bytes_match_jax():
    args = dict(ids=[7, 9, 11], note="hi", pair=(3, b"\x00\x01"), tags={"z": 1, "a": 2},
                fixed=[5, 2 ** 63], big=2 ** 100 + 3)
    for note in ("hi", None):
        t = TPayload(header=THeader(3, "zk", True), **dict(args, note=note))
        j = JPayload(header=JHeader(3, "zk", True), **dict(args, note=note))
        for m in MODES:
            raw = t.serialize_with_mode(m)
            assert raw == j.serialize_with_mode(_j_mode(m))
            assert t.serialized_size(m) == len(raw)
            assert TPayload.deserialize_with_mode(raw, m) == t
    assert TPayload.deserialize_compressed(t.serialize_compressed()) == t
    assert THeader.deserialize_uncompressed_unchecked(THeader(1, "", False).serialize_uncompressed()) \
        == THeader(1, "", False)


def test_derive_string_annotations_and_missing_codec():
    @TD.canonical
    class Inner:
        n: "int"

    globals()["_TDeriveInner"] = Inner

    @TD.canonical
    class Outer:
        inner: "_TDeriveInner"
        tag: "str"

    o = Outer(inner=Inner(n=5), tag="x")
    assert Outer.deserialize_compressed(o.serialize_compressed()) == o
    with pytest.raises(TypeError, match="no codec"):
        @TD.canonical
        class Bad:
            x: object


def test_derive_fp_vec_bytes_match_jax():
    """A Vec<F> leaf (BN254 Fr, 5 elements; tests/test_derive.py's shape):
    the same bytes, the decoded words equal, a >= p element rejected under
    validation and taken without."""
    jspec, tspec = jbn.G1.scalar, tbn.G1.scalar
    vals = [int(v) for v in np.random.default_rng(0).integers(1, 1 << 60, size=5)]
    ja = jnp.stack([jfp.const_array(jspec, v, ()) for v in vals], axis=1).reshape(jspec.num_limbs, 5)
    ta = tfp.from_ints(tspec, vals, device="cpu")
    assert np.array_equal(np.asarray(ja), interop.limbs_to_numpy(ta))

    @TD.canonical(codecs={"evals": TD.fp_vec(tspec, device="cpu")})
    class TEvals:
        evals: object

    @JD.canonical(codecs={"evals": JD.fp_vec(jspec)})
    class JEvals:
        evals: object

    raw = TEvals(evals=ta).serialize_compressed()
    assert raw == JEvals(evals=ja).serialize_compressed()
    assert torch.equal(TEvals.deserialize_compressed(raw).evals, ta)
    bad = bytearray(raw)
    bad[8:40] = b"\xff" * 32
    with pytest.raises(TC.SerializationError):
        TEvals.deserialize_compressed(bytes(bad))
    got = TEvals.deserialize_compressed_unchecked(bytes(bad)).evals
    assert np.array_equal(interop.limbs_to_numpy(got),
                          np.asarray(JEvals.deserialize_compressed_unchecked(bytes(bad)).evals))
    with pytest.raises(TC.SerializationError, match="truncated"):
        TEvals.deserialize_compressed(raw[:-1])


def test_derive_sw_points_bytes_match_jax():
    """Vec<G1> (BN254, infinity included) in every mode: the JAX package's
    bytes, the decoded points' words, an off-curve x rejected."""
    curve = jbn.G1
    gen = (curve.gen_x, curve.gen_y)
    pts = [ec_mul(gen, k, curve.a_int, curve.base.modulus) if k else None for k in (1, 2, 5, 0)]
    JA = curve.affine_from_ints(pts)
    TA = interop.affine_from_numpy(np.asarray(JA.x), np.asarray(JA.y), np.asarray(JA.inf), "cpu")

    @TD.canonical(codecs={"pts": TD.sw_points(tbn.G1, device="cpu"), "evals": TD.fp_vec(tbn.FR, device="cpu")})
    class TProof:
        pts: object
        evals: object

    @JD.canonical(codecs={"pts": JD.sw_points(curve), "evals": JD.fp_vec(jbn.FR)})
    class JProof:
        pts: object
        evals: object

    ev = [3, 1 << 200]
    tp = TProof(pts=TA, evals=tfp.from_ints(tbn.FR, ev, device="cpu"))
    jp = JProof(pts=JA, evals=jfp.from_ints(jbn.FR, ev))
    for m in MODES:
        raw = tp.serialize_with_mode(m)
        assert raw == jp.serialize_with_mode(_j_mode(m))
        back = TProof.deserialize_with_mode(raw, m)
        jback = JProof.deserialize_with_mode(raw, _j_mode(m))
        for g, w in zip(back.pts, jback.pts):
            assert np.array_equal(g.numpy() if g.dtype == torch.bool else interop.limbs_to_numpy(g),
                                  np.asarray(w))
    raw = bytearray(tp.serialize_with_mode(COMPRESSED_CHECKED))
    raw[8] ^= 1
    with pytest.raises(TC.SerializationError):
        TProof.deserialize_with_mode(bytes(raw), COMPRESSED_CHECKED)


def test_derive_te_and_ext_points_bytes_match_jax():
    """Vec of Jubjub points and of BLS12-381 G2 points in one struct."""
    g = (jjj.EDWARDS.gen_x, jjj.EDWARDS.gen_y)
    jte = jjj.EDWARDS.affine_from_ints([te_mul(g, k) for k in (1, 2, 3)])
    tte = TEAffine(_lt(jte.x), _lt(jte.y))
    H = jb381.G2.generator((1,))
    H2 = jsw_ext.to_affine(jb381.G2, jsw_ext.double(jb381.G2, jsw_ext.from_affine(jb381.G2, H)))
    jg2 = jsw_ext.ExtAffine(jnp.concatenate([H.x, H2.x], axis=-1),
                            jnp.concatenate([H.y, H2.y], axis=-1), jnp.concatenate([H.inf, H2.inf]))
    tg2 = interop.ext_affine_from_numpy(np.asarray(jg2.x), np.asarray(jg2.y), np.asarray(jg2.inf),
                                        "cpu")

    @TD.canonical(codecs={"te": TD.te_points(tjj.EDWARDS, device="cpu"),
                          "g2": TD.sw_points_ext(tb381.G2, device="cpu")})
    class TMixed:
        te: object
        g2: object

    @JD.canonical(codecs={"te": JD.te_points(jjj.EDWARDS), "g2": JD.sw_points_ext(jb381.G2)})
    class JMixed:
        te: object
        g2: object

    tm, jm = TMixed(te=tte, g2=tg2), JMixed(te=jte, g2=jg2)
    for m in (COMPRESSED_CHECKED, UNCOMPRESSED_CHECKED):
        raw = tm.serialize_with_mode(m)
        assert raw == jm.serialize_with_mode(_j_mode(m))
        back = TMixed.deserialize_with_mode(raw, m)
        assert torch.equal(back.te.x, tte.x) and torch.equal(back.te.y, tte.y)
        assert torch.equal(back.g2.x, tg2.x) and torch.equal(back.g2.y, tg2.y)
    assert J_CC.compress and not J_UC.compress


# ---------------------------------------------------------------------------
# random_bytes
# ---------------------------------------------------------------------------

def test_field_from_random_bytes_matches_jax_and_oracle():
    """tests/test_random_bytes.py's BLS12-381 Fq rows (some >= p) with two
    flag bits, and BN254 Fr rows shorter and longer than an element."""
    spec, tspec = jb381.FQ, tb381.FQ
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, size=(64, field_byte_size(tspec, 2)), dtype=np.uint8)
    data[:8, :-1] = 0xFF
    ja, jflags, jok = jrb.field_from_random_bytes(spec, data, flag_bits=2)
    ta, tflags, tok = trb.field_from_random_bytes(tspec, data, flag_bits=2, device="cpu")
    assert np.array_equal(np.asarray(ja), interop.limbs_to_numpy(ta))
    assert np.array_equal(jflags, tflags) and np.array_equal(jok, tok)
    vals = tfp.to_ints(tspec, ta)
    for i in range(64):
        want_v, want_f = _oracle_field(spec, bytes(data[i]), 2)
        assert tflags[i] == want_f and tok[i] == (want_v is not None)
        if want_v is not None:
            assert vals[i] == want_v
    rng = np.random.default_rng(8)
    nb = field_byte_size(tbn.FR, 0)
    for k in (nb - 5, nb, nb + 7):
        data = rng.integers(0, 256, size=(8, k), dtype=np.uint8)
        ja, _, jok = jrb.field_from_random_bytes(jbn.FR, data)
        ta, _, tok = trb.field_from_random_bytes(tbn.FR, data, device="cpu")
        assert np.array_equal(np.asarray(ja), interop.limbs_to_numpy(ta)) and np.array_equal(jok, tok)
    with pytest.raises(ValueError):
        trb.field_from_random_bytes(tbn.FR, data, flag_bits=9)


def test_sw_from_random_bytes_matches_jax_and_oracle():
    """BN254 G1, 96 rows (the infinity encoding, both flags, random rows):
    the JAX package's words and mask; on the curve, the greatest root iff
    the negative flag is clear, by Python ints."""
    curve, tcurve = jbn.G1, tbn.G1
    p = curve.base.modulus
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, size=(96, field_byte_size(tcurve.base, 2)), dtype=np.uint8)
    data[0] = 0
    data[0, -1] = 0x40
    data[1] = 0
    data[1, -1] = 0xC0
    jpts, jok = jrb.sw_from_random_bytes(curve, data)
    tpts, tok = trb.sw_from_random_bytes(tcurve, data, device="cpu")
    assert np.array_equal(jok, tok) and bool(tok[0]) and not tok[1]
    assert np.array_equal(np.asarray(jpts.x), interop.limbs_to_numpy(tpts.x))
    assert np.array_equal(np.asarray(jpts.y), interop.limbs_to_numpy(tpts.y))
    assert np.array_equal(np.asarray(jpts.inf), tpts.inf.numpy())
    xs, ys = tfp.to_ints(tcurve.base, tpts.x), tfp.to_ints(tcurve.base, tpts.y)
    n_valid = 0
    for i in range(2, 96):
        want_x, flags = _oracle_field(curve.base, bytes(data[i]), 2)
        if not tok[i]:
            continue
        n_valid += 1
        assert xs[i] == want_x and (ys[i] ** 2 - (want_x ** 3 + curve.b_int)) % p == 0
        assert (ys[i] <= p - ys[i]) if flags & 0x80 else (ys[i] >= p - ys[i])
    assert n_valid >= 10


def test_te_from_random_bytes_matches_jax_and_oracle():
    curve, tcurve = jjj.EDWARDS, tjj.EDWARDS
    p = curve.base.modulus
    rng = np.random.default_rng(10)
    data = rng.integers(0, 256, size=(64, field_byte_size(tcurve.base, 1)), dtype=np.uint8)
    jpts, jok = jrb.te_from_random_bytes(curve, data)
    tpts, tok = trb.te_from_random_bytes(tcurve, data, device="cpu")
    assert np.array_equal(jok, tok)
    assert np.array_equal(np.asarray(jpts.x), interop.limbs_to_numpy(tpts.x))
    assert np.array_equal(np.asarray(jpts.y), interop.limbs_to_numpy(tpts.y))
    xs = tfp.to_ints(tcurve.base, tpts.x)
    n_valid = 0
    for i in range(64):
        want_y, flags = _oracle_field(curve.base, bytes(data[i]), 1)
        if not tok[i]:
            continue
        n_valid += 1
        x2 = (want_y ** 2 - 1) * pow(curve.d_int * want_y ** 2 - curve.a_int, -1, p) % p
        assert (xs[i] ** 2 - x2) % p == 0
        assert (xs[i] >= p - xs[i]) if flags & 0x80 else (xs[i] <= p - xs[i])
    assert n_valid >= 10
