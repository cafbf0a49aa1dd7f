"""Port parity: zkarray_torch.serialize, ec.point_serde (short Weierstrass)
and curves.bls12_381_zcash (G1) against the JAX package's bytes and the
zcash BLS12-381 vectors, byte for byte.

Field elements: tests/test_serialize.py's inputs (BN254 Fr at 16 elements,
BLS12-381 Fq with SW flags at 3), non-canonical bytes rejected. SW points:
tests/test_point_serde.py's eight BN254 points, both encodings, validated,
with rejected encodings beside them. zcash: all 1,000 G1 vectors (k G for
k < 1000), compressed and uncompressed, byte-exact both ways and validated
through the fast subgroup check."""

import hashlib
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import same  # noqa: E402
from zkarray.curves import bls12_381 as jb381  # noqa: E402
from zkarray.curves import bn254 as jbn254  # noqa: E402
from zkarray.ec import point_serde as jps  # noqa: E402
from zkarray.ff import fp as jfp  # noqa: E402
from zkarray.serialize import canonical as jser  # noqa: E402
from zkarray.serialize import wrappers as jwrap  # noqa: E402
from zkarray_torch.curves import bls12_381 as tb381  # noqa: E402
from zkarray_torch.curves import bls12_381_zcash as tzc  # noqa: E402
from zkarray_torch.curves import bn254 as tbn254  # noqa: E402
from zkarray_torch.ec import point_serde as tps  # noqa: E402
from zkarray_torch.ec import sw as tsw  # noqa: E402
from zkarray_torch.ff import fp as tfp  # noqa: E402
from zkarray_torch.serialize import canonical as tser  # noqa: E402
from zkarray_torch.serialize import wrappers as twrap  # noqa: E402
from zkarray_torch.testing import ec_add, ec_mul  # noqa: E402

VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")


def test_field_serde_matches_jax():
    """Byte sizes, little-endian layout, flags packed into the last byte and
    read back, and a value >= p rejected."""
    for js, ts in ((jbn254.FR, tbn254.FR), (jb381.FQ, tb381.FQ), (jb381.FR, tb381.FR)):
        for bits in (0, 1, 2, 8):
            assert tser.field_byte_size(ts, bits) == jser.field_byte_size(js, bits)
    js, ts = jbn254.FR, tbn254.FR
    p = ts.modulus
    rng = random.Random(0)
    xs = [0, 1, p - 1] + [rng.randrange(p) for _ in range(13)]
    data = tser.serialize_fp(ts, tfp.from_ints(ts, xs, device="cpu"))
    assert np.array_equal(data, jser.serialize_fp(js, jfp.from_ints(js, xs)))
    back, flags, valid = tser.deserialize_fp(ts, data, device="cpu")
    jback, _, _ = jser.deserialize_fp(js, data)
    assert same(jback, back) and valid.all() and (flags == 0).all()
    assert tfp.to_ints(ts, back) == xs

    js, ts = jb381.FQ, tb381.FQ
    fl = np.array([tser.SW_FLAG_INFINITY, tser.SW_FLAG_NEGATIVE, 0], dtype=np.uint8)
    data = tser.serialize_fp(ts, tfp.from_ints(ts, [5, 7, 11], device="cpu"), flag_bits=2, flags=fl)
    assert np.array_equal(data, jser.serialize_fp(js, jfp.from_ints(js, [5, 7, 11]), 2, fl))
    back, got_fl, valid = tser.deserialize_fp(ts, data, flag_bits=2, device="cpu")
    assert valid.all() and list(got_fl) == [0x40, 0x80, 0] and tfp.to_ints(ts, back) == [5, 7, 11]
    with pytest.raises(ValueError):
        tser.serialize_fp(ts, back, flag_bits=9)

    ts = tbn254.FR
    p = ts.modulus
    raw = np.stack([np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8)
                    for v in (p, p - 1, (1 << 256) - 1, p + 1)])
    _, _, valid = tser.deserialize_fp(ts, raw, device="cpu")
    assert valid.tolist() == [False, True, False, False]
    _, _, valid = tser.deserialize_fp(ts, raw, validate=False, device="cpu")
    assert valid.all()
    with pytest.raises(ValueError):
        tser.deserialize_fp(ts, raw[:, :31], device="cpu")


def test_modes_and_hash_match_jax():
    assert [(m.compress, m.validate) for m in (
        twrap.COMPRESSED_CHECKED, twrap.COMPRESSED_UNCHECKED, twrap.UNCOMPRESSED_CHECKED,
        twrap.UNCOMPRESSED_UNCHECKED)] == [(m.compress, m.validate) for m in (
            jwrap.COMPRESSED_CHECKED, jwrap.COMPRESSED_UNCHECKED, jwrap.UNCOMPRESSED_CHECKED,
            jwrap.UNCOMPRESSED_UNCHECKED)]
    data = np.arange(40, dtype=np.uint8).reshape(5, 8)
    for name in ("sha256", "blake2b"):
        got = twrap.hash_canonical(lambda: data, name)
        assert got == jwrap.hash_canonical(lambda: data, name)
        assert got == hashlib.new(name, data.tobytes()).digest()
    assert twrap.hash_canonical(lambda: b"abc") == hashlib.sha256(b"abc").digest()


def bn254_points():
    """tests/test_point_serde.py:test_sw_roundtrip_bn254's eight points."""
    c = tbn254.G1
    rng = random.Random(0)
    return [None] + [ec_mul((c.gen_x, c.gen_y), rng.randrange(1, c.scalar.modulus), 0,
                            c.base.modulus) for _ in range(7)]


@pytest.mark.parametrize("compress", [True, False], ids=["compressed", "uncompressed"])
def test_sw_point_serde_matches_jax(compress):
    """serialize_sw: the JAX package's bytes. deserialize_sw (validate): the
    JAX package's points and masks on those bytes; then encodings beside
    them: infinity with the negative flag (rejected when compressed, where
    it is a second encoding of infinity), a non-canonical x, and
    (compressed) an x with no point on the curve or (uncompressed) a point
    off it, all rejected."""
    jc, tc = jbn254.G1, tbn254.G1
    pts = bn254_points()
    jA = jc.affine_from_ints(pts)
    tA = tsw.affine_from_ints(tc, pts, "cpu")
    data = tps.serialize_sw(tc, tA, compress)
    assert np.array_equal(data, jps.serialize_sw(jc, jA, compress))
    jback, jok = jps.deserialize_sw(jc, data, compress)
    p = tc.base.modulus
    bad = data[:3].copy()
    bad[0, 31 if compress else 63] |= tser.SW_FLAG_NEGATIVE  # infinity flagged negative
    bad[1, :32] = np.frombuffer(p.to_bytes(32, "little"), dtype=np.uint8)  # x = p
    bad[1, 31] |= data[1, 31] & 0xC0 if compress else 0
    if compress:
        x = next(x for x in range(2, 100) if pow((x ** 3 + 3) % p, (p - 1) // 2, p) == p - 1)
        bad[2, :32] = np.frombuffer(x.to_bytes(32, "little"), dtype=np.uint8)
    else:
        bad[2, 32] ^= 1  # y + 1: off the curve
    back, ok = tps.deserialize_sw(tc, np.concatenate([data, bad]), compress, device="cpu")
    for j, t in zip(jback[:2], back[:2]):
        assert np.array_equal(np.asarray(j), t[:, :8].numpy().view(np.uint32))
    assert np.array_equal(np.asarray(jback.inf), back.inf[:8].numpy())
    assert np.array_equal(np.asarray(jok), ok[:8]) and ok[:8].all()
    assert ok[8:].tolist() == [compress is False, False, False]
    assert tsw.affine_to_ints(tc, tsw.AffinePoints(*(v[..., :8] for v in back))) == pts


def zcash_points():
    c = tb381.G1
    pts, cur = [None], None
    for _ in range(999):
        cur = ec_add(cur, (c.gen_x, c.gen_y), 0, c.base.modulus)
        pts.append(cur)
    return pts


@pytest.mark.parametrize("compress", [True, False], ids=["compressed", "uncompressed"])
def test_zcash_g1_vectors_both_ways(compress):
    """All 1,000 zcash G1 vectors: serialize_g1 gives their bytes;
    deserialize_g1 with validate=True (the fast subgroup check) accepts
    every one and gives the points back; a flipped compression flag is
    rejected."""
    width = 48 if compress else 96
    name = f"g1_{'compressed' if compress else 'uncompressed'}_valid_test_vectors.dat"
    with open(os.path.join(VEC_DIR, name), "rb") as f:
        want = np.frombuffer(f.read(), dtype=np.uint8).reshape(1000, width)
    pts = zcash_points()
    A = tsw.affine_from_ints(tb381.G1, pts, "cpu")
    assert np.array_equal(tzc.serialize_g1(A, compress=compress), want)
    back, ok = tzc.deserialize_g1(want, compress=compress, validate=True, device="cpu")
    assert ok.all()
    assert tsw.affine_to_ints(tb381.G1, back) == pts
    assert np.array_equal(tzc.serialize_g1(back, compress=compress), want)
    flipped = want[:2].copy()
    flipped[:, 0] ^= tzc.COMPRESSED_FLAG
    _, ok2 = tzc.deserialize_g1(flipped, compress=compress, validate=False, device="cpu")
    assert not ok2.any()
