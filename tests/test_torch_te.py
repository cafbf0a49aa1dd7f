"""Port parity: zkarray_torch.ec.te, curves.te_zoo and ed_on_bls12_381,
ec.h2c.elligator2 and ec.point_serde's TE formats against the JAX package,
word for word (extended coordinates included).

The JAX calls run at the shapes its own tests compile: Jubjub's group law
at 6 lanes and scalar_mul at 3 (tests/test_te.py), the zoo's one-lane
checks on ed_on_bls12_377, ed_on_bn254 (a = 1) and curve25519
(tests/test_zoo.py), Elligator2 at 8 lanes on Jubjub and Bandersnatch
(tests/test_elligator2.py) and the TE round trip at 5 points
(tests/test_point_serde.py). The NW = 10, 12 and 24 curves, which no JAX
test compiles, are held against the affine host model
(zkarray_torch/testing.py:te_add_host). On the CPU every field operation is
its kernel's plain version."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from zkarray.curves import ed_on_bls12_381 as jjj  # noqa: E402
from zkarray.curves import te_zoo as jtz  # noqa: E402
from zkarray.ec import point_serde as jps  # noqa: E402
from zkarray.ec import te as jte  # noqa: E402
from zkarray.ec.h2c.elligator2 import _te_scale as j_te_scale  # noqa: E402
from zkarray.ec.h2c.elligator2 import elligator2_map as j_elligator2  # noqa: E402
from zkarray.ff import fp as jfp  # noqa: E402
from zkarray_torch import interop  # noqa: E402
from zkarray_torch.curves import ed_on_bls12_381 as tjj  # noqa: E402
from zkarray_torch.curves import te_zoo as ttz  # noqa: E402
from zkarray_torch.ec import point_serde as tps  # noqa: E402
from zkarray_torch.ec import te as tte  # noqa: E402
from zkarray_torch.ec.h2c import elligator2 as tell  # noqa: E402
from zkarray_torch.ff import fp as tfp  # noqa: E402
from zkarray_torch.interop import limbs_from_numpy, limbs_to_numpy  # noqa: E402
from zkarray_torch.testing import host_elligator2, sqrt_mod, te_add_host, te_mul_host  # noqa: E402

JJ, TJ = jjj.EDWARDS, tjj.EDWARDS


def _t(j):
    return limbs_from_numpy(np.asarray(j), "cpu")


def _same(jP, tP):
    assert len(jP) == len(tP)
    for j, t in zip(jP, tP):
        assert np.array_equal(np.asarray(j), limbs_to_numpy(t))


def _gen(c):
    return (c.gen_x, c.gen_y)


@pytest.mark.parametrize("name", sorted(jtz.TE_CURVES) + ["ed_on_bls12_381"])
def test_te_constants_match_jax(name):
    jc = JJ if name == "ed_on_bls12_381" else jtz.TE_CURVES[name]
    tc = TJ if name == "ed_on_bls12_381" else ttz.TE_CURVES[name]
    assert tc.name == jc.name and tc.a_is_minus_one == jc.a_is_minus_one
    assert interop.same_te_curve(tc, jc.a_int, jc.d_int, jc.gen_x, jc.gen_y, jc.cofactor,
                                 jc.mont_coeff_a, jc.mont_coeff_b)
    for jf, tf in ((jc.base, tc.base), (jc.scalar, tc.scalar)):
        assert interop.same_field(tf, jf.modulus, jf.generator_int, jf.r_int, jf.r2_int, jf.inv16)
        assert (tf.name, tf.small_subgroup_base, tf.small_subgroup_base_adicity,
                tf.large_subgroup_root_int, tf.sqrt_mode, tf.sqrt_qnr) == (
            jf.name, jf.small_subgroup_base, jf.small_subgroup_base_adicity,
            jf.large_subgroup_root_int, jf.sqrt_mode, jf.sqrt_qnr)
    assert sorted(ttz.TE_FIELDS) == sorted(jtz.TE_FIELDS)
    assert ttz.ED_ON_BW6_761 is ttz.ED_ON_CP6_782


def _jubjub_pairs():
    """tests/test_te.py:test_on_curve_and_group_laws's 6 + 6 points."""
    g = _gen(JJ)
    rng = random.Random(0)
    ks1 = [0, 1, 2, 5, rng.randrange(JJ.scalar.modulus), 7]
    ks2 = [0, 3, 2, 1, rng.randrange(JJ.scalar.modulus), 11]
    return [te_mul_host(TJ, g, k) for k in ks1], [te_mul_host(TJ, g, k) for k in ks2]


def test_jubjub_group_law_matches_jax():
    """a = -1 (the negation branch): from_affine, add, add_mixed, double,
    neg, to_affine, is_on_curve and is_zero, extended words equal."""
    p1, p2 = _jubjub_pairs()
    J1, J2 = JJ.affine_from_ints(p1), JJ.affine_from_ints(p2)
    T1, T2 = TJ.affine_from_ints(p1, device="cpu"), TJ.affine_from_ints(p2, device="cpu")
    _same(J1, T1)
    jP, jQ = jte.from_affine(JJ, J1), jte.from_affine(JJ, J2)
    tP, tQ = tte.from_affine(TJ, T1), tte.from_affine(TJ, T2)
    _same(jP, tP)
    js = jte.add(JJ, jP, jQ)
    ts = tte.add(TJ, tP, tQ)
    _same(js, ts)
    # the JAX package's points carried across add to the same words
    tQc = interop.te_extended_from_numpy([np.asarray(v) for v in jQ], "cpu")
    for j, t in zip(js, interop.te_extended_to_numpy(tte.add(TJ, tP, tQc))):
        assert np.array_equal(np.asarray(j), t)
    _same(js, tte.add_mixed(TJ, tP, T2))
    _same(jte.double(JJ, jP), tte.double(TJ, tP))
    _same(jte.neg(JJ, jP), tte.neg(TJ, tP))
    ja, ta = jte.to_affine(JJ, js), tte.to_affine(TJ, ts)
    _same(ja, ta)
    assert TJ.affine_to_ints(ta) == [te_add_host(TJ, a, b) for a, b in zip(p1, p2)]
    assert tte.is_on_curve(TJ, ta).tolist() == np.asarray(jte.is_on_curve(JJ, ja)).tolist()
    assert tte.is_zero(TJ, ts).tolist() == np.asarray(jte.is_zero(JJ, js)).tolist()
    assert tte.is_zero(TJ, ts).tolist() == [True] + [False] * 5
    off = tte.TEAffine(ta.x, tfp.add(TJ.base, ta.y, tfp.one(TJ.base, (6,), "cpu")))
    assert not tte.is_on_curve(TJ, off).any()


@pytest.mark.parametrize("k", [5, -6, 0])
def test_jubjub_scalar_mul_const_matches_jax_ladder(k):
    """scalar_mul_const against the JAX package's double and add (6 lanes)
    stepped over k's bits on the host, the JAX scalar_mul_const's select
    keeping the doubling at a clear bit; negative k negates."""
    p1, _ = _jubjub_pairs()
    jP = jte.from_affine(JJ, JJ.affine_from_ints(p1))
    acc = jte.zero(JJ, (6,))
    for bit in bin(abs(k))[2:] if k else "":
        acc = jte.double(JJ, acc)
        if bit == "1":
            acc = jte.add(JJ, acc, jP)
    if k < 0:
        acc = jte.neg(JJ, acc)
    tP = tte.from_affine(TJ, TJ.affine_from_ints(p1, device="cpu"))
    _same(acc, tte.scalar_mul_const(TJ, tP, k))


def test_jubjub_scalar_mul_matches_jax():
    """tests/test_te.py:test_scalar_mul's 3 lanes (k = 0, 1, random)."""
    g = _gen(JJ)
    rng = random.Random(1)
    pts = [te_mul_host(TJ, g, k) for k in (1, 2, 3)]
    ks = [0, 1, rng.randrange(JJ.scalar.modulus)]
    js = jfp.from_ints(JJ.scalar, ks, mont=False)
    jm = jte.scalar_mul(JJ, JJ.affine_from_ints(pts), js)
    tm = tte.scalar_mul(TJ, TJ.affine_from_ints(pts, device="cpu"), _t(js))
    _same(jm, tm)
    assert TJ.affine_to_ints(tte.to_affine(TJ, tm)) == [te_mul_host(TJ, p, k)
                                                        for p, k in zip(pts, ks)]


@pytest.mark.parametrize("name", ["ed_on_bls12_377", "ed_on_bn254", "curve25519"])
def test_te_zoo_one_lane_matches_jax(name):
    """tests/test_zoo.py's check, 2G + G (and [3]G by scalar_mul on
    ed_on_bn254), words equal: a = -1, a = 1 and a = 486664 (the product
    branch)."""
    jc, tc = jtz.TE_CURVES[name], ttz.TE_CURVES[name]
    jG, tG = jc.generator((1,)), tc.generator((1,), device="cpu")
    _same(jG, tG)
    jP, tP = jte.from_affine(jc, jG), tte.from_affine(tc, tG)
    j3 = jte.add(jc, jte.double(jc, jP), jP)
    t3 = tte.add(tc, tte.double(tc, tP), tP)
    _same(j3, t3)
    _same(jte.to_affine(jc, j3), tte.to_affine(tc, t3))
    assert tc.affine_to_ints(tte.to_affine(tc, t3)) == [te_mul_host(tc, _gen(tc), 3)]
    if name == "ed_on_bn254":  # the ladder (its steps are the add and double above)
        js = jfp.from_ints(jc.scalar, [3], mont=False)
        jm = jte.scalar_mul(jc, jG, js)
        tm = tte.scalar_mul(tc, tG, _t(js))
        _same(jm, tm)
        _same(jte.to_affine(jc, jm), tte.to_affine(tc, tm))


@pytest.mark.parametrize("name,nw", [("ed_on_mnt4_298", 10), ("ed_on_cp6_782", 12),
                                     ("ed_on_mnt4_753", 24)])
def test_te_wide_curves_against_host(name, nw):
    """The NW = 10, 12 and 24 curves (a = -1) at 3 lanes: add, double,
    to_affine, is_on_curve and scalar_mul_const against the affine host
    model (scalar_mul's ladder is the same code at every width: held at
    NW = 8 above)."""
    tc = ttz.TE_CURVES[name]
    assert tc.base.num_limbs == 2 * nw and tc.a_is_minus_one
    g = _gen(tc)
    ks = [1, 5, 1234567]
    pts = [te_mul_host(tc, g, k) for k in ks]
    qs = [te_mul_host(tc, g, k) for k in (2, 5, 99)]
    A, B = tc.affine_from_ints(pts, device="cpu"), tc.affine_from_ints(qs, device="cpu")
    P = tte.from_affine(tc, A)
    assert tte.is_on_curve(tc, A).all()
    assert tc.affine_to_ints(tte.to_affine(tc, tte.add_mixed(tc, P, B))) == [
        te_add_host(tc, a, b) for a, b in zip(pts, qs)]
    assert tc.affine_to_ints(tte.to_affine(tc, tte.double(tc, P))) == [
        te_add_host(tc, a, a) for a in pts]
    assert tc.affine_to_ints(tte.to_affine(tc, tte.scalar_mul_const(tc, P, 1000003))) == [
        te_mul_host(tc, a, 1000003) for a in pts]
    assert bool(tte.is_zero(tc, tte.add(tc, P, tte.neg(tc, P))).all())


def test_te_serde_matches_jax():
    """tests/test_point_serde.py:test_te_roundtrip's 5 points, both modes,
    bytes and decoded words equal the JAX package's; then the same shape
    with one compressed y whose x^2 is not a square, and one uncompressed
    point off the curve (ok False there, as in the JAX package)."""
    g = _gen(JJ)
    pts = [(0, 1)] + [te_mul_host(TJ, g, k) for k in (1, 2, 5, 77)]
    jA, tA = JJ.affine_from_ints(pts), TJ.affine_from_ints(pts, device="cpu")
    p = TJ.base.modulus
    bad_y = next(y for y in range(2, 100)
                 if sqrt_mod((y * y - 1) * pow(TJ.d_int * y * y - TJ.a_int, -1, p), p) is None)
    for compress in (True, False):
        jd = jps.serialize_te(JJ, jA, compress)
        td = tps.serialize_te(TJ, tA, compress)
        assert np.array_equal(jd, td)
        jb, jok = jps.deserialize_te(JJ, jd, compress)
        tb, tok = tps.deserialize_te(TJ, td, compress, device="cpu")
        _same(jb, tb)
        assert tok.tolist() == np.asarray(jok).tolist() == [True] * 5
        assert TJ.affine_to_ints(tb) == pts
        bad = td.copy()
        if compress:
            bad[3] = tps.serialize_fp(TJ.base, tfp.from_ints(TJ.base, [bad_y], device="cpu"),
                                      flag_bits=1, flags=np.zeros(1, np.uint8))[0]
        else:
            nb = bad.shape[1] // 2
            bad[3, nb:] = td[2, nb:]  # x of 5G, y of 2G
        jb, jok = jps.deserialize_te(JJ, bad, compress)
        tb, tok = tps.deserialize_te(TJ, bad, compress, device="cpu")
        _same(jb, tb)
        assert tok.tolist() == np.asarray(jok).tolist() == [True] * 3 + [False, True]


@pytest.mark.parametrize("name", ["ed_on_bls12_381", "ed_on_bls12_381_bandersnatch"])
def test_elligator2_matches_jax(name):
    """8 lanes (the JAX test's shape): u = 0, which lands on y' = 0 (-A/B is
    no square on both curves, so x' = -A - x1 = 0), then 1, 2 and random u;
    words equal the JAX package's, points equal the host model's, every
    image on the curve. (x' = -1 needs (A - 2)/B, the raw d, to be a
    square: never on these complete curves.)"""
    jc = JJ if name == "ed_on_bls12_381" else jtz.TE_CURVES[name]
    tc = TJ if name == "ed_on_bls12_381" else ttz.TE_CURVES[name]
    p, zeta = tc.base.modulus, tc.base.sqrt_qnr
    A, B = tc.mont_coeff_a % p, tc.mont_coeff_b % p
    assert pow(-A * pow(B, -1, p) % p, (p - 1) // 2, p) == p - 1
    assert pow((A - 2) * pow(B, -1, p) % p, (p - 1) // 2, p) == p - 1
    rng = random.Random(0)
    us = [0, 1, 2] + [rng.randrange(p) for _ in range(5)]
    ju = jfp.from_ints(jc.base, us)
    jm = j_elligator2(jc, ju, int(zeta))
    tm = tell.elligator2_map(tc, _t(ju), int(zeta))
    _same(jm, tm)
    assert tc.affine_to_ints(tm) == [host_elligator2(tc, u, zeta) for u in us]
    assert tc.affine_to_ints(tm)[0] == (0, 1)
    assert tte.is_on_curve(tc, tm).all()
    assert tell._te_scale(tc) == j_te_scale(jc)


def test_elligator2_exceptions_and_5mod8_against_host():
    """Z u^2 = -1 (reachable with a square Z: Jubjub with Z = 1, u = sqrt(-1))
    gives the identity; curve25519 (the 5 mod 8 square root) against the
    host model."""
    p = TJ.base.modulus
    i = sqrt_mod(p - 1, p)
    us = [i, p - i, 3]
    got = TJ.affine_to_ints(tell.elligator2_map(TJ, tfp.from_ints(TJ.base, us, device="cpu"), 1))
    assert got == [(0, 1), (0, 1), host_elligator2(TJ, 3, 1)]
    tc = ttz.CURVE25519
    zeta = tc.base.sqrt_qnr
    us = [0, 1, 7, random.Random(5).randrange(tc.base.modulus)]
    tm = tell.elligator2_map(tc, tfp.from_ints(tc.base, us, device="cpu"), zeta)
    assert tc.affine_to_ints(tm) == [host_elligator2(tc, u, zeta) for u in us]
    assert tte.is_on_curve(tc, tm).all()
    with pytest.raises(ValueError):
        tell.elligator2_map(ttz.ED_ON_MNT4_753, tfp.zero(ttz.ED_ON_MNT4_753.base, (1,), "cpu"), 5)
