"""Port parity: zkarray_torch.ec.sw XYZZ ops (add, double, the mixed add
and the affine doubling) against zkarray.ec.sw, bit for bit, on the six edge
classes of tests/test_kernels.py (generic, P == A, P == -A, P at infinity,
A at infinity, both at infinity), plus the Python-int oracle. Batch width 8
is the one tests/test_sw.py compiles. The tree sum (the plain version of the
xyzz_tree_sum kernel) against zkarray.ec.msm._tree_sum_last at an odd width
with edge-class pairs, and against the port's per-level route at others.

The Jacobian group law (double, add, mixed add, negation, to-affine) on the
edge classes with other Z representatives than 1, against the JAX package's
words at width 8 on BN254 and BLS12-381 G1 (a = 0, dbl-2009-l) and on the
JAX package's secp256r1 constants (a = -3, dbl-2007-bl); scalar_mul against
its words on tests/test_sw.py's four BN254 points; scalar_mul_const, the
cofactor, curve and subgroup checks and the fast BLS12-381 G1 check against
the oracle and the JAX package's masks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import (JC, TC, assert_same_points, port_field, xyzz_both,  # noqa: E402
                          xyzz_coords)
from zkarray.curves import bn254 as jbn254  # noqa: E402
from zkarray.curves import zoo as jzoo  # noqa: E402
from zkarray.ec import fast_checks as jfast  # noqa: E402
from zkarray.ec import msm as jmsm  # noqa: E402
from zkarray.ec import sw as jsw  # noqa: E402
from zkarray.ff import fp as jfp  # noqa: E402
from zkarray_torch.curves import bls12_377 as tbls377  # noqa: E402
from zkarray_torch.curves import bn254 as tbn254  # noqa: E402
from zkarray_torch.ec import fast_checks as tfast  # noqa: E402
from zkarray_torch.ec import msm as tmsm  # noqa: E402
from zkarray_torch.ec import sw as tsw  # noqa: E402
from zkarray_torch.interop import affine_from_numpy, limbs_from_numpy, limbs_to_numpy  # noqa: E402
from zkarray_torch.kernels import sw as ksw  # noqa: E402
from zkarray_torch.testing import (ec_add, ec_mul, ec_neg, jac_edge_pairs,  # noqa: E402
                                   jacobian_coords, off_subgroup_points)


def edge_pairs(n=8, seed=11):
    mod = JC.base.modulus
    gen = (JC.gen_x, JC.gen_y)
    rng = np.random.default_rng(seed)
    ps, qs = [], []
    for i in range(n):
        k1, k2 = (int(k) for k in rng.integers(1, 1 << 20, size=2))
        P = ec_mul(gen, k1, 0, mod)
        cls = i % 6
        if cls == 0:
            Q = ec_mul(gen, k2, 0, mod)  # generic
        elif cls == 1:
            Q = P  # doubling
        elif cls == 2:
            Q = (P[0], (-P[1]) % mod)  # cancellation
        elif cls == 3:
            P, Q = None, ec_mul(gen, k2, 0, mod)  # P at infinity
        elif cls == 4:
            Q = None  # A at infinity
        else:
            P, Q = None, None
        ps.append(P)
        qs.append(Q)
    return ps, qs


def port_affine(jA):
    return affine_from_numpy(np.asarray(jA.x), np.asarray(jA.y), np.asarray(jA.inf), "cpu")


def test_xyzz_ops_match_jax_and_oracle():
    mod = JC.base.modulus
    ps, qs = edge_pairs()
    jA1, jA2 = JC.affine_from_ints(ps), JC.affine_from_ints(qs)
    tA1, tA2 = port_affine(jA1), port_affine(jA2)
    jP, jQ = jsw.xyzz_from_affine(JC, jA1), jsw.xyzz_from_affine(JC, jA2)
    tP, tQ = tsw.xyzz_from_affine(TC, tA1), tsw.xyzz_from_affine(TC, tA2)
    assert_same_points(jP, tP)

    jS, tS = jsw.xyzz_add(JC, jP, jQ), tsw.xyzz_add(TC, tP, tQ)
    assert_same_points(jS, tS)
    jD, tD = jsw.xyzz_double(JC, jP), tsw.xyzz_double(TC, tP)
    assert_same_points(jD, tD)

    jaff, taff = jsw.xyzz_to_affine(JC, jS), tsw.xyzz_to_affine(TC, tS)
    assert np.array_equal(np.asarray(jaff.x), limbs_to_numpy(taff.x))
    assert np.array_equal(np.asarray(jaff.y), limbs_to_numpy(taff.y))
    assert np.array_equal(np.asarray(jaff.inf), taff.inf.numpy())
    assert tsw.affine_to_ints(TC, taff) == [ec_add(p, q, 0, mod) for p, q in zip(ps, qs)]
    assert tsw.affine_to_ints(TC, tsw.xyzz_to_affine(TC, tD)) == [
        ec_add(p, p, 0, mod) for p in ps
    ]


def test_xyzz_add_affine_matches_jax_and_oracle():
    """The mixed add (plain version of the xyzz_add_affine kernel on the CPU)
    against the JAX package's XLA path at width 8, then the six edge classes
    of tests/test_kernels.py at n = 64 and the doubling against the oracle."""
    mod = JC.base.modulus
    ps, qs = edge_pairs()
    jA1, jA2 = JC.affine_from_ints(ps), JC.affine_from_ints(qs)
    tA1, tA2 = port_affine(jA1), port_affine(jA2)
    tP = tsw.xyzz_from_affine(TC, tA1)
    got = tsw.xyzz_add_affine(TC, tP, tA2)
    assert isinstance(got, tsw.XYZZPoints)
    assert_same_points(jsw.xyzz_add_affine(JC, jsw.xyzz_from_affine(JC, jA1), jA2), got)
    plain = ksw.xyzz_add_affine_plain(TC, tP, tA2.x, tA2.y, tA2.inf)
    assert all(torch.equal(a, b) for a, b in zip(plain, got))

    ps, qs = edge_pairs(n=64, seed=12)
    tA1 = tsw.affine_from_ints(TC, ps, device="cpu")
    tA2 = tsw.affine_from_ints(TC, qs, device="cpu")
    got = tsw.xyzz_add_affine(TC, tsw.xyzz_from_affine(TC, tA1), tA2)
    assert tsw.affine_to_ints(TC, tsw.xyzz_to_affine(TC, got)) == [
        ec_add(p, q, 0, mod) for p, q in zip(ps, qs)]
    dbl = tsw.xyzz_double_affine(TC, tA1)
    assert tsw.affine_to_ints(TC, tsw.xyzz_to_affine(TC, dbl)) == [ec_add(p, p, 0, mod) for p in ps]


def test_xyzz_add_and_double_on_tree_halves_match_jax():
    """ec/sw.py:xyzz_add and xyzz_double (on the CPU, the plain versions of the
    xyzz_add and xyzz_double kernels) against the JAX package at width 8. The
    port's P and Q are the last-axis halves of one (L, 16) tensor, as the
    MSM's tree sums hand them over; Q is another XYZZ representative than P
    (random ZZ = lam^2), so P == Q and P == -Q take the doubling and cancel
    branches on words that differ. Lane 6's P has y = 0 (not a curve point;
    the formulas do not need one), so the doubling also takes its y = 0 edge."""
    mod = JC.base.modulus
    rng = np.random.default_rng(13)
    ps, qs = edge_pairs(seed=13)
    ps[6] = (ps[6][0], 0)
    lams = [int.from_bytes(rng.bytes(48), "little") % (mod - 1) + 1 for _ in range(16)]
    coords = [xyzz_coords(pt, lam, mod) for pt, lam in zip(ps + qs, lams)]
    jW, tW = xyzz_both(coords, (16,))
    jP, jQ = (type(jW)(*(v[:, lo : lo + 8] for v in jW)) for lo in (0, 8))
    tP, tQ = (type(tW)(*(v[:, lo : lo + 8] for v in tW)) for lo in (0, 8))
    assert not tQ.x.is_contiguous()
    tS = tsw.xyzz_add(TC, tP, tQ)
    assert_same_points(jsw.xyzz_add(JC, jP, jQ), tS)
    assert_same_points(jsw.xyzz_double(JC, jP), tsw.xyzz_double(TC, tP))
    got = tsw.affine_to_ints(TC, tsw.xyzz_to_affine(TC, tS))
    assert [g for i, g in enumerate(got) if i != 6] == [
        ec_add(p, q, 0, mod) for i, (p, q) in enumerate(zip(ps, qs)) if i != 6]


def test_xyzz_zero_and_affine_round_trip():
    ps, _ = edge_pairs()
    tA = tsw.affine_from_ints(TC, ps, device="cpu")
    assert tsw.affine_to_ints(TC, tA) == ps
    assert_same_points(jsw.xyzz_zero(JC, (3, 2)), tsw.xyzz_zero(TC, (3, 2), "cpu"))
    assert bool(tsw.xyzz_is_inf(tsw.xyzz_zero(TC, (4,), "cpu")).all())


def tree_rows(m, seed):
    """(2, m) XYZZ points, random representatives (ZZ = lam^2). Row 0 pairs
    element i with i + m // 2 (the first level's pairs) as P == Q, P == -Q,
    P at infinity, Q at infinity, both at infinity, then generic; row 1 is
    generic but for a P == Q pair with y = 0 (not a curve point; the formulas
    do not need one) and a point at infinity carried by an odd width."""
    mod = JC.base.modulus
    rng = np.random.default_rng(seed)
    gen = (JC.gen_x, JC.gen_y)
    rows = [[ec_mul(gen, int(k), 0, mod) for k in rng.integers(1, 1 << 20, size=m)] for _ in range(2)]
    h = m // 2
    edges = [lambda p: p, lambda p: (p[0], (-p[1]) % mod), None, "q_inf", "both"]
    for i, e in enumerate(edges[:h]):
        p = rows[0][i]
        if e is None:
            rows[0][i] = None
        elif e == "q_inf":
            rows[0][i + h] = None
        elif e == "both":
            rows[0][i] = rows[0][i + h] = None
        else:
            rows[0][i + h] = e(p)
    if h:
        rows[1][0] = (rows[1][0][0], 0)
        rows[1][h] = rows[1][0]
    if m % 2:
        rows[1][m - 1] = None
    lams = rng.integers(1, 1 << 62, size=2 * m)
    coords = [xyzz_coords(pt, int(lam), mod) for pt, lam in zip(rows[0] + rows[1], lams)]
    return xyzz_both(coords, (2, m))


def test_xyzz_tree_sum_plain_matches_jax_tree_sum():
    """m = 13: levels of 13, 7, 4 and 2 points, two of them odd."""
    jP, tP = tree_rows(13, seed=31)
    got = ksw.xyzz_tree_sum_plain(TC, tP)
    assert got[0].shape == (TC.base.num_limbs, 2, 1)
    assert_same_points(jmsm._tree_sum_last(JC, jP), got)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 16])
def test_xyzz_tree_sum_plain_matches_per_level_route(m, monkeypatch):
    """Against ec/msm.py:_tree_sum_last with every level an element-wise
    xyzz_add (TREE_SUM_MAX = 1), the route the JAX comparison pins."""
    _, tP = tree_rows(m, seed=40 + m)
    monkeypatch.setattr(ksw, "TREE_SUM_MAX", 1)
    want = tmsm._tree_sum_last(TC, tP)
    assert all(torch.equal(a, b) for a, b in zip(ksw.xyzz_tree_sum_plain(TC, tP), want))


# ---------------------------------------------------------------------------
# Jacobian coordinates and scalar multiplication
# ---------------------------------------------------------------------------

JR = jzoo.SECP256R1  # a = -3: the general-a doubling
TR = tsw.SWCurveSpec("secp256r1", port_field(JR.base), port_field(JR.scalar), JR.a_int, JR.b_int,
                     JR.gen_x, JR.gen_y, JR.cofactor)
JAC_CURVES = {"bn254": (jbn254.G1, tbn254.G1), "bls12_381": (JC, TC), "secp256r1": (JR, TR)}


def jac_both(jcurve, coords):
    """[(X, Y, Z) canonical ints] -> the same points as JAX and port CPU
    JacobianPoints (Montgomery form)."""
    js = [jfp.from_ints(jcurve.base, [c[k] for c in coords]) for k in range(3)]
    ts = [limbs_from_numpy(np.asarray(j), "cpu") for j in js]
    return jsw.JacobianPoints(*js), tsw.JacobianPoints(*ts)


def jac_pairs(jcurve, tcurve, seed):
    """Eight edge-class pairs (generic, P == Q, P == -Q, P = inf, Q = inf,
    both inf, generic, P == Q): JAX and port P and Q with random Z, the
    affine Q, and the affine ints."""
    mod = tcurve.base.modulus
    rng = np.random.default_rng(seed)
    ps, qs = jac_edge_pairs(tcurve, 8, rng)
    lams = [int.from_bytes(rng.bytes(48), "little") % (mod - 1) + 1 for _ in range(16)]
    jP, tP = jac_both(jcurve, [jacobian_coords(p, lam, mod) for p, lam in zip(ps, lams)])
    jQ, tQ = jac_both(jcurve, [jacobian_coords(q, lam, mod) for q, lam in zip(qs, lams[8:])])
    jA = jcurve.affine_from_ints(qs)
    return ps, qs, jP, tP, jQ, tQ, jA, port_affine(jA)


@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
def test_jacobian_ops_match_jax_and_oracle(name):
    """a = 0: jac_add, jac_add_mixed, jac_double and to_affine against the
    JAX package's words at width 8 (tests/test_sw.py compiles them there),
    jac_neg and the sums against the oracle."""
    jcurve, tcurve = JAC_CURVES[name]
    mod = tcurve.base.modulus
    ps, qs, jP, tP, jQ, tQ, jA, tA = jac_pairs(jcurve, tcurve, 21)
    tS = tsw.jac_add(tcurve, tP, tQ)
    assert_same_points(jsw.jac_add(jcurve, jP, jQ), tS)
    tM = tsw.jac_add_mixed(tcurve, tP, tA)
    assert_same_points(jsw.jac_add_mixed(jcurve, jP, jA), tM)
    tD = tsw.jac_double(tcurve, tP)
    assert_same_points(jsw.jac_double(jcurve, jP), tD)
    taff = tsw.to_affine(tcurve, tS)
    jaff = jsw.to_affine(jcurve, jsw.jac_add(jcurve, jP, jQ))
    assert_same_points(jaff[:2], taff[:2])
    assert np.array_equal(np.asarray(jaff.inf), taff.inf.numpy())
    want = [ec_add(p, q, 0, mod) for p, q in zip(ps, qs)]
    assert tsw.affine_to_ints(tcurve, taff) == want
    assert tsw.affine_to_ints(tcurve, tsw.to_affine(tcurve, tM)) == want
    assert tsw.affine_to_ints(tcurve, tsw.to_affine(tcurve, tD)) == [ec_add(p, p, 0, mod) for p in ps]
    tN = tsw.jac_neg(tcurve, tP)
    assert tsw.affine_to_ints(tcurve, tsw.to_affine(tcurve, tN)) == [ec_neg(p, mod) for p in ps]
    assert tsw.jac_is_inf(tS).tolist() == [w is None for w in want]


def test_jacobian_ops_general_a_match_jax():
    """a = -3 (secp256r1, rebuilt from the JAX package's zoo constants):
    jac_add and jac_add_mixed against the JAX package's words, jac_double
    against the doubling jac_add selects on its P == Q lanes (1 and 7), and
    every result against the oracle."""
    a, mod = TR.a_int, TR.base.modulus
    ps, qs, jP, tP, jQ, tQ, jA, tA = jac_pairs(JR, TR, 22)
    jS, tS = jsw.jac_add(JR, jP, jQ), tsw.jac_add(TR, tP, tQ)
    assert_same_points(jS, tS)
    tM = tsw.jac_add_mixed(TR, tP, tA)
    assert_same_points(jsw.jac_add_mixed(JR, jP, jA), tM)
    tD = tsw.jac_double(TR, tP)
    for j, t in zip(jS, tD):
        assert np.array_equal(np.asarray(j)[:, [1, 7]], limbs_to_numpy(t)[:, [1, 7]])
    want = [ec_add(p, q, a, mod) for p, q in zip(ps, qs)]
    assert tsw.affine_to_ints(TR, tsw.to_affine(TR, tS)) == want
    assert tsw.affine_to_ints(TR, tsw.to_affine(TR, tM)) == want
    assert tsw.affine_to_ints(TR, tsw.to_affine(TR, tD)) == [ec_add(p, p, a, mod) for p in ps]
    tG = TR.generator((2,), "cpu")
    assert tsw.is_on_curve(TR, tG).tolist() == [True, True]


def test_scalar_mul_matches_jax_and_oracle():
    """tests/test_sw.py:test_scalar_mul's four BN254 points and scalars (0,
    1, random, r - 1): the same Jacobian words as the JAX package."""
    import random

    jcurve, tcurve = JAC_CURVES["bn254"]
    mod = tcurve.base.modulus
    rng = random.Random(3)
    scalars = [0, 1, rng.randrange(tcurve.scalar.modulus), tcurve.scalar.modulus - 1]
    pts = [ec_mul((tcurve.gen_x, tcurve.gen_y), k, 0, mod) for k in (1, 2, 3, 5)]
    jA = jcurve.affine_from_ints(pts)
    js = jfp.from_ints(jcurve.scalar, scalars, mont=False)
    tJ = tsw.scalar_mul(tcurve, port_affine(jA), limbs_from_numpy(np.asarray(js), "cpu"))
    assert_same_points(jsw.scalar_mul(jcurve, jA, js), tJ)
    assert tsw.affine_to_ints(tcurve, tsw.to_affine(tcurve, tJ)) == [
        ec_mul(p, k, 0, mod) for p, k in zip(pts, scalars)]


def test_scalar_mul_const_signs_and_zero():
    """k = 0 gives the JAX package's infinity words (1, 1, 0); k < 0 the
    negation of |k| P; both against the oracle."""
    tcurve = tbn254.G1
    mod = tcurve.base.modulus
    pts = [ec_mul((tcurve.gen_x, tcurve.gen_y), k, 0, mod) for k in (7, 11)] + [None]
    P = tsw.from_affine(tcurve, tsw.affine_from_ints(tcurve, pts, "cpu"))
    assert_same_points(jsw.jac_zero(jbn254.G1, (3,)), tsw.scalar_mul_const(tcurve, P, 0))
    neg = tsw.scalar_mul_const(tcurve, P, -13)
    assert_same_points(tsw.jac_neg(tcurve, tsw.scalar_mul_const(tcurve, P, 13)), neg)
    assert tsw.affine_to_ints(tcurve, tsw.to_affine(tcurve, neg)) == [
        ec_mul(p, -13, 0, mod) if p else None for p in pts]


def test_clear_cofactor_curve_and_subgroup_checks():
    """BLS12-377 G1: two points outside the subgroup (never multiplied by the
    cofactor), a subgroup point and infinity; is_on_curve (and a point off
    the curve); clear_cofactor against the oracle; the generic
    subgroup_check on the raw and the cleared points."""
    tcurve = tbls377.G1
    mod, h = tcurve.base.modulus, tcurve.cofactor
    rng = np.random.default_rng(23)
    off = off_subgroup_points(tcurve, 2, rng)
    sub = ec_mul((tcurve.gen_x, tcurve.gen_y), int(rng.integers(1, 1 << 62)), 0, mod)
    A = tsw.affine_from_ints(tcurve, off + [sub, None, (sub[0], sub[1] + 1)], "cpu")
    assert tsw.is_on_curve(tcurve, A).tolist() == [True, True, True, True, False]
    cleared = tsw.to_affine(tcurve, tsw.clear_cofactor(tcurve, A))
    assert tsw.affine_to_ints(tcurve, cleared)[:4] == [
        ec_mul(p, h, 0, mod) if p else None for p in off + [sub, None]]
    both_ = tsw.AffinePoints(*(torch.cat([u[..., :4], v[..., :2]], dim=-1)
                               for u, v in zip(A, cleared)))
    assert tsw.subgroup_check(tcurve, both_).tolist() == [False, False, True, True, True, True]


def test_fast_g1_subgroup_check_matches_jax():
    """phi(P) == -[X^2]P on tests/test_fast_checks.py's inputs (G, 2G,
    infinity; a curve point outside the subgroup): the JAX package's masks."""
    mod = JC.base.modulus
    g = (JC.gen_x, JC.gen_y)
    x = 3
    while True:
        y = pow((x ** 3 + 4) % mod, (mod + 1) // 4, mod)
        if y * y % mod == (x ** 3 + 4) % mod:
            break
        x += 1
    good = [g, ec_add(g, g, 0, mod), None]
    jgood, jbad = JC.affine_from_ints(good), JC.affine_from_ints([(x, y)])
    tA = tsw.affine_from_ints(TC, good + [(x, y)], "cpu")
    got = tfast.bls12_381_g1_subgroup_check(TC, tA)
    assert got.tolist() == [True, True, True, False]
    want = np.concatenate([np.asarray(jfast.bls12_381_g1_subgroup_check(JC, jgood)),
                           np.asarray(jfast.bls12_381_g1_subgroup_check(JC, jbad))])
    assert np.array_equal(want, got.numpy())
