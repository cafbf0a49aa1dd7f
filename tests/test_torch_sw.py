"""Port parity: zkarray_torch.ec.sw XYZZ ops (add, double, the mixed add
and the affine doubling) against zkarray.ec.sw, bit for bit, on the six edge
classes of tests/test_kernels.py (generic, P == A, P == -A, P at infinity,
A at infinity, both at infinity), plus the Python-int oracle. Batch width 8
is the one tests/test_sw.py compiles. The tree sum (the plain version of the
xyzz_tree_sum kernel) against zkarray.ec.msm._tree_sum_last at an odd width
with edge-class pairs, and against the port's per-level route at others."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import JC, TC, assert_same_points, xyzz_both, xyzz_coords  # noqa: E402
from zkarray.ec import msm as jmsm  # noqa: E402
from zkarray.ec import sw as jsw  # noqa: E402
from zkarray_torch.ec import msm as tmsm  # noqa: E402
from zkarray_torch.ec import sw as tsw  # noqa: E402
from zkarray_torch.interop import affine_from_numpy, limbs_to_numpy  # noqa: E402
from zkarray_torch.kernels import sw as ksw  # noqa: E402
from zkarray_torch.testing import ec_add, ec_mul  # noqa: E402


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
