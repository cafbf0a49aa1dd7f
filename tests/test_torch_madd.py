"""The mixed add xyzz_add_affine on moduli with their top bit set
(secp256r1, a = -3; secp256k1, a = 0), where csrc/madd.cu runs its
PlainCallOps instantiation: the kernel's plain version (the CPU route of
ec/sw.py:xyzz_add_affine) against the JAX package's
zkarray/ec/sw.py:xyzz_add_affine on secp256r1, bit for bit, and both curves
against the Python-int oracle, on the edge classes (generic, P == A,
P == -A, P at infinity, A at infinity, both at infinity) at width 8."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from zkarray.curves import zoo as jzoo  # noqa: E402
from zkarray.ec import sw as jsw  # noqa: E402
from zkarray_torch.curves import zoo as tzoo  # noqa: E402
from zkarray_torch.ec import sw as tsw  # noqa: E402
from zkarray_torch.interop import limbs_to_numpy  # noqa: E402
from zkarray_torch.kernels import sw as ksw  # noqa: E402
from zkarray_torch.testing import ec_add, ec_mul  # noqa: E402


def _edge_pairs(curve, n=8, seed=15):
    a, mod = curve.a_int, curve.base.modulus
    gen = (curve.gen_x, curve.gen_y)
    rng = np.random.default_rng(seed)
    ps, qs = [], []
    for i in range(n):
        k1, k2 = (int(k) for k in rng.integers(1, 1 << 20, size=2))
        P, Q = ec_mul(gen, k1, a, mod), ec_mul(gen, k2, a, mod)
        cls = i % 6
        if cls == 1:
            Q = P
        elif cls == 2:
            Q = (P[0], (-P[1]) % mod)
        elif cls == 3:
            P = None
        elif cls == 4:
            Q = None
        elif cls == 5:
            P = Q = None
        ps.append(P)
        qs.append(Q)
    return ps, qs


@pytest.mark.parametrize("name", ["SECP256R1", "SECP256K1"])
def test_xyzz_add_affine_top_bit_moduli(name):
    tc = getattr(tzoo, name)
    mod = tc.base.modulus
    assert mod >> (16 * tc.base.num_limbs - 1) == 1  # p >= R/2: the PlainCallOps route
    ps, qs = _edge_pairs(tc)
    tA1 = tsw.affine_from_ints(tc, ps, device="cpu")
    tA2 = tsw.affine_from_ints(tc, qs, device="cpu")
    tP = tsw.xyzz_from_affine(tc, tA1)
    got = tsw.xyzz_add_affine(tc, tP, tA2)
    plain = ksw.xyzz_add_affine_plain(tc, tP, tA2.x, tA2.y, tA2.inf)
    assert all(torch.equal(g, w) for g, w in zip(got, plain))
    assert tsw.affine_to_ints(tc, tsw.xyzz_to_affine(tc, got)) == [
        ec_add(p, q, tc.a_int, mod) for p, q in zip(ps, qs)]
    if name == "SECP256R1":
        jc = jzoo.SECP256R1
        jA1, jA2 = jc.affine_from_ints(ps), jc.affine_from_ints(qs)
        want = jsw.xyzz_add_affine(jc, jsw.xyzz_from_affine(jc, jA1), jA2)
        assert all(np.array_equal(np.asarray(w), limbs_to_numpy(g)) for w, g in zip(want, got))
        assert np.array_equal(np.asarray(jA2.x), limbs_to_numpy(tA2.x))
