"""Host oracles and known-answer inputs for the port's tests and chip_smoke.py.

The port's own copies of tests/ec_oracle.py (textbook affine arithmetic on
Python ints) and of bench.py's tiled MSM inputs with their O(1)-host-work
known answer.
"""

from __future__ import annotations

import numpy as np

from zkarray_torch.ec.sw import SWCurveSpec, affine_from_ints


def ec_neg(p, mod):
    return None if p is None else (p[0], (-p[1]) % mod)


def ec_add(p, q, a, mod):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2 and (y1 + y2) % mod == 0:
        return None
    if p == q:
        lam = (3 * x1 * x1 + a) * pow(2 * y1, -1, mod) % mod
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, mod) % mod
    x3 = (lam * lam - x1 - x2) % mod
    y3 = (lam * (x1 - x3) - y1) % mod
    return (x3, y3)


def ec_mul(p, k, a, mod):
    if k < 0:
        return ec_mul(ec_neg(p, mod), -k, a, mod)
    acc = None
    for bit in bin(k)[2:] if k else "":
        acc = ec_add(acc, acc, a, mod)
        if bit == "1":
            acc = ec_add(acc, p, a, mod)
    return acc


def ec_msm_oracle(pts, scalars, a, mod):
    """Σ k_i·P_i as an affine int pair (or None for the identity)."""
    acc = None
    for p, k in zip(pts, scalars):
        acc = ec_add(acc, ec_mul(p, k, a, mod), a, mod)
    return acc


def tiled_inputs(curve: SWCurveSpec, n: int, rng: np.random.Generator, base_n: int = 64):
    """A valid point batch that tiles ``base_n`` multiples k_j·G, with random
    scalars below 2^(16 Ls - 2). Returns (px, py, scalars, ks, bits): uint32
    limb arrays (L, n), (L, n), (Ls, n), the multipliers and the scalar
    bound. Same draws as bench.py:_tiled_inputs for the same generator."""
    gen = (curve.gen_x, curve.gen_y)
    ks = [int(k) for k in rng.integers(1, 1 << 30, size=base_n)]
    base_pts = [ec_mul(gen, k, curve.a_int, curve.base.modulus) for k in ks]
    A0 = affine_from_ints(curve, base_pts, device="cpu")
    reps = n // base_n
    px = np.tile(A0.x.numpy().astype(np.uint32), (1, reps))
    py = np.tile(A0.y.numpy().astype(np.uint32), (1, reps))
    Ls = curve.scalar.num_limbs
    sc = rng.integers(0, 1 << 16, size=(Ls, n), dtype=np.uint32)
    sc[-1] >>= 2
    return px, py, sc, ks, 16 * Ls - 2


def expected_msm(curve: SWCurveSpec, ks, sc: np.ndarray):
    """Host known answer for ``tiled_inputs``: with P_i = k_(i mod base_n)·G,
    Σ s_i·P_i = (Σ_j k_j·(Σ_(i ≡ j) s_i) mod r)·G, one host scalar-mul."""
    r = curve.scalar.modulus
    base_n = len(ks)
    Ls = sc.shape[0]
    total = 0
    for j in range(base_n):
        limb_sums = sc[:, j::base_n].astype(np.uint64).sum(axis=1)  # exact below 2^64
        agg = sum(int(limb_sums[l]) << (16 * l) for l in range(Ls)) % r
        total = (total + ks[j] * agg) % r
    return ec_mul((curve.gen_x, curve.gen_y), total, curve.a_int, curve.base.modulus)
