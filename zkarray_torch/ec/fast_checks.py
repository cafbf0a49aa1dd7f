"""Endomorphism-based subgroup check for BLS12-381 G1.

Counterpart of zkarray/ec/fast_checks.py's G1 part: phi(P) == -[X^2]P
(eprint 2021/1130 section 6) with the [|X|]P == P early-out, two 64-bit
ladders in place of the generic check's 255-bit one. The G2 check (psi)
waits for the towers. Returns a bool mask (True = in the subgroup; the
identity passes).
"""

from __future__ import annotations

import torch

from zkarray_torch.ec import sw
from zkarray_torch.ec.sw import AffinePoints, JacobianPoints, SWCurveSpec
from zkarray_torch.ff import fp

# cube root of unity beta for phi(x, y) = (beta x, y), and |X| of BLS12-381
BLS12_381_BETA = 793479390729215512621379701633421447060886740281060493010456487427281649075476305620758731620350
BLS12_381_X_ABS = 0xD201000000010000


def _jac_eq(curve: SWCurveSpec, P: JacobianPoints, Q: JacobianPoints) -> torch.Tensor:
    """Batched projective equality: cross-multiplied Jacobian compare."""
    f = curve.base
    z1z1 = fp.mont_sqr(f, P.z)
    z2z2 = fp.mont_sqr(f, Q.z)
    x_eq = fp.eq(fp.mont_mul(f, P.x, z2z2), fp.mont_mul(f, Q.x, z1z1))
    y_eq = fp.eq(fp.mont_mul(f, P.y, fp.mont_mul(f, z2z2, Q.z)),
                 fp.mont_mul(f, Q.y, fp.mont_mul(f, z1z1, P.z)))
    i1, i2 = sw.jac_is_inf(P), sw.jac_is_inf(Q)
    return torch.where(i1 | i2, i1 == i2, x_eq & y_eq)


def bls12_381_g1_subgroup_check(curve: SWCurveSpec, A: AffinePoints) -> torch.Tensor:
    """phi(P) == -[X^2]P. ``curve`` must be bls12_381.G1."""
    f = curve.base
    P = sw.from_affine(curve, A)
    xP = sw.scalar_mul_const(curve, P, BLS12_381_X_ABS)
    bad_fixed = _jac_eq(curve, xP, P) & ~A.inf  # [|X|]P == P for P != inf: not in it
    neg_x2P = sw.jac_neg(curve, sw.scalar_mul_const(curve, xP, BLS12_381_X_ABS))
    beta = fp.const_array(f, BLS12_381_BETA, A.x.shape[1:], A.x.device)
    endo = sw.from_affine(curve, AffinePoints(fp.mont_mul(f, beta, A.x), A.y, A.inf))
    return (_jac_eq(curve, neg_x2P, endo) & ~bad_fixed) | A.inf
