"""Endomorphism-based subgroup checks for BLS12-381 G1 and G2.

Counterpart of zkarray/ec/fast_checks.py: G1 by phi(P) == -[X^2]P
(eprint 2021/1130 section 6) with the [|X|]P == P early-out, two 64-bit
ladders in place of the generic check's 255-bit one; G2 by psi(P) == [X]P
(section 4), one 64-bit ladder and a Frobenius. Each returns a bool mask
(True = in the subgroup; the identity passes).
"""

from __future__ import annotations

import torch

from zkarray_torch.ec import sw, sw_ext
from zkarray_torch.ec.sw import AffinePoints, JacobianPoints, SWCurveSpec
from zkarray_torch.ff import fp

# cube root of unity beta for phi(x, y) = (beta x, y), and |X| of BLS12-381
BLS12_381_BETA = 793479390729215512621379701633421447060886740281060493010456487427281649075476305620758731620350
BLS12_381_X_ABS = 0xD201000000010000

# psi's constants (reference curves/bls12_381/src/curves/g2.rs:243-258)
_PSI_X_C1 = 4002409555221667392624310435006688643935503118305586438271171395842971157480381377015405980053539358417135540939437
_PSI_Y = (
    2973677408986561043442465346520108879172042883009249989176415018091420807192182638567116318576472649347015917690530,
    1028732146235106349975324479215795277384839936929757896155643118032610843298655225875571310552543014690878354869257,
)


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


def _psi(g2curve, Q: sw_ext.ExtAffine) -> sw_ext.ExtAffine:
    """psi(P): the Frobenius on the coordinates and the twist constants."""
    F2 = g2curve.ops
    fq = F2.spec
    batch, dev = F2.batch_shape_of(Q.x), Q.x.device
    x = F2.frobenius(Q.x, 1)
    y = F2.frobenius(Q.y, 1)
    c1 = fp.const_array(fq, _PSI_X_C1, batch, dev)
    # x' = (-c1 x[1], c1 x[0]): the product by (0, c1) in Fq2
    x_new = torch.stack([fp.neg(fq, fp.mont_mul(fq, c1, x[1])), fp.mont_mul(fq, c1, x[0])])
    y_new = F2.mul(y, F2.const(_PSI_Y, batch, dev))
    return sw_ext.ExtAffine(x_new, y_new, Q.inf)


def _ext_jac_eq(g2curve, P: sw_ext.ExtJacobian, Q: sw_ext.ExtJacobian) -> torch.Tensor:
    F2 = g2curve.ops
    z1z1 = F2.sqr(P.z)
    z2z2 = F2.sqr(Q.z)
    x_eq = F2.eq(F2.mul(P.x, z2z2), F2.mul(Q.x, z1z1))
    y_eq = F2.eq(F2.mul(P.y, F2.mul(z2z2, Q.z)), F2.mul(Q.y, F2.mul(z1z1, P.z)))
    i1, i2 = F2.is_zero(P.z), F2.is_zero(Q.z)
    return torch.where(i1 | i2, i1 == i2, x_eq & y_eq)


def bls12_381_g2_subgroup_check(g2curve, Q: sw_ext.ExtAffine) -> torch.Tensor:
    """psi(P) == [X]P, X negative: compared against -[|X|]P. ``g2curve``
    must be bls12_381.G2."""
    P = sw_ext.from_affine(g2curve, Q)
    xP = sw_ext.neg(g2curve, sw_ext.scalar_mul_const(g2curve, P, BLS12_381_X_ABS))
    psiQ = sw_ext.from_affine(g2curve, _psi(g2curve, Q))
    return _ext_jac_eq(g2curve, xP, psiQ) | Q.inf
