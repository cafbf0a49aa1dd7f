"""Wahby–Boneh map for BLS12-381 G2: SWU on the 3-isogenous curve E2'/Fq2,
the rational isogeny map, and the psi-based cofactor clearing
[h(psi)] P = [x^2 - x - 1] P + [x - 1] psi(P) + psi^2(2P) (eprint 2017/419
§4.1), x the negative BLS parameter.

Counterpart of zkarray/ec/h2c/wb_g2.py, the same schedule: two Fq2 ladders
of ec/sw_ext.py:scalar_mul_const by BLS_X, then four adds.
``map_to_g2_pairs`` runs the steps after hash_to_field over many messages
at once.
"""

from __future__ import annotations

import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.curves import bls12_381 as b381
from zkarray_torch.ec import sw_ext as swe
from zkarray_torch.ec.h2c import _bls12_381_g2_iso as iso
from zkarray_torch.ec.h2c.swu_ext import swu_map_ext
from zkarray_torch.ec.sw_ext import ExtAffine, ExtJacobian
from zkarray_torch.ff.hash_to_field import hash_to_field_ints


def _eval_poly2(F2, coeffs, x):
    """Horner evaluation of a constant-Fq2-coefficient polynomial at batched x."""
    dev = x.device
    acc = F2.const(coeffs[-1], F2.batch_shape_of(x), dev)
    for c in reversed(coeffs[:-1]):
        acc = F2.add(F2.mul(acc, x), F2.const(c, (), dev))
    return acc


def _isogeny_map_g2(px, py):
    """E2'(x, y) -> E2(x', y') through the 3-isogeny's rational maps."""
    F2 = b381.FQ2
    xn = _eval_poly2(F2, iso.X_MAP_NUMERATOR, px)
    xd = _eval_poly2(F2, iso.X_MAP_DENOMINATOR, px)
    yn = _eval_poly2(F2, iso.Y_MAP_NUMERATOR, px)
    yd = _eval_poly2(F2, iso.Y_MAP_DENOMINATOR, px)
    inv = F2.inv(F2.mul(xd, yd))
    x = F2.mul(F2.mul(xn, inv), yd)
    y = F2.mul(py, F2.mul(F2.mul(yn, inv), xd))
    return x, y


def bls12_381_g2_wb_map(u: torch.Tensor) -> ExtAffine:
    """WB map: SWU on E2', then the isogeny to E2 (no cofactor clearing)."""
    x, y = swu_map_ext(b381.FQ2, u, iso.ISO_A, iso.ISO_B, iso.ZETA, iso.NEG_B_OVER_A,
                       iso.B_OVER_ZA)
    x, y = _isogeny_map_g2(x, y)
    batch = b381.FQ2.batch_shape_of(u)
    return ExtAffine(x, y, torch.zeros(batch, dtype=torch.bool, device=u.device))


def _psi(A: ExtAffine) -> ExtJacobian:
    """psi(x, y) = (PSI_X conj(x), PSI_Y conj(y))."""
    F2 = b381.FQ2
    dev = A.x.device
    x = F2.mul(F2.const(iso.PSI_X, (), dev), F2.conjugate(A.x))
    y = F2.mul(F2.const(iso.PSI_Y, (), dev), F2.conjugate(A.y))
    return swe.from_affine(b381.G2, ExtAffine(x, y, A.inf))


def _psi2(P: ExtJacobian) -> ExtJacobian:
    """psi^2(X, Y, Z) = (PSI2_X X, -Y, Z): PSI2_X scales the affine x, so it
    applies to Jacobian coordinates directly."""
    F2 = b381.FQ2
    return ExtJacobian(F2.mul(F2.const(iso.PSI2_X, (), P.x.device), P.x), F2.neg(P.y), P.z)


def _neg(P: ExtJacobian) -> ExtJacobian:
    return ExtJacobian(P.x, b381.FQ2.neg(P.y), P.z)


def clear_cofactor_g2(A: ExtAffine) -> ExtJacobian:
    """[h(psi)] P in the JAX package's order (zkarray/ec/h2c/wb_g2.py:73-87)."""
    curve = b381.G2
    Pj = swe.from_affine(curve, A)
    x_p = swe.scalar_mul_const(curve, Pj, iso.BLS_X)  # [x] P
    psi_p = _psi(A)
    psi2_p2 = _psi2(swe.double(curve, Pj))
    tmp = swe.add(curve, x_p, psi_p)  # [x] P + psi(P)
    tmp2 = swe.scalar_mul_const(curve, tmp, iso.BLS_X)  # [x^2] P + [x] psi(P)
    res = swe.add(curve, psi2_p2, tmp2)
    res = swe.add(curve, res, _neg(x_p))
    res = swe.add(curve, res, _neg(psi_p))
    return swe.add(curve, res, _neg(Pj))


def map_to_g2_pairs(u: torch.Tensor) -> ExtAffine:
    """u (2, L, 2n): the n messages' first elements, then their second ->
    to_affine(clear_cofactor_g2(to_affine(map(u0) + map(u1)))) for each
    message, as hash_to_curve_bls12_381_g2 composes them (n = 1 there)."""
    G2 = b381.G2
    n = u.shape[-1] // 2
    pts = bls12_381_g2_wb_map(u)
    p0 = ExtAffine(pts.x[..., :n], pts.y[..., :n], pts.inf[:n])
    p1 = ExtAffine(pts.x[..., n:], pts.y[..., n:], pts.inf[n:])
    q = swe.add(G2, swe.from_affine(G2, p0), swe.from_affine(G2, p1))
    return swe.to_affine(G2, clear_cofactor_g2(swe.to_affine(G2, q)))


def hash_to_curve_bls12_381_g2(msg: bytes, dst: bytes, device=DEFAULT_DEVICE) -> ExtAffine:
    """The RFC 9380 suite BLS12381G2_XMD:SHA-256_SSWU_RO_, one message."""
    u0, u1 = hash_to_field_ints(b381.FQ, msg, dst, 2, ext_degree=2)
    return map_to_g2_pairs(b381.FQ2.from_ints([[u0[0], u1[0]], [u0[1], u1[1]]], device))
