"""Wahby–Boneh map for BLS12-381 G1: SWU on the 11-isogenous curve E', the
rational isogeny map, and the RFC 9380 pipeline hash_to_field -> map twice
-> add -> clear the cofactor with h_eff = 0xd201000000010001.

Counterpart of zkarray/ec/h2c/wb.py. The isogeny's four polynomials are
Horner chains of one mont_mul and one fp_add a coefficient (degrees 11 to
15); the group steps run on ec/sw.py's Jacobian formulas.
``map_to_g1_pairs`` runs the steps after hash_to_field over many messages
at once.
"""

from __future__ import annotations

import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.curves import bls12_381 as b381
from zkarray_torch.ec import sw
from zkarray_torch.ec.h2c import _bls12_381_g1_iso as iso
from zkarray_torch.ec.h2c.swu import swu_map
from zkarray_torch.ec.sw import AffinePoints, SWCurveSpec
from zkarray_torch.ff import fp
from zkarray_torch.ff.hash_to_field import hash_to_field

H_EFF_G1 = 0xD201000000010001

# the isogenous curve E' (its generator is never used)
ISO_CURVE = SWCurveSpec(name="bls12_381.G1_iso", base=b381.FQ, scalar=b381.FR, a=iso.ISO_A,
                        b=iso.ISO_B, gen_x=0, gen_y=0, cofactor=1)


def _eval_poly(spec, coeffs_ints, x):
    """Horner evaluation of a constant-coefficient polynomial at batched x."""
    dev = x.device
    acc = fp.const_array(spec, coeffs_ints[-1], x.shape[1:], dev)
    for c in reversed(coeffs_ints[:-1]):
        acc = fp.add(spec, fp.mont_mul(spec, acc, x), fp.const_array(spec, c, (), dev))
    return acc


def _isogeny_map(px, py):
    """E'(x, y) -> E(x', y') through the 11-isogeny's rational maps, one
    batch inversion of x_den y_den."""
    f = b381.FQ
    xn = _eval_poly(f, iso.X_MAP_NUMERATOR, px)
    xd = _eval_poly(f, iso.X_MAP_DENOMINATOR, px)
    yn = _eval_poly(f, iso.Y_MAP_NUMERATOR, px)
    yd = _eval_poly(f, iso.Y_MAP_DENOMINATOR, px)
    inv = fp.batch_inv(f, fp.mont_mul(f, xd, yd))
    x = fp.mont_mul(f, fp.mont_mul(f, xn, inv), yd)
    y = fp.mont_mul(f, py, fp.mont_mul(f, fp.mont_mul(f, yn, inv), xd))
    return x, y


def bls12_381_g1_wb_map(u: torch.Tensor) -> AffinePoints:
    """WB map: SWU on E', then the isogeny to E (no cofactor clearing)."""
    p_iso = swu_map(ISO_CURVE, u, iso.ZETA)
    x, y = _isogeny_map(p_iso.x, p_iso.y)
    return AffinePoints(x, y, torch.zeros(tuple(u.shape[1:]), dtype=torch.bool, device=u.device))


def map_to_g1_pairs(u: torch.Tensor) -> AffinePoints:
    """u (L, 2n): the n messages' first elements, then their second ->
    to_affine(h_eff (map(u0) + map(u1))) for each message, as
    hash_to_curve_bls12_381_g1 composes them (n = 1 there)."""
    n = u.shape[1] // 2
    pts = bls12_381_g1_wb_map(u)
    p0 = sw.from_affine(b381.G1, AffinePoints(pts.x[:, :n], pts.y[:, :n], pts.inf[:n]))
    p1 = AffinePoints(pts.x[:, n:], pts.y[:, n:], pts.inf[n:])
    q = sw.jac_add_mixed(b381.G1, p0, p1)
    cleared = sw.scalar_mul_const(b381.G1, q, H_EFF_G1)
    return sw.to_affine(b381.G1, cleared)


def hash_to_curve_bls12_381_g1(msg: bytes, dst: bytes, device=DEFAULT_DEVICE) -> AffinePoints:
    """The RFC 9380 suite BLS12381G1_XMD:SHA-256_SSWU_RO_, one message."""
    return map_to_g1_pairs(hash_to_field(b381.FQ, msg, dst, 2, device=device))
