"""BLS12-381 G1 and G2 in the zcash/zkcrypto wire format.

Counterpart of zkarray/curves/bls12_381_zcash.py. Big-endian field bytes,
flags in the top bits of the FIRST byte: 0x80 compressed, 0x40 infinity,
0x20 y is the lexicographically larger root. G1: 48 bytes compressed, 96
uncompressed; G2 (Fq2 coordinates, each as c1 ++ c0, c1-dominant order):
96 compressed, 192 uncompressed. With ``validate`` deserialization runs the
fast subgroup checks (G1: phi(P) == -[X^2]P; G2: psi(P) == [X]P).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.curves import bls12_381 as b381
from zkarray_torch.ec import fast_checks
from zkarray_torch.ec import sw as sw_mod
from zkarray_torch.ec import sw_ext
from zkarray_torch.ec.point_serde import y_is_negative
from zkarray_torch.ec.sw import AffinePoints
from zkarray_torch.ff import fp
from zkarray_torch.serialize.canonical import below_modulus, bytes_to_limbs, limbs_to_bytes

COMPRESSED_FLAG = 0x80
INFINITY_FLAG = 0x40
SORT_FLAG = 0x20


def _fq_to_be(x: torch.Tensor) -> np.ndarray:
    """(L, n) Montgomery -> (n, 48) big-endian bytes."""
    return np.ascontiguousarray(limbs_to_bytes(fp.from_mont(b381.FQ, x), 48)[:, ::-1])


def _be_to_fq(data: np.ndarray, device) -> Tuple[torch.Tensor, np.ndarray]:
    """(n, 48) big-endian bytes -> (Montgomery tensor, value < p mask)."""
    limbs = bytes_to_limbs(b381.FQ, np.ascontiguousarray(data[:, ::-1]))
    return fp.to_mont(b381.FQ, torch.from_numpy(limbs).to(device)), below_modulus(b381.FQ, limbs)


def serialize_g1(pts: AffinePoints, compress: bool = True) -> np.ndarray:
    f = b381.FQ
    inf = pts.inf.reshape(-1).cpu().numpy()
    xb = _fq_to_be(fp.select(pts.inf, fp.zero(f, pts.x.shape[1:], pts.x.device), pts.x))
    if compress:
        out = xb.copy()
        sort = y_is_negative(f, pts.y).reshape(-1).cpu().numpy() & ~inf
        out[:, 0] |= COMPRESSED_FLAG | np.where(sort, SORT_FLAG, 0).astype(np.uint8)
    else:
        yb = _fq_to_be(fp.select(pts.inf, fp.zero(f, pts.y.shape[1:], pts.y.device), pts.y))
        out = np.concatenate([xb, yb], axis=1)
    out[:, 0] |= np.where(inf, INFINITY_FLAG, 0).astype(np.uint8)
    return out


def deserialize_g1(data: np.ndarray, compress: bool = True, validate: bool = True,
                   device=DEFAULT_DEVICE) -> Tuple[AffinePoints, np.ndarray]:
    """-> (points on ``device``, valid mask). Invalid: a compression flag
    that disagrees with ``compress``, a coordinate >= p, x with no point,
    infinity with the sort flag; under ``validate`` also off the curve
    (uncompressed) or outside the subgroup."""
    f = b381.FQ
    data = np.asarray(data, dtype=np.uint8)
    if data.ndim == 1:
        data = data[None]
    data = data.copy()
    n = data.shape[0]
    flags = data[:, 0] & 0xE0
    is_comp = (flags & COMPRESSED_FLAG) != 0
    is_inf = (flags & INFINITY_FLAG) != 0
    sort = (flags & SORT_FLAG) != 0
    data[:, 0] &= 0x1F
    inf_t = torch.from_numpy(is_inf).to(device)
    if compress:
        x, ok = _be_to_fq(data[:, :48], device)
        rhs = fp.add(f, fp.mont_mul(f, fp.mont_sqr(f, x), x), fp.const_array(f, 4, (n,), device))
        root, is_sq = fp.sqrt(f, rhs)
        y_small = fp.select(y_is_negative(f, root), fp.neg(f, root), root)
        y = fp.select(torch.from_numpy(sort).to(device), fp.neg(f, y_small), y_small)
        pts = AffinePoints(x, y, inf_t)
        ok = ok & is_comp & (is_sq.cpu().numpy() | is_inf) & ~(is_inf & sort)
    else:
        x, okx = _be_to_fq(data[:, :48], device)
        y, oky = _be_to_fq(data[:, 48:96], device)
        pts = AffinePoints(x, y, inf_t)
        ok = ~is_comp & okx & oky
        if validate:
            ok = ok & sw_mod.is_on_curve(b381.G1, pts).cpu().numpy()
    if validate:
        ok = ok & fast_checks.bls12_381_g1_subgroup_check(b381.G1, pts).cpu().numpy()
    return pts, ok


# ---------------------------------------------------------------------------
# G2: x = c1 BE ++ c0 BE, flags in the first byte of c1
# ---------------------------------------------------------------------------

def _fq2_is_larger(y: torch.Tensor) -> torch.Tensor:
    """y > -y in arkworks' Fq2 order: c1 first, c0 where c1 is zero."""
    return torch.where(fp.is_zero(b381.FQ, y[1]), y_is_negative(b381.FQ, y[0]),
                       y_is_negative(b381.FQ, y[1]))


def serialize_g2(pts: sw_ext.ExtAffine, compress: bool = True) -> np.ndarray:
    F2 = b381.FQ2
    inf = pts.inf.reshape(-1).cpu().numpy()
    batch, dev = F2.batch_shape_of(pts.x), pts.x.device
    xz = F2.select(pts.inf, F2.zero(batch, dev), pts.x)
    xb = np.concatenate([_fq_to_be(xz[1]), _fq_to_be(xz[0])], axis=1)
    if compress:
        out = xb.copy()
        sort = _fq2_is_larger(pts.y).reshape(-1).cpu().numpy() & ~inf
        out[:, 0] |= COMPRESSED_FLAG | np.where(sort, SORT_FLAG, 0).astype(np.uint8)
    else:
        yz = F2.select(pts.inf, F2.zero(batch, dev), pts.y)
        out = np.concatenate([xb, _fq_to_be(yz[1]), _fq_to_be(yz[0])], axis=1)
    out[:, 0] |= np.where(inf, INFINITY_FLAG, 0).astype(np.uint8)
    return out


def _be_to_fq2(data: np.ndarray, device) -> Tuple[torch.Tensor, np.ndarray]:
    """(n, 96) big-endian bytes c1 ++ c0 -> ((2, L, n) Montgomery tensor,
    both coefficients < p mask)."""
    c1, ok1 = _be_to_fq(data[:, :48], device)
    c0, ok0 = _be_to_fq(data[:, 48:96], device)
    return torch.stack([c0, c1]), ok0 & ok1


def deserialize_g2(data: np.ndarray, compress: bool = True, validate: bool = True,
                   device=DEFAULT_DEVICE) -> Tuple[sw_ext.ExtAffine, np.ndarray]:
    """-> (points on ``device``, valid mask), with deserialize_g1's rules;
    the root of a compressed point from towers.quad_sqrt."""
    from zkarray_torch.ff.towers import quad_sqrt

    F2 = b381.FQ2
    curve = b381.G2
    data = np.asarray(data, dtype=np.uint8)
    if data.ndim == 1:
        data = data[None]
    data = data.copy()
    n = data.shape[0]
    flags = data[:, 0] & 0xE0
    is_comp = (flags & COMPRESSED_FLAG) != 0
    is_inf = (flags & INFINITY_FLAG) != 0
    sort = (flags & SORT_FLAG) != 0
    data[:, 0] &= 0x1F
    inf_t = torch.from_numpy(is_inf).to(device)
    if compress:
        x, ok = _be_to_fq2(data[:, :96], device)
        rhs = F2.add(F2.mul(F2.sqr(x), x), F2.const(curve.b_host, (n,), device))
        root, is_sq = quad_sqrt(F2, rhs)
        y_small = F2.select(_fq2_is_larger(root), F2.neg(root), root)
        y = F2.select(torch.from_numpy(sort).to(device), F2.neg(y_small), y_small)
        pts = sw_ext.ExtAffine(x, y, inf_t)
        ok = ok & is_comp & (is_sq.cpu().numpy() | is_inf) & ~(is_inf & sort)
    else:
        x, lx = _be_to_fq2(data[:, :96], device)
        y, ly = _be_to_fq2(data[:, 96:192], device)
        pts = sw_ext.ExtAffine(x, y, inf_t)
        ok = ~is_comp & lx & ly
        if validate:
            ok = ok & (sw_ext.is_on_curve(curve, pts).cpu().numpy() | is_inf)
    if validate:
        ok = ok & fast_checks.bls12_381_g2_subgroup_check(curve, pts).cpu().numpy()
    return pts, ok
