"""BLS12-381 G1 in the zcash/zkcrypto wire format.

Counterpart of zkarray/curves/bls12_381_zcash.py's G1 part; G2 waits for
the towers. Big-endian field bytes, flags in the top bits of the FIRST
byte: 0x80 compressed, 0x40 infinity, 0x20 y is the lexicographically
larger root. G1: 48 bytes compressed, 96 uncompressed. With ``validate``
deserialization runs the fast G1 subgroup check (phi(P) == -[X^2]P).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.curves import bls12_381 as b381
from zkarray_torch.ec import fast_checks
from zkarray_torch.ec import sw as sw_mod
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
