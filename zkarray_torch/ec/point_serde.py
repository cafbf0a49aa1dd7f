"""Short-Weierstrass point serialization in arkworks' canonical format.

Counterpart of zkarray/ec/point_serde.py's SW part (serialize_sw,
deserialize_sw); the twisted-Edwards formats wait for the Edwards curves.
Compressed = x bytes with SWFlags in the top 2 bits of the last byte (y
negative when y > -y as integers); uncompressed = x bytes ++ y bytes with
the flags; infinity = zeros and the infinity flag.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core import limbs as lb
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ec import sw as sw_mod
from zkarray_torch.ec.sw import AffinePoints, SWCurveSpec
from zkarray_torch.ff import fp
from zkarray_torch.serialize.canonical import (SW_FLAG_INFINITY, SW_FLAG_NEGATIVE, deserialize_fp,
                                               field_byte_size, serialize_fp)


def y_is_negative(spec: FieldSpec, y: torch.Tensor) -> torch.Tensor:
    """y > -y as canonical integers (the lexicographically larger root), as
    a batch-shaped bool tensor on y's device."""
    _, borrow = lb.sub_with_borrow(fp.from_mont(spec, fp.neg(spec, y)), fp.from_mont(spec, y))
    return borrow


def serialize_sw(curve: SWCurveSpec, pts: AffinePoints, compress: bool = True) -> np.ndarray:
    f = curve.base
    inf = pts.inf.reshape(-1).cpu().numpy()
    neg = y_is_negative(f, pts.y).reshape(-1).cpu().numpy()
    flags = np.where(inf, np.uint8(SW_FLAG_INFINITY),
                     np.where(neg, np.uint8(SW_FLAG_NEGATIVE), np.uint8(0)))
    xz = fp.select(pts.inf, fp.zero(f, pts.x.shape[1:], pts.x.device), pts.x)
    if compress:
        return serialize_fp(f, xz, flag_bits=2, flags=flags)
    yz = fp.select(pts.inf, fp.zero(f, pts.y.shape[1:], pts.y.device), pts.y)
    return np.concatenate([serialize_fp(f, xz), serialize_fp(f, yz, flag_bits=2, flags=flags)],
                          axis=1)


def deserialize_sw(curve: SWCurveSpec, data: np.ndarray, compress: bool = True,
                   validate: bool = True, device=DEFAULT_DEVICE
                   ) -> Tuple[AffinePoints, np.ndarray]:
    """-> (points on ``device``, valid mask). Invalid: bad flags, x with no
    point (compressed), not on the curve (uncompressed, validate), not in
    the subgroup (validate, generic check)."""
    f = curve.base
    data = np.asarray(data, dtype=np.uint8)
    if data.ndim == 1:
        data = data[None]
    n = data.shape[0]
    if compress:
        x, flags, ok = deserialize_fp(f, data, flag_bits=2, device=device)
        is_inf = (flags & SW_FLAG_INFINITY) != 0
        neg = (flags & SW_FLAG_NEGATIVE) != 0
        rhs = fp.add(f, fp.mont_mul(f, fp.mont_sqr(f, x), x),
                     fp.const_array(f, curve.b_int, (n,), device))
        if not curve.a_is_zero:
            rhs = fp.add(f, rhs, fp.mont_mul(f, fp.const_array(f, curve.a_int, (), device), x))
        root, is_sq = fp.sqrt(f, rhs)
        y_pos = fp.select(y_is_negative(f, root), fp.neg(f, root), root)
        y = fp.select(torch.from_numpy(neg).to(device), fp.neg(f, y_pos), y_pos)
        pts = AffinePoints(x, y, torch.from_numpy(is_inf).to(device))
        ok = ok & (is_sq.cpu().numpy() | is_inf) & ~(is_inf & neg)
    else:
        nb = field_byte_size(f)
        x, _, okx = deserialize_fp(f, data[:, :nb], device=device)
        y, flags, oky = deserialize_fp(f, data[:, nb:], flag_bits=2, device=device)
        pts = AffinePoints(x, y, torch.from_numpy((flags & SW_FLAG_INFINITY) != 0).to(device))
        ok = okx & oky
        if validate:
            ok = ok & sw_mod.is_on_curve(curve, pts).cpu().numpy()
    if validate:
        ok = ok & sw_mod.subgroup_check(curve, pts).cpu().numpy()
    return pts, ok
