"""Point serialization (short-Weierstrass and twisted-Edwards) in arkworks'
canonical format.

Counterpart of zkarray/ec/point_serde.py: short-Weierstrass points
(serialize_sw, deserialize_sw, and for points over an extension field
serialize_sw_ext, deserialize_sw_ext) and twisted-Edwards points
(serialize_te, deserialize_te). SW compressed = x bytes with SWFlags in the
top 2 bits of the last byte (y negative when y > -y as integers; over an
extension, coefficient by coefficient from the highest); uncompressed = x
bytes ++ y bytes with the flags; infinity = zeros and the infinity flag.
An extension element is its coefficients c0..c_{d-1} in order, the flags
in the last. TE compressed = y bytes with the sign of x in the top bit
(TEFlags); uncompressed = x bytes ++ that.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core import limbs as lb
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ec import sw as sw_mod
from zkarray_torch.ec import sw_ext
from zkarray_torch.ec import te as te_mod
from zkarray_torch.ec.sw import AffinePoints, SWCurveSpec
from zkarray_torch.ec.te import TEAffine, TECurveSpec
from zkarray_torch.ff import fp
from zkarray_torch.serialize.canonical import (SW_FLAG_INFINITY, SW_FLAG_NEGATIVE,
                                               TE_FLAG_NEGATIVE, deserialize_fp,
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


def serialize_te(curve: TECurveSpec, pts: TEAffine, compress: bool = True) -> np.ndarray:
    """TE points -> (n, nb) compressed (y with the sign of x) or (n, 2 nb)
    uncompressed bytes."""
    f = curve.base
    flags = np.where(y_is_negative(f, pts.x).reshape(-1).cpu().numpy(),
                     np.uint8(TE_FLAG_NEGATIVE), np.uint8(0))
    if compress:
        return serialize_fp(f, pts.y, flag_bits=1, flags=flags)
    return np.concatenate([serialize_fp(f, pts.x), serialize_fp(f, pts.y, flag_bits=1, flags=flags)],
                          axis=1)


def deserialize_te(curve: TECurveSpec, data: np.ndarray, compress: bool = True,
                   validate: bool = True, device=DEFAULT_DEVICE) -> Tuple[TEAffine, np.ndarray]:
    """-> (points on ``device``, valid mask). Compressed: x^2 = (y^2 - 1) /
    (d y^2 - a), the root with x's sign; invalid where that is no square.
    Under ``validate`` the points must lie on the curve; no subgroup check
    (zkarray/ec/point_serde.py:deserialize_te)."""
    f = curve.base
    data = np.asarray(data, dtype=np.uint8)
    if data.ndim == 1:
        data = data[None]
    if compress:
        y, flags, ok = deserialize_fp(f, data, flag_bits=1, device=device)
        neg = torch.from_numpy((flags & TE_FLAG_NEGATIVE) != 0).to(device)
        batch = y.shape[1:]
        y2 = fp.mont_sqr(f, y)
        num = fp.sub(f, y2, fp.one(f, batch, device))
        den = fp.sub(f, fp.mont_mul(f, fp.const_array(f, curve.d_int, (), device), y2),
                     fp.const_array(f, curve.a_int, batch, device))
        root, is_sq = fp.sqrt(f, fp.mont_mul(f, num, fp.batch_inv(f, den)))
        x_pos = fp.select(y_is_negative(f, root), fp.neg(f, root), root)
        pts = TEAffine(fp.select(neg, fp.neg(f, x_pos), x_pos), y)
        ok = ok & is_sq.cpu().numpy()
    else:
        nb = field_byte_size(f)
        x, _, okx = deserialize_fp(f, data[:, :nb], device=device)
        y, _, oky = deserialize_fp(f, data[:, nb:], flag_bits=1, device=device)
        pts = TEAffine(x, y)
        ok = okx & oky
    if validate:
        ok = ok & te_mod.is_on_curve(curve, pts).cpu().numpy()
    return pts, ok


# ---------------------------------------------------------------------------
# points over an extension field (G2): arkworks' default canonical format
# ---------------------------------------------------------------------------

def ext_y_is_negative(F, y: torch.Tensor) -> torch.Tensor:
    """y > -y in arkworks' extension-field order: coefficient-lexicographic,
    the HIGHEST coefficient first (quadratic_extension.rs:444-453)."""
    spec = F.spec
    gt = torch.zeros(F.batch_shape_of(y), dtype=torch.bool, device=y.device)
    decided = torch.zeros_like(gt)
    for j in range(F.deg - 1, -1, -1):
        gt |= ~decided & y_is_negative(spec, y[j])
        decided |= ~fp.is_zero(spec, y[j])
    return gt


def serialize_sw_ext(curve: sw_ext.ExtCurveSpec, pts: sw_ext.ExtAffine,
                     compress: bool = True) -> np.ndarray:
    """ExtAffine points over a quadratic or cubic extension -> canonical
    bytes, (n, deg * nb) compressed or (n, 2 deg nb) uncompressed."""
    F = curve.ops
    spec, deg = F.spec, F.deg
    batch, dev = F.batch_shape_of(pts.x), pts.x.device
    inf = pts.inf.reshape(-1).cpu().numpy()
    neg = ext_y_is_negative(F, pts.y).reshape(-1).cpu().numpy()
    flags = np.where(inf, np.uint8(SW_FLAG_INFINITY),
                     np.where(neg, np.uint8(SW_FLAG_NEGATIVE), np.uint8(0)))

    def enc(v, with_flags):
        parts = [serialize_fp(spec, v[j]) for j in range(deg - 1)]
        parts.append(serialize_fp(spec, v[deg - 1], flag_bits=2 if with_flags else 0,
                                  flags=flags if with_flags else None))
        return np.concatenate(parts, axis=1)

    xz = F.select(pts.inf, F.zero(batch, dev), pts.x)
    if compress:
        return enc(xz, True)
    yz = F.select(pts.inf, F.zero(batch, dev), pts.y)
    return np.concatenate([enc(xz, False), enc(yz, True)], axis=1)


def deserialize_sw_ext(curve: sw_ext.ExtCurveSpec, data: np.ndarray, compress: bool = True,
                       validate: bool = True, device=DEFAULT_DEVICE
                       ) -> Tuple[sw_ext.ExtAffine, np.ndarray]:
    """Canonical bytes -> (ExtAffine on ``device``, valid mask). Compressed
    decoding of quadratic extensions takes the root from towers.quad_sqrt;
    compressed cubic-extension points are not implemented (the reference
    raises NotImplementedError too). Under ``validate`` the points must lie
    on the curve; no subgroup check here."""
    from zkarray_torch.ff.towers import quad_sqrt

    F = curve.ops
    spec, deg = F.spec, F.deg
    data = np.asarray(data, dtype=np.uint8)
    if data.ndim == 1:
        data = data[None]
    n = data.shape[0]
    nb = field_byte_size(spec)

    def dec(block, flag_bits_last):
        coeffs, oks, flags, off = [], np.ones(n, dtype=bool), None, 0
        for j in range(deg):
            fb = flag_bits_last if j == deg - 1 else 0
            w = field_byte_size(spec, fb)
            v, fl, ok = deserialize_fp(spec, block[:, off:off + w], flag_bits=fb, device=device)
            off += w
            coeffs.append(v)
            oks &= ok
            flags = fl
        return torch.stack(coeffs), flags, oks

    if compress:
        if deg != 2:
            raise NotImplementedError(
                "compressed ext-point decoding implemented for quadratic extensions only")
        x, flags, ok = dec(data, 2)
        is_inf = (flags & SW_FLAG_INFINITY) != 0
        neg = (flags & SW_FLAG_NEGATIVE) != 0
        rhs = F.add(F.mul(F.sqr(x), x), F.const(curve.b_host, (n,), device))
        if not curve.a_is_zero:
            rhs = F.add(rhs, F.mul(F.const(curve.a_host, (n,), device), x))
        root, is_sq = quad_sqrt(F, rhs)
        y_pos = F.select(ext_y_is_negative(F, root), F.neg(root), root)
        y = F.select(torch.from_numpy(neg).to(device), F.neg(y_pos), y_pos)
        pts = sw_ext.ExtAffine(x, y, torch.from_numpy(is_inf).to(device))
        ok = ok & (is_sq.cpu().numpy() | is_inf) & ~(is_inf & neg)
    else:
        x, _, okx = dec(data[:, :deg * nb], 0)
        y, flags, oky = dec(data[:, deg * nb:], 2)
        is_inf = (flags & SW_FLAG_INFINITY) != 0
        pts = sw_ext.ExtAffine(x, y, torch.from_numpy(is_inf).to(device))
        ok = okx & oky
    if validate:
        ok = ok & (sw_ext.is_on_curve(curve, pts).cpu().numpy() | is_inf)
    return pts, ok
