"""Sampling field and group elements from raw (hash or RNG) bytes.

Counterpart of zkarray/serialize/random_bytes.py. Reference:
``Field::from_random_bytes_with_flags`` / ``from_random_bytes``
(ff/src/fields/models/fp/mod.rs:252-296, ff/src/fields/mod.rs:247-257) and
``AffineRepr::from_random_bytes`` (ec/src/models/short_weierstrass/
affine.rs:264-277, twisted_edwards/affine.rs:177-180).

Exact semantics mirrored:
* the value is the little-endian integer of the input bytes with every bit
  at position >= MODULUS_BIT_SIZE cleared; candidates >= p are invalid;
* flags are read from byte ``buffer_byte_size(bits + flag_bits) - 1`` of the
  ORIGINAL input (before masking), from its top ``flag_bits`` bits;
* SW points: infinity flag with x == 0 -> identity; infinity with x != 0 or
  both flags set -> invalid; otherwise y is the GREATER root iff the
  negative-flag bit is clear (the reference passes ``y_is_positive`` as
  ``greatest``: from_random_bytes is a sampling aid, deliberately not the
  serialization convention); no subgroup check (get_point_from_x_unchecked);
* TE points: x is the greater root iff the x-negative flag is SET
  (get_point_from_y_unchecked(y, flags.is_negative())).

The host masks the bytes and reads the flags (batched numpy); the device
evaluates the curve equation and takes the square roots (ff/fp.py:sqrt).
Masks come back as numpy bool arrays, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ec.point_serde import y_is_negative
from zkarray_torch.ec.sw import AffinePoints, SWCurveSpec
from zkarray_torch.ec.te import TEAffine, TECurveSpec
from zkarray_torch.ff import fp
from zkarray_torch.serialize.canonical import (SW_FLAG_INFINITY, SW_FLAG_NEGATIVE,
                                               TE_FLAG_NEGATIVE, below_modulus, bytes_to_limbs,
                                               field_byte_size)


def field_from_random_bytes(spec: FieldSpec, data: np.ndarray, flag_bits: int = 0,
                            device=DEFAULT_DEVICE) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """(n, k) LE bytes -> (Montgomery field tensor (L, n) on ``device``,
    flags (n,), ok (n,)).

    ``ok`` is False where the masked candidate is >= p (the reference
    returns None there). Any byte length k is accepted; bytes beyond the
    reference's 64-bit limb buffer are ignored.
    """
    if flag_bits > 8:
        raise ValueError("flags must fit one byte (Flags::BIT_SIZE <= 8)")
    data = np.asarray(data, dtype=np.uint8)
    if data.ndim == 1:
        data = data[None]
    n, k = data.shape
    span = 8 * ((spec.bits + 63) // 64)  # the reference's 64-bit limb buffer
    buf = np.zeros((n, span), dtype=np.uint8)
    buf[:, : min(k, span)] = data[:, : min(k, span)]

    flags = np.zeros(n, dtype=np.uint8)
    if flag_bits:
        flags_mask = (0xFF << (8 - flag_bits)) & 0xFF
        flag_loc = field_byte_size(spec, flag_bits) - 1
        if flag_loc < k:
            flags = (data[:, flag_loc] & flags_mask).astype(np.uint8)

    # clear every bit at position >= MODULUS_BIT_SIZE
    top_byte, top_bit = spec.bits // 8, spec.bits % 8
    if top_byte < span:
        buf[:, top_byte] &= (1 << top_bit) - 1
        buf[:, top_byte + 1:] = 0
    limbs = bytes_to_limbs(spec, buf[:, : min(span, 2 * spec.num_limbs)])  # canonical (L, n)
    ok = below_modulus(spec, limbs)
    return fp.to_mont(spec, torch.from_numpy(limbs).to(device)), flags, ok


def _mask(m: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(m, dtype=bool)).to(device)


def sw_from_random_bytes(curve: SWCurveSpec, data: np.ndarray,
                         device=DEFAULT_DEVICE) -> Tuple[AffinePoints, np.ndarray]:
    """(n, k) bytes -> (points on ``device``, ok). On the curve through the
    square root's existence; NO subgroup check."""
    f = curve.base
    x, flags, okf = field_from_random_bytes(f, data, flag_bits=2, device=device)
    n = x.shape[1]
    is_inf = (flags & SW_FLAG_INFINITY) != 0
    neg = (flags & SW_FLAG_NEGATIVE) != 0
    bad_flags = is_inf & neg  # SWFlags::from_u8 -> None
    x_zero = fp.is_zero(f, x).cpu().numpy()
    identity = is_inf & x_zero & ~neg

    # y^2 = x^3 + a x + b; the greatest root iff "positive" (no negative bit)
    rhs = fp.add(f, fp.mont_mul(f, fp.mont_sqr(f, x), x), fp.const_array(f, curve.b_int, (n,), device))
    if not curve.a_is_zero:
        rhs = fp.add(f, rhs, fp.mont_mul(f, fp.const_array(f, curve.a_int, (), device), x))
    root, is_sq = fp.sqrt(f, rhs)
    y_small = fp.select(y_is_negative(f, root), fp.neg(f, root), root)
    y = fp.select(_mask(~neg, device), fp.neg(f, y_small), y_small)

    ident = _mask(identity, device)
    zero = fp.zero(f, (n,), device)
    pts = AffinePoints(fp.select(ident, zero, x), fp.select(ident, zero, y), ident)
    ok = okf & ~bad_flags & (identity | (~is_inf & is_sq.cpu().numpy()))
    return pts, ok


def te_from_random_bytes(curve: TECurveSpec, data: np.ndarray,
                         device=DEFAULT_DEVICE) -> Tuple[TEAffine, np.ndarray]:
    """(n, k) bytes -> (points on ``device``, ok): y from the bytes, x the
    greater root iff the negative flag is set; no subgroup check."""
    f = curve.base
    y, flags, okf = field_from_random_bytes(f, data, flag_bits=1, device=device)
    neg = (flags & TE_FLAG_NEGATIVE) != 0
    batch = tuple(y.shape[1:])
    y2 = fp.mont_sqr(f, y)
    num = fp.sub(f, y2, fp.one(f, batch, device))
    den = fp.sub(f, fp.mont_mul(f, fp.const_array(f, curve.d_int, (), device), y2),
                 fp.const_array(f, curve.a_int, batch, device))
    # d y^2 - a == 0 has no inverse: the reference's get_point_from_y_unchecked
    # returns None there; batch_inv maps 0 -> 0, which would otherwise let
    # (0, y) through as a fake square, so those rows are invalid
    den_ok = ~fp.is_zero(f, den).cpu().numpy()
    root, is_sq = fp.sqrt(f, fp.mont_mul(f, num, fp.batch_inv(f, den)))
    x_small = fp.select(y_is_negative(f, root), fp.neg(f, root), root)
    x = fp.select(_mask(neg, device), fp.neg(f, x_small), x_small)
    return TEAffine(x, y), okf & den_ok & is_sq.cpu().numpy()
