"""Planar base-2^16 limb primitives on torch tensors.

Counterpart of zkarray/core/limbs.py. Layout ``[L, *batch]``, limb axis
leading. Tensors at the API hold limbs in int32; the arithmetic here runs in
int64, where a signed carry is an arithmetic right shift (torch's CPU uint32
has no add, sub, shift or compare).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core.fieldspec import LIMB_BITS, LIMB_MASK


# ---------------------------------------------------------------------------
# host <-> limb conversion (numpy; boundary code, not a hot path)
# ---------------------------------------------------------------------------

def int_to_limbs_np(x: int, num_limbs: int) -> np.ndarray:
    """One Python int -> (L,) uint32 little-endian base-2^16 limbs."""
    x = int(x)
    if x < 0 or x >> (LIMB_BITS * num_limbs):
        raise ValueError("integer does not fit in given limb count")
    return np.asarray([(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(num_limbs)],
                      dtype=np.uint32)


def ints_to_limbs_np(xs: Sequence[int], num_limbs: int) -> np.ndarray:
    """Python ints -> (L, len(xs)) uint32 planar limb array."""
    out = np.empty((num_limbs, len(xs)), dtype=np.uint32)
    for j, x in enumerate(xs):
        out[:, j] = int_to_limbs_np(x, num_limbs)
    return out


def limbs_to_int(limbs) -> int:
    """(L,) limb vector (tensor or array) -> Python int."""
    return limbs_to_ints(np.asarray(limbs.detach().cpu() if isinstance(limbs, torch.Tensor)
                                    else limbs).reshape(-1, 1))[0]


def limbs_to_ints(limbs) -> list:
    """(L, *batch) limb tensor or array of 16-bit limbs -> flat list of
    Python ints (one copy to the host, then each element's bytes)."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    arr = np.asarray(limbs)
    flat = np.ascontiguousarray(arr.reshape(arr.shape[0], -1).T.astype("<u2"))
    return [int.from_bytes(row.tobytes(), "little") for row in flat]


# ---------------------------------------------------------------------------
# device primitives (broadcast over trailing batch axes)
# ---------------------------------------------------------------------------

def zeros(num_limbs: int, batch_shape=(), device=DEFAULT_DEVICE) -> torch.Tensor:
    return torch.zeros((num_limbs,) + tuple(batch_shape), dtype=torch.int32, device=device)


def normalize(cols: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """Carry-propagate signed int64 base-2^16 columns into 16-bit limbs.

    Returns (out_limbs, *batch) int64 limbs in [0, 2^16); the final carry is
    dropped (callers guarantee it is zero or read it via ``sub_with_borrow``).
    """
    out, _ = _ripple(cols, out_limbs)
    return out


def _ripple(cols: torch.Tensor, out_limbs: int):
    """(limbs, final signed carry) of int64 columns with |value| < 2^62.

    Three carry-save passes bring every column below 2^17 (each pass moves
    all columns' high bits up one limb at once); the exact ripple then runs
    over 48-bit chunks of three limbs, a third of the serial steps."""
    x = cols.to(torch.int64)
    if x.shape[0] < out_limbs:
        x = torch.cat([x, x.new_zeros((out_limbs - x.shape[0],) + tuple(x.shape[1:]))])
    else:
        x = x[:out_limbs].clone()
    top = torch.zeros_like(x[0])
    for _ in range(3):
        c = x >> LIMB_BITS
        x &= LIMB_MASK
        x[1:] += c[:-1]
        top += c[-1]
    m = -(-out_limbs // 3)
    x = torch.cat([x, x.new_zeros((3 * m - out_limbs,) + tuple(x.shape[1:]))])
    x = x.reshape((m, 3) + tuple(x.shape[1:]))
    # columns are now in (-2^15, 2^17): a chunk is exact in int64
    chunks = x[:, 0] + (x[:, 1] << LIMB_BITS) + (x[:, 2] << (2 * LIMB_BITS))
    c = torch.zeros_like(top)
    for j in range(m):
        t = chunks[j] + c
        chunks[j] = t & ((1 << 48) - 1)
        c = t >> 48
    out = torch.stack([chunks & LIMB_MASK, (chunks >> LIMB_BITS) & LIMB_MASK,
                       chunks >> (2 * LIMB_BITS)], dim=1).reshape((3 * m,) + tuple(x.shape[2:]))
    # limbs past out_limbs in the top chunk belong to the final carry
    carry = top + (c << (LIMB_BITS * (3 * m - out_limbs)))
    for k in range(out_limbs, 3 * m):
        carry = carry + (out[k] << (LIMB_BITS * (k - out_limbs)))
    return out[:out_limbs], carry


def sub_with_borrow(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a - b over canonical limbs of equal length. Returns (int64 diff limbs
    mod 2^(16 L), borrow) with borrow True where b > a."""
    diff, c = _ripple(a.to(torch.int64) - b.to(torch.int64), a.shape[0])
    return diff, c < 0


def geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b elementwise over the batch (canonical limbs); bool tensor."""
    _, borrow = sub_with_borrow(a, b)
    return ~borrow


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-batch-element select: mask True -> a. mask shape = batch shape."""
    return torch.where(mask[None], a, b)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """True where all limbs are zero (batch-shaped bool)."""
    return (a == 0).all(dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def bit(a: torch.Tensor, i: int) -> torch.Tensor:
    """Bit i (Python int index) of each batch element, as 0/1 in a's dtype."""
    return (a[i // LIMB_BITS] >> (i % LIMB_BITS)) & 1


def num_bits_total(a: torch.Tensor) -> torch.Tensor:
    """Bit length per batch element (int32): the top nonzero limb's index
    times 16 plus that limb's own bit length; 0 for zero."""
    x = a.to(torch.int64)
    nz = x != 0
    top = (a.shape[0] - 1) - torch.flip(nz, [0]).to(torch.int8).argmax(dim=0)
    v = x.gather(0, top[None])[0]
    width = torch.zeros_like(v)
    for s in (8, 4, 2, 1):
        m = v >= (1 << s)
        width = width + torch.where(m, s, 0)
        v = torch.where(m, v >> s, v)
    width = width + (v > 0).to(torch.int64)
    return torch.where(nz.any(dim=0), top * LIMB_BITS + width, 0).to(torch.int32)


def pack_pairs(a: torch.Tensor) -> torch.Tensor:
    """(2k, ...) 16-bit limb rows -> (k, ...) 32-bit words as int32 bit
    patterns (zkarray/ec/msm.py:_pack_pairs)."""
    a = a.to(torch.int64)
    w = a[0::2] | (a[1::2] << LIMB_BITS)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def unpack_pairs(w: torch.Tensor) -> torch.Tensor:
    """(k, ...) int32 word bit patterns -> (2k, ...) int32 16-bit limb rows."""
    k = w.shape[0]
    lo = w & LIMB_MASK
    hi = (w >> LIMB_BITS) & LIMB_MASK
    return torch.stack([lo, hi], dim=1).reshape((2 * k,) + tuple(w.shape[1:]))
