"""Big-integer helpers: NAF and wNAF recoding, bit lists, and wide
products and shifts on limb tensors.

Counterpart of zkarray/core/bigint.py. The recodings are host work on
Python ints, as there; ``wnaf_digits`` is the same recoding for a batch of
scalars at once in numpy (ec/wnaf.py's ``WnafContext.mul`` uses it), digit
for digit equal to ``find_wnaf``. The tensor helpers work on canonical
(L, *batch) 16-bit limbs held in int32, the layout of the rest of the port.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from zkarray_torch.core import limbs as lb


def find_naf(x: int) -> List[int]:
    """Non-adjacent form digits, least significant first."""
    out = []
    while x != 0:
        if x % 2:
            z = 2 - (x % 4)
            out.append(z)
            x -= z
        else:
            out.append(0)
        x //= 2
    return out


def find_wnaf(x: int, w: int) -> List[int]:
    """Width-w NAF digits, least significant first: odd digits in
    (-2^(w-1), 2^(w-1)), zeros between."""
    out = []
    while x != 0:
        if x % 2:
            z = x % (1 << w)
            if z >= 1 << (w - 1):
                z -= 1 << w
            out.append(z)
            x -= z
        else:
            out.append(0)
        x //= 2
    return out


def wnaf_digits(xs: Sequence[int], w: int) -> np.ndarray:
    """(steps, len(xs)) int32 wNAF digits of nonnegative ints, least
    significant first, column j equal to find_wnaf(xs[j], w) padded with
    zeros to the longest (no row when every x is zero, one when xs is
    empty, as zkarray/ec/wnaf.py pads its lists); one vectorised step per
    digit over 16-bit limbs."""
    n = len(xs)
    if n == 0:
        return np.zeros((1, 0), dtype=np.int32)
    nl = max(1, -(-max(int(x).bit_length() for x in xs) // 16)) + 1  # room for a carry
    x = lb.ints_to_limbs_np(xs, nl).astype(np.int64)
    half, full = 1 << (w - 1), 1 << w
    digits = []
    while x.any():
        low = x[0] % full
        z = np.where(x[0] & 1, np.where(low >= half, low - full, low), 0)
        x[0] -= z  # x - z is even; propagate the borrow (z > 0) or carry (z < 0)
        for i in range(nl - 1):
            c = x[i] >> 16
            x[i] &= 0xFFFF
            x[i + 1] += c
        digits.append(z)
        x[:-1] = (x[:-1] >> 1) | ((x[1:] & 1) << 15)  # x //= 2
        x[-1] >>= 1
    if not digits:  # every scalar zero: no step, as find_wnaf's empty lists give
        return np.zeros((0, n), dtype=np.int32)
    return np.stack(digits).astype(np.int32)


def bits_be(x: int, width: int = None) -> List[int]:
    """Big-endian bit list (optionally zero-padded to ``width``)."""
    s = bin(x)[2:] if x else "0"
    if width is not None:
        s = s.zfill(width)
    return [int(c) for c in s]


def bits_le(x: int, width: int = None) -> List[int]:
    return bits_be(x, width)[::-1]


# ---- wide products and shifts on limb tensors ----

def mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product of canonical limb tensors: (La, *B) x (Lb, *B) ->
    (La + Lb, *B) canonical limbs (schoolbook columns, one carry pass)."""
    La, Lb = a.shape[0], b.shape[0]
    batch = torch.broadcast_shapes(tuple(a.shape[1:]), tuple(b.shape[1:]))
    a64 = a.to(torch.int64).expand((La,) + batch)
    b64 = b.to(torch.int64).expand((Lb,) + batch)
    cols = torch.zeros((La + Lb + 1,) + batch, dtype=torch.int64, device=a.device)
    for i in range(La):
        prod = a64[i][None] * b64
        cols[i:i + Lb] += prod & lb.LIMB_MASK
        cols[i + 1:i + 1 + Lb] += prod >> lb.LIMB_BITS
    return lb.normalize(cols, La + Lb).to(torch.int32)


def shl_limbs(a: torch.Tensor, k_bits: int) -> torch.Tensor:
    """Left shift by a constant bit count, the limb axis extended."""
    Lw, rem = divmod(k_bits, lb.LIMB_BITS)
    out_len = a.shape[0] + Lw + (1 if rem else 0)
    pad = [0, 0] * (a.dim() - 1) + [Lw, 1 if rem else 0]
    padded = torch.nn.functional.pad(a, pad)
    if rem == 0:
        return padded[:out_len]
    lo = (padded << rem) & lb.LIMB_MASK
    hi = torch.cat([torch.zeros_like(padded[:1]), (padded >> (lb.LIMB_BITS - rem))[:-1]])
    return (lo | hi)[:out_len]


def shr_limbs(a: torch.Tensor, k_bits: int) -> torch.Tensor:
    """Right shift by a constant bit count (the limb count kept)."""
    Lw, rem = divmod(k_bits, lb.LIMB_BITS)
    L = a.shape[0]
    shifted = torch.cat([a[Lw:], a.new_zeros((min(Lw, L),) + tuple(a.shape[1:]))])
    if rem == 0:
        return shifted
    lo = shifted >> rem
    hi = torch.cat([(shifted[1:] << (lb.LIMB_BITS - rem)) & lb.LIMB_MASK,
                    torch.zeros_like(shifted[:1])])
    return lo | hi
