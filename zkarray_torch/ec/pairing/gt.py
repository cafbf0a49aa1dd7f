"""GT, the pairing's target group, as an additive group of prime order.

Counterpart of zkarray/ec/pairing/gt.py (ark-ec's PairingOutput): the
cyclotomic subgroup of order r of a pairing's target field, written
additively: zero = 1, add = the field product, double = the cyclotomic
square, neg = the conjugate, scalar multiplication = a power. A GT batch is
a target-field coefficient stack (an Fp12 element (2, 3, 2, L, *batch), a
BW6 Fp6 element (2, 3, L, *batch)), and each group op is one batched tower
op, so GTGroup works over any target tower the port has.

Scalars are canonical 16-bit limbs (Ls, *batch), the JAX package's layout;
their bits and window digits are read on the device, with no host loop over
the batch. The ladders run the JAX package's steps in its order (the double
and the add on every bit, then a select): the words are its words.
"""

from __future__ import annotations

import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core.fieldspec import LIMB_BITS
from zkarray_torch.ff import cyclotomic as cyc


class GTGroup:
    """Additive view of the cyclotomic subgroup of a pairing's target field:
    ``ext`` the target tower, ``scalar`` the r-order scalar FieldSpec."""

    def __init__(self, ext, scalar):
        self.ext = ext
        self.scalar = scalar
        self.name = f"gt({ext.name})"

    def __hash__(self):
        return hash(("gt", self.ext, self.scalar))

    def __eq__(self, o):
        return isinstance(o, GTGroup) and o.ext == self.ext and o.scalar == self.scalar

    def __repr__(self):
        return f"GTGroup({self.ext.name})"

    def zero(self, batch_shape=(), device=DEFAULT_DEVICE):
        return self.ext.one(batch_shape, device)

    def is_zero(self, a):
        return self.ext.eq(a, self.ext.one(self.ext.batch_shape_of(a), a.device))

    def add(self, a, b):
        return self.ext.mul(a, b)

    def neg(self, a):
        return cyc.cyclotomic_inverse(self.ext, a)

    def sub(self, a, b):
        return self.ext.mul(a, self.neg(b))

    def double(self, a):
        return cyc.cyclotomic_sqr(self.ext, a)

    def select(self, mask, a, b):
        return self.ext.select(mask, a, b)

    def eq(self, a, b):
        return self.ext.eq(a, b)

    def mul_const(self, a, e: int):
        """a e for a host integer e (the NAF ladder, reduced mod r)."""
        return cyc.cyclotomic_exp(self.ext, a, e % self.scalar.modulus)


def gt_mul_scalar(gt: GTGroup, a, scalars: torch.Tensor):
    """a s element-wise for scalars s in canonical limbs (Ls, *batch): a
    double-and-add ladder over all Ls * 16 bits, high first, the add kept
    where the lane's bit is set (reference pairing.rs mul_bigint)."""
    ext = gt.ext
    batch = ext.batch_shape_of(a)
    sc = scalars.to(torch.int64)
    r = gt.zero(batch, a.device)
    for i in range(gt.scalar.num_limbs * LIMB_BITS - 1, -1, -1):
        limb, off = divmod(i, LIMB_BITS)
        bit = ((sc[limb] >> off) & 1).bool()
        r = gt.double(r)
        r = ext.select(bit, gt.add(r, a), r)
    return r


def _window_digits(scalars: torch.Tensor, Ls: int, W: int, c: int) -> torch.Tensor:
    """(W, n) unsigned c-bit window digits of canonical limbs (Ls, n)."""
    sc = scalars.to(torch.int64)
    digs = []
    for w in range(W):
        limb, off = divmod(w * c, LIMB_BITS)
        raw = sc[limb] >> off
        if off + c > LIMB_BITS and limb + 1 < Ls:
            raw = raw | (sc[limb + 1] << (LIMB_BITS - off))
        digs.append(raw & ((1 << c) - 1))
    return torch.stack(digs)


def gt_msm(gt: GTGroup, points, scalars: torch.Tensor, c: int = 3):
    """sum_i scalars_i points_i over GT: Pippenger with unsigned c-bit
    windows, high first; each window's 2^c - 1 buckets by one-hot selects
    and a log tree of products over the n points, then a suffix sum
    (reference: VariableBaseMSM's default for PairingOutput). ``points``: a
    target-field stack with a trailing batch axis (n,); ``scalars``:
    canonical limbs (Ls, n). Returns one element (batch ())."""
    ext = gt.ext
    n = scalars.shape[-1]
    dev = points.device
    W = (gt.scalar.bits + c - 1) // c
    digits = _window_digits(scalars, gt.scalar.num_limbs, W, c)
    B = (1 << c) - 1  # buckets 1..B
    labels = torch.arange(1, B + 1, device=dev)[:, None]
    pts = points[..., None, :].expand(tuple(points.shape[:-1]) + (B, n))
    one = gt.zero((B, n), dev)
    total = gt.zero((), dev)
    for w in range(W - 1, -1, -1):
        for _ in range(c):
            total = gt.double(total)
        sel = ext.select(digits[w][None, :] == labels, pts, one)  # (..., B, n)
        m = n
        while m > 1:
            h = m // 2
            red = gt.add(sel[..., :h], sel[..., h:2 * h])
            if m % 2:
                red = torch.cat([red, sel[..., 2 * h:]], dim=-1)
                m = h + 1
            else:
                m = h
            sel = red
        buckets = sel[..., 0]  # (..., B)
        run = acc = gt.zero((), dev)
        for b in range(B - 1, -1, -1):  # sum_b (b + 1) bucket_b
            run = gt.add(run, buckets[..., b])
            acc = gt.add(acc, run)
        total = gt.add(total, acc)
    return total


mul_scalar = gt_mul_scalar
msm = gt_msm
