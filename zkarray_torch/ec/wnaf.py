"""wNAF scalar multiplication by one base.

Counterpart of zkarray/ec/wnaf.py: a host-built table of the 2^(w-1) odd
multiples of the base, the scalars recoded to width-w NAF digits on the
host (core/bigint.py:wnaf_digits, the batch form of find_wnaf), and one
ladder over the digits, most significant first, shared by the batch: a
``jac_double`` and a ``jac_add_mixed`` of the gathered (sign-adjusted)
table entry per digit (field kernel launches on a CUDA device).
"""

from __future__ import annotations

from typing import Sequence

import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core.bigint import wnaf_digits
from zkarray_torch.ec import sw
from zkarray_torch.ec.fixed_base import _host_add, _mont_limbs
from zkarray_torch.ec.sw import AffinePoints, JacobianPoints, SWCurveSpec
from zkarray_torch.ff import fp


class WnafContext:
    def __init__(self, curve: SWCurveSpec, base_xy, window: int = 4, device=DEFAULT_DEVICE):
        """base_xy: (x, y) canonical ints. Table: [1, 3, ..., 2^w - 1] G in
        Montgomery form, (L, 2^(w-1)) each coordinate."""
        self.curve = curve
        self.window = window
        a, mod = curve.a_int, curve.base.modulus
        g2 = _host_add(base_xy, base_xy, a, mod)
        odd = [base_xy]
        for _ in range((1 << (window - 1)) - 1):
            odd.append(_host_add(odd[-1], g2, a, mod))
        self.tx = torch.from_numpy(_mont_limbs(curve, [q[0] for q in odd])).to(device)
        self.ty = torch.from_numpy(_mont_limbs(curve, [q[1] for q in odd])).to(device)

    def mul(self, scalars: Sequence[int]) -> JacobianPoints:
        """k_i G for a batch of host-int scalars."""
        r = self.curve.scalar.modulus
        digits = wnaf_digits([int(k) % r for k in scalars], self.window)
        return _wnaf_apply(self.curve, self.tx, self.ty,
                           torch.from_numpy(digits).to(self.tx.device))


def _wnaf_apply(curve, tx, ty, digits) -> JacobianPoints:
    """Over the digits (steps, n) from the most significant:
    acc = 2 acc + sign table[|d| >> 1] (d = 0: the add of infinity)."""
    f = curve.base
    acc = sw.jac_zero(curve, (digits.shape[1],), tx.device)
    for d in digits.flip(0):
        acc = sw.jac_double(curve, acc)
        idx = (d.abs() >> 1).to(torch.int64)
        py = ty[:, idx]
        py = fp.select(d < 0, fp.neg(f, py), py)
        acc = sw.jac_add_mixed(curve, acc, AffinePoints(tx[:, idx], py, d == 0))
    return acc
