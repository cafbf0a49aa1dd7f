"""Fixed-base windowed batch scalar multiplication.

Counterpart of zkarray/ec/fixed_base.py: a table of outerc x 2^window
multiples of the base, built once on the host in Python ints (the rows
advanced together, one batched inversion per step), then per
scalar one table row gathered per window and the rows summed by a pairwise
tree of ``jac_add`` (field kernel launches on a CUDA device).
"""

from __future__ import annotations

import numpy as np
import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core import limbs as lb
from zkarray_torch.ec import sw
from zkarray_torch.ec.sw import AffinePoints, JacobianPoints, SWCurveSpec


def _host_add(p, q, a, mod):
    """Affine addition on the host (None = infinity)."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2 and (y1 + y2) % mod == 0:
        return None
    if p == q:
        lam = (3 * x1 * x1 + a) * pow(2 * y1, -1, mod) % mod
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, mod) % mod
    x3 = (lam * lam - x1 - x2) % mod
    return (x3, (lam * (x1 - x3) - y1) % mod)


def _batch_inv(vals, mod):
    """The inverses of nonzero ints mod ``mod`` with one pow (Montgomery's
    trick)."""
    pre = [1]
    for v in vals:
        pre.append(pre[-1] * v % mod)
    inv = pow(pre[-1], -1, mod)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = pre[i] * inv % mod
        inv = inv * vals[i] % mod
    return out


def _host_rows(starts, count: int, a: int, mod: int):
    """For each affine start g (not infinity, of order above count): the row
    [None, g, 2g, ..., (count - 1) g], the rows advanced together with one
    batched inversion per step. Each entry is the unique affine point, as
    _host_add's chain gives."""
    rows = [[None] for _ in starts]
    if count > 1:
        for row, g in zip(rows, starts):
            row.append(g)
    if count > 2:
        for row, g in zip(rows, starts):
            row.append(_host_add(g, g, a, mod))
    for _ in range(3, count):
        invs = _batch_inv([(g[0] - row[-1][0]) % mod for row, g in zip(rows, starts)], mod)
        for row, g, inv in zip(rows, starts, invs):
            x1, y1 = row[-1]
            lam = (g[1] - y1) * inv % mod
            x3 = (lam * lam - x1 - g[0]) % mod
            row.append((x3, (lam * (x1 - x3) - y1) % mod))
    return rows


def _mont_limbs(curve: SWCurveSpec, ints) -> np.ndarray:
    """Canonical ints -> their Montgomery-form limbs, (L, len(ints)) int32."""
    f = curve.base
    return lb.ints_to_limbs_np([f.to_mont_int(v) for v in ints], f.num_limbs).astype(np.int32)


class FixedBaseTable:
    def __init__(self, curve: SWCurveSpec, base_xy, window: int = 8, device=DEFAULT_DEVICE):
        """base_xy: (x, y) canonical ints of the base point. Row r of the
        table holds j 2^(r window) G for j < 2^window (j = 0: infinity)."""
        self.curve = curve
        self.window = window
        self.outerc = -(-curve.scalar.bits // window)
        a, mod = curve.a_int, curve.base.modulus
        starts = [base_xy]
        for _ in range(self.outerc - 1):
            g = starts[-1]
            for _ in range(window):
                g = _host_add(g, g, a, mod)
            starts.append(g)
        rows = _host_rows(starts, 1 << window, a, mod)
        L = curve.base.num_limbs
        pts = [pt for row in rows for pt in row]
        inf = np.asarray([pt is None for pt in pts], dtype=bool).reshape(self.outerc, 1 << window)
        shape = (L, self.outerc, 1 << window)
        self.tx = torch.from_numpy(_mont_limbs(curve, [0 if q is None else q[0] for q in pts])
                                   .reshape(shape)).to(device)
        self.ty = torch.from_numpy(_mont_limbs(curve, [0 if q is None else q[1] for q in pts])
                                   .reshape(shape)).to(device)
        self.tinf = torch.from_numpy(inf).to(device)

    def batch_mul(self, scalars: torch.Tensor) -> JacobianPoints:
        """scalars: canonical limbs (Ls, n) -> k_i G, batched."""
        return _apply_table(self.curve, self.tx, self.ty, self.tinf, scalars, self.window,
                            self.outerc)


def _apply_table(curve, tx, ty, tinf, scalars, window: int, outerc: int) -> JacobianPoints:
    """Window r's digit of every scalar (its bits r window .. across the
    16-bit limbs), the table rows gathered, then the pairwise jac_add tree."""
    Ls = scalars.shape[0]
    mask = (1 << window) - 1
    pts = []
    for r in range(outerc):
        limb, off = divmod(r * window, 16)
        raw = scalars[limb] >> off
        if off + window > 16 and limb + 1 < Ls:
            raw = raw | (scalars[limb + 1] << (16 - off))
        d = (raw & mask).to(torch.int64)
        pts.append(AffinePoints(tx[:, r, d], ty[:, r, d], tinf[r, d]))
    acc = [sw.from_affine(curve, p) for p in pts]
    while len(acc) > 1:
        nxt = [sw.jac_add(curve, acc[i], acc[i + 1]) for i in range(0, len(acc) - 1, 2)]
        if len(acc) % 2:
            nxt.append(acc[-1])
        acc = nxt
    return acc[0]
