"""Multi-device MSM: points sharded over the mesh, partial sums combined
through one all_gather.

Counterpart of zkarray/dist/msm.py. Each rank runs the port's whole
Pippenger pipeline (ec/msm.py:msm) on its contiguous shard of the points
and scalars, giving one partial XYZZ sum; the D partials are all_gathered
(D points: a few KB) and every rank reduces them with the JAX package's
halving tree, in its order and with its odd tail, so the replicated result
has the JAX package's words.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from zkarray_torch.dist.mesh import Mesh
from zkarray_torch.ec import msm as msm_mod
from zkarray_torch.ec import sw
from zkarray_torch.ec.sw import AffinePoints, SWCurveSpec, XYZZPoints


def tree_reduce(curve: SWCurveSpec, acc: XYZZPoints) -> XYZZPoints:
    """(L, D) partials -> one XYZZ point (coords (L,)): halve by adding the
    first h columns to the next h, an odd last column carried over
    (zkarray/dist/msm.py's tree)."""
    d = acc.x.shape[1]
    while d > 1:
        h = d // 2
        red = sw.xyzz_add(curve, XYZZPoints(*(s[:, :h] for s in acc)),
                          XYZZPoints(*(s[:, h:2 * h] for s in acc)))
        if d % 2:
            red = XYZZPoints(*(torch.cat([r, s[:, 2 * h:]], dim=1) for r, s in zip(red, acc)))
            d = h + 1
        else:
            d = h
        acc = red
    return XYZZPoints(*(s[:, 0] for s in acc))


def msm_sharded(curve: SWCurveSpec, points: AffinePoints, scalars: torch.Tensor, mesh: Mesh,
                c: Optional[int] = None, axis: str = "shards",
                max_scalar_bits: Optional[int] = None) -> XYZZPoints:
    """Σ scalars_i · points_i with the point axis sharded over ``mesh``.

    ``points`` and ``scalars`` are the whole arrays, the same on every rank
    (the scalars canonical limbs (Ls, n)); this rank takes columns
    [rank n/D, (rank + 1) n/D). Returns one XYZZ point (coords (L,)), the
    same on every rank. ``c`` and ``max_scalar_bits`` are ec/msm.py:msm's.
    """
    if axis != mesh.axis:
        raise ValueError(f"msm_sharded: the mesh's axis is {mesh.axis!r}, not {axis!r}")
    n = points.x.shape[1]
    if n % mesh.size:
        raise ValueError(f"point count {n} must divide by mesh size {mesh.size}")
    lo, hi = mesh.rank * (n // mesh.size), (mesh.rank + 1) * (n // mesh.size)
    local = msm_mod.msm(
        curve,
        AffinePoints(points.x[:, lo:hi].contiguous(), points.y[:, lo:hi].contiguous(),
                     points.inf[lo:hi].contiguous()),
        scalars[:, lo:hi].contiguous(), c, max_scalar_bits)
    mine = torch.stack(list(local))  # (4, L)
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine, group=mesh.group)
    acc = torch.stack(parts, dim=-1)  # (4, L, D), rank order
    return tree_reduce(curve, XYZZPoints(*acc.unbind(0)))
