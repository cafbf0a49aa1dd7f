"""Streaming MSM: chunked inputs, a buffered point stream, and a stream
coalesced by base point.

Counterpart of zkarray/ec/stream_msm.py. ``msm_chunks`` carries one
ChunkedMSM bucket state (ec/msm.py) across chunks at most as wide as the
first, so the reduction is paid once; a wider chunk runs a whole msm whose
sum is added in. ``ChunkedPippenger`` buffers points on the host and runs
an msm per full buffer; ``HashMapPippenger`` sums the scalars of equal
bases on the host before one msm. The MSM kernels carry every flush.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.ec import msm as msm_mod
from zkarray_torch.ec import sw
from zkarray_torch.ec.sw import AffinePoints, SWCurveSpec, XYZZPoints
from zkarray_torch.ff import fp


def _xyzz_sum(curve: SWCurveSpec, a: XYZZPoints, b: XYZZPoints) -> XYZZPoints:
    """a + b for two single XYZZ points (coords (L,))."""
    merged = sw.xyzz_add(curve, XYZZPoints(*(v[..., None] for v in a)),
                         XYZZPoints(*(v[..., None] for v in b)))
    return XYZZPoints(*(v[..., 0] for v in merged))


def msm_chunks(curve: SWCurveSpec, chunk_iter: Iterable[Tuple[AffinePoints, torch.Tensor]],
               c: Optional[int] = None, device=DEFAULT_DEVICE) -> XYZZPoints:
    """MSM over a stream of (points, scalars) chunks: one XYZZ point."""
    cm = None
    extra = None
    for pts, scalars in chunk_iter:
        n = pts.x.shape[1]
        if cm is None:
            cm = msm_mod.ChunkedMSM(curve, chunk_size=n, c=c, device=pts.x.device)
        if n <= cm.chunk_size:
            cm.add_chunk(pts, scalars)
            continue
        part = msm_mod.msm(curve, pts, scalars, cm.c)
        extra = part if extra is None else _xyzz_sum(curve, extra, part)
    if cm is None:
        return sw.xyzz_zero(curve, (), device)
    total = cm.result()
    return total if extra is None else _xyzz_sum(curve, total, extra)


class ChunkedPippenger:
    """Points buffered on the host; each full buffer (and the rest at the
    end) one msm on ``device``, the partial sums added."""

    def __init__(self, curve: SWCurveSpec, chunk_size: int = 1 << 20, c=None,
                 device=DEFAULT_DEVICE):
        self.curve = curve
        self.chunk_size = chunk_size
        self.c = c
        self.device = device
        self._pts: list = []
        self._scalars: list = []
        self.total = None

    def add(self, point_xy, scalar_int: int):
        self._pts.append(point_xy)
        self._scalars.append(int(scalar_int))
        if len(self._pts) >= self.chunk_size:
            self._flush()

    def _flush(self):
        if not self._pts:
            return
        A = sw.affine_from_ints(self.curve, self._pts, self.device)
        s = fp.from_ints(self.curve.scalar, self._scalars, mont=False, device=self.device)
        part = msm_mod.msm(self.curve, A, s, self.c)
        self.total = part if self.total is None else _xyzz_sum(self.curve, self.total, part)
        self._pts, self._scalars = [], []

    def finalize(self) -> XYZZPoints:
        self._flush()
        return self.total if self.total is not None else sw.xyzz_zero(self.curve, (), self.device)


class HashMapPippenger:
    """Scalars of equal base points summed on the host, then one msm."""

    def __init__(self, curve: SWCurveSpec, c=None, device=DEFAULT_DEVICE):
        self.curve = curve
        self.c = c
        self.device = device
        self._acc = {}

    def add(self, point_xy, scalar_int: int):
        self._acc[point_xy] = (self._acc.get(point_xy, 0) + int(scalar_int)) % self.curve.scalar.modulus

    def finalize(self) -> XYZZPoints:
        if not self._acc:
            return sw.xyzz_zero(self.curve, (), self.device)
        pts = list(self._acc.keys())
        A = sw.affine_from_ints(self.curve, pts, self.device)
        s = fp.from_ints(self.curve.scalar, [self._acc[p] for p in pts], mont=False,
                         device=self.device)
        return msm_mod.msm(self.curve, A, s, self.c)
