"""Short-Weierstrass XYZZ group law, batched over planar limb tensors.

Counterpart of zkarray/ec/sw.py (the XYZZ subset: the MSM's ops and the
mixed add). The full add, the doubling and the mixed add are one fused
kernel launch each on a CUDA device (kernels/sw.py, csrc/xyzz.cu and
csrc/madd.cu); their plain versions, which the CPU takes, compute every
candidate and select with batch masks. Both keep the JAX package's formulas
and select order, so results match it bit for bit. Points are NamedTuples of
(L, *batch) int32 limb tensors. Infinity: XYZZ zz == 0 (canonically (1, 1, 0, 0) in Montgomery
form), affine an explicit bool mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core import limbs as lb
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ff import fp
from zkarray_torch.kernels import sw as ksw


class AffinePoints(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor  # bool, batch-shaped


class XYZZPoints(NamedTuple):
    """(X/ZZ, Y/ZZZ) with ZZ^3 == ZZZ^2."""

    x: torch.Tensor
    y: torch.Tensor
    zz: torch.Tensor
    zzz: torch.Tensor


class SWCurveSpec:
    """y^2 = x^3 + a x + b over ``base``; plain Python-int constants."""

    def __init__(self, name: str, base: FieldSpec, scalar: FieldSpec, a: int, b: int,
                 gen_x: int, gen_y: int, cofactor: int = 1):
        self.name = name
        self.base = base
        self.scalar = scalar
        self.a_int = a % base.modulus
        self.b_int = b % base.modulus
        self.gen_x = gen_x
        self.gen_y = gen_y
        self.cofactor = cofactor
        self.a_is_zero = self.a_int == 0

    def __hash__(self):
        return hash((self.name, self.base, self.scalar, self.a_int, self.b_int))

    def __eq__(self, other):
        return isinstance(other, SWCurveSpec) and (
            self.name, self.base, self.a_int, self.b_int
        ) == (other.name, other.base, other.a_int, other.b_int)

    def __repr__(self):
        return f"SWCurveSpec({self.name})"


def affine_from_ints(curve: SWCurveSpec, xys, device=DEFAULT_DEVICE) -> AffinePoints:
    """[(x, y) or None] -> AffinePoints batch (None = infinity)."""
    xs = [0 if p is None else p[0] for p in xys]
    ys = [0 if p is None else p[1] for p in xys]
    inf = torch.from_numpy(np.asarray([p is None for p in xys], dtype=bool)).to(device)
    return AffinePoints(fp.from_ints(curve.base, xs, device=device),
                        fp.from_ints(curve.base, ys, device=device), inf)


def affine_to_ints(curve: SWCurveSpec, pts: AffinePoints):
    """AffinePoints -> [(x, y) | None] host list."""
    xs = fp.to_ints(curve.base, pts.x)
    ys = fp.to_ints(curve.base, pts.y)
    inf = pts.inf.reshape(-1).cpu().numpy()
    return [None if i else (x, y) for x, y, i in zip(xs, ys, inf)]


# ---------------------------------------------------------------------------
# predicates and conversions
# ---------------------------------------------------------------------------

def xyzz_is_inf(P: XYZZPoints) -> torch.Tensor:
    return lb.is_zero(P.zz)


def xyzz_zero(curve: SWCurveSpec, batch_shape=(), device=DEFAULT_DEVICE) -> XYZZPoints:
    f = curve.base
    one = fp.one(f, batch_shape, device).contiguous()
    z = fp.zero(f, batch_shape, device)
    return XYZZPoints(one, one.clone(), z, z.clone())


def xyzz_from_affine(curve: SWCurveSpec, A: AffinePoints) -> XYZZPoints:
    f = curve.base
    batch = A.x.shape[1:]
    z = fp.select(A.inf, fp.zero(f, batch, A.x.device), fp.one(f, batch, A.x.device))
    return XYZZPoints(A.x, A.y, z, z)


def select_xyzz(mask, P: XYZZPoints, Q: XYZZPoints) -> XYZZPoints:
    return XYZZPoints(*(fp.select(mask, p, q) for p, q in zip(P, Q)))


def xyzz_to_affine(curve: SWCurveSpec, P: XYZZPoints) -> AffinePoints:
    f = curve.base
    x = fp.mont_mul(f, P.x, fp.batch_inv(f, P.zz))
    y = fp.mont_mul(f, P.y, fp.batch_inv(f, P.zzz))
    return AffinePoints(x, y, xyzz_is_inf(P))


# ---------------------------------------------------------------------------
# XYZZ formulas (EFD add-2008-s, dbl-2008-s-1)
# ---------------------------------------------------------------------------

def xyzz_add(curve: SWCurveSpec, P: XYZZPoints, Q: XYZZPoints) -> XYZZPoints:
    """Full XYZZ + XYZZ, edge-complete (zkarray/ec/sw.py:xyzz_add): the fused
    kernel kernels/sw.py:xyzz_add, one launch on a CUDA device, its plain
    version on the CPU."""
    return XYZZPoints(*ksw.xyzz_add(curve, P, Q))


def xyzz_add_affine(curve: SWCurveSpec, P: XYZZPoints, A: AffinePoints) -> XYZZPoints:
    """Bucket += affine point (mmadd-xyzz), edge-complete
    (zkarray/ec/sw.py:xyzz_add_affine): the fused kernel
    kernels/sw.py:xyzz_add_affine at every batch size on a CUDA device, its
    plain version on the CPU."""
    return XYZZPoints(*ksw.xyzz_add_affine(curve, P, A.x, A.y, A.inf))


def xyzz_double_affine(curve: SWCurveSpec, A: AffinePoints) -> XYZZPoints:
    """2·affine in XYZZ (mdbl-2008-s-1); infinity or y == 0 -> infinity
    (zkarray/ec/sw.py:xyzz_double_affine)."""
    f = curve.base
    X1, Y1 = A.x, A.y
    U = fp.double(f, Y1)
    V = fp.mont_sqr(f, U)
    W = fp.mont_mul(f, U, V)
    S = fp.mont_mul(f, X1, V)
    XX = fp.mont_sqr(f, X1)
    M = fp.add(f, fp.double(f, XX), XX)
    if not curve.a_is_zero:
        M = fp.add(f, M, fp.const_array(f, curve.a_int, (), X1.device))
    X3 = fp.sub(f, fp.mont_sqr(f, M), fp.double(f, S))
    Y3 = fp.sub(f, fp.mont_mul(f, M, fp.sub(f, S, X3)), fp.mont_mul(f, W, Y1))
    out = XYZZPoints(X3, Y3, V, W)
    bad = A.inf | fp.is_zero(f, Y1)
    return select_xyzz(bad, xyzz_zero(curve, X3.shape[1:], X3.device), out)


def xyzz_double(curve: SWCurveSpec, P: XYZZPoints) -> XYZZPoints:
    """dbl-2008-s-1; infinity or y == 0 -> infinity (zkarray/ec/sw.py:xyzz_double):
    the fused kernel kernels/sw.py:xyzz_double on a CUDA device, its plain
    version on the CPU."""
    return XYZZPoints(*ksw.xyzz_double(curve, P))
