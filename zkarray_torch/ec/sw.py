"""Short-Weierstrass group law, batched over planar limb tensors.

Counterpart of zkarray/ec/sw.py. XYZZ: the full add, the doubling and the
mixed add are one fused kernel launch each on a CUDA device (kernels/sw.py,
csrc/xyzz.cu and csrc/madd.cu); their plain versions, which the CPU takes,
compute every candidate and select with batch masks. Jacobian (dbl-2009-l
for a = 0, dbl-2007-bl otherwise, add-2007-bl, madd-2007-bl) and scalar
multiplication: chains of ff/fp.py calls, each product a mont_mul or
mont_sqr launch on a CUDA device. Every routine keeps the JAX package's
formulas and select order, so results match it bit for bit, infinity's
non-canonical words included. Points are NamedTuples of (L, *batch) int32
limb tensors. Infinity: Jacobian z == 0, XYZZ zz == 0 (canonically
(1, 1, 0, 0) in Montgomery form), affine an explicit bool mask.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core import limbs as lb
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ff import fp
from zkarray_torch.kernels import mont as km
from zkarray_torch.kernels import sw as ksw


class AffinePoints(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor  # bool, batch-shaped


class JacobianPoints(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor  # z == 0 encodes infinity


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

    def generator(self, batch_shape=(), device=DEFAULT_DEVICE) -> AffinePoints:
        return AffinePoints(fp.const_array(self.base, self.gen_x, batch_shape, device),
                            fp.const_array(self.base, self.gen_y, batch_shape, device),
                            torch.zeros(tuple(batch_shape), dtype=torch.bool, device=device))

    def affine_from_ints(self, xys, device=DEFAULT_DEVICE) -> "AffinePoints":
        """[(x, y) or None] -> AffinePoints batch (None = infinity)."""
        return affine_from_ints(self, xys, device)

    def affine_to_ints(self, pts: "AffinePoints"):
        """AffinePoints -> [(x, y) | None] host list."""
        return affine_to_ints(self, pts)


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

def jac_is_inf(P: JacobianPoints) -> torch.Tensor:
    return lb.is_zero(P.z)


def jac_zero(curve: SWCurveSpec, batch_shape=(), device=DEFAULT_DEVICE) -> JacobianPoints:
    f = curve.base
    one = fp.one(f, batch_shape, device)
    return JacobianPoints(one, one, fp.zero(f, batch_shape, device))


def from_affine(curve: SWCurveSpec, A: AffinePoints) -> JacobianPoints:
    f = curve.base
    batch = A.x.shape[1:]
    z = fp.select(A.inf, fp.zero(f, batch, A.x.device), fp.one(f, batch, A.x.device))
    return JacobianPoints(A.x, A.y, z)


def select_jac(mask, P: JacobianPoints, Q: JacobianPoints) -> JacobianPoints:
    return JacobianPoints(*(fp.select(mask, p, q) for p, q in zip(P, Q)))


def to_affine(curve: SWCurveSpec, P: JacobianPoints) -> AffinePoints:
    """Jacobian -> affine through one batch inversion (infinity maps to
    (0, 0) with its mask set)."""
    f = curve.base
    zinv = fp.batch_inv(f, P.z)
    zinv2 = fp.mont_sqr(f, zinv)
    x = fp.mont_mul(f, P.x, zinv2)
    y = fp.mont_mul(f, P.y, fp.mont_mul(f, zinv, zinv2))
    return AffinePoints(x, y, jac_is_inf(P))


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
    """(X / ZZ, Y / ZZZ), (0, 0) at infinity (zkarray/ec/sw.py:
    xyzz_to_affine): kernels/mont.py:mont_div, one launch for both
    coordinates of every point on a CUDA device; on the CPU its plain
    version, the JAX package's products by two batch inverses."""
    xy = km.mont_div(curve.base, P.x, P.zz, P.y, P.zzz)
    return AffinePoints(xy[0], xy[1], xyzz_is_inf(P))


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


# ---------------------------------------------------------------------------
# Jacobian formulas (zkarray/ec/sw.py:186-298)
# ---------------------------------------------------------------------------

def jac_double(curve: SWCurveSpec, P: JacobianPoints) -> JacobianPoints:
    """Doubling; infinity and 2-torsion give z3 = 0. a == 0: dbl-2009-l;
    general a: dbl-2007-bl."""
    f = curve.base
    X1, Y1, Z1 = P
    dbl = functools.partial(fp.double, f)
    if curve.a_is_zero:
        A = fp.mont_sqr(f, X1)
        B = fp.mont_sqr(f, Y1)
        C = fp.mont_sqr(f, B)
        D = dbl(fp.sub(f, fp.sub(f, fp.mont_sqr(f, fp.add(f, X1, B)), A), C))
        E = fp.add(f, dbl(A), A)
        X3 = fp.sub(f, fp.mont_sqr(f, E), dbl(D))
        Y3 = fp.sub(f, fp.mont_mul(f, E, fp.sub(f, D, X3)), dbl(dbl(dbl(C))))
        return JacobianPoints(X3, Y3, dbl(fp.mont_mul(f, Y1, Z1)))
    XX = fp.mont_sqr(f, X1)
    YY = fp.mont_sqr(f, Y1)
    YYYY = fp.mont_sqr(f, YY)
    ZZ = fp.mont_sqr(f, Z1)
    S = dbl(fp.sub(f, fp.sub(f, fp.mont_sqr(f, fp.add(f, X1, YY)), XX), YYYY))
    a_c = fp.const_array(f, curve.a_int, (), X1.device)
    M = fp.add(f, fp.add(f, dbl(XX), XX), fp.mont_mul(f, a_c, fp.mont_sqr(f, ZZ)))
    X3 = fp.sub(f, fp.mont_sqr(f, M), dbl(S))
    Y3 = fp.sub(f, fp.mont_mul(f, M, fp.sub(f, S, X3)), dbl(dbl(dbl(YYYY))))
    Z3 = fp.sub(f, fp.sub(f, fp.mont_sqr(f, fp.add(f, Y1, Z1)), YY), ZZ)
    return JacobianPoints(X3, Y3, Z3)


def jac_add(curve: SWCurveSpec, P: JacobianPoints, Q: JacobianPoints) -> JacobianPoints:
    """add-2007-bl for every lane, then the doubling, infinity, P and Q
    selected in the JAX package's order (the last select wins)."""
    f = curve.base
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = fp.mont_sqr(f, Z1)
    Z2Z2 = fp.mont_sqr(f, Z2)
    U1 = fp.mont_mul(f, X1, Z2Z2)
    U2 = fp.mont_mul(f, X2, Z1Z1)
    S1 = fp.mont_mul(f, Y1, fp.mont_mul(f, Z2, Z2Z2))
    S2 = fp.mont_mul(f, Y2, fp.mont_mul(f, Z1, Z1Z1))
    H = fp.sub(f, U2, U1)
    r = fp.double(f, fp.sub(f, S2, S1))
    I = fp.mont_sqr(f, fp.double(f, H))  # noqa: E741
    J = fp.mont_mul(f, H, I)
    V = fp.mont_mul(f, U1, I)
    X3 = fp.sub(f, fp.sub(f, fp.mont_sqr(f, r), J), fp.double(f, V))
    Y3 = fp.sub(f, fp.mont_mul(f, r, fp.sub(f, V, X3)), fp.double(f, fp.mont_mul(f, S1, J)))
    Z3 = fp.mont_mul(f, fp.sub(f, fp.sub(f, fp.mont_sqr(f, fp.add(f, Z1, Z2)), Z1Z1), Z2Z2), H)
    return _edge_selects(curve, P, JacobianPoints(X3, Y3, Z3), H, r, jac_is_inf(Q), Q)


def jac_add_mixed(curve: SWCurveSpec, P: JacobianPoints, A: AffinePoints) -> JacobianPoints:
    """madd-2007-bl (Z2 = 1) for every lane, then the edge selects as in
    jac_add."""
    f = curve.base
    X1, Y1, Z1 = P
    Z1Z1 = fp.mont_sqr(f, Z1)
    U2 = fp.mont_mul(f, A.x, Z1Z1)
    S2 = fp.mont_mul(f, A.y, fp.mont_mul(f, Z1, Z1Z1))
    H = fp.sub(f, U2, X1)
    r = fp.double(f, fp.sub(f, S2, Y1))
    HH = fp.mont_sqr(f, H)
    I = fp.double(f, fp.double(f, HH))  # noqa: E741
    J = fp.mont_mul(f, H, I)
    V = fp.mont_mul(f, X1, I)
    X3 = fp.sub(f, fp.sub(f, fp.mont_sqr(f, r), J), fp.double(f, V))
    Y3 = fp.sub(f, fp.mont_mul(f, r, fp.sub(f, V, X3)), fp.double(f, fp.mont_mul(f, Y1, J)))
    Z3 = fp.sub(f, fp.sub(f, fp.mont_sqr(f, fp.add(f, Z1, H)), Z1Z1), HH)
    return _edge_selects(curve, P, JacobianPoints(X3, Y3, Z3), H, r, A.inf, from_affine(curve, A))


def _edge_selects(curve, P, R, H, r, q_inf, Q):
    """P == Q: the doubling; P == -Q: infinity; P at infinity: Q; Q at
    infinity: P (zkarray/ec/sw.py:253-261 and :287-294)."""
    f = curve.base
    h0, r0 = fp.is_zero(f, H), fp.is_zero(f, r)
    p_inf = jac_is_inf(P)
    both = ~p_inf & ~q_inf
    R = select_jac(both & h0 & r0, jac_double(curve, P), R)
    R = select_jac(both & h0 & ~r0, jac_zero(curve, P.x.shape[1:], P.x.device), R)
    R = select_jac(p_inf, Q, R)
    return select_jac(q_inf, P, R)


def jac_neg(curve: SWCurveSpec, P: JacobianPoints) -> JacobianPoints:
    return JacobianPoints(P.x, fp.neg(curve.base, P.y), P.z)


# ---------------------------------------------------------------------------
# curve predicates and scalar multiplication (zkarray/ec/sw.py:435-510)
# ---------------------------------------------------------------------------

def is_on_curve(curve: SWCurveSpec, A: AffinePoints) -> torch.Tensor:
    """y^2 == x^3 + a x + b; infinity counts as on the curve."""
    f = curve.base
    dev = A.x.device
    y2 = fp.mont_sqr(f, A.y)
    rhs = fp.add(f, fp.mont_mul(f, fp.mont_sqr(f, A.x), A.x),
                 fp.const_array(f, curve.b_int, A.x.shape[1:], dev))
    if not curve.a_is_zero:
        rhs = fp.add(f, rhs, fp.mont_mul(f, fp.const_array(f, curve.a_int, (), dev), A.x))
    return fp.eq(y2, rhs) | A.inf


def scalar_bits(scalars: torch.Tensor, nbits: int) -> torch.Tensor:
    """(nbits, *batch) bool bits of canonical (Ls, *batch) scalar limbs,
    most significant first."""
    i = torch.arange(nbits - 1, -1, -1, device=scalars.device)
    idx = (i // 16).reshape((nbits,) + (1,) * (scalars.dim() - 1)).expand(
        (nbits,) + tuple(scalars.shape[1:]))
    shift = (i % 16).reshape((nbits,) + (1,) * (scalars.dim() - 1))
    return ((scalars.to(torch.int64).gather(0, idx) >> shift) & 1).bool()


def scalar_mul(curve: SWCurveSpec, A: AffinePoints, scalars: torch.Tensor) -> JacobianPoints:
    """Per-element k_i P_i by double-and-add over the scalar limbs' 16 Ls
    bits, most significant first. ``scalars``: canonical (not Montgomery)
    (Ls, *batch) limbs of the scalar field."""
    acc = jac_zero(curve, A.x.shape[1:], A.x.device)
    for b in scalar_bits(scalars, curve.scalar.num_limbs * 16):
        acc = jac_double(curve, acc)
        acc = select_jac(b, jac_add_mixed(curve, acc, A), acc)
    return acc


def scalar_mul_const(curve: SWCurveSpec, P: JacobianPoints, k: int) -> JacobianPoints:
    """k P for a Python-int k (negative: the negated multiple; zero:
    infinity). Double-and-add over |k|'s bits, most significant first; a
    clear bit keeps the doubling, as the JAX package's select of it does,
    so no add is computed there."""
    if k == 0:
        return jac_zero(curve, P.x.shape[1:], P.x.device)
    acc = jac_zero(curve, P.x.shape[1:], P.x.device)
    for bit in bin(abs(k))[2:]:
        acc = jac_double(curve, acc)
        if bit == "1":
            acc = jac_add(curve, acc, P)
    return jac_neg(curve, acc) if k < 0 else acc


def clear_cofactor(curve: SWCurveSpec, A: AffinePoints) -> JacobianPoints:
    return scalar_mul_const(curve, from_affine(curve, A), curve.cofactor)


def subgroup_check(curve: SWCurveSpec, A: AffinePoints) -> torch.Tensor:
    """Generic check r P == infinity."""
    return jac_is_inf(scalar_mul_const(curve, from_affine(curve, A), curve.scalar.modulus))
