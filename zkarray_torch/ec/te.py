"""Twisted Edwards curves a x^2 + y^2 = 1 + d x^2 y^2 in extended coordinates.

Counterpart of zkarray/ec/te.py: extended (X, Y, T, Z) with T = X Y / Z and
the complete add-2008-hwcd / dbl-2008-hwcd formulas, so no lane needs an
edge mask (identity = (0, 1)). Each field op is an ff/fp.py call: a product
is one mont_mul or mont_sqr launch, a linear op one fp_add or fp_sub launch
on a CUDA device. The formulas keep the JAX package's operation order
(a A as a negation when a = -1), so extended words match it bit for bit.

The spec also carries the birational Montgomery coefficients that
ec/h2c/elligator2.py maps through.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ec.sw import scalar_bits
from zkarray_torch.ff import fp


class TEAffine(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor  # identity = (0, 1): no infinity flag


class TEExtended(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    t: torch.Tensor  # t = x y / z
    z: torch.Tensor


class TECurveSpec:
    """a x^2 + y^2 = 1 + d x^2 y^2 over ``base``; plain Python-int constants."""

    def __init__(self, name: str, base: FieldSpec, scalar: FieldSpec, a: int, d: int,
                 gen_x: int, gen_y: int, cofactor: int = 1,
                 mont_coeff_a: Optional[int] = None, mont_coeff_b: Optional[int] = None):
        self.name = name
        self.base = base
        self.scalar = scalar
        self.a_int = a % base.modulus
        self.d_int = d % base.modulus
        self.gen_x = gen_x
        self.gen_y = gen_y
        self.cofactor = cofactor
        self.mont_coeff_a = mont_coeff_a
        self.mont_coeff_b = mont_coeff_b
        self.a_is_minus_one = self.a_int == base.modulus - 1

    def __hash__(self):
        return hash((self.name, self.base, self.a_int, self.d_int))

    def __eq__(self, o):
        return isinstance(o, TECurveSpec) and (o.name, o.a_int, o.d_int) == (
            self.name, self.a_int, self.d_int)

    def __repr__(self):
        return f"TECurveSpec({self.name})"

    def generator(self, batch_shape=(), device=DEFAULT_DEVICE) -> TEAffine:
        return TEAffine(fp.const_array(self.base, self.gen_x, batch_shape, device),
                        fp.const_array(self.base, self.gen_y, batch_shape, device))

    def affine_from_ints(self, xys, device=DEFAULT_DEVICE) -> TEAffine:
        return TEAffine(fp.from_ints(self.base, [p[0] for p in xys], device=device),
                        fp.from_ints(self.base, [p[1] for p in xys], device=device))

    def affine_to_ints(self, pts: TEAffine):
        return list(zip(fp.to_ints(self.base, pts.x), fp.to_ints(self.base, pts.y)))


def zero(spec: TECurveSpec, batch_shape=(), device=DEFAULT_DEVICE) -> TEExtended:
    f = spec.base
    return TEExtended(fp.zero(f, batch_shape, device), fp.one(f, batch_shape, device),
                      fp.zero(f, batch_shape, device), fp.one(f, batch_shape, device))


def from_affine(spec: TECurveSpec, A: TEAffine) -> TEExtended:
    f = spec.base
    return TEExtended(A.x, A.y, fp.mont_mul(f, A.x, A.y), fp.one(f, A.x.shape[1:], A.x.device))


def is_zero(spec: TECurveSpec, P: TEExtended) -> torch.Tensor:
    """(0 : z : 0 : z) with z != 0."""
    return fp.is_zero(spec.base, P.x) & fp.eq(P.y, P.z)


def _mul_a(spec: TECurveSpec, x: torch.Tensor) -> torch.Tensor:
    f = spec.base
    if spec.a_is_minus_one:
        return fp.neg(f, x)
    return fp.mont_mul(f, fp.const_array(f, spec.a_int, (), x.device), x)


def add(spec: TECurveSpec, P: TEExtended, Q: TEExtended) -> TEExtended:
    """Complete extended addition add-2008-hwcd (zkarray/ec/te.py:119)."""
    f = spec.base
    dev = P.x.device
    A = fp.mont_mul(f, P.x, Q.x)
    B = fp.mont_mul(f, P.y, Q.y)
    C = fp.mont_mul(f, fp.mont_mul(f, P.t, Q.t), fp.const_array(f, spec.d_int, (), dev))
    D = fp.mont_mul(f, P.z, Q.z)
    E = fp.sub(f, fp.sub(f, fp.mont_mul(f, fp.add(f, P.x, P.y), fp.add(f, Q.x, Q.y)), A), B)
    F = fp.sub(f, D, C)
    G = fp.add(f, D, C)
    H = fp.sub(f, B, _mul_a(spec, A))
    return TEExtended(fp.mont_mul(f, E, F), fp.mont_mul(f, G, H), fp.mont_mul(f, E, H),
                      fp.mont_mul(f, F, G))


def add_mixed(spec: TECurveSpec, P: TEExtended, A2: TEAffine) -> TEExtended:
    """Mixed addition (Z2 = 1, T2 = x2 y2)."""
    return add(spec, P, from_affine(spec, A2))


def double(spec: TECurveSpec, P: TEExtended) -> TEExtended:
    """dbl-2008-hwcd (zkarray/ec/te.py:152)."""
    f = spec.base
    A = fp.mont_sqr(f, P.x)
    B = fp.mont_sqr(f, P.y)
    C = fp.double(f, fp.mont_sqr(f, P.z))
    D = _mul_a(spec, A)
    E = fp.sub(f, fp.sub(f, fp.mont_sqr(f, fp.add(f, P.x, P.y)), A), B)
    G = fp.add(f, D, B)
    F = fp.sub(f, G, C)
    H = fp.sub(f, D, B)
    return TEExtended(fp.mont_mul(f, E, F), fp.mont_mul(f, G, H), fp.mont_mul(f, E, H),
                      fp.mont_mul(f, F, G))


def neg(spec: TECurveSpec, P: TEExtended) -> TEExtended:
    f = spec.base
    return TEExtended(fp.neg(f, P.x), P.y, fp.neg(f, P.t), P.z)


def _sel(mask, P: TEExtended, Q: TEExtended) -> TEExtended:
    return TEExtended(*(fp.select(mask, p, q) for p, q in zip(P, Q)))


def to_affine(spec: TECurveSpec, P: TEExtended) -> TEAffine:
    f = spec.base
    zinv = fp.batch_inv(f, P.z)
    return TEAffine(fp.mont_mul(f, P.x, zinv), fp.mont_mul(f, P.y, zinv))


def is_on_curve(spec: TECurveSpec, A: TEAffine) -> torch.Tensor:
    """a x^2 + y^2 == 1 + d x^2 y^2."""
    f = spec.base
    dev = A.x.device
    x2 = fp.mont_sqr(f, A.x)
    y2 = fp.mont_sqr(f, A.y)
    lhs = fp.add(f, _mul_a(spec, x2), y2)
    rhs = fp.add(f, fp.one(f, A.x.shape[1:], dev),
                 fp.mont_mul(f, fp.const_array(f, spec.d_int, (), dev), fp.mont_mul(f, x2, y2)))
    return fp.eq(lhs, rhs)


def scalar_mul(spec: TECurveSpec, A: TEAffine, scalars: torch.Tensor) -> TEExtended:
    """Per-element k_i P_i over canonical scalar limbs (Ls, *batch): one
    doubling and one full add a bit, num_limbs * 16 bits, the add's result
    kept where the bit is set (zkarray/ec/te.py:216)."""
    Q = from_affine(spec, A)
    acc = zero(spec, A.x.shape[1:], A.x.device)
    for b in scalar_bits(scalars, spec.scalar.num_limbs * 16):
        acc = double(spec, acc)
        acc = _sel(b, add(spec, acc, Q), acc)
    return acc


def scalar_mul_const(spec: TECurveSpec, P: TEExtended, k: int) -> TEExtended:
    """k P for a Python-int k (negative: the negated multiple). A clear bit
    keeps the doubling, as the JAX package's select does, so no add is
    computed there."""
    acc = zero(spec, P.x.shape[1:], P.x.device)
    if k == 0:
        return acc
    for bit in bin(abs(k))[2:]:
        acc = double(spec, acc)
        if bit == "1":
            acc = add(spec, acc, P)
    return neg(spec, acc) if k < 0 else acc
