"""Double-odd curves y^2 = x (x^2 + a x + b) in (e, u) coordinates (jq255s).

Counterpart of zkarray/ec/double_odd.py. A group element is the pair
{P, P + N} (N the 2-torsion point); affine (e, u) with identity (1, 0),
projective (E : Z : U : T) with e = E/Z, u = U/Z, T = U^2/Z. The doubling
and additions are complete (no edge masks). Each field op is an ff/fp.py
call, one kernel launch on a CUDA device, in the JAX package's order, so
the projective words match it bit for bit. Curve constant c = a^2 - 4b.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ec.sw import scalar_bits
from zkarray_torch.ff import fp


class DOAffine(NamedTuple):
    e: torch.Tensor
    u: torch.Tensor  # identity = (1, 0): no infinity flag


class DOProjective(NamedTuple):
    e: torch.Tensor
    z: torch.Tensor
    u: torch.Tensor
    t: torch.Tensor  # T = U^2 / Z


class DOCurveSpec:
    def __init__(self, name: str, base: FieldSpec, scalar: FieldSpec, a: int, b: int,
                 gen_e: int, gen_u: int, cofactor: int = 2):
        self.name = name
        self.base = base
        self.scalar = scalar
        p = base.modulus
        self.a_int = a % p
        self.b_int = b % p
        self.c_int = (self.a_int * self.a_int - 4 * self.b_int) % p
        self.gen_e = gen_e % p
        self.gen_u = gen_u % p
        self.cofactor = cofactor
        self.cofactor_inv = pow(cofactor, -1, scalar.modulus)

    def __hash__(self):
        return hash((self.name, self.base, self.a_int, self.b_int))

    def __eq__(self, o):
        return isinstance(o, DOCurveSpec) and (o.name, o.a_int, o.b_int) == (
            self.name, self.a_int, self.b_int)

    def __repr__(self):
        return f"DOCurveSpec({self.name})"

    def generator(self, batch_shape=(), device=DEFAULT_DEVICE) -> DOAffine:
        return DOAffine(fp.const_array(self.base, self.gen_e, batch_shape, device),
                        fp.const_array(self.base, self.gen_u, batch_shape, device))

    def affine_from_ints(self, eus, device=DEFAULT_DEVICE) -> DOAffine:
        return DOAffine(fp.from_ints(self.base, [p[0] for p in eus], device=device),
                        fp.from_ints(self.base, [p[1] for p in eus], device=device))

    def affine_to_ints(self, pts: DOAffine):
        return list(zip(fp.to_ints(self.base, pts.e), fp.to_ints(self.base, pts.u)))


def zero(spec: DOCurveSpec, batch_shape=(), device=DEFAULT_DEVICE) -> DOProjective:
    """The identity representative O = (1 : 1 : 0 : 0)."""
    f = spec.base
    one = fp.one(f, batch_shape, device)
    z = fp.zero(f, batch_shape, device)
    return DOProjective(one, one, z, z)


def from_affine(spec: DOCurveSpec, A: DOAffine) -> DOProjective:
    f = spec.base
    return DOProjective(A.e, fp.one(f, A.e.shape[1:], A.e.device), A.u, fp.mont_sqr(f, A.u))


def is_zero(spec: DOCurveSpec, P: DOProjective) -> torch.Tensor:
    """U = 0 for both identity representatives."""
    return fp.is_zero(spec.base, P.u)


def _mul_a(spec: DOCurveSpec, x: torch.Tensor) -> torch.Tensor:
    f = spec.base
    if spec.a_int == f.modulus - 1:
        return fp.neg(f, x)
    if spec.a_int == 0:
        return fp.zero(f, x.shape[1:], x.device)
    return fp.mont_mul(f, fp.const_array(f, spec.a_int, (), x.device), x)


def _mul_c(spec: DOCurveSpec, x: torch.Tensor) -> torch.Tensor:
    return fp.mont_mul(spec.base, fp.const_array(spec.base, spec.c_int, (), x.device), x)


def double(spec: DOCurveSpec, P: DOProjective) -> DOProjective:
    """Complete doubling (zkarray/ec/double_odd.py:131)."""
    f = spec.base
    ee = fp.mont_sqr(f, P.e)
    w = fp.sub(f, fp.add(f, ee, fp.double(f, _mul_a(spec, fp.mont_sqr(f, P.u)))),
               fp.double(f, _mul_c(spec, fp.mont_sqr(f, P.t))))  # E^2 + 2a U^2 - 2c T^2
    j = fp.double(f, fp.mont_mul(f, P.e, P.u))  # 2 E U
    t2 = fp.mont_sqr(f, j)
    u2 = fp.mont_mul(f, j, w)
    z2 = fp.mont_sqr(f, w)
    x2 = fp.double(f, fp.mont_sqr(f, ee))  # 2 E^4
    e2 = fp.add(f, fp.sub(f, x2, z2), _mul_a(spec, t2))
    return DOProjective(e2, z2, u2, t2)


def _finish_add(spec, n1, n2, n3, n4, n5, n6):
    f = spec.base
    cn4 = _mul_c(spec, n4)
    n7 = fp.sub(f, n2, cn4)
    n3d = fp.double(f, n3)
    e = fp.add(f, fp.mont_mul(f, fp.add(f, n2, cn4), fp.sub(f, n1, _mul_a(spec, n3d))),
               _mul_c(spec, fp.mont_mul(f, n3d, n5)))
    return DOProjective(e, fp.mont_sqr(f, n7), fp.mont_mul(f, n7, n6), fp.mont_sqr(f, n6))


def add(spec: DOCurveSpec, P: DOProjective, Q: DOProjective) -> DOProjective:
    """Complete projective addition, Algorithm 3 of doubleodd-jq
    (zkarray/ec/double_odd.py:151)."""
    f = spec.base
    n1 = fp.mont_mul(f, P.e, Q.e)
    n2 = fp.mont_mul(f, P.z, Q.z)
    n3 = fp.mont_mul(f, P.u, Q.u)
    n4 = fp.mont_mul(f, P.t, Q.t)
    n5 = fp.sub(f, fp.sub(f, fp.mont_mul(f, fp.add(f, P.z, P.t), fp.add(f, Q.z, Q.t)), n2), n4)
    n6 = fp.sub(f, fp.sub(f, fp.mont_mul(f, fp.add(f, P.e, P.u), fp.add(f, Q.e, Q.u)), n1), n3)
    return _finish_add(spec, n1, n2, n3, n4, n5, n6)


def add_mixed(spec: DOCurveSpec, P: DOProjective, A2: DOAffine) -> DOProjective:
    """Mixed addition, Z2 = 1 and T2 = u2^2 (zkarray/ec/double_odd.py:191)."""
    f = spec.base
    ot = fp.mont_sqr(f, A2.u)
    n1 = fp.mont_mul(f, P.e, A2.e)
    n2 = P.z
    n3 = fp.mont_mul(f, P.u, A2.u)
    n4 = fp.mont_mul(f, P.t, ot)
    n5 = fp.add(f, fp.mont_mul(f, P.z, ot), P.t)
    n6 = fp.sub(f, fp.sub(f, fp.mont_mul(f, fp.add(f, P.e, P.u), fp.add(f, A2.e, A2.u)), n1), n3)
    return _finish_add(spec, n1, n2, n3, n4, n5, n6)


def neg(spec: DOCurveSpec, P: DOProjective) -> DOProjective:
    return DOProjective(P.e, P.z, fp.neg(spec.base, P.u), P.t)


def neg_affine(spec: DOCurveSpec, A: DOAffine) -> DOAffine:
    return DOAffine(A.e, fp.neg(spec.base, A.u))


def _sel(mask, P: DOProjective, Q: DOProjective) -> DOProjective:
    return DOProjective(*(fp.select(mask, a, b) for a, b in zip(P, Q)))


def to_affine(spec: DOCurveSpec, P: DOProjective) -> DOAffine:
    """One batch inversion of Z (never 0); the identity maps to (1, 0)."""
    f = spec.base
    zinv = fp.batch_inv(f, P.z)
    e = fp.mont_mul(f, P.e, zinv)
    u = fp.mont_mul(f, P.u, zinv)
    idm = is_zero(spec, P)
    batch, dev = e.shape[1:], e.device
    return DOAffine(fp.select(idm, fp.one(f, batch, dev), e),
                    fp.select(idm, fp.zero(f, batch, dev), u))


def _e_squared(spec: DOCurveSpec, u: torch.Tensor) -> torch.Tensor:
    """c u^4 - 2a u^2 + 1."""
    f = spec.base
    u2 = fp.mont_sqr(f, u)
    return fp.add(f, fp.sub(f, _mul_c(spec, fp.mont_sqr(f, u2)), fp.double(f, _mul_a(spec, u2))),
                  fp.one(f, u.shape[1:], u.device))


def is_on_curve(spec: DOCurveSpec, A: DOAffine) -> torch.Tensor:
    """e^2 == c u^4 - 2a u^2 + 1."""
    rhs = _e_squared(spec, A.u)
    return fp.eq(fp.mont_sqr(spec.base, A.e), rhs)


def get_e_from_u(spec: DOCurveSpec, u: torch.Tensor):
    """e = sqrt(c u^4 - 2a u^2 + 1): (e, ok mask) (zkarray/ec/double_odd.py:263)."""
    return fp.sqrt(spec.base, _e_squared(spec, u))


def scalar_mul(spec: DOCurveSpec, A: DOAffine, scalars: torch.Tensor) -> DOProjective:
    """Per-element k_i P_i over canonical scalar limbs (Ls, *batch): one
    doubling and one mixed add a bit, num_limbs * 16 bits, the add's result
    kept where the bit is set."""
    acc = zero(spec, A.e.shape[1:], A.e.device)
    for b in scalar_bits(scalars, spec.scalar.num_limbs * 16):
        acc = double(spec, acc)
        acc = _sel(b, add_mixed(spec, acc, A), acc)
    return acc


def scalar_mul_const(spec: DOCurveSpec, P: DOProjective, k: int) -> DOProjective:
    """k P for a Python-int k (negative: the negated multiple); a clear bit
    keeps the doubling, so no add is computed there."""
    acc = zero(spec, P.e.shape[1:], P.e.device)
    if k == 0:
        return acc
    for bit in bin(abs(k))[2:]:
        acc = double(spec, acc)
        if bit == "1":
            acc = add(spec, acc, P)
    return neg(spec, acc) if k < 0 else acc


def eq_points(spec: DOCurveSpec, P: DOProjective, Q: DOProjective) -> torch.Tensor:
    """e1 u2 == e2 u1 for non-identity points; identities compare by U = 0."""
    f = spec.base
    pz, qz = is_zero(spec, P), is_zero(spec, Q)
    cross = fp.eq(fp.mont_mul(f, P.e, Q.u), fp.mont_mul(f, Q.e, P.u))
    return torch.where(pz | qz, pz & qz, cross)
