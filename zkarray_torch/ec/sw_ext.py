"""Short-Weierstrass group law over any field of the tower (G2 over Fp2).

Counterpart of zkarray/ec/sw_ext.py: Jacobian coordinates with the same
EFD formulas (dbl-2009-l for a = 0, the a-term otherwise; add-2007-bl) and
the same select order for the edge cases, so results match the JAX package
word for word, infinity's non-canonical X and Y included. Each field op is
a tower op from ff/towers.py: a product is one mont_mul launch, a linear op
one fp_add or fp_sub launch on a CUDA device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from zkarray_torch import DEFAULT_DEVICE


class ExtAffine(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor  # bool, batch-shaped


class ExtJacobian(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor  # z == 0 encodes infinity


class ExtCurveSpec:
    """y^2 = x^3 + a x + b over the field given by ``ops`` (host constants)."""

    def __init__(self, name, ops, scalar_spec, a_host, b_host, gen_x_host, gen_y_host,
                 cofactor=1):
        self.name = name
        self.ops = ops
        self.scalar = scalar_spec
        self.a_host = a_host
        self.b_host = b_host
        self.gen_x = gen_x_host
        self.gen_y = gen_y_host
        self.cofactor = cofactor
        self.a_is_zero = ops.host.eq(a_host, ops.host.zero())

    def __hash__(self):
        return hash((self.name, self.ops))

    def __eq__(self, o):
        return isinstance(o, ExtCurveSpec) and o.name == self.name and o.ops == self.ops

    def __repr__(self):
        return f"ExtCurveSpec({self.name})"

    def generator(self, batch_shape=(), device=DEFAULT_DEVICE) -> ExtAffine:
        F = self.ops
        return ExtAffine(F.const(self.gen_x, batch_shape, device),
                         F.const(self.gen_y, batch_shape, device),
                         torch.zeros(batch_shape, dtype=torch.bool, device=device))


def is_inf(curve: ExtCurveSpec, P: ExtJacobian) -> torch.Tensor:
    return curve.ops.is_zero(P.z)


def zero(curve: ExtCurveSpec, batch_shape=(), device=DEFAULT_DEVICE) -> ExtJacobian:
    F = curve.ops
    return ExtJacobian(F.one(batch_shape, device), F.one(batch_shape, device),
                       F.zero(batch_shape, device))


def from_affine(curve: ExtCurveSpec, A: ExtAffine) -> ExtJacobian:
    F = curve.ops
    batch, dev = F.batch_shape_of(A.x), A.x.device
    return ExtJacobian(A.x, A.y, F.select(A.inf, F.zero(batch, dev), F.one(batch, dev)))


def _sel(curve: ExtCurveSpec, mask, P: ExtJacobian, Q: ExtJacobian) -> ExtJacobian:
    F = curve.ops
    return ExtJacobian(F.select(mask, P.x, Q.x), F.select(mask, P.y, Q.y),
                       F.select(mask, P.z, Q.z))


def double(curve: ExtCurveSpec, P: ExtJacobian) -> ExtJacobian:
    F = curve.ops
    X1, Y1, Z1 = P
    XX = F.sqr(X1)
    YY = F.sqr(Y1)
    YYYY = F.sqr(YY)
    ZZ = F.sqr(Z1)
    S = F.double(F.sub(F.sub(F.sqr(F.add(X1, YY)), XX), YYYY))
    M = F.add(F.double(XX), XX)
    if not curve.a_is_zero:
        M = F.add(M, F.mul(F.const(curve.a_host, (), X1.device), F.sqr(ZZ)))
    X3 = F.sub(F.sqr(M), F.double(S))
    Y3 = F.sub(F.mul(M, F.sub(S, X3)), F.double(F.double(F.double(YYYY))))
    Z3 = F.sub(F.sub(F.sqr(F.add(Y1, Z1)), YY), ZZ)
    return ExtJacobian(X3, Y3, Z3)


def add(curve: ExtCurveSpec, P: ExtJacobian, Q: ExtJacobian) -> ExtJacobian:
    F = curve.ops
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(Y1, F.mul(Z2, Z2Z2))
    S2 = F.mul(Y2, F.mul(Z1, Z1Z1))
    H = F.sub(U2, U1)
    r = F.double(F.sub(S2, S1))
    I = F.sqr(F.double(H))  # noqa: E741
    J = F.mul(H, I)
    V = F.mul(U1, I)
    X3 = F.sub(F.sub(F.sqr(r), J), F.double(V))
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.double(F.mul(S1, J)))
    Z3 = F.mul(F.sub(F.sub(F.sqr(F.add(Z1, Z2)), Z1Z1), Z2Z2), H)
    R = ExtJacobian(X3, Y3, Z3)
    h0 = F.is_zero(H)
    r0 = F.is_zero(r)
    p_inf = is_inf(curve, P)
    q_inf = is_inf(curve, Q)
    both = ~p_inf & ~q_inf
    R = _sel(curve, both & h0 & r0, double(curve, P), R)
    R = _sel(curve, both & h0 & ~r0, zero(curve, F.batch_shape_of(X1), X1.device), R)
    R = _sel(curve, p_inf, Q, R)
    R = _sel(curve, q_inf, P, R)
    return R


def neg(curve: ExtCurveSpec, P: ExtJacobian) -> ExtJacobian:
    return ExtJacobian(P.x, curve.ops.neg(P.y), P.z)


def scalar_mul_const(curve: ExtCurveSpec, P: ExtJacobian, k: int) -> ExtJacobian:
    """k P for a Python-int k (negative: the negated multiple; zero:
    infinity). Double-and-add over |k|'s bits, high first; where a bit is
    clear the JAX package's select keeps the doubling, so no add is computed
    there."""
    F = curve.ops
    acc = zero(curve, F.batch_shape_of(P.x), P.x.device)
    if k == 0:
        return acc
    for bit in bin(abs(k))[2:]:
        acc = double(curve, acc)
        if bit == "1":
            acc = add(curve, acc, P)
    return neg(curve, acc) if k < 0 else acc


def to_affine(curve: ExtCurveSpec, P: ExtJacobian) -> ExtAffine:
    F = curve.ops
    zinv = F.inv(P.z)  # inv(0) = 0: infinity maps to (0, 0)
    zinv2 = F.sqr(zinv)
    return ExtAffine(F.mul(P.x, zinv2), F.mul(P.y, F.mul(zinv, zinv2)), is_inf(curve, P))


def is_on_curve(curve: ExtCurveSpec, A: ExtAffine) -> torch.Tensor:
    F = curve.ops
    dev = A.x.device
    y2 = F.sqr(A.y)
    rhs = F.add(F.mul(F.sqr(A.x), A.x), F.const(curve.b_host, F.batch_shape_of(A.x), dev))
    if not curve.a_is_zero:
        rhs = F.add(rhs, F.mul(F.const(curve.a_host, (), dev), A.x))
    return F.eq(y2, rhs) | A.inf
