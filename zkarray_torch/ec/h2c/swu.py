"""Simplified SWU map to curve (RFC 9380 §6.6.2), batched.

Counterpart of zkarray/ec/h2c/swu.py: for a curve with a b != 0 and a fixed
non-square Z. Every branch is computed and mask-selected in the JAX
package's order; each field op is an ff/fp.py call (a kernel launch on a
CUDA device). The constants -b/a and b/(Z a) are exact field values, so
they are computed on the host, where the JAX package inverts on the device:
the words are the same.
"""

from __future__ import annotations

import torch

from zkarray_torch.ec.sw import AffinePoints, SWCurveSpec
from zkarray_torch.ff import fp


def sgn0(spec, x: torch.Tensor) -> torch.Tensor:
    """RFC 9380 §4.1 sgn0 for m = 1: the parity of the canonical value."""
    return fp.from_mont(spec, x)[0] & 1


def swu_map(curve: SWCurveSpec, u: torch.Tensor, zeta: int) -> AffinePoints:
    """u (L, *batch) field elements -> points on ``curve`` (never infinity)."""
    f = curve.base
    p = f.modulus
    batch, dev = u.shape[1:], u.device
    a = fp.const_array(f, curve.a_int, (), dev)
    b = fp.const_array(f, curve.b_int, (), dev)
    z = fp.const_array(f, zeta, (), dev)

    u2 = fp.mont_sqr(f, u)
    zu2 = fp.mont_mul(f, z, u2)  # Z u^2
    den = fp.add(f, fp.mont_sqr(f, zu2), zu2)  # Z^2 u^4 + Z u^2
    den_zero = fp.is_zero(f, den)
    tv1 = fp.batch_inv(f, den)  # 0 where den == 0
    # x1 = (-b/a)(1 + tv1); exceptional: x1 = b/(Z a)
    neg_b_over_a = fp.const_array(f, -curve.b_int * pow(curve.a_int, -1, p), (), dev)
    x1 = fp.mont_mul(f, neg_b_over_a, fp.add(f, fp.one(f, batch, dev), tv1))
    x1_exc = fp.const_array(f, curve.b_int * pow(zeta * curve.a_int, -1, p), batch, dev)
    x1 = fp.select(den_zero, x1_exc, x1)

    def g(x):
        return fp.add(f, fp.add(f, fp.mont_mul(f, fp.mont_sqr(f, x), x), fp.mont_mul(f, a, x)), b)

    gx1 = g(x1)
    x2 = fp.mont_mul(f, zu2, x1)
    gx2 = g(x2)
    r1, ok1 = fp.sqrt(f, gx1)
    r2, _ = fp.sqrt(f, gx2)
    x = fp.select(ok1, x1, x2)
    y = fp.select(ok1, r1, r2)
    y = fp.select(sgn0(f, u) == sgn0(f, y), y, fp.neg(f, y))  # sgn0(y) == sgn0(u)
    return AffinePoints(x, y, torch.zeros(tuple(batch), dtype=torch.bool, device=dev))
