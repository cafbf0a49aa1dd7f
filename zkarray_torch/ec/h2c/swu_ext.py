"""Simplified SWU map over a quadratic extension (RFC 9380 §6.6.2 with the
§4.1 sgn0 for m = 2), batched.

Counterpart of zkarray/ec/h2c/swu_ext.py: every branch computed and
mask-selected in the JAX package's order; the square root is
ff/towers.py:quad_sqrt (two base-field roots through the norm). Each tower
op is a product (mont_mul) or a linear op (fp_add/fp_sub) launch on a CUDA
device.
"""

from __future__ import annotations

import torch

from zkarray_torch.ff import fp
from zkarray_torch.ff.towers import ExtOps, quad_sqrt


def sgn0_m2(F2: ExtOps, e: torch.Tensor) -> torch.Tensor:
    """sgn0 for m = 2: the canonical parity of c0, or of c1 where c0 = 0."""
    spec = F2.spec
    d0 = fp.from_mont(spec, e[0])[0] & 1
    d1 = fp.from_mont(spec, e[1])[0] & 1
    return torch.where(fp.is_zero(spec, e[0]), d1, d0)


def swu_map_ext(F2: ExtOps, u: torch.Tensor, a_host: tuple, b_host: tuple, zeta_host: tuple,
                neg_b_over_a_host: tuple, b_over_za_host: tuple) -> tuple:
    """u (2, L, *batch) Fq2 elements -> (x, y) on E': y^2 = x^3 + a x + b
    (never infinity). -b/a and b/(Z a) come from the host."""
    batch, dev = F2.batch_shape_of(u), u.device
    a = F2.const(a_host, (), dev)
    b = F2.const(b_host, (), dev)
    z = F2.const(zeta_host, (), dev)

    u2 = F2.sqr(u)
    zu2 = F2.mul(z, u2)  # Z u^2
    den = F2.add(F2.sqr(zu2), zu2)  # Z^2 u^4 + Z u^2
    den_zero = F2.is_zero(den)
    tv1 = F2.inv(den)  # inv(0) = 0 where den == 0
    x1 = F2.mul(F2.const(neg_b_over_a_host, (), dev), F2.add(F2.one(batch, dev), tv1))
    x1 = F2.select(den_zero, F2.const(b_over_za_host, batch, dev), x1)

    def g(x):
        return F2.add(F2.add(F2.mul(F2.sqr(x), x), F2.mul(a, x)), b)

    gx1 = g(x1)
    x2 = F2.mul(zu2, x1)
    gx2 = g(x2)
    r1, ok1 = quad_sqrt(F2, gx1)
    r2, _ = quad_sqrt(F2, gx2)
    x = F2.select(ok1, x1, x2)
    y = F2.select(ok1, r1, r2)
    y = F2.select(sgn0_m2(F2, u) == sgn0_m2(F2, y), y, F2.neg(y))  # sgn0(y) == sgn0(u)
    return x, y
