"""Elligator2 map to curve for twisted Edwards curves (RFC 9380 §6.7.1).

Counterpart of zkarray/ec/h2c/elligator2.py: the map to the Montgomery form
B y'^2 = x'^3 + A x'^2 + x', then the birational map to the TE curve,
scaled by a host constant s with s^2 = ((A + 2)/B)/a. Batched and
mask-selected in the JAX package's order; the square roots are the base
field's ff/fp.py:sqrt (Tonelli–Shanks on Jubjub's and Bandersnatch's field,
the 5 mod 8 route on curve25519's).
"""

from __future__ import annotations

import functools

import torch

from zkarray_torch.ec.h2c.swu import sgn0
from zkarray_torch.ec.te import TEAffine, TECurveSpec
from zkarray_torch.ff import fp


def elligator2_map(spec: TECurveSpec, u: torch.Tensor, zeta: int) -> TEAffine:
    """u (L, *batch) -> points on the TE curve (cofactor not cleared)."""
    if spec.mont_coeff_a is None:
        raise ValueError(f"{spec.name} has no Montgomery form constants")
    f = spec.base
    batch, dev = u.shape[1:], u.device
    A = fp.const_array(f, spec.mont_coeff_a, (), dev)
    one = fp.one(f, batch, dev)
    z = fp.const_array(f, zeta, (), dev)

    # x1 = -A / (1 + Z u^2); Z u^2 = -1 -> x1 = -A
    zu2 = fp.mont_mul(f, z, fp.mont_sqr(f, u))
    den = fp.add(f, one, zu2)
    den_zero = fp.is_zero(f, den)
    x1 = fp.neg(f, fp.mont_mul(f, A, fp.batch_inv(f, fp.select(den_zero, one, den))))

    # y'^2 = (x'^3 + A x'^2 + x') / B
    Binv = fp.const_array(f, pow(spec.mont_coeff_b % f.modulus, -1, f.modulus), (), dev)

    def g(x):
        x2 = fp.mont_sqr(f, x)
        num = fp.add(f, fp.add(f, fp.mont_mul(f, x2, x), fp.mont_mul(f, A, x2)), x)
        return fp.mont_mul(f, num, Binv)

    gx1 = g(x1)
    x2 = fp.sub(f, fp.neg(f, x1), A)
    gx2 = g(x2)
    r1, ok1 = fp.sqrt(f, gx1)
    r2, _ = fp.sqrt(f, gx2)
    xm = fp.select(ok1, x1, x2)
    ym = fp.select(ok1, r1, r2)
    ym = fp.select(sgn0(f, u) == sgn0(f, ym), ym, fp.neg(f, ym))  # sgn0(y') == sgn0(u)

    # (x', y') -> (s x'/y', (x' - 1)/(x' + 1)); y' = 0 or x' = -1 -> (0, 1)
    sc = _te_scale(spec)
    xs = fp.mont_mul(f, fp.mont_mul(f, xm, fp.batch_inv(f, ym)), fp.const_array(f, sc, (), dev))
    num = fp.sub(f, xm, one)
    den2 = fp.add(f, xm, one)
    d0 = fp.is_zero(f, den2)
    ys = fp.mont_mul(f, num, fp.batch_inv(f, fp.select(d0, one, den2)))
    exc = fp.is_zero(f, ym) | d0 | den_zero
    return TEAffine(fp.select(exc, fp.zero(f, batch, dev), xs), fp.select(exc, one, ys))


@functools.lru_cache(maxsize=None)
def _te_scale(spec: TECurveSpec) -> int:
    """s with s^2 = a'/a, a' = (A + 2)/B: the raw birational image on
    (a', d' = (A - 2)/B) maps to (s x', y') on (a, d). Host ints; asserts
    that the same s takes d' to d."""
    p = spec.base.modulus
    A, B = spec.mont_coeff_a % p, spec.mont_coeff_b % p
    a_p = (A + 2) * pow(B, -1, p) % p
    d_p = (A - 2) * pow(B, -1, p) % p
    val = a_p * pow(spec.a_int, -1, p) % p
    s = pow(val, (p + 1) // 4, p) if p % 4 == 3 else _tonelli_host(val, p)
    assert s * s % p == val, "incompatible Montgomery constants"
    assert d_p * pow(val, -1, p) % p == spec.d_int, "d mismatch"
    return s


def _tonelli_host(n, p):
    """A square root of n mod p by Tonelli–Shanks (the JAX package's root)."""
    if pow(n, (p - 1) // 2, p) != 1:
        raise ValueError("not a QR")
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(n, q, p), pow(n, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r
