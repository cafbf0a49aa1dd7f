"""Dense univariate polynomials over (L, n) coefficient tensors.

Counterpart of zkarray/poly/dense.py. A coefficient tensor carries no
degree; ``degree`` finds the highest nonzero coefficient on the host. Every
product, sum and difference is a field kernel launch on a CUDA device
(ff/fp.py), and ``mul`` transforms through Radix2Domain (the NTT kernels).
The loops the JAX package writes as ``fori_loop``/``scan`` are Python loops
here, one launch or two per step: ``evaluate``'s two-level Horner makes
about 4 sqrt(n) launches, ``divide_with_q_and_r`` three per quotient
coefficient, each over the whole remainder, as there.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ff import fp
from zkarray_torch.poly.domain import Radix2Domain


def _pad(a: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Zero columns before and after axis 1 of (L, n)."""
    return torch.nn.functional.pad(a, (left, right))


def from_ints(spec: FieldSpec, coeffs, device=DEFAULT_DEVICE) -> torch.Tensor:
    return fp.from_ints(spec, coeffs, device=device)


def degree(spec: FieldSpec, coeffs: torch.Tensor) -> int:
    """The highest nonzero coefficient's index (0 for the zero polynomial)."""
    nz = (~fp.is_zero(spec, coeffs)).nonzero()
    return int(nz[-1, 0]) if nz.numel() else 0


def evaluate(spec: FieldSpec, coeffs: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """The polynomial at a batch of points tau (L, m) -> (L, m): Horner over
    chunks of k ~ sqrt(n) coefficients at every point at once, then Horner
    over the chunk values in tau^k."""
    L = spec.num_limbs
    n = coeffs.shape[1]
    m = tau.shape[1]
    if n == 1:
        return coeffs[:, 0:1].expand(L, m)
    k = max(1, 1 << (int(math.log2(max(n, 2))) // 2))
    nc = -(-n // k)
    c = _pad(coeffs, 0, nc * k - n).reshape(L, nc, k)  # chunk j: coefficients [j k, j k + k)
    acc = fp.zero(spec, (nc, m), tau.device)
    tau_b = tau[:, None, :]
    for i in range(k):
        acc = fp.add(spec, fp.mont_mul(spec, acc, tau_b), c[:, :, k - 1 - i, None])
    tk = fp.pow_const(spec, tau, k)
    r = fp.zero(spec, (m,), tau.device)
    for j in range(nc):
        r = fp.add(spec, fp.mont_mul(spec, r, tk), acc[:, nc - 1 - j])
    return r


def _widen(a: torch.Tensor, b: torch.Tensor):
    n = max(a.shape[1], b.shape[1])
    return _pad(a, 0, n - a.shape[1]), _pad(b, 0, n - b.shape[1])


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fp.add(spec, *_widen(a, b))


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fp.sub(spec, *_widen(a, b))


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return fp.neg(spec, a)


def scale(spec: FieldSpec, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return fp.mont_mul(spec, a, s.reshape(spec.num_limbs, 1))


def naive_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product: one row product and one add per coefficient of a."""
    na, nb = a.shape[1], b.shape[1]
    out = fp.zero(spec, (na + nb - 1,), a.device)
    for i in range(na):
        prod = fp.mont_mul(spec, a[:, i:i + 1], b)
        out = fp.add(spec, out, _pad(prod, i, na - 1 - i))
    return out


def mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product through a shared radix-2 domain (schoolbook up to 16
    coefficients of product)."""
    na, nb = a.shape[1], b.shape[1]
    target = na + nb - 1
    if target <= 16:
        return naive_mul(spec, a, b)[:, :target]
    dom = Radix2Domain(spec, 1 << (target - 1).bit_length())
    return dom.ifft(fp.mont_mul(spec, dom.fft(a), dom.fft(b)))[:, :target]


def mul_by_vanishing_poly(spec: FieldSpec, a: torch.Tensor, domain_size: int) -> torch.Tensor:
    """a(X) (X^n - 1): shift and subtract."""
    return fp.add(spec, _pad(a, domain_size, 0), _pad(fp.neg(spec, a), 0, domain_size))


def divide_by_vanishing_poly(spec: FieldSpec, coeffs: torch.Tensor,
                             domain_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(quotient, remainder) of the division by X^n - 1:
    q[i] = sum_(j >= 1) c[i + j n], summed from the highest stripe of n
    down, one add per stripe; r = c_low + q."""
    n = domain_size
    m = coeffs.shape[1]
    if m <= n:
        return fp.zero(spec, (1,), coeffs.device), coeffs
    qlen = m - n
    nstripes = -(-qlen // n)
    hi = _pad(coeffs[:, n:], 0, nstripes * n - qlen).reshape(spec.num_limbs, nstripes, n)
    q = torch.empty_like(hi)
    acc = hi[:, -1]
    q[:, -1] = acc
    for s in range(nstripes - 2, -1, -1):
        acc = fp.add(spec, hi[:, s], acc)
        q[:, s] = acc
    q = q.reshape(spec.num_limbs, nstripes * n)[:, :qlen]
    r = fp.add(spec, coeffs[:, :n], _pad(q, 0, n - min(n, qlen))[:, :n])
    return q, r


def divide_with_q_and_r(spec: FieldSpec, a: torch.Tensor,
                        b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Long division a = q b + r, deg r < deg b: one step per quotient
    coefficient, from the top, each subtracting q_i X^i b from the whole
    remainder (O(deg q deg a) work, as zkarray/poly/dense.py does)."""
    da = degree(spec, a)
    db = degree(spec, b)
    dev = a.device
    if da < db:
        return fp.zero(spec, (1,), dev), a
    lead_inv = fp.inv(spec, b[:, db:db + 1])
    qlen = da - db + 1
    rem = a[:, :da + 1]
    bvec = b[:, :db + 1]
    qs = []
    for i in range(qlen):
        pos = da - i
        qi = fp.mont_mul(spec, rem[:, pos:pos + 1], lead_inv)
        full = _pad(fp.mont_mul(spec, qi, bvec), pos - db, da - pos)
        rem = fp.sub(spec, rem, full)
        qs.append(qi)
    q = torch.cat(qs[::-1], dim=1)
    return q, rem[:, :db] if db > 0 else fp.zero(spec, (1,), dev)
