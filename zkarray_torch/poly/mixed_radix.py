"""Mixed-radix evaluation domains: sizes 2^a q^b for fields with a small
multiplicative subgroup of order q^b (the MNT fields: q = 7 at 298 bits,
q = 5 at 753 bits).

Counterpart of zkarray/poly/mixed_radix.py: recursive Cooley-Tukey splits
n = n1 n2 over axis 1 of (L, n, *rest), the power-of-two part on the radix-2
core (domain.py:_fft_core, the butterfly_dit kernel) and parts of at most
32 points by a direct DFT (n products and n additions). The twiddles
w^(k1 i2) between the two passes are one ``twiddle_mul`` launch on the
first pass's output when nothing is batched beside it, else one mont_mul
by the (L, n1, n2) table that ``twiddle_table`` builds; the JAX package
gathers them from a power table of w. Every product is fully reduced, so
the words are the same.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ff import fp
from zkarray_torch.kernels import mont as km
from zkarray_torch.poly.domain import (_fft_core, _pad_to, _power_table, distribute_powers, power_table,
                                       twiddle_table)


def _naive_dft(spec: FieldSpec, A: torch.Tensor, n: int, w_int: int) -> torch.Tensor:
    """DFT over axis 1 of (L, n, *rest) by direct summation (small n)."""
    L = spec.num_limbs
    pt = _power_table(spec, w_int, n, A.device)  # read-only: gathered below
    idx = (torch.arange(n)[:, None] * torch.arange(n)[None, :]) % n  # [k, j]
    T = pt[:, idx.reshape(-1).to(A.device)].reshape(L, n, n)
    r1 = (1,) * (A.dim() - 2)
    out = None
    for j in range(n):
        term = fp.mont_mul(spec, T[:, :, j].reshape((L, n) + r1), A[:, j][:, None])
        out = term if out is None else fp.add(spec, out, term)
    return out


def _fft_any(spec: FieldSpec, A: torch.Tensor, n: int, w_int: int) -> torch.Tensor:
    """DFT over axis 1 of (L, n, *rest), any n = 2^a q^b."""
    if n == 1:
        return A
    if n & (n - 1) == 0:
        return _fft_core(spec, A, n, w_int, None)
    if n <= 32:
        return _naive_dft(spec, A, n, w_int)
    # n = n1 n2 with n1 = 2^a if a > 0, else the smallest prime factor
    a = (n & -n).bit_length() - 1
    if a > 0:
        n1 = 1 << a
    else:
        n1 = 3
        while n % n1:
            n1 += 2
    n2 = n // n1
    p = spec.modulus
    L = A.shape[0]
    rest = tuple(A.shape[2:])
    B = _fft_any(spec, A.reshape((L, n1, n2) + rest), n1, pow(w_int, n2, p))  # over i1
    if math.prod(rest) == 1:
        tw = km.twiddle_tables(spec, w_int, (n1 - 1) * (n2 - 1), A.device)
        C = km.twiddle_mul(spec, B.reshape(L, n1, n2), tw).reshape(B.shape)
    else:
        T = twiddle_table(spec, w_int, n1, n2, A.device)
        C = fp.mont_mul(spec, B, T.reshape((L, n1, n2) + (1,) * len(rest)))
    E = _fft_any(spec, C.movedim(2, 1), n2, pow(w_int, n1, p))  # over i2: [k2, k1]
    return E.reshape((L, n) + rest)


def _mixed_fft(spec: FieldSpec, arr: torch.Tensor, n: int, w_int: int,
               scale_int: Optional[int]) -> torch.Tensor:
    out = _fft_any(spec, arr.reshape(spec.num_limbs, n, 1), n, w_int)[:, :, 0]
    if scale_int is not None:
        out = fp.mont_mul(spec, out, fp.const_array(spec, scale_int, (1,), arr.device))
    return out


def best_mixed_domain_size(spec: FieldSpec, target: int) -> int:
    """The smallest 2^a q^b >= target that the field supports."""
    q = spec.small_subgroup_base
    if q is None:
        raise ValueError("field has no small subgroup")
    best = None
    for b in range(spec.small_subgroup_base_adicity + 1):
        qb = q ** b
        a = max(0, (-(-target // qb) - 1).bit_length())
        if a > spec.two_adicity:
            continue
        size = (1 << a) * qb
        if size >= target and (best is None or size < best):
            best = size
    if best is None:
        raise ValueError(f"no mixed domain of size >= {target}")
    return best


class MixedRadixDomain:
    """Coset offset <g> with |<g>| = 2^a q^b
    (zkarray/poly/mixed_radix.py:MixedRadixDomain)."""

    def __init__(self, spec: FieldSpec, size: int, offset_int: int = 1):
        p = spec.modulus
        rest = size >> ((size & -size).bit_length() - 1)
        q = spec.small_subgroup_base
        if q is not None:
            while rest % q == 0:
                rest //= q
        if rest != 1:
            raise ValueError(f"size {size} is not 2^a q^b for this field")
        self.spec = spec
        self.size = size
        self.group_gen_int = spec.root_of_unity(size)
        self.group_gen_inv_int = pow(self.group_gen_int, -1, p)
        self.size_inv_int = pow(size, -1, p)
        self.offset_int = offset_int % p
        self.offset_inv_int = pow(self.offset_int, -1, p)
        self.offset_pow_size_int = pow(self.offset_int, size, p)

    def fft(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Coefficients (L, m), m <= n -> evaluations (L, n) on the coset."""
        coeffs = _pad_to(coeffs, self.size)
        if self.offset_int != 1:
            coeffs = distribute_powers(self.spec, coeffs, self.offset_int)
        return _mixed_fft(self.spec, coeffs, self.size, self.group_gen_int, None)

    def ifft(self, evals: torch.Tensor) -> torch.Tensor:
        out = _mixed_fft(self.spec, evals, self.size, self.group_gen_inv_int, self.size_inv_int)
        if self.offset_int != 1:
            out = distribute_powers(self.spec, out, self.offset_inv_int)
        return out

    def elements(self, device=DEFAULT_DEVICE) -> torch.Tensor:
        """(L, n) table [offset g^0, ..., offset g^(n-1)]."""
        t = power_table(self.spec, self.group_gen_int, self.size, device)
        if self.offset_int != 1:
            t = fp.mont_mul(self.spec, t, fp.const_array(self.spec, self.offset_int, (1,), device))
        return t

    def __repr__(self):
        return f"MixedRadixDomain({self.spec.name}, {self.size}, offset={self.offset_int})"
