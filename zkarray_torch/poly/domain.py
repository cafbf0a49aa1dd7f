"""Radix-2 evaluation domains and the batched NTT.

Counterpart of zkarray/poly/domain.py (Radix2Domain and the transforms under
it). Output convention as there: ``fft(coeffs)[k] = f(offset·g^k)`` with g the
size-n root of unity, natural order.

Every stage of every transform is one launch of the ``butterfly_dit`` kernel
(kernels/mont.py), in place. The buffer it writes is always one the
transform owns, the output of its bit-reversal gather: never the caller's
coefficients and never a broadcast constant. A power table of up to
km.POW_TABLE_MAX (2^16) entries is one ``pow_table`` launch. Every multiply by
powers of a base, the four-step k1-twiddles, the degree-aware twist, the
coset twist and larger power tables, is one ``twiddle_mul`` launch that forms
w^e from two small tables, with the four-step ifft's n^-1 folded into them;
it reads slices and broadcasts in place and writes a column block of its
output in place. The JAX package builds the same tables by doubling chains
of products; every product is fully reduced, so the words are the same.
Tables are built on the device of the tensor they serve.

``vanishing_polynomial`` and ``filter_polynomial`` build their sparse
terms with poly/sparse.py; ``GeneralDomain`` picks a mixed-radix domain
(poly/mixed_radix.py) where the 2-adicity is too small.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ff import fp
from zkarray_torch.kernels import mont as km

# Sizes at which fft/ifft switch from the flat ladder to the four-step split,
# and from four-step to its chunked execution (zkarray/poly/domain.py).
FOURSTEP_MIN = 1 << 16
FOURSTEP_BIG = 1 << 23
# Column blocks of each fft_fourstep_big pass.
BIG_CHUNKS = 8


@functools.lru_cache(maxsize=16)
def _bitrev_perm(log_n: int, device=DEFAULT_DEVICE) -> torch.Tensor:
    """int64 bit-reversal permutation of 0 .. 2^log_n - 1, built on ``device``
    once per size (a read-only index: every block of a four-step pass gathers
    with it, and building it costs ~4 small launches per bit)."""
    idx = torch.arange(1 << log_n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def power_table(spec: FieldSpec, w_int: int, n: int, device=DEFAULT_DEVICE) -> torch.Tensor:
    """(L, n) Montgomery-form table [w^0, w^1, ..., w^(n-1)]."""
    if n <= km.POW_TABLE_MAX:
        return km.pow_table(spec, w_int, n, device)
    tw = km.twiddle_tables(spec, w_int, n - 1, device)
    return km.twiddle_mul(spec, fp.one(spec, (1, n), device), tw, 1, 0).reshape(spec.num_limbs, n)


def distribute_powers(spec: FieldSpec, arr: torch.Tensor, c_int: int) -> torch.Tensor:
    """arr[j] * c^j (the coset twist)."""
    tw = km.twiddle_tables(spec, c_int, arr.shape[1] - 1, arr.device)
    return km.twiddle_mul(spec, arr[:, None, :], tw, 1, 0).reshape(arr.shape)


def twiddle_table(spec: FieldSpec, w_int: int, n1: int, n2: int, device=DEFAULT_DEVICE) -> torch.Tensor:
    """(L, n1, n2) table T[k1, i2] = w^(k1·i2)."""
    tw = km.twiddle_tables(spec, w_int, (n1 - 1) * (n2 - 1), device)
    return km.twiddle_mul(spec, fp.one(spec, (n1, n2), device), tw)


def fft_fourstep_core(spec: FieldSpec, x: torch.Tensor, n1: int, n2: int, w_int: int,
                      scale_int: Optional[int] = None) -> torch.Tensor:
    """Four-step (Bailey) NTT: (L, n) flat, i = i1·n2 + i2 -> (L, n) natural
    order. The k1-twiddle multiply (with ``scale_int`` folded in) runs in
    place in the first pass's output."""
    L = x.shape[0]
    p = spec.modulus
    B = _fft_core(spec, x.reshape(L, n1, n2), n1, pow(w_int, n2, p), None)  # owned
    tw = km.twiddle_tables(spec, w_int, (n1 - 1) * (n2 - 1), x.device, scale_int)
    km.twiddle_mul(spec, B, tw, out=B)
    E = _fft_core(spec, B.transpose(1, 2), n2, pow(w_int, n1, p), None)  # [k2, k1]
    return E.reshape(L, n1 * n2)


def fft_fourstep_big(spec: FieldSpec, x: torch.Tensor, n1: int, n2: int, w_int: int,
                     scale_int: Optional[int] = None) -> torch.Tensor:
    """Four-step NTT with both sub-transform passes run column block by
    column block (BIG_CHUNKS blocks), written into preallocated outputs, so
    the peak is input + two outputs + one block's working set. Pass 1's
    k1-twiddle multiply (with ``scale_int`` folded in) writes each block of
    its output; the pass-2 transpose is a view: each block's bit-reversal
    gather reads it."""
    L = x.shape[0]
    p = spec.modulus
    dev = x.device
    CH = BIG_CHUNKS
    if n1 % CH or n2 % CH:
        raise ValueError(f"fft_fourstep_big: n1 = {n1} and n2 = {n2} must be multiples of {CH}")
    m1, m2 = n1 // CH, n2 // CH
    w1, w2 = pow(w_int, n2, p), pow(w_int, n1, p)
    A = x.reshape(L, n1, n2)
    tw1 = power_table(spec, w1, max(n1 // 2, 1), dev)
    tw2 = tw1 if (w2, n2) == (w1, n1) else power_table(spec, w2, max(n2 // 2, 1), dev)

    # pass 1: size-n1 NTT over axis 1 of each i2-block, then the k1-twiddle
    # w^(k1·i2) written into the block of C
    tw = km.twiddle_tables(spec, w_int, (n1 - 1) * (n2 - 1), dev, scale_int)
    C = torch.empty((L, n1, n2), dtype=torch.int32, device=dev)
    for c in range(CH):
        cols = slice(c * m2, (c + 1) * m2)
        blk = _fft_core(spec, A[:, :, cols], n1, w1, None, tw=tw1)
        km.twiddle_mul(spec, blk, tw, 0, c * m2, out=C[:, :, cols])
        del blk

    # pass 2: size-n2 NTT over axis 1 of each k1-block of the transpose
    Ct = C.transpose(1, 2)  # (L, n2, n1), a view
    E = torch.empty((L, n2, n1), dtype=torch.int32, device=dev)
    for c in range(CH):
        cols = slice(c * m1, (c + 1) * m1)
        E[:, :, cols] = _fft_core(spec, Ct[:, :, cols], n2, w2, None, tw=tw2)
    return E.reshape(L, n1 * n2)


def _fft_core(spec: FieldSpec, arr: torch.Tensor, n: int, w_int: int, scale_int: Optional[int],
              tw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In-order -> in-order radix-2 NTT over axis 1 of (L, n, *rest) with
    root w (DIT after bit reversal); ``rest`` axes are independent batch
    transforms. Outputs are scaled by ``scale_int`` when given (n^-1 for the
    inverse). ``tw``: the power table of w (max(n/2, 1) entries), when the
    caller already has it. Returns a new tensor; ``arr`` is only read."""
    L = arr.shape[0]
    rest = tuple(arr.shape[2:])
    rflat = math.prod(rest)
    log_n = n.bit_length() - 1
    if 1 << log_n != n or arr.shape[1] != n:
        raise ValueError(f"_fft_core: axis 1 of {tuple(arr.shape)} must be the power of two {n}")
    dev = arr.device
    if tw is None:
        tw = power_table(spec, w_int, max(n // 2, 1), dev)
    x = torch.index_select(arr, 1, _bitrev_perm(log_n, str(dev))).contiguous()  # owned
    xv = x.view(L, n, rflat)
    for s in range(1, log_n + 1):
        m = 1 << s
        km.butterfly_dit(spec, xv.view(L, n // m, 2, m // 2, rflat), tw, n // m)
    if scale_int is not None:
        x = fp.mont_mul(spec, x, fp.const_array(spec, scale_int, (1,) * (1 + len(rest)), dev))
    return x


def _pad_to(coeffs: torch.Tensor, n: int) -> torch.Tensor:
    m = coeffs.shape[1]
    if m == n:
        return coeffs
    return torch.cat([coeffs, coeffs.new_zeros((coeffs.shape[0], n - m))], dim=1)


class Radix2Domain:
    """Multiplicative coset offset·<g> of size n = 2^k
    (zkarray/poly/domain.py:Radix2Domain)."""

    def __init__(self, spec: FieldSpec, size: int, offset_int: int = 1):
        if size < 1 or size & (size - 1):
            raise ValueError("domain size must be a power of two")
        log_n = size.bit_length() - 1
        if log_n > spec.two_adicity:
            raise ValueError(f"size 2^{log_n} exceeds 2-adicity {spec.two_adicity} of {spec.name}")
        p = spec.modulus
        self.spec = spec
        self.size = size
        self.log_size = log_n
        self.group_gen_int = spec.root_of_unity(size) if size > 1 else 1
        self.group_gen_inv_int = pow(self.group_gen_int, -1, p)
        self.size_inv_int = pow(size, -1, p)
        self.offset_int = offset_int % p
        self.offset_inv_int = pow(self.offset_int, -1, p)
        self.offset_pow_size_int = pow(self.offset_int, size, p)

    def get_coset(self, offset_int: int) -> "Radix2Domain":
        return Radix2Domain(self.spec, self.size, offset_int)

    def _transform(self, x: torch.Tensor, w_int: int, scale_int: Optional[int]) -> torch.Tensor:
        spec, n = self.spec, self.size
        n1 = 1 << ((n.bit_length() - 1) // 2)
        if n >= FOURSTEP_BIG:
            return fft_fourstep_big(spec, x, n1, n // n1, w_int, scale_int)
        if n >= FOURSTEP_MIN:
            return fft_fourstep_core(spec, x, n1, n // n1, w_int, scale_int)
        return _fft_core(spec, x, n, w_int, scale_int)

    def fft(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Coefficients (L, m), m <= n -> evaluations (L, n) on the coset.

        Degree-aware: when the power-of-two-padded coefficient count m2 has
        4·m2 <= n, the n points split into n/m2 cosets w_n^j·<w_m2>, each a
        size-m2 transform of the coefficients twisted by powers of w_n^j."""
        n = self.size
        m = coeffs.shape[1]
        if m > n:
            raise ValueError("too many coefficients for domain")
        m2 = 1 << max(0, m - 1).bit_length()
        if 4 * m2 <= n:
            return self._degree_aware_fft(coeffs, m2)
        coeffs = _pad_to(coeffs, n)
        if self.offset_int != 1:
            coeffs = distribute_powers(self.spec, coeffs, self.offset_int)
        return self._transform(coeffs, self.group_gen_int, None)

    def _degree_aware_fft(self, coeffs: torch.Tensor, m2: int) -> torch.Tensor:
        spec, n, p = self.spec, self.size, self.spec.modulus
        dev = coeffs.device
        coeffs = _pad_to(coeffs, m2)
        if self.offset_int != 1:
            coeffs = distribute_powers(spec, coeffs, self.offset_int)
        k = n // m2
        # twist tw[j, i] = coeffs[i] · w_n^(j·i), j < k, i < m2
        L = spec.num_limbs
        tables = km.twiddle_tables(spec, self.group_gen_int, (k - 1) * (m2 - 1), dev)
        tw = km.twiddle_mul(spec, coeffs[:, None, :].expand(L, k, m2), tables)
        # size-m2 transforms along axis 1, rest axis k:
        # evals[:, t, j] = f(w^j · w_m2^t) = f(w^(t·k + j))
        evals = _fft_core(spec, tw.transpose(1, 2), m2, pow(self.group_gen_int, k, p), None)
        return evals.reshape(L, n)

    def ifft(self, evals: torch.Tensor) -> torch.Tensor:
        """Evaluations on the coset -> coefficients (L, n)."""
        if evals.shape[1] != self.size:
            raise ValueError("evaluation count must equal domain size")
        out = self._transform(evals, self.group_gen_inv_int, self.size_inv_int)
        if self.offset_int != 1:
            out = distribute_powers(self.spec, out, self.offset_inv_int)
        return out

    # ---- domain queries ----

    def elements(self, device=DEFAULT_DEVICE) -> torch.Tensor:
        """(L, n) table [offset·g^0, ..., offset·g^(n-1)]."""
        t = power_table(self.spec, self.group_gen_int, self.size, device)
        if self.offset_int != 1:
            t = fp.mont_mul(self.spec, t, fp.const_array(self.spec, self.offset_int, (1,), device))
        return t

    def evaluate_vanishing_polynomial(self, tau: torch.Tensor) -> torch.Tensor:
        """Z(tau) = tau^n - offset^n, batched over tau."""
        spec = self.spec
        tn = fp.pow_const(spec, tau, self.size)
        return fp.sub(spec, tn, fp.const_array(spec, self.offset_pow_size_int, tau.shape[1:], tau.device))

    def evaluate_all_lagrange_coefficients(self, tau: torch.Tensor) -> torch.Tensor:
        """L_i(tau) for all i, with one batch inversion. tau: one element
        (L,) or (L, 1) -> (L, n)."""
        spec, n = self.spec, self.size
        dev = tau.device
        tau = tau.reshape(spec.num_limbs, 1)
        elems = self.elements(dev)  # r_i = offset·g^i
        # L_i(tau) = Z(tau) · r_i / (n·offset^n·(tau - r_i))
        z = self.evaluate_vanishing_polynomial(tau)
        taus = tau.expand(elems.shape)
        inv_diffs = fp.batch_inv(spec, fp.sub(spec, taus, elems))
        c_int = pow((self.size * self.offset_pow_size_int) % spec.modulus, -1, spec.modulus)
        zc = fp.mont_mul(spec, z, fp.const_array(spec, c_int, (1,), dev))
        li = fp.mont_mul(spec, fp.mont_mul(spec, zc, elems), inv_diffs)
        # at tau = r_i the formula is 0/0: L_i = 1 there, the others 0
        hit = fp.eq(taus, elems)
        exact = fp.select(hit, fp.one(spec, (n,), dev), fp.zero(spec, (n,), dev))
        return fp.select(hit.any().expand(n), exact, li)

    def mul_polynomials_in_evaluation_domain(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return fp.mont_mul(self.spec, a, b)

    # ---- vanishing and filter polynomials ----

    def vanishing_polynomial(self, device=DEFAULT_DEVICE):
        """Z(X) = X^n - offset^n as sparse (degrees, coeffs)."""
        from zkarray_torch.poly import sparse

        p = self.spec.modulus
        return sparse.uv_from_terms(
            self.spec, [(0, (-self.offset_pow_size_int) % p), (self.size, 1)], device)

    def filter_polynomial(self, subdomain: "Radix2Domain", device=DEFAULT_DEVICE) -> torch.Tensor:
        """Dense coefficients of the polynomial that is 1 on ``subdomain`` and
        0 on the rest of this domain: sum_i b^(k-1-i) X^(i M) scaled, with
        b = offset_S^M and k = n/M (both vanishing polynomials are
        binomials, so no long division)."""
        from zkarray_torch.poly import sparse

        p = self.spec.modulus
        N, M = self.size, subdomain.size
        if N % M:
            raise ValueError("subdomain size must divide domain size")
        k = N // M
        b = subdomain.offset_pow_size_int
        if pow(b, k, p) != self.offset_pow_size_int:
            raise ValueError("subdomain is not contained in this domain")
        scale = (M * b) % p * pow(N % p, -1, p) % p
        terms = [(i * M, pow(b, k - 1 - i, p) * scale % p) for i in range(k)]
        degrees, coeffs = sparse.uv_from_terms(self.spec, terms, device)
        return sparse.uv_to_dense(self.spec, degrees, coeffs, (k - 1) * M + 1)

    def evaluate_filter_polynomial(self, subdomain: "Radix2Domain", tau: torch.Tensor) -> torch.Tensor:
        """The filter polynomial at tau (L, *batch): 1 where tau is in the
        subdomain, else (M/n) Z_self(tau) / Z_sub(tau)."""
        spec = self.spec
        dev = tau.device
        v_sub = subdomain.evaluate_vanishing_polynomial(tau)
        v_self = self.evaluate_vanishing_polynomial(tau)
        c_int = (subdomain.size * pow(self.size, -1, spec.modulus)) % spec.modulus
        val = fp.mont_mul(spec, fp.mont_mul(spec, fp.const_array(spec, c_int, (), dev), v_self),
                          fp.inv(spec, v_sub))
        return fp.select(fp.is_zero(spec, v_sub), fp.one(spec, val.shape[1:], dev), val)

    def reindex_by_subdomain(self, other: "Radix2Domain", index: int) -> int:
        """Index translation when the first |S| elements are a subdomain's."""
        if self.size < other.size:
            raise ValueError("the subdomain is larger than the domain")
        period = self.size // other.size
        if index < other.size:
            return index * period
        i = index - other.size
        x = period - 1
        return i + (i // x) + 1

    def __repr__(self):
        return f"Radix2Domain({self.spec.name}, 2^{self.log_size}, offset={self.offset_int})"


def GeneralDomain(spec: FieldSpec, min_size: int, offset_int: int = 1):
    """The domain for at least ``min_size`` evaluations: radix-2 where the
    2-adicity allows, else the smallest mixed-radix domain
    (zkarray/poly/domain.py:GeneralDomain)."""
    n = 1 << max(0, min_size - 1).bit_length()
    if n.bit_length() - 1 <= spec.two_adicity:
        return Radix2Domain(spec, n, offset_int)
    from zkarray_torch.poly.mixed_radix import MixedRadixDomain, best_mixed_domain_size

    return MixedRadixDomain(spec, best_mixed_domain_size(spec, min_size), offset_int)
