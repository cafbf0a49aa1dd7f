"""Batched Montgomery prime-field arithmetic on planar base-2^16 limbs.

Counterpart of zkarray/ff/fp.py. Field tensors are ``int32[L, *batch]`` in
Montgomery form unless stated otherwise, R = 2^(16 L). ``mont_mul``,
``mont_sqr``, ``pow_const``, ``pow2k``, ``inv``, ``add``, ``sub``,
``double`` and ``neg`` go through zkarray_torch.kernels.mont, which launches
a CUDA kernel for CUDA tensors;
everything else here is plain PyTorch on the tensors' own device (in the JAX
package it is XLA).

``pow2k`` is one ``mont_pow`` launch with exponent 2^k on a CUDA device
where the JAX package runs k squarings: the field arithmetic is exact, so
the words are the same, and Tonelli-Shanks' s(s - 1)/2 squarings become s
launches. ``sum_of_products`` and ``tree_sum`` accumulate lazily in int64
columns, as the JAX package does in uint32 ones, and reduce once per chunk.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core import limbs as lb
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.kernels import mont as km


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------

_const = km.const


def const_array(spec: FieldSpec, x_canonical: int, batch_shape=(), device=DEFAULT_DEVICE):
    """Canonical int -> Montgomery-form (L, *batch) constant."""
    return _const(spec, spec.to_mont_int(x_canonical % spec.modulus), batch_shape, device)


def zero(spec: FieldSpec, batch_shape=(), device=DEFAULT_DEVICE) -> torch.Tensor:
    return lb.zeros(spec.num_limbs, batch_shape, device=device)


def one(spec: FieldSpec, batch_shape=(), device=DEFAULT_DEVICE) -> torch.Tensor:
    return _const(spec, spec.r_int, batch_shape, device)


# ---------------------------------------------------------------------------
# host <-> device conversion
# ---------------------------------------------------------------------------

def from_ints(spec: FieldSpec, xs, mont: bool = True, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Python ints -> (L, n) int32 tensor (Montgomery form by default)."""
    xs = [int(x) % spec.modulus for x in xs]
    if mont:
        xs = [spec.to_mont_int(x) for x in xs]
    arr = lb.ints_to_limbs_np(xs, spec.num_limbs).astype("int32")
    return torch.from_numpy(arr).to(device)


def to_ints(spec: FieldSpec, a: torch.Tensor, mont: bool = True) -> list:
    """(L, *batch) limb tensor -> flat list of canonical Python ints."""
    vals = lb.limbs_to_ints(a)
    if mont:
        vals = [spec.from_mont_int(v) for v in vals]
    return vals


# ---------------------------------------------------------------------------
# core arithmetic
# ---------------------------------------------------------------------------

def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p, broadcast as kernels.mont.align
    does (the kernel on CUDA tensors)."""
    return km.mont_mul(spec, a, b)


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery square (the kernel on CUDA tensors)."""
    return km.mont_sqr(spec, a)


def mont_reduce(spec: FieldSpec, cols: torch.Tensor) -> torch.Tensor:
    """(Σ cols_k 2^(16k)) * R^-1 mod p for (K <= 2L+1, *batch) lazy columns
    whose value is < R p."""
    K = 2 * spec.num_limbs + 1
    full = torch.zeros((K,) + tuple(cols.shape[1:]), dtype=torch.int64, device=cols.device)
    full[: cols.shape[0]] = cols
    return km.redc_plain(spec, full).to(torch.int32)


add = km.fp_add  # (a + b) mod p, one csrc/fadd.cu launch on a CUDA device
sub = km.fp_sub  # (a - b) mod p, likewise
neg = km.fp_neg  # -a mod p (0 stays 0): one fp_sub launch of 0 - a


def double(spec: FieldSpec, a: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    return add(spec, a, a, out)


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Canonical limbs -> Montgomery form (multiply by R^2)."""
    return mont_mul(spec, a, _const(spec, spec.r2_int, a.shape[1:], a.device))


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical limbs."""
    return mont_reduce(spec, a)


def is_zero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return lb.is_zero(a)


def is_one(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return lb.eq(a, one(spec, a.shape[1:], a.device))


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return lb.eq(a, b)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask (batch-shaped bool) ? a : b."""
    return torch.where(mask[None], a, b)


# ---------------------------------------------------------------------------
# powering and inversion
# ---------------------------------------------------------------------------

def pow_const(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a Python-int exponent: square-and-multiply over the
    exponent's bits, low bit first (zkarray/ff/fp.py:pow_const); one
    csrc/mont.cu:mont_pow launch on a CUDA device."""
    return km.mont_pow(spec, a, e)


def pow_u32(spec: FieldSpec, a: torch.Tensor, e) -> torch.Tensor:
    """a^e for a per-element exponent e < 2^32 (an int or a batch-shaped
    integer tensor): 32 steps of square-and-multiply, low bit first, each
    step's product kept where e's bit is set (zkarray/ff/fp.py:pow_u32)."""
    L = spec.num_limbs
    e = torch.as_tensor(e, dtype=torch.int64, device=a.device)
    batch = torch.broadcast_shapes(tuple(a.shape[1:]), tuple(e.shape))
    a = a.reshape(tuple(a.shape) + (1,) * (len(batch) - (a.dim() - 1))).expand((L,) + batch)
    e = e.reshape(tuple(e.shape) + (1,) * (len(batch) - e.dim())).expand(batch)
    res, base = one(spec, batch, a.device), a
    for i in range(32):
        res = select(((e >> i) & 1) == 1, mont_mul(spec, res, base), res)
        base = mont_sqr(spec, base)
    return res


def pow2k(spec: FieldSpec, a: torch.Tensor, k: int) -> torch.Tensor:
    """a^(2^k): on a CUDA device one csrc/mont.cu:mont_pow launch with
    exponent 2^k (per 2^(MAX_EXP_BITS - 1) of it), where
    zkarray/ff/fp.py:pow2k runs k squarings; the plain version does the
    same k squarings."""
    while k > 0:
        step = min(k, km.MAX_EXP_BITS - 1)
        a = km.mont_pow(spec, a, 1 << step)
        k -= step
    return a


def inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^-1; inv(0) = 0. On a CUDA device one csrc/mont.cu:mont_inv launch,
    a binary extended GCD per element (the reference's inverse); on the CPU
    Fermat's a^(p-2), as zkarray/ff/fp.py:inv computes it. The inverse is
    unique, so both give the same words."""
    return km.mont_inv(spec, a)


def batch_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse of a batch via Montgomery's trick: prefix and
    suffix product scans and one inversion (kernels/mont.py:batch_inv_by on
    ``mont_mul`` and ``inv``). Zeros map to zero."""
    return km.batch_inv_by(spec, a, mont_mul, inv)


# ---------------------------------------------------------------------------
# legendre / sqrt
# ---------------------------------------------------------------------------

def legendre(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Legendre symbol as int32: 1 (square), -1 (non-square), 0 (zero)."""
    l = pow_const(spec, a, spec.mod_minus_one_div_two)  # noqa: E741
    out = torch.where(is_one(spec, l), 1, -1)
    return torch.where(lb.is_zero(a), 0, out).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _ts_consts(spec: FieldSpec) -> Tuple[int, ...]:
    """Tonelli-Shanks constants, Montgomery form: cs_inv[j] = c^(-2^j) for
    j < s, where c = qnr^trace has exact order 2^s (zkarray/ff/fp.py:
    _ts_consts; its second table is the first one again)."""
    p = spec.modulus
    x = pow(pow(spec.sqrt_qnr, spec.trace, p), -1, p)
    out = []
    for _ in range(spec.two_adicity):
        out.append(spec.to_mont_int(x))
        x = x * x % p
    return tuple(out)


def sqrt(spec: FieldSpec, a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched square root: (root, is_square mask); root 0 where a is not a
    square. p = 3 mod 4: one power; p = 5 mod 8: Atkin, corrected by
    2^((p-1)/4); else Tonelli-Shanks as a bit-by-bit discrete log in the
    2-Sylow subgroup, with no data-dependent control flow
    (zkarray/ff/fp.py:sqrt, the same roots)."""
    batch, dev = a.shape[1:], a.device
    if spec.sqrt_mode == "3mod4":
        r = pow_const(spec, a, spec.sqrt_exp)
    elif spec.sqrt_mode == "5mod8":
        p = spec.modulus
        r = pow_const(spec, a, (p + 3) // 8)
        chk = pow_const(spec, a, (p - 1) // 4)
        twist = const_array(spec, pow(2, (p - 1) // 4, p), batch, dev)
        r = select(is_one(spec, chk), r, mont_mul(spec, r, twist))
    else:
        s, t = spec.two_adicity, spec.trace
        cs_inv = _ts_consts(spec)
        # g = a^t lies in the order-2^s subgroup; r^2 = a g with r = a^((t+1)/2).
        # Solve c^f = g bit by bit: f_j = [(g c^-f<j)^(2^(s-1-j)) != 1]; for a
        # square f is even and its root is r c^(-f/2)
        g = pow_const(spec, a, t)
        r = pow_const(spec, a, (t + 1) // 2)
        for j in range(s):
            bit = ~is_one(spec, pow2k(spec, g, s - 1 - j))
            g = select(bit, mont_mul(spec, g, _const(spec, cs_inv[j], batch, dev)), g)
            if j >= 1:
                r = select(bit, mont_mul(spec, r, _const(spec, cs_inv[j - 1], batch, dev)), r)
    ok = eq(mont_sqr(spec, r), a)
    return select(ok, r, zero(spec, batch, dev)), ok


# ---------------------------------------------------------------------------
# dot products / sums
# ---------------------------------------------------------------------------

def _product_cols(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of two L-limb tensors as (2L+1, *batch) int64
    columns (each below L 2^32: exact)."""
    L = spec.num_limbs
    a, b = km.align(L, a, b)
    b64 = b.to(torch.int64)
    cols = torch.zeros((2 * L + 1,) + tuple(a.shape[1:]), dtype=torch.int64, device=a.device)
    for i in range(L):
        cols[i : i + L] += a[i].to(torch.int64)[None] * b64
    return cols


def sum_of_products(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Sum_i a_i b_i along a batch axis (``axis`` counts batch axes).

    mont_reduce is exact while the columns' value stays below R p, so up to
    k = floor(R/p) - 1 raw products (each < p^2) accumulate per reduction;
    below k = 2 each product is reduced and the products tree-summed
    (zkarray/ff/fp.py:sum_of_products)."""
    ax = axis + 1
    n = a.shape[ax]
    k_lazy = max(0, ((1 << spec.r_bits) // spec.modulus) - 1)
    if k_lazy < 2:
        return tree_sum(spec, mont_mul(spec, a, b), axis=axis)
    out = None
    for s0 in range(0, n, k_lazy):
        cols = None
        for idx in range(s0, min(s0 + k_lazy, n)):
            c = _product_cols(spec, a.select(ax, idx), b.select(ax, idx))
            cols = c if cols is None else cols + c
        part = mont_reduce(spec, cols)
        out = part if out is None else add(spec, out, part)
    return out


def tree_sum(spec: FieldSpec, a: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Field sum along a batch axis: lazy limb sums of up to 2^14 elements
    (value < 2^14 p < R p), each chunk brought back by one mont_reduce and
    to_mont (zkarray/ff/fp.py:tree_sum)."""
    ax = axis + 1
    chunk = 1 << 14
    x = a
    while x.shape[ax] > 1:
        n = x.shape[ax]
        x64 = x.to(torch.int64)
        if n > chunk:
            pad = (-n) % chunk
            if pad:
                x64 = torch.cat([x64, x64.new_zeros(x64.shape[:ax] + (pad,) + x64.shape[ax + 1:])],
                                dim=ax)
            shp = list(x64.shape)
            shp[ax : ax + 1] = [(n + pad) // chunk, chunk]
            lazy = x64.reshape(shp).sum(dim=ax + 1)
        else:
            lazy = x64.sum(dim=ax, keepdim=True)
        x = to_mont(spec, mont_reduce(spec, lazy))
    return x.select(ax, 0)
