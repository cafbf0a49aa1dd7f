"""Batched Montgomery prime-field arithmetic on planar base-2^16 limbs.

Counterpart of zkarray/ff/fp.py (main-path subset). Field tensors are
``int32[L, *batch]`` in Montgomery form unless stated otherwise, R = 2^(16 L).
``mont_mul``, ``mont_sqr``, ``pow_const`` and ``inv`` go through
zkarray_torch.kernels.mont, which launches a CUDA kernel for CUDA tensors;
everything else here is plain PyTorch on the tensors' own device (in the JAX
package it is XLA).
"""

from __future__ import annotations

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


add = km.add  # (a + b) mod p
sub = km.sub  # (a - b) mod p


def double(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return add(spec, a, a)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """-a mod p (0 stays 0)."""
    p = km.limb_col(spec, spec.modulus, str(a.device), a.dim() - 1).expand(a.shape)
    d, _ = lb.sub_with_borrow(p, a)
    return torch.where(lb.is_zero(a)[None], a.to(torch.int64), d).to(torch.int32)


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Canonical limbs -> Montgomery form (multiply by R^2)."""
    return mont_mul(spec, a, _const(spec, spec.r2_int, a.shape[1:], a.device))


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical limbs."""
    return mont_reduce(spec, a)


def is_zero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return lb.is_zero(a)


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


def inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^-1; inv(0) = 0. On a CUDA device one csrc/mont.cu:mont_inv launch,
    a binary extended GCD per element (the reference's inverse); on the CPU
    Fermat's a^(p-2), as zkarray/ff/fp.py:inv computes it. The inverse is
    unique, so both give the same words."""
    return km.mont_inv(spec, a)


def _scan_mul(spec: FieldSpec, x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Inclusive prefix (or suffix) products along axis 1 of (L, n), in
    log2(n) rounds of doubling strides (Hillis-Steele)."""
    n = x.shape[1]
    d = 1
    while d < n:
        if reverse:
            x = torch.cat([mont_mul(spec, x[:, : n - d], x[:, d:]), x[:, n - d :]], dim=1)
        else:
            x = torch.cat([x[:, :d], mont_mul(spec, x[:, d:], x[:, : n - d])], dim=1)
        d *= 2
    return x


def batch_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse of a batch via Montgomery's trick: prefix and
    suffix product scans and one inversion. Zeros map to zero."""
    L = spec.num_limbs
    batch_shape = a.shape[1:]
    x = a.reshape(L, -1)
    n = x.shape[1]
    zmask = lb.is_zero(x)
    x = select(zmask, one(spec, (n,), x.device), x)
    pre = _scan_mul(spec, x, reverse=False)
    suf = _scan_mul(spec, x, reverse=True)
    total_inv = inv(spec, pre[:, -1:])
    one1 = one(spec, (1,), x.device)
    pre_ex = torch.cat([one1, pre[:, :-1]], dim=1)
    suf_ex = torch.cat([suf[:, 1:], one1], dim=1)
    out = mont_mul(spec, mont_mul(spec, pre_ex, suf_ex), total_inv)
    out = select(zmask, torch.zeros_like(out), out)
    return out.reshape((L,) + tuple(batch_shape))
