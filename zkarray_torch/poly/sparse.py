"""Sparse polynomials: univariate (degree, coeff) pairs and multivariate
(powers, coeffs) term lists.

Counterpart of zkarray/poly/sparse.py. Term bookkeeping (sorting, merging
like terms, dropping zeros) is host numpy, as there; coefficients are
(L, k) Montgomery-form tensors and every combination of them is a field
kernel launch on a CUDA device. Degrees and powers are int64 tensors on the
coefficients' device. Every product and sum is fully reduced, so the words
are the JAX package's.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ff import fp


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(device)


# ---- univariate sparse: (degrees int64 (k,), coeffs (L, k)) ----

def uv_from_terms(spec: FieldSpec, terms: Sequence[Tuple[int, int]], device=DEFAULT_DEVICE):
    """[(degree, coeff_int)] -> (degrees, coeffs), sorted by degree."""
    terms = sorted(terms)
    degs = _index([d for d, _ in terms], device)
    return degs, fp.from_ints(spec, [c for _, c in terms], device=device)


def uv_evaluate(spec: FieldSpec, degrees: torch.Tensor, coeffs: torch.Tensor,
                tau: torch.Tensor) -> torch.Tensor:
    """sum_i c_i tau^(d_i), batched over points tau (L, m) -> (L, m)."""
    powers = fp.pow_u32(spec, tau[:, None, :], degrees.to(coeffs.device)[:, None])  # (L, k, m)
    return fp.tree_sum(spec, fp.mont_mul(spec, coeffs[:, :, None], powers), axis=0)


def uv_to_dense(spec: FieldSpec, degrees, coeffs: torch.Tensor, length=None) -> torch.Tensor:
    """Dense (L, length) coefficients (length: the degree + 1 by default);
    the coefficients' words are added into zeros, as the JAX package's
    scatter-add does."""
    degs = np.asarray(torch.as_tensor(degrees).cpu(), dtype=np.int64)
    n = int(degs.max()) + 1 if length is None else length
    return fp.zero(spec, (n,), coeffs.device).index_add_(1, _index(degs, coeffs.device), coeffs)


# ---- multivariate sparse: (powers int64 (k, num_vars), coeffs (L, k)) ----

def mv_from_terms(spec: FieldSpec, num_vars: int, terms, device=DEFAULT_DEVICE):
    """[(coeff_int, [(var, power), ...])] -> (powers (k, num_vars), coeffs
    (L, k)), in the given term order."""
    powers = np.zeros((len(terms), num_vars), dtype=np.int64)
    for i, (_, term) in enumerate(terms):
        for v, e in term:
            powers[i, v] += e
    return _index(powers, device), fp.from_ints(spec, [c for c, _ in terms], device=device)


def _combine_terms(spec: FieldSpec, keys: np.ndarray, coeffs: torch.Tensor):
    """keys (k, d) row keys -> unique sorted keys with the coefficients of
    each key summed and exact zeros dropped: one field add per occurrence
    rank (zkarray/poly/sparse.py:_combine_terms)."""
    dev = coeffs.device
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    order = np.argsort(inv, kind="stable")
    counts = np.bincount(inv[order], minlength=uniq.shape[0])
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    coeffs_sorted = coeffs[:, _index(order, dev)]
    acc = fp.zero(spec, (uniq.shape[0],), dev)
    for r in range(int(counts.max()) if counts.size else 0):
        sel = counts > r
        dst = _index(np.nonzero(sel)[0], dev)
        acc[:, dst] = fp.add(spec, acc[:, dst], coeffs_sorted[:, _index((starts + r)[sel], dev)])
    keep = np.nonzero(~fp.is_zero(spec, acc).cpu().numpy())[0]
    return uniq[keep], acc[:, _index(keep, dev)]


def mv_add(spec: FieldSpec, a, b):
    """(powers, coeffs) + (powers, coeffs), like terms combined, zeros
    dropped."""
    (pa, ca), (pb, cb) = a, b
    keys = np.concatenate([pa.cpu().numpy(), pb.cpu().numpy()], axis=0)
    uniq, acc = _combine_terms(spec, keys, torch.cat([ca, cb], dim=1))
    return _index(uniq, ca.device), acc


def mv_neg(spec: FieldSpec, a):
    pa, ca = a
    return pa, fp.neg(spec, ca)


def mv_sub(spec: FieldSpec, a, b):
    return mv_add(spec, a, mv_neg(spec, b))


def uv_add(spec: FieldSpec, a, b):
    """Sparse univariate add, like terms combined, zeros dropped."""
    (da, ca), (db, cb) = a, b
    keys = np.concatenate([da.cpu().numpy(), db.cpu().numpy()])[:, None]
    uniq, acc = _combine_terms(spec, keys, torch.cat([ca, cb], dim=1))
    return _index(uniq[:, 0], ca.device), acc


def uv_neg(spec: FieldSpec, a):
    d, c = a
    return d, fp.neg(spec, c)


def uv_sub(spec: FieldSpec, a, b):
    return uv_add(spec, a, uv_neg(spec, b))


def mv_evaluate(spec: FieldSpec, powers: torch.Tensor, coeffs: torch.Tensor,
                point: torch.Tensor) -> torch.Tensor:
    """sum_i c_i prod_j x_j^(e_ij) at one point (L, num_vars) -> (L, 1), or
    at a batch of points (L, num_vars, m) -> (L, m)."""
    L = spec.num_limbs
    k, nv = powers.shape
    rest = tuple(point.shape[2:])
    pw = fp.pow_u32(spec, point[:, None].expand((L, k, nv) + rest),
                    powers.to(point.device).reshape((k, nv) + (1,) * len(rest)))
    # product over the variables, a log tree over axis 2
    t, n = pw, nv
    while n > 1:
        h = n // 2
        red = fp.mont_mul(spec, t[:, :, :h], t[:, :, h:2 * h])
        if n % 2:
            red = torch.cat([red, t[:, :, 2 * h:]], dim=2)
            n = h + 1
        else:
            n = h
        t = red
    prods = fp.mont_mul(spec, coeffs.reshape((L, k) + (1,) * len(rest)), t[:, :, 0])
    out = fp.tree_sum(spec, prods, axis=0)
    return out.reshape(L, 1) if not rest else out


def _geom_terms_table(spec: FieldSpec, bases: tuple, scales: tuple, n: int, tree: bool = True,
                      device=DEFAULT_DEVICE) -> torch.Tensor:
    """sum_i scales_i bases_i^j for j < n (or the (L, k, n) rows when not
    ``tree``): each term's geometric row built by doubling, one mont_mul
    by host shift constants per doubling; bases and scales are canonical
    host ints."""
    p = spec.modulus
    k = len(bases)
    T = torch.empty((spec.num_limbs, k, n), dtype=torch.int32, device=device)
    T[:, :, 0] = fp.from_ints(spec, list(scales), device=device)
    m = 1
    while m < n:
        w = min(m, n - m)
        shift = fp.from_ints(spec, [pow(b, m, p) for b in bases], device=device)  # (L, k)
        T[:, :, m:m + w] = fp.mont_mul(spec, T[:, :, :w], shift[:, :, None])
        m *= 2
    return fp.tree_sum(spec, T, axis=0) if tree else T


def uv_evaluate_over_domain(spec: FieldSpec, degrees, coeffs: torch.Tensor, domain) -> torch.Tensor:
    """The sparse polynomial at every point of an evaluation domain, (L, n)
    in domain order: evals[j] = sum_i c_i (offset g^j)^(d_i), each term's
    (g^(d_i))^j a geometric row (O(terms n) products, no dense fft)."""
    p = spec.modulus
    degs = [int(d) for d in torch.as_tensor(degrees).cpu().tolist()]
    cs = fp.to_ints(spec, coeffs)
    bases = tuple(pow(domain.group_gen_int, d, p) for d in degs)
    scales = tuple((c * pow(domain.offset_int, d, p)) % p for c, d in zip(cs, degs))
    return _geom_terms_table(spec, bases, scales, domain.size, device=coeffs.device)
