"""Dense and sparse multilinear extensions (the sumcheck building block).

Counterpart of zkarray/poly/mle.py. A dense MLE is its (L, 2^k) table over
{0,1}^k in little-endian index order (variable j is bit j of the index).
``fix_variables`` folds adjacent pairs lo + r (hi - lo), three launches per
variable on a CUDA device; ``eq_table`` doubles its table once per variable
with two products. Sparse MLEs are (indices int64 (nnz,), values (L, nnz)).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ff import fp


def num_vars(evals: torch.Tensor) -> int:
    n = evals.shape[1]
    k = n.bit_length() - 1
    if 1 << k != n:
        raise ValueError(f"evaluation table must have power-of-two size, not {n}")
    return k


def fix_variables(spec: FieldSpec, evals: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Fix the first m variables to ``points`` (L, m): the folded table
    (L, 2^(k - m))."""
    L = spec.num_limbs
    x = evals
    for j in range(points.shape[1]):
        pairs = x.reshape(L, x.shape[1] // 2, 2)
        lo, hi = pairs[:, :, 0], pairs[:, :, 1]
        x = fp.add(spec, lo, fp.mont_mul(spec, fp.sub(spec, hi, lo), points[:, j:j + 1]))
    return x


def evaluate(spec: FieldSpec, evals: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """The MLE at one point (L, k) -> (L, 1)."""
    if point.shape[1] != num_vars(evals):
        raise ValueError(f"point has {point.shape[1]} coordinates, the MLE {num_vars(evals)} variables")
    return fix_variables(spec, evals, point)


def relabel(spec: FieldSpec, evals: torch.Tensor, a: int, b: int, k: int) -> torch.Tensor:
    """Swap the variable blocks [a, a + k) and [b, b + k)."""
    idx = np.arange(1 << num_vars(evals))
    amask = ((1 << k) - 1) << a
    bmask = ((1 << k) - 1) << b
    new = (idx & ~amask & ~bmask) | (((idx & amask) >> a) << b) | (((idx & bmask) >> b) << a)
    return evals[:, torch.from_numpy(new.astype(np.int64)).to(evals.device)]


def concat(spec: FieldSpec, polys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tables one after another, zero-padded to a power of two."""
    total = sum(p.shape[1] for p in polys)
    n = 1 << (total - 1).bit_length()
    return torch.nn.functional.pad(torch.cat(list(polys), dim=1), (0, n - total))


def add(spec, a, b):
    return fp.add(spec, a, b)


def sub(spec, a, b):
    return fp.sub(spec, a, b)


def mul(spec, a, b):
    """Pointwise product of two tables."""
    return fp.mont_mul(spec, a, b)


def eq_table(spec: FieldSpec, r: torch.Tensor) -> torch.Tensor:
    """eq(x, r) = prod_j (x_j r_j + (1 - x_j)(1 - r_j)) over {0,1}^k, (L, 2^k).
    Variable j's factors are appended as the table's top half, so bit j of
    the index is x_j (little-endian)."""
    dev = r.device
    one = fp.one(spec, (1,), dev)
    t = one
    for j in range(r.shape[1]):
        rj = r[:, j:j + 1]
        t = torch.cat([fp.mont_mul(spec, t, fp.sub(spec, one, rj)), fp.mont_mul(spec, t, rj)], dim=1)
    return t


def evaluate_sparse(spec: FieldSpec, indices: torch.Tensor, values: torch.Tensor,
                    point: torch.Tensor) -> torch.Tensor:
    """sum_i v_i eq(bits(idx_i), point) -> (L, 1)."""
    tbl = eq_table(spec, point)
    prods = fp.mont_mul(spec, tbl[:, indices.to(tbl.device)], values)
    return fp.tree_sum(spec, prods, axis=0).reshape(spec.num_limbs, 1)


def fix_variables_sparse(spec: FieldSpec, indices: torch.Tensor, values: torch.Tensor,
                         points: torch.Tensor, num_fixed: int):
    """Fix the first ``num_fixed`` variables of a sparse MLE: (indices over
    the remaining variables, values weighted by eq(low bits, points)).
    Equal indices may repeat; ``evaluate_sparse`` and ``sparse_to_dense``
    sum them."""
    tbl = eq_table(spec, points)
    idx = indices.to(tbl.device)
    w = tbl[:, idx & ((1 << num_fixed) - 1)]
    return idx >> num_fixed, fp.mont_mul(spec, values, w)


def sparse_to_dense(spec: FieldSpec, indices: torch.Tensor, values: torch.Tensor,
                    nv: int) -> torch.Tensor:
    """The dense (L, 2^nv) table, duplicate indices summed."""
    n = 1 << nv
    L = spec.num_limbs
    dev = values.device
    nnz = values.shape[1]
    onehot = indices.to(dev)[None, :] == torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    sel = fp.select(onehot, values[:, None, :].expand(L, n, nnz), fp.zero(spec, (n, nnz), dev))
    return fp.tree_sum(spec, sel, axis=1)
