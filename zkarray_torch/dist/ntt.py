"""Multi-device NTT: the four-step (Bailey) decomposition with three
all_to_all exchanges.

Counterpart of zkarray/dist/ntt.py. Cross-shard butterfly stages become
matrix transposes: a local FFT over n1, the twiddle, a transpose, a local
FFT over n2 and a last transpose back to natural order. Each of the JAX
package's ``jax.lax.all_to_all(..., tiled=True)`` calls is one
``torch.distributed.all_to_all_single``: the split axis is cut into D
blocks moved to the front (block j goes to rank j) and the received blocks
are laid along the concatenation axis in rank order. The local twiddles are
the JAX package's: a power table of w, shifted by w^(rank n2/D), then
powered over k1 by log-depth doubling; every product is fully reduced, so
the words are its words.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.dist.mesh import Mesh
from zkarray_torch.ff import fp
from zkarray_torch.poly.domain import _fft_core, _power_table, fft_fourstep_core


def fft_fourstep(spec: FieldSpec, x: torch.Tensor, n1: int, n2: int, w_int: int,
                 scale_int: Optional[int] = None) -> torch.Tensor:
    """Single-device four-step NTT (the sharded version's oracle): x (L, n)
    flat, i = i1 n2 + i2 -> (L, n) natural order."""
    return fft_fourstep_core(spec, x, n1, n2, w_int, scale_int)


def _all_to_all(t: torch.Tensor, split: int, concat: int, mesh: Mesh) -> torch.Tensor:
    """jax.lax.all_to_all(t, split_axis=split, concat_axis=concat,
    tiled=True) over the mesh, for split != concat (axes >= 1): block j of
    the split axis goes to rank j, and the block received from rank j lands
    at position j of the concatenation axis."""
    D = mesh.size
    shape = list(t.shape)
    send = t.reshape(shape[:split] + [D, shape[split] // D] + shape[split + 1:]).movedim(split, 0)
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    out_shape = list(recv.shape[1:])
    out_shape[concat] *= D
    return recv.movedim(0, concat).reshape(out_shape)


def fft_sharded(spec: FieldSpec, x: torch.Tensor, mesh: Mesh, w_int: int,
                n1: Optional[int] = None, axis: str = "shards", scale_int: Optional[int] = None,
                local: bool = False) -> torch.Tensor:
    """Sharded four-step NTT over ``mesh``: x is the whole (L, n) array, or
    this rank's (L, n/D) contiguous shard when ``local``; returns this
    rank's (L, n/D) shard of the natural-order output.

    Needs n1 n2 = n with D | n1 and D | n2 (D the mesh size). Twiddles are
    computed per shard (no replicated n-sized table).
    """
    if axis != mesh.axis:
        raise ValueError(f"fft_sharded: the mesh's axis is {mesh.axis!r}, not {axis!r}")
    L = x.shape[0]
    D, me = mesh.size, mesh.rank
    n = x.shape[1] * D if local else x.shape[1]
    p = spec.modulus
    if n1 is None:
        n1 = 1 << ((n.bit_length() - 1) // 2)
        while n1 % D and n1 < n:  # no power of two is a multiple of an odd D > 1
            n1 *= 2
    n2 = n // n1
    if n1 * n2 != n or n1 % D or n2 % D:
        raise ValueError(f"need n1·n2 = n with D | n1 and D | n2 (n1={n1}, n2={n2}, D={D})")
    x_loc = x if local else x[:, me * (n // D):(me + 1) * (n // D)]
    dev = x.device
    w_n1, w_n2 = pow(w_int, n2, p), pow(w_int, n1, p)

    # (L, n1/D, n2) rows -> i1 whole, i2 sharded: (L, n1, n2/D)
    A = _all_to_all(x_loc.reshape(L, n1 // D, n2), 2, 1, mesh)
    B = _fft_core(spec, A, n1, w_n1, None)
    # T[k1, j] = w^(k1 (off + j)), off = rank n2/D: the base w^(off + j),
    # then its powers over k1 by doubling
    base_local = _power_table(spec, w_int, n2 // D, dev)  # read-only
    w_off = fp.pow_u32(spec, fp.const_array(spec, w_int, (1,), dev), me * (n2 // D))
    base = fp.mont_mul(spec, base_local, w_off)  # (L, n2/D)
    T = fp.one(spec, (1, n2 // D), dev)
    bpow = base[:, None, :]
    for _ in range(n1.bit_length() - 1):
        T = torch.cat([T, fp.mont_mul(spec, T, bpow)], dim=1)
        bpow = fp.mont_sqr(spec, bpow)
    C = fp.mont_mul(spec, B, T)
    # k1 sharded, i2 whole: (L, n1/D, n2); then the size-n2 NTT over i2
    C = _all_to_all(C, 1, 2, mesh)
    E = _fft_core(spec, C.transpose(1, 2), n2, w_n2, scale_int)  # (L, n2, n1/D) = [k2, k1]
    # natural order k = k2 n1 + k1: k2 sharded, k1 whole
    E = _all_to_all(E, 1, 2, mesh)
    return E.reshape(L, n // D)


def gather_shards(shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' (L, m) shards -> the whole (L, D m) array on every rank."""
    parts = [torch.empty_like(shard) for _ in range(mesh.size)]
    dist.all_gather(parts, shard.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=1)
