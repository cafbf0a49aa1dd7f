"""Variable-base multi-scalar multiplication (signed-digit Pippenger).

Counterpart of zkarray/ec/msm.py: msm, msm_affine, ChunkedMSM, the
magnitude-partitioned msm_mixed (classify_scalars, _msm_binary) and their
building blocks. The design is the JAX package's "aligned bucket rounds":

1.  Per window, sort point indices by |digit| (stable); the sort payload
    carries the point index, the digit's sign (bit 30) and an infinity flag
    (bit 29).
2.  Bucket b's points sit at sorted positions [S[b-1], S[b]) (searchsorted).
3.  Round r adds to every bucket its r-th point. Slots are permuted by
    occupancy, descending; band 1 runs mean + 2 sigma rounds over all slots,
    band 2 continues the top-1/8 prefix, and a residual loop of T-round
    tiles finishes any bucket beyond both bands. The bands are performance
    choices, never correctness assumptions.
4.  Buckets reduce to window sums by weight bits (tree sums + bit-Horner),
    and one Horner launch combines the windows. A tree's levels wider than
    kernels/sw.py:TREE_SUM_MAX are element-wise xyzz_add launches; the rest
    of the tree is one xyzz_tree_sum launch, and the bit-Horner over all
    windows one xyzz_bit_horner launch.

There is one accumulate path on every device: the feeds are built here in
plain PyTorch and consumed by kernels/sw.py:xyzz_accum_grid and
xyzz_accum_tiles, which run the CUDA kernel on CUDA tensors and the plain
version on CPU tensors. The JAX package's per-round XLA fallback exists for
its TPU build and has no counterpart here.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core.limbs import pack_pairs as _pack_pairs
from zkarray_torch.core.limbs import unpack_pairs as _unpack_pairs
from zkarray_torch.ec import sw
from zkarray_torch.ec.sw import AffinePoints, SWCurveSpec, XYZZPoints
from zkarray_torch.ff import fp
from zkarray_torch.kernels import sw as ksw

# Rounds per residual tile.
ACCUM_T = 16
# Band bounds in standard deviations of the Poisson bucket occupancy.
R1_SIG = 2.0
R2_SIG = 5.0
# Device-memory budget for one window group's band-1 coordinate feed. A
# BLS12-381 MSM of 2^20 points at c = 13 needs ~2.3 GB for all 20 windows,
# so on an 80 GB card one group takes them all.
GROUP_BYTES = 16 << 30
# Device-memory budget for the bucket reduction's masked copies of the
# bucket state, one per weight bit of a group: the 13 bits of c = 13 take
# 0.4 GB and share one group, so each tree level is one launch for them all.
REDUCE_BYTES = 2 << 30
IDX_MASK = (1 << 29) - 1


def default_window_size(n: int) -> int:
    """c ~ log2(n)/2 + 3 (zkarray/ec/msm.py:default_window_size)."""
    if n <= 32:
        return 3
    return max(3, min(16, int(math.log2(n)) // 2 + 3))


def signed_digits(spec, scalars: torch.Tensor, c: int, num_windows: int) -> torch.Tensor:
    """Canonical scalar limbs (Ls, N) -> signed window digits (W, N) int32
    in [-2^(c-1), 2^(c-1)]. Requires c <= 16."""
    if not 1 <= c <= 16:
        raise ValueError("window size must be in [1, 16]")
    Ls = spec.num_limbs
    s = scalars.to(torch.int64)
    mask = (1 << c) - 1
    half = 1 << (c - 1)
    carry = torch.zeros(s.shape[1], dtype=torch.int64, device=s.device)
    outs = []
    for w in range(num_windows):
        bitpos = w * c
        limb, off = divmod(bitpos, 16)
        if limb < Ls:
            raw = s[limb] >> off
            if off + c > 16 and limb + 1 < Ls:
                raw = raw | (s[limb + 1] << (16 - off))
            raw = raw & mask
        else:
            raw = torch.zeros_like(carry)
        coef = raw + carry
        carry = (coef + half) >> c
        outs.append(coef - (carry << c))
    return torch.stack(outs).to(torch.int32)


def _window_geometry(c: int, scalar_bits: int):
    """(W, half, splits, W_main); splits = [(w, v_w, K_w)] tail windows whose
    narrow digit range is spread over K_w sub-slots."""
    half = 1 << (c - 1)
    W = (scalar_bits + c + 1) // c
    splits = []
    for w in range(W):
        rem_w = max(0, min(c, scalar_bits - c * w))
        v_w = (1 << rem_w) + 1
        K_w = max(1, half // v_w)
        if K_w >= 2:
            splits.append((w, v_w, K_w))
    W_main = splits[0][0] if splits else W
    return W, half, splits, W_main


def _accum_bounds(c: int, n: int, T: int):
    """Static band-1 and band-2 round counts from Poisson occupancy."""
    half = 1 << (c - 1)
    mean = max(1.0, n / half)
    sig = math.sqrt(mean)
    r1 = max(T, int(math.ceil((mean + R1_SIG * sig) / T)) * T)
    r2 = max(T, int(math.ceil((R2_SIG * sig) / T)) * T)
    return r1, r2


def _group_windows(W: int, half: int, r1b: int, L: int) -> int:
    """Windows whose band-1 feed (r1b * half slots of L int32 words each) is
    built together within GROUP_BYTES."""
    per_window = r1b * half * L * 4
    return max(1, min(W, GROUP_BYTES // max(per_window, 1)))


def _accum_grid(curve, packed, S, counts, pxy, state, c, scalar_bits):
    """Occupancy-permuted band sweeps plus the residual loop, per window
    group; returns the (L, W, half) bucket state."""
    L = curve.base.num_limbs
    Lp = L // 2
    W, half, _, _ = _window_geometry(c, scalar_bits)
    N = packed.shape[1]
    T = ACCUM_T
    r1b, r2b = _accum_bounds(c, N, T)
    G = _group_windows(W, half, r1b, L)
    dev = packed.device
    packed_flat = packed.reshape(W * N)

    def padded_feed(slo, base, cnt, r_start, R):
        """Round-major feed for slots (slo, base, cnt) from round r_start
        (an int or a per-slot tensor): coords (L, R, width), vwords (R, width)."""
        t = torch.arange(R, dtype=torch.int64, device=dev)
        pos = (slo + r_start)[None, :] + t[:, None]
        valid = pos < (slo + cnt)[None, :]
        posc = torch.where(valid, pos, 0)
        pk = packed_flat[(base[None, :] + posc).reshape(-1)]
        idx = (pk & IDX_MASK).to(torch.int64)
        vword = valid.to(torch.int32) | (((pk >> 30) & 1).reshape(valid.shape) << 1)
        coords = pxy[:, idx].reshape(L, R, slo.shape[0])
        return coords, vword

    out_parts = []
    for g0 in range(0, W, G):
        g1 = min(W, g0 + G)
        Gg = g1 - g0
        WB = Gg * half
        nb = -(-WB // 1024)
        WBp = nb * 1024
        pad = WBp - WB

        cnt = F.pad(counts[g0:g1].reshape(WB), (0, pad))
        slo = F.pad(S[g0:g1, :-1].reshape(WB), (0, pad))
        base = F.pad(
            (torch.arange(g0, g1, dtype=torch.int64, device=dev) * N)[:, None]
            .expand(Gg, half).reshape(WB),
            (0, pad),
        )
        # occupancy-descending slot permutation (pad slots have count 0)
        order = torch.argsort(-cnt, stable=True)
        cnt_s, slo_s, base_s = cnt[order], slo[order], base[order]

        rws = torch.cat([_pack_pairs(v[:, g0:g1].reshape(L, WB)) for v in state], dim=0)
        stp = F.pad(rws, (0, pad))[:, order].contiguous()

        # band 1: all slots
        c1, v1 = padded_feed(slo_s, base_s, cnt_s, 0, r1b)
        stp = ksw.xyzz_accum_grid(curve, stp, c1, v1)
        del c1, v1

        # band 2: the top-occupancy prefix only
        K = max(1, nb // 8) * 1024
        if K < WBp:
            c2, v2 = padded_feed(slo_s[:K], base_s[:K], cnt_s[:K], r1b, r2b)
            st2 = ksw.xyzz_accum_grid(curve, stp[:, :K].contiguous(), c2, v2)
            stp = torch.cat([st2, stp[:, K:]], dim=1)
            done = torch.where(torch.arange(WBp, device=dev) < K, r1b + r2b, r1b)
        else:
            c2, v2 = padded_feed(slo_s, base_s, cnt_s, r1b, r2b)
            stp = ksw.xyzz_accum_grid(curve, stp, c2, v2)
            done = torch.full((WBp,), r1b + r2b, dtype=torch.int64, device=dev)
        del c2, v2

        # residual: occupancy beyond the static bounds (normally none)
        rem_max = int((cnt_s - done).clamp(min=0).max())
        for t0 in range(0, rem_max, T):
            c3, v3 = padded_feed(slo_s, base_s, cnt_s, done + t0, T)
            stp = ksw.xyzz_accum_tiles(curve, stp, c3, v3)

        # un-permute and unpack the group's bucket state
        inv = torch.empty_like(order)
        inv[order] = torch.arange(WBp, device=dev)
        rws = stp[:, inv][:, :WB]
        parts = [_unpack_pairs(rws[i * Lp : (i + 1) * Lp]) for i in range(4)]
        out_parts.append(XYZZPoints(*(p.reshape(L, Gg, half) for p in parts)))
    if len(out_parts) == 1:
        return out_parts[0]
    return XYZZPoints(*(torch.cat(vs, dim=1) for vs in zip(*out_parts)))


def msm_accumulate(curve: SWCurveSpec, points: AffinePoints, scalars: torch.Tensor,
                   c: int, scalar_bits: int, state: XYZZPoints) -> XYZZPoints:
    """Accumulate one point/scalar chunk into the (L, W, half) bucket state."""
    n = points.x.shape[1]
    if n >= 1 << 29:
        raise ValueError("at most 2^29 - 1 points per chunk")
    W, half, splits, _ = _window_geometry(c, scalar_bits)
    dev = points.x.device

    digits = signed_digits(curve.scalar, scalars, c, W)  # (W, N)
    # points at infinity sort below every bucket fence and are never fetched
    mag = torch.where(points.inf[None, :], 0, digits.abs())
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    for w, v_w, K_w in splits:
        row = mag[w]
        mag[w] = torch.where(row > 0, row + (iota % K_w) * v_w, 0)

    payload = (
        iota[None, :]
        | ((digits < 0).to(torch.int32) << 30)
        | (points.inf.to(torch.int32) << 29)[None, :]
    )
    keys, perm = torch.sort(mag, dim=1, stable=True)
    packed = torch.gather(payload, 1, perm)

    # bucket b (1..half) occupies sorted range [S[b-1], S[b])
    vals = torch.arange(1, half + 2, dtype=keys.dtype, device=dev).expand(W, half + 1)
    S = torch.searchsorted(keys, vals.contiguous(), side="left")  # (W, half+1) int64
    counts = S[:, 1:] - S[:, :-1]
    pxy = _pack_pairs(torch.cat([points.x, points.y], dim=0))  # (L, N) words
    return _accum_grid(curve, packed, S, counts, pxy, state, c, scalar_bits)


def _tree_sum_last(curve, P: XYZZPoints) -> XYZZPoints:
    """Pairwise tree-sum over the last axis: element i meets i + m // 2, an
    odd last element is carried. The route is the width's: each level wider
    than kernels.sw.TREE_SUM_MAX is one element-wise xyzz_add, and the levels
    from there down to one point are one xyzz_tree_sum."""
    m = P.x.shape[-1]
    while m > ksw.TREE_SUM_MAX:
        h = m // 2
        lo = XYZZPoints(*(v[..., :h] for v in P))
        hi = XYZZPoints(*(v[..., h : 2 * h] for v in P))
        red = sw.xyzz_add(curve, lo, hi)
        if m % 2:
            red = XYZZPoints(*(torch.cat([a, v[..., 2 * h :]], dim=-1) for a, v in zip(red, P)))
        m -= h
        P = red
    if m > 1:
        P = XYZZPoints(*ksw.xyzz_tree_sum(curve, P))
    return P


def _bits_per_group(L: int, W: int, B: int, nbits: int) -> int:
    """Weight bits whose masked (L, q, W, B) bucket copies are tree-summed
    together within REDUCE_BYTES (the JAX package takes 4)."""
    return max(1, min(nbits, REDUCE_BYTES // (4 * L * W * B * 4)))


def _weighted_sum_bits(curve: SWCurveSpec, state: XYZZPoints, weights: np.ndarray,
                       quad: Optional[int] = None) -> XYZZPoints:
    """win_w = sum_j weights[w, j] * state[:, w, j] for a host-constant
    weight matrix: per weight bit a masked tree-sum, then bit-Horner. The
    bits go through the tree sums ``quad`` at a time (by default as many as
    REDUCE_BYTES allows); every (bit, window) row is summed on its own, so
    the grouping does not change the result. The bit masks are made on the
    tensors' device from one copy of the weights (host temporaries of the
    mask size cost more than the reduce's kernels on a host whose page
    faults are slow). The bit-Horner over the (L, nbits, W) partials is one
    kernels.sw.xyzz_bit_horner call; with one group it reads the tree sums'
    output in place."""
    f = curve.base
    L = f.num_limbs
    W, B = weights.shape
    dev = state.x.device
    nbits = int(weights.max()).bit_length()
    if quad is None:
        quad = _bits_per_group(L, W, B, nbits)
    wdev = torch.from_numpy(weights.astype(np.int32)).to(dev)[None]  # weights < 2^31
    parts = ([], [], [], [])  # per coordinate, each group's (L, q, W) partials
    for k0 in range(0, nbits, quad):
        q = min(quad, nbits - k0)
        ks = torch.arange(k0, k0 + q, dtype=torch.int32, device=dev)[:, None, None]
        mj = ((wdev >> ks) & 1).bool()  # (q, W, B)
        one = fp.one(f, (q, W, B), dev)
        zero = fp.zero(f, (q, W, B), dev)
        sel = XYZZPoints(
            fp.select(mj, state.x[:, None], one),
            fp.select(mj, state.y[:, None], one),
            fp.select(mj, state.zz[:, None], zero),
            fp.select(mj, state.zzz[:, None], zero),
        )
        for cs, v in zip(parts, _tree_sum_last(curve, sel)):
            cs.append(v.reshape(L, q, W))
    stacked = [cs[0] if len(cs) == 1 else torch.cat(cs, dim=1) for cs in parts]
    return XYZZPoints(*ksw.xyzz_bit_horner(curve, stacked))  # coords (L, W)


@functools.lru_cache(maxsize=None)
def _bucket_weights(c: int, scalar_bits: int) -> np.ndarray:
    """(W, half) bucket weights: 1..half, restarting every v_w slots in a
    split window (slot d + v_w k holds digit d + 1). Cached per (c, bits),
    so the array is read-only."""
    W, half, splits, _ = _window_geometry(c, scalar_bits)
    weights = np.zeros((W, half), dtype=np.uint32)
    weights[:] = np.arange(1, half + 1, dtype=np.uint32)[None, :]
    for w, v_w, K_w in splits:
        row = np.zeros(half, dtype=np.uint32)
        used = K_w * v_w
        row[:used] = (np.arange(used, dtype=np.uint32) % v_w) + 1
        weights[w] = row
    weights.setflags(write=False)
    return weights


def msm_reduce(curve: SWCurveSpec, state: XYZZPoints, c: int, scalar_bits: int) -> XYZZPoints:
    """(L, W, half) bucket state -> the MSM's XYZZ point, coords (L,)."""
    win = _weighted_sum_bits(curve, state, _bucket_weights(c, scalar_bits))  # coords (L, W)
    L = curve.base.num_limbs
    rows = torch.cat(list(win), dim=0)  # (4L, W)
    res = ksw.horner_windows(curve, rows.T.contiguous(), c)  # (4L,)
    return XYZZPoints(*(res[i * L : (i + 1) * L] for i in range(4)))


def msm(curve: SWCurveSpec, points: AffinePoints, scalars: torch.Tensor,
        c: Optional[int] = None, max_scalar_bits: Optional[int] = None) -> XYZZPoints:
    """Σ scalars_i * points_i; ``scalars`` canonical limbs (Ls, N). Returns
    one XYZZ point (coords (L,)); ``max_scalar_bits`` bounds every scalar's
    bit length and with it the window count."""
    n = points.x.shape[1]
    if c is None:
        c = default_window_size(n)
    scalar_bits = curve.scalar.bits
    if max_scalar_bits is not None:
        scalar_bits = min(scalar_bits, max_scalar_bits)
    W, half, _, _ = _window_geometry(c, scalar_bits)
    state = sw.xyzz_zero(curve, (W, half), points.x.device)
    state = msm_accumulate(curve, points, scalars, c, scalar_bits, state)
    return msm_reduce(curve, state, c, scalar_bits)


def msm_affine(curve, points, scalars, c=None) -> AffinePoints:
    res = msm(curve, points, scalars, c)
    return sw.xyzz_to_affine(curve, XYZZPoints(*(v.reshape(v.shape + (1,)) for v in res)))


class ChunkedMSM:
    """Streaming MSM over fixed-size chunks with the (W, half) bucket state
    carried between them, so the reduction is paid once at the end. All
    chunks have the same width; a shorter one is padded with infinity
    points and zero scalars."""

    def __init__(self, curve: SWCurveSpec, chunk_size: int, c: Optional[int] = None,
                 max_scalar_bits: Optional[int] = None, device=DEFAULT_DEVICE):
        self.curve = curve
        self.chunk_size = chunk_size
        self.c = default_window_size(chunk_size) if c is None else c
        bits = curve.scalar.bits
        if max_scalar_bits is not None:
            bits = min(bits, max_scalar_bits)
        self.scalar_bits = bits
        W, half, _, _ = _window_geometry(self.c, bits)
        self.state = sw.xyzz_zero(curve, (W, half), device)

    def add_chunk(self, points: AffinePoints, scalars: torch.Tensor):
        """Accumulate one chunk (width <= chunk_size)."""
        n = points.x.shape[1]
        if n > self.chunk_size:
            raise ValueError("chunk wider than chunk_size")
        if n != self.chunk_size:
            pad = self.chunk_size - n
            points = AffinePoints(
                F.pad(points.x, (0, pad)),
                F.pad(points.y, (0, pad)),
                F.pad(points.inf, (0, pad), value=True),
            )
            scalars = F.pad(scalars, (0, pad))
        self.state = msm_accumulate(
            self.curve, points, scalars, self.c, self.scalar_bits, self.state
        )

    def result(self) -> XYZZPoints:
        return msm_reduce(self.curve, self.state, self.c, self.scalar_bits)


# ---------------------------------------------------------------------------
# magnitude-partitioned front end (reference msm_signed's ScalarSize classes,
# ec/src/scalar_mul/variable_base/mod.rs:242-434)
# ---------------------------------------------------------------------------

SCALAR_CLASSES = (1, 8, 16, 32, 64)


@functools.lru_cache(maxsize=None)
def _limb_bit_lengths() -> np.ndarray:
    """Bit length of every 16-bit limb value (0 for 0)."""
    v = np.arange(1 << 16)
    out = np.zeros(1 << 16, dtype=np.int64)
    out[1:] = np.floor(np.log2(v[1:])).astype(np.int64) + 1
    out.setflags(write=False)
    return out


def classify_scalars(scalars_np: np.ndarray, num_bits: int):
    """Host pass: scalar limb matrix (Ls, N) -> [(bits, index array)], one
    entry per nonempty class of bit lengths (0, 1], (1, 8], (8, 16], (16,
    32], (32, 64], (64, num_bits]; every nonzero scalar is in exactly one
    class and zero scalars in none (zkarray/ec/msm.py:classify_scalars).
    The bit length is that of the top nonzero limb, read from a table, plus
    16 per limb below it: a few whole-array passes, where the JAX package
    takes a log2 pass per limb (~0.2 s for 2^20 BLS12-381 scalars)."""
    Ls, n = scalars_np.shape
    nz = scalars_np != 0
    top = Ls - 1 - np.argmax(nz[::-1], axis=0)  # the top nonzero limb (Ls - 1 when all are zero)
    bitlen = np.where(nz.any(axis=0),
                      16 * top + _limb_bit_lengths()[scalars_np[top, np.arange(n)]], 0)
    out = []
    prev = 0
    for b in SCALAR_CLASSES + (num_bits,):
        b = min(b, num_bits)
        sel = np.nonzero((bitlen > prev) & (bitlen <= b))[0]
        if sel.size:
            out.append((b, sel))
        prev = b
        if b == num_bits:
            break
    return out


def _msm_binary(curve: SWCurveSpec, points: AffinePoints) -> XYZZPoints:
    """Σ P_i (every scalar 1): the XYZZ tree sum of the points in the JAX
    package's order (zkarray/ec/msm.py:_msm_binary, the reference's
    msm_binary without the sort), through _tree_sum_last: xyzz_add launches
    on levels wider than kernels.sw.TREE_SUM_MAX, then one xyzz_tree_sum."""
    st = _tree_sum_last(curve, sw.xyzz_from_affine(curve, points))
    return XYZZPoints(*(v[..., 0] for v in st))


def msm_mixed(curve: SWCurveSpec, points: AffinePoints, scalars: torch.Tensor,
              c: Optional[int] = None) -> XYZZPoints:
    """Magnitude-partitioned MSM (reference msm_signed, mod.rs:242-347): the
    scalars are read to the host once and classified by bit length; the
    1-bit class is a tree sum of its points, every other class one
    ``msm(..., max_scalar_bits=bits)`` over its points, and the class
    totals are added in class order with xyzz_add. All-zero scalars give
    xyzz_zero. Returns one XYZZ point (coords (L,))."""
    classes = classify_scalars(scalars.cpu().numpy(), curve.scalar.bits)
    dev = points.x.device
    total = None
    for bits, idx in classes:
        ix = torch.from_numpy(idx).to(dev)
        sub = AffinePoints(points.x[:, ix], points.y[:, ix], points.inf[ix])
        if bits <= 1:
            part = _msm_binary(curve, sub)
        else:
            part = msm(curve, sub, scalars[:, ix], c, int(bits))
        total = part if total is None else sw.xyzz_add(curve, total, part)
    if total is None:
        return sw.xyzz_zero(curve, (), dev)
    return total
