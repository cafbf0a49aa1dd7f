"""Montgomery product, square and NTT butterflies: CUDA kernels and plain
PyTorch versions.

Counterpart of zkarray/kernels/mont.py:mont_mul, mont_sqr,
butterfly_dit_inplace and butterfly_stage. Each wrapper takes the plain
version for tensors on the CPU and launches its kernel (``csrc/mont.cu``,
``csrc/ntt.cu``) for tensors on a CUDA device (or raises); there is no other
rule and no fallback. Both versions compute every product a*b*R^-1 mod p and
every sum and difference fully reduced, so they agree bit for bit with each
other and with the JAX package.

``butterfly_dit`` runs one DIT stage in place, as the TPU kernel does through
input_output_aliases. The TPU kernel needed H % 8 == 0 and R % 128 == 0 (its
(8, 128) tiling) and took lane-broadcast twiddles, so the JAX package runs
the stages with half < 8 through XLA's slice/mul/add/concatenate instead.
Here one kernel runs every stage, with the twiddles read from the power
table at a stride. The results are identical either way, because the field
arithmetic is exact: each stage computes the same fully reduced
(lo + hi w, lo - hi w).

The module also holds the plain field helpers (constants, add, sub) that
ff/fp.py and the plain versions in kernels/sw.py share, so the kernel layer
depends on core/ only.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from zkarray_torch.core.fieldspec import LIMB_BITS, LIMB_MASK, FieldSpec
from zkarray_torch.core.limbs import normalize, sub_with_borrow
from zkarray_torch.kernels import _build


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def align2(L: int, a: torch.Tensor, b: torch.Tensor):
    """Broadcast two (L, *batch) tensors to a common batch shape, padding
    TRAILING batch dims (zkarray/ff/fp.py:_align2)."""
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = a.reshape(a.shape + (1,) * (len(batch) - (a.dim() - 1))).expand((L,) + batch)
    b = b.reshape(b.shape + (1,) * (len(batch) - (b.dim() - 1))).expand((L,) + batch)
    return a, b


@functools.lru_cache(maxsize=None)
def limb_col(spec: FieldSpec, value: int, device: str, ndim: int) -> torch.Tensor:
    """(L, 1, ..., 1) int64 limbs of a constant, for broadcasting over ndim
    batch axes."""
    t = torch.tensor(spec.limbs_of(value), dtype=torch.int64, device=device)
    return t.reshape((spec.num_limbs,) + (1,) * ndim)


@functools.lru_cache(maxsize=None)
def field_words(spec: FieldSpec, a_mont: int = 0) -> np.ndarray:
    """Host constant block the kernels read: p | 1 (Montgomery) | a
    (Montgomery) as NW = L/2 32-bit words each, then -p^-1 mod 2^32 and an
    a == 0 flag (layout in csrc/field.cuh)."""
    nw = spec.num_limbs // 2

    def words(x):
        return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(nw)]

    return np.asarray(
        words(spec.modulus) + words(spec.r_int) + words(a_mont)
        + [spec.inv32, int(a_mont == 0)],
        dtype=np.uint32,
    )


def const(spec: FieldSpec, value: int, batch_shape, device) -> torch.Tensor:
    """(L, *batch) int32 view of a constant's limbs (cached per device)."""
    col = limb_col(spec, value, str(torch.device(device)), len(tuple(batch_shape)))
    return col.to(torch.int32).expand((spec.num_limbs,) + tuple(batch_shape))


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p, plain PyTorch on the tensors' device."""
    a, b = align2(spec.num_limbs, a, b)
    s = normalize(a.to(torch.int64) + b.to(torch.int64), spec.num_limbs + 1)
    return cond_sub_p_plain(spec, s).to(torch.int32)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p, plain PyTorch on the tensors' device."""
    L = spec.num_limbs
    a, b = align2(L, a, b)
    d, borrow = sub_with_borrow(a, b)
    p = limb_col(spec, spec.modulus, str(d.device), d.dim() - 1)
    d_fix = normalize(d + p, L)
    return torch.where(borrow[None], d_fix, d).to(torch.int32)


def words_ptr(words: np.ndarray):
    return words.ctypes.data_as(ctypes.c_void_p)


def check_cuda_int32(what: str, *ts: torch.Tensor, contiguous: bool = True):
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: expected CUDA tensors, got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: expected int32 tensors, got {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors")
        if t.device != ts[0].device:
            raise ValueError(f"{what}: tensors on different devices")


def on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; False when every one lies on
    a CUDA device; raises on a mix."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {sorted(kinds)}")


# ---------------------------------------------------------------------------
# plain PyTorch version (int64 lanes holding 16-bit limbs)
# ---------------------------------------------------------------------------

def redc_plain(spec: FieldSpec, cols: torch.Tensor) -> torch.Tensor:
    """Montgomery-reduce (2L+1, *batch) int64 columns (value < R p):
    returns (value * R^-1 mod p) as int64 limbs. Mirrors _redc: per limb,
    m = -t_i/p mod 2^16, fold m*p in, carry the cleared column up."""
    L = spec.num_limbs
    batch = cols.shape[1:]
    p = limb_col(spec, spec.modulus, str(cols.device), len(batch))
    for i in range(L):
        m = (cols[i] * spec.inv16) & LIMB_MASK
        cols[i : i + L] += m[None] * p
        cols[i + 1] += cols[i] >> LIMB_BITS
    return cond_sub_p_plain(spec, normalize(cols[L:], L + 1))


def cond_sub_p_plain(spec: FieldSpec, r: torch.Tensor) -> torch.Tensor:
    """r (L+1 canonical int64 limbs, value < 2p) -> r mod p as L limbs."""
    L = spec.num_limbs
    p = limb_col(spec, spec.modulus, str(r.device), r.dim() - 1)
    p_ext = torch.cat([p, torch.zeros_like(p[:1])]).expand_as(r)
    diff, borrow = sub_with_borrow(r, p_ext)
    return torch.where(borrow[None], r[:L], diff[:L])


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b*R^-1 mod p on (L, *batch) limb tensors, in plain PyTorch."""
    L = spec.num_limbs
    a, b = align2(L, a, b)
    batch = tuple(a.shape[1:])
    a64 = a.to(torch.int64)
    b64 = b.to(torch.int64)
    cols = torch.zeros((2 * L + 1,) + batch, dtype=torch.int64, device=a.device)
    for i in range(L):
        cols[i : i + L] += a64[i][None] * b64  # 16x16-bit products, exact in int64
    return redc_plain(spec, cols).to(torch.int32)


def mont_sqr_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul_plain(spec, a, a)


def butterfly_dit_plain(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor,
                        stride: int) -> torch.Tensor:
    """One DIT stage in place on x (L, C, 2, H, R): (lo, hi) -> (lo + hi w_h,
    lo - hi w_h) with w_h = tw[:, h * stride]; returns x."""
    L, H = x.shape[0], x.shape[3]
    w = tw[:, : (H - 1) * stride + 1 : stride].reshape(L, 1, H, 1)
    lo, hi = x[:, :, 0], x[:, :, 1]
    t = mont_mul_plain(spec, hi, w)
    s, d = add(spec, lo, t), sub(spec, lo, t)
    lo.copy_(s)
    hi.copy_(d)
    return x


def butterfly_stage_plain(spec: FieldSpec, lo: torch.Tensor, hi: torch.Tensor,
                          w: torch.Tensor):
    """DIF butterfly (lo, hi, w) -> (lo + hi, (lo - hi) w)."""
    return add(spec, lo, hi), mont_mul_plain(spec, sub(spec, lo, hi), w)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _operand(t: torch.Tensor):
    """(tensor, ld, period) such that batch element i (row-major), limb k, of
    ``t`` sits at offset k*ld + i % period from its data pointer: true for a
    contiguous tensor, a slice along the first batch axis and a constant
    broadcast over leading batch axes. Anything else is copied first."""
    dims = [(s, st) for s, st in zip(t.shape[1:], t.stride()[1:]) if s != 1]
    period, j = 1, len(dims)
    while j > 0 and dims[j - 1][1] == period:
        period *= dims[j - 1][0]
        j -= 1
    if any(st != 0 for _, st in dims[:j]):
        t = t.contiguous()
        return t, t[0].numel(), t[0].numel()
    return t, t.stride(0), period


def _launch(entry: str, kernel: str, spec: FieldSpec, *ins: torch.Tensor) -> torch.Tensor:
    """Run an element-wise kernel of csrc/mont.cu on (L, *batch) inputs of
    one shape (strided as ``_operand`` allows)."""
    L = spec.num_limbs
    check_cuda_int32(kernel, *ins, contiguous=False)
    if ins[0].shape[0] != L or any(t.shape != ins[0].shape for t in ins):
        raise ValueError(f"{kernel}: expected equal (L={L}, *batch) shapes")
    ops = [_operand(t) for t in ins]
    out = torch.empty(ins[0].shape, dtype=torch.int32, device=ins[0].device)
    lib = _build.load("mont")
    with torch.cuda.device(out.device):
        err = getattr(lib, entry)(
            *(v for t, ld, per in ops for v in (t.data_ptr(), ld, per)), out.data_ptr(),
            out.numel() // L, L // 2, words_ptr(field_words(spec)),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, kernel)
    _build.LAUNCHES[kernel] += 1
    return out


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of (L, *batch) int32 limb tensors (broadcast as
    _align2 does). CPU tensors: plain version; CUDA tensors: the kernel."""
    if on_cpu(a, b):
        return mont_mul_plain(spec, a, b)
    a, b = align2(spec.num_limbs, a, b)
    return _launch("zk_mont_mul", "mont_mul", spec, a, b)


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery square; dispatch as ``mont_mul``."""
    if on_cpu(a):
        return mont_sqr_plain(spec, a)
    return _launch("zk_mont_sqr", "mont_sqr", spec, a)


def _launch_dit(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, stride: int):
    """Launch csrc/ntt.cu:butterfly_dit_kernel on x (L, C, 2, H, R) in place."""
    L = spec.num_limbs
    check_cuda_int32("butterfly_dit", x, tw)
    _, C, two, H, R = x.shape
    if x.shape[0] != L or two != 2 or tw.dim() != 2 or tw.shape[0] != L:
        raise ValueError(f"butterfly_dit: x {tuple(x.shape)} is not (L={L}, C, 2, H, R) "
                         f"or tw {tuple(tw.shape)} is not (L, T)")
    if stride < 1 or (H - 1) * stride >= tw.shape[1] or C * H * R >= 1 << 31:
        raise ValueError(f"butterfly_dit: stride {stride} over {tw.shape[1]} twiddles "
                         f"for H = {H}, or {C * H * R} pairs, is out of range")
    lib = _build.load("ntt")
    with torch.cuda.device(x.device):
        err = lib.zk_butterfly_dit(x.data_ptr(), tw.data_ptr(), C, H, R, tw.shape[1], stride,
                                   L // 2, words_ptr(field_words(spec)),
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "butterfly_dit")
    _build.LAUNCHES["butterfly_dit"] += 1
    return x


def butterfly_dit(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, stride: int):
    """One radix-2 DIT stage, IN PLACE on x int32[L, C, 2, H, R] (contiguous):
    pair (c, h, r) -> (lo + hi w_h, lo - hi w_h), w_h = tw[:, h * stride] of a
    power table tw int32[L, T]. Returns x. The caller owns x: it must not be
    anyone else's data. CPU tensors: plain version; CUDA tensors: the kernel."""
    if not x.is_contiguous():
        raise ValueError("butterfly_dit: x must be contiguous (it is written in place)")
    if on_cpu(x, tw):
        return butterfly_dit_plain(spec, x, tw, stride)
    return _launch_dit(spec, x, tw, stride)


def butterfly_stage(spec: FieldSpec, lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor):
    """DIF butterfly (lo, hi, w) -> (lo + hi, (lo - hi) w) over (L, *batch)
    tensors broadcast to one batch shape. Dispatch as ``mont_mul``."""
    L = spec.num_limbs
    if on_cpu(lo, hi, w):
        return butterfly_stage_plain(spec, lo, hi, w)
    lo, hi = align2(L, lo, hi)
    lo, w = align2(L, lo, w)
    hi, w = align2(L, hi, w)
    lo, hi, w = lo.contiguous(), hi.contiguous(), w.contiguous()
    check_cuda_int32("butterfly_stage", lo, hi, w)
    out_a, out_b = torch.empty_like(lo), torch.empty_like(lo)
    lib = _build.load("ntt")
    with torch.cuda.device(lo.device):
        err = lib.zk_butterfly_stage(lo.data_ptr(), hi.data_ptr(), w.data_ptr(), out_a.data_ptr(),
                                     out_b.data_ptr(), lo.numel() // L, L // 2,
                                     words_ptr(field_words(spec)),
                                     torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "butterfly_stage")
    _build.LAUNCHES["butterfly_stage"] += 1
    return out_a, out_b
