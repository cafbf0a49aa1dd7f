"""Montgomery product, square, power and NTT butterflies: CUDA kernels and
plain PyTorch versions.

Counterpart of zkarray/kernels/mont.py:mont_mul, mont_sqr,
butterfly_dit_inplace and butterfly_stage; ``mont_pow`` has no Pallas
counterpart (it runs ff/fp.py:pow_const's square-and-multiply chain in one
launch, where the JAX package leaves XLA to fuse a lax.scan). Each wrapper takes the plain
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

def align(L: int, *ts: torch.Tensor):
    """Broadcast (L, *batch) tensors to a common batch shape, padding
    TRAILING batch dims (zkarray/ff/fp.py:_align2). Tensors of one shape are
    returned as they are: the broadcast costs more host time than a launch."""
    if all(t.shape == ts[0].shape for t in ts[1:]):
        return ts
    batch = torch.broadcast_shapes(*(t.shape[1:] for t in ts))
    return tuple(t.reshape(t.shape + (1,) * (len(batch) - (t.dim() - 1))).expand((L,) + batch)
                 for t in ts)



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
    a, b = align(spec.num_limbs, a, b)
    s = normalize(a.to(torch.int64) + b.to(torch.int64), spec.num_limbs + 1)
    return cond_sub_p_plain(spec, s).to(torch.int32)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p, plain PyTorch on the tensors' device."""
    L = spec.num_limbs
    a, b = align(L, a, b)
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
    a, b = align(L, a, b)
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
    """(tensor, ld, inner, outer) such that batch element i (row-major), limb
    k, of ``t`` sits at offset k*ld + (i // inner)*outer + i % inner from its
    data pointer (csrc/field.cuh:Operand). That holds for a contiguous tensor
    (inner = n), a slice along the first batch axis, a constant broadcast over
    leading batch axes (outer = 0) and the last-axis halves v[..., :h],
    v[..., h:2h] of a (..., m) tensor (inner = h, outer = m): the innermost
    contiguous run of batch axes is ``inner``, and the axes outside it must
    step through memory as one axis of stride ``outer``. Anything else is
    copied first."""
    dims = [(s, st) for s, st in zip(t.shape[1:], t.stride()[1:]) if s != 1]
    inner, j = 1, len(dims)
    while j > 0 and dims[j - 1][1] == inner:
        inner *= dims[j - 1][0]
        j -= 1
    outer = dims[j - 1][1] if j else 0
    span = outer
    for s, st in reversed(dims[:j]):
        if st != span:
            t = t.contiguous()
            return t, t[0].numel(), t[0].numel(), 0
        span *= s
    return t, t.stride(0), inner, outer


def operand_words(ops) -> np.ndarray:
    """Host descriptors (pointer, ld, inner, outer) of ``_operand`` results,
    one row each, as the C entries read them."""
    return np.asarray([(t.data_ptr(), ld, inner, outer) for t, ld, inner, outer in ops],
                      dtype=np.int64)


def launch_strided(source: str, kernel: str, L: int, consts: np.ndarray, ins, out_lead=(),
                   extra=()) -> torch.Tensor:
    """Run the element-wise kernel ``kernel`` of csrc/<source>.cu (C entry
    zk_<kernel>(operand descriptors, out, n, *extra, NW, consts, stream)) on
    (L, *batch) inputs of one shape, strided as ``_operand`` allows; returns
    its contiguous output of shape out_lead + (L, *batch)."""
    check_cuda_int32(kernel, *ins, contiguous=False)
    shape = ins[0].shape
    if shape[0] != L or any(t.shape != shape for t in ins):
        raise ValueError(f"{kernel}: expected inputs of one (L={L}, *batch) shape")
    desc = operand_words([_operand(t) for t in ins])
    out = torch.empty(tuple(out_lead) + tuple(shape), dtype=torch.int32, device=ins[0].device)
    lib = _build.load(source)
    with torch.cuda.device(out.device):
        err = getattr(lib, f"zk_{kernel}")(
            words_ptr(desc), out.data_ptr(), ins[0].numel() // L, *extra, L // 2,
            words_ptr(consts), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, kernel)
    _build.LAUNCHES[kernel] += 1
    return out


def _launch(kernel: str, spec: FieldSpec, *ins: torch.Tensor,
            exponent: int | None = None) -> torch.Tensor:
    """Run the element-wise kernel ``kernel`` of csrc/mont.cu on (L, *batch)
    inputs of one shape; ``exponent`` is mont_pow's."""
    extra = ()
    if exponent is not None:
        nbits = exponent.bit_length()
        words = np.asarray([(exponent >> (32 * i)) & 0xFFFFFFFF for i in range(-(-nbits // 32))]
                           or [0], dtype=np.uint32)
        extra = (words_ptr(words), nbits)
    return launch_strided("mont", kernel, spec.num_limbs, field_words(spec), ins, extra=extra)


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of (L, *batch) int32 limb tensors (broadcast as
    align does). CPU tensors: plain version; CUDA tensors: the kernel."""
    if on_cpu(a, b):
        return mont_mul_plain(spec, a, b)
    a, b = align(spec.num_limbs, a, b)
    return _launch("mont_mul", spec, a, b)


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery square; dispatch as ``mont_mul``."""
    if on_cpu(a):
        return mont_sqr_plain(spec, a)
    return _launch("mont_sqr", spec, a)


# csrc/mont.cu:MAX_EXP_WORDS 32-bit words
MAX_EXP_BITS = 64 * 32


def mont_pow_plain(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a host exponent e >= 0: square-and-multiply over e's bits, low
    bit first (zkarray/ff/fp.py:pow_const), in plain PyTorch."""
    res = const(spec, spec.r_int, a.shape[1:], a.device).contiguous()
    base = a
    while e:
        if e & 1:
            res = mont_mul_plain(spec, res, base)
        e >>= 1
        if e:
            base = mont_sqr_plain(spec, base)
    return res


def mont_pow(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e element-wise for a host exponent 0 <= e < 2^MAX_EXP_BITS (e = 0
    gives one; a = 0 gives 0 for e > 0). CPU tensors: plain version; CUDA
    tensors: csrc/mont.cu:mont_pow_kernel, the whole chain in one launch."""
    e = int(e)
    if e < 0:
        raise ValueError("mont_pow: the exponent must be >= 0")
    if on_cpu(a):
        return mont_pow_plain(spec, a, e)
    if e.bit_length() > MAX_EXP_BITS:
        raise ValueError(f"mont_pow: exponents are limited to {MAX_EXP_BITS} bits on CUDA")
    return _launch("mont_pow", spec, a, exponent=e)


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
    lo, hi, w = align(L, lo, hi, w)
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
