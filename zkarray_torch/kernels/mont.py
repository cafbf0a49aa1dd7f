"""Montgomery product, square, power and NTT butterflies: CUDA kernels and
plain PyTorch versions.

Counterpart of zkarray/kernels/mont.py:mont_mul, mont_sqr,
butterfly_dit_inplace and butterfly_stage; ``mont_pow`` has no Pallas
counterpart (it runs ff/fp.py:pow_const's square-and-multiply chain in one
launch, where the JAX package leaves XLA to fuse a lax.scan), nor has
``mont_inv`` (the field inverse by binary GCD, ff/fp.py:inv's route on a
CUDA device; its plain version is the JAX package's Fermat power), nor have
``pow_table`` and ``twiddle_mul`` (one launch each for a power table and for
a block's k1-twiddle multiply, where poly/domain.py ran chains of mont_mul
and mont_sqr launches), nor have ``fp_add`` and ``fp_sub`` (csrc/fadd.cu:
ff/fp.py's add, double, sub and neg as one launch each, read and written
through the operand map). Each wrapper takes the plain version for tensors on
the CPU and launches its kernel (``csrc/mont.cu``, ``csrc/ntt.cu``,
``csrc/twiddle.cu``) for tensors on a CUDA device (or raises); there is no
other rule and no fallback. Both versions compute every product a*b*R^-1 mod p and
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

The module also holds the plain field helpers (constants, ``add_plain``,
``sub_plain``) that ff/fp.py and the plain versions in
kernels/sw.py share, so the kernel layer depends on core/ only. The plain
versions call the plain bodies on any device: chip_smoke.py runs them on
the card as references.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.core.limbs import (add_with_carry, is_zero, normalize, pack_pairs,
                                      sub_with_borrow, unpack_pairs)
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


def add_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p, plain PyTorch on the tensors' device: a + b on L + 1
    limbs, p subtracted once when the sum is >= p (the low L limbs kept)."""
    a, b = align(spec.num_limbs, a, b)
    s, c = add_with_carry(a, b)
    return cond_sub_p_plain(spec, torch.cat([s, c[None]])).to(torch.int32)


def sub_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p, plain PyTorch on the tensors' device: p added once on a
    borrow, modulo 2^(16 L). 0 - a is -a mod p, 0 for a = 0."""
    L = spec.num_limbs
    a, b = align(L, a, b)
    d, borrow = sub_with_borrow(a, b)
    d_fix, _ = add_with_carry(d, limb_col(spec, spec.modulus, str(d.device), d.dim() - 1))
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

# lanes of one block of the plain product: its (L, L, lanes) int64 products
# stay within 2^27 elements (1 GiB)
_PLAIN_BLOCK_ELEMS = 1 << 27


@functools.lru_cache(maxsize=None)
def _diagonals(la: int, lb: int, n_out: int, device: str):
    """For the flattened (la, lb) products a_i b_j: the output column i + j
    of each one with i + j < n_out, and their positions."""
    k = (torch.arange(la)[:, None] + torch.arange(lb)[None, :]).reshape(-1)
    keep = (k < n_out).nonzero().squeeze(1)
    return k[keep].to(device), keep.to(device)


def _columns(a: torch.Tensor, b: torch.Tensor, n_out: int) -> torch.Tensor:
    """Columns k < n_out of the product of int64 limb vectors a (La, n) and
    b (Lb, n) or (Lb, 1): sum over i + j = k of a_i b_j, each 16 x 16-bit
    product exact in int64, by one outer product and one index_add."""
    k, keep = _diagonals(a.shape[0], b.shape[0], n_out, str(a.device))
    prod = (a[:, None] * b[None, :]).reshape(a.shape[0] * b.shape[0], -1)
    if keep.numel() != prod.shape[0]:
        prod = prod[keep]
    out = torch.zeros((n_out, prod.shape[1]), dtype=torch.int64, device=a.device)
    return out.index_add_(0, k, prod)


def _by_blocks(spec: FieldSpec, fn, *cols: torch.Tensor) -> torch.Tensor:
    """fn over blocks of lanes of the (k, n) tensors ``cols``, so that no
    block's (L, L, lanes) products pass _PLAIN_BLOCK_ELEMS; the blocks'
    results joined along the lanes."""
    L = spec.num_limbs
    step = max(1, _PLAIN_BLOCK_ELEMS // (L * L))
    out = [fn(*(c[:, s:s + step] for c in cols)) for s in range(0, cols[0].shape[1], step)]
    return torch.cat(out, 1) if len(out) > 1 else out[0]


def _redc_block(spec: FieldSpec, cols: torch.Tensor, products: bool = False) -> torch.Tensor:
    """Montgomery reduction of (2L+1, m) int64 columns T < R p (each below
    2^58): with lo = T mod R, m = lo (-p^-1) mod R makes T + m p a multiple
    of R, and T R^-1 mod p is (T + m p)/R, below 2p: one carry pass over the
    columns of T + m p, their high L+1 limbs, one conditional subtract.
    ``products``: the columns are one product's (each below L 2^32 < 2^38),
    so the low ones go into m's product without a carry pass of their own
    (its columns then stay below 2^60)."""
    L = spec.num_limbs
    dev = str(cols.device)
    lo = cols[:L] if products else normalize(cols[:L], L)
    m = normalize(_columns(lo, limb_col(spec, spec.p_inv_neg_r, dev, 1), L), L)
    mp = _columns(m, limb_col(spec, spec.modulus, dev, 1), 2 * L)
    total = cols + torch.cat([mp, torch.zeros_like(mp[:1])])
    if 2 * L + 1 <= 61:  # one carry lookahead over every limb
        return cond_sub_p_plain(spec, normalize(total, 2 * L + 1)[L:])
    _, c = normalize(total[:L], L, carry_out=True)  # the low half is a multiple of R
    high = total[L:]
    high[0] += c
    return cond_sub_p_plain(spec, normalize(high, L + 1))


def redc_plain(spec: FieldSpec, cols: torch.Tensor) -> torch.Tensor:
    """Montgomery-reduce (2L+1, *batch) int64 columns (value < R p): returns
    (value * R^-1 mod p) as int64 limbs. The same value as _redc's per-limb
    reduction (the reduced result is unique), in a few whole-vector steps
    (``_redc_block``) over blocks of lanes."""
    out = _by_blocks(spec, lambda c: _redc_block(spec, c), cols.reshape(cols.shape[0], -1))
    return out.reshape((spec.num_limbs,) + tuple(cols.shape[1:]))


def cond_sub_p_plain(spec: FieldSpec, r: torch.Tensor) -> torch.Tensor:
    """r (L+1 canonical int64 limbs, value < 2p) -> r mod p as L limbs."""
    L = spec.num_limbs
    p = limb_col(spec, spec.modulus, str(r.device), r.dim() - 1)
    p_ext = torch.cat([p, torch.zeros_like(p[:1])]).expand_as(r)
    diff, borrow = sub_with_borrow(r, p_ext)
    return torch.where(borrow[None], r[:L], diff[:L])


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b*R^-1 mod p on (L, *batch) limb tensors, in plain PyTorch: the
    product's columns (``_columns``) and ``_redc_block``, over blocks of
    lanes so that no temporary passes 2^27 int64 elements."""
    L = spec.num_limbs
    a, b = align(L, a, b)
    batch = tuple(a.shape[1:])
    a64 = a.reshape(L, -1).to(torch.int64)
    b64 = b.reshape(L, -1).to(torch.int64)
    out = _by_blocks(spec, lambda x, y: _redc_block(spec, _columns(x, y, 2 * L + 1), True), a64, b64)
    return out.to(torch.int32).reshape((L,) + batch)


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
    s, d = add_plain(spec, lo, t), sub_plain(spec, lo, t)
    lo.copy_(s)
    hi.copy_(d)
    return x


def butterfly_stage_plain(spec: FieldSpec, lo: torch.Tensor, hi: torch.Tensor,
                          w: torch.Tensor):
    """DIF butterfly (lo, hi, w) -> (lo + hi, (lo - hi) w)."""
    return add_plain(spec, lo, hi), mont_mul_plain(spec, sub_plain(spec, lo, hi), w)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def batch_map(shape, strides):
    """(inner, outer) such that batch element i (row-major) of batch axes
    ``shape`` with element strides ``strides`` sits at (i // inner)*outer +
    i % inner, or None where no such map exists: the innermost contiguous
    run of batch axes is ``inner``, and the axes outside it must step
    through memory as one axis of stride ``outer``."""
    dims = [(s, st) for s, st in zip(shape, strides) if s != 1]
    inner, j = 1, len(dims)
    while j > 0 and dims[j - 1][1] == inner:
        inner *= dims[j - 1][0]
        j -= 1
    outer = dims[j - 1][1] if j else 0
    span = outer
    for s, st in reversed(dims[:j]):
        if st != span:
            return None
        span *= s
    return inner, outer


def _operand(t: torch.Tensor):
    """(tensor, ld, inner, outer) such that batch element i (row-major), limb
    k, of ``t`` sits at offset k*ld + (i // inner)*outer + i % inner from its
    data pointer (csrc/field.cuh:Operand; ``batch_map``). That holds for a
    contiguous tensor (inner = n), a slice along the first batch axis, a
    constant broadcast over leading batch axes (outer = 0) and the last-axis
    halves v[..., :h], v[..., h:2h] of a (..., m) tensor (inner = h, outer =
    m). Anything else is copied first."""
    m = batch_map(t.shape[1:], t.stride()[1:])
    if m is None:
        t = t.contiguous()
        return t, t[0].numel(), t[0].numel(), 0
    return (t, t.stride(0)) + m


def operand_words(ops) -> np.ndarray:
    """Host descriptors (pointer, ld, inner, outer) of ``_operand`` results,
    one row each, as the C entries read them."""
    return np.asarray([(t.data_ptr(), ld, inner, outer) for t, ld, inner, outer in ops],
                      dtype=np.int64)


def launch_strided(source: str, kernel: str, L: int, consts: np.ndarray, ins, out_lead=(),
                   extra=()) -> torch.Tensor:
    """Run the element-wise kernel ``kernel`` of library ``source`` (C entry
    zk_<kernel>(operand descriptors, out, n, *extra, NW, consts, stream)) on
    (L, *batch) inputs of one shape, strided as ``_operand`` allows; returns
    its contiguous output of shape out_lead + (L, *batch)."""
    check_cuda_int32(kernel, *ins, contiguous=False)
    shape = ins[0].shape
    if shape[0] != L or any(t.shape != shape for t in ins):
        raise ValueError(f"{kernel}: expected inputs of one (L={L}, *batch) shape")
    ops = [_operand(t) for t in ins]  # held until the launch: a copy may be among them
    desc = operand_words(ops)
    out = torch.empty(tuple(out_lead) + tuple(shape), dtype=torch.int32, device=ins[0].device)
    lib = _build.load(source)
    with torch.cuda.device(out.device):
        err = getattr(lib, f"zk_{kernel}")(
            words_ptr(desc), out.data_ptr(), ins[0].numel() // L, *extra, L // 2,
            words_ptr(consts), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, kernel)
    _build.LAUNCHES[kernel] += 1
    return out


@functools.lru_cache(maxsize=None)
def _r2_words(spec: FieldSpec) -> np.ndarray:
    """R^2 mod p as NW = L/2 host words: mont_inv's starting coefficient,
    mont_div's factor that puts a numerator x R in the form x R^2."""
    return np.asarray([(spec.r2_int >> (32 * i)) & 0xFFFFFFFF for i in range(spec.num_limbs // 2)],
                      dtype=np.uint32)


def _launch(kernel: str, spec: FieldSpec, *ins: torch.Tensor,
            exponent: int | None = None) -> torch.Tensor:
    """Run the element-wise kernel ``kernel`` of csrc/mont.cu on (L, *batch)
    inputs of one shape, from the library built for its width (raises for
    a width outside _build.FIELD_LIBS); ``exponent`` is mont_pow's."""
    extra = ()
    if kernel == "mont_inv":
        extra = (words_ptr(_r2_words(spec)), 0)  # 0: lanes by width
    if exponent is not None:
        nbits = exponent.bit_length()
        words = np.asarray([(exponent >> (32 * i)) & 0xFFFFFFFF for i in range(-(-nbits // 32))]
                           or [0], dtype=np.uint32)
        extra = (words_ptr(words), nbits)
    return launch_strided(_build.field_lib(spec.num_limbs // 2), kernel, spec.num_limbs,
                          field_words(spec), ins, extra=extra)


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


def mont_inv_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^-1 element-wise (0 -> 0) by Fermat, a^(p - 2) through
    ``mont_pow_plain``: the JAX package's route (zkarray/ff/fp.py:inv). The
    inverse is unique, so its words are the kernel's."""
    return mont_pow_plain(spec, a, spec.modulus - 2)


# csrc/mont.cu:GCD_STEPS: steps of the inverse's binary GCD a batch;
# GCD_WIDE: from this many elements (points for mont_div) on, one lane a
# division instead of a pair
GCD_STEPS = 30
GCD_WIDE = 1 << 14


def gcd_batches(spec: FieldSpec) -> int:
    """Batches the inverse and division kernels run for ``spec``
    (csrc/mont.cu:gcd_batches): ceil((2 bits(p) - 1) / GCD_STEPS), the
    binary GCD's bound of 2 bits(p) - 1 steps."""
    return -(-(2 * spec.modulus.bit_length() - 1) // GCD_STEPS)


def mont_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^-1 element-wise (0 -> 0) for Montgomery words a < p in (L, *batch).
    CPU tensors: plain version; CUDA tensors: csrc/mont.cu:mont_inv_kernel,
    a batched binary GCD in one launch (two lanes an element below GCD_WIDE
    elements, one from there on)."""
    if on_cpu(a):
        return mont_inv_plain(spec, a)
    return _launch("mont_inv", spec, a)


# ---------------------------------------------------------------------------
# division (csrc/mont.cu:mont_div_kernel): the to-affine's two quotients
# ---------------------------------------------------------------------------

def _scan_products(spec: FieldSpec, mul, x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Inclusive prefix (or suffix) products along axis 1 of (L, n), in
    log2(n) rounds of doubling strides (Hillis-Steele)."""
    n = x.shape[1]
    d = 1
    while d < n:
        if reverse:
            x = torch.cat([mul(spec, x[:, : n - d], x[:, d:]), x[:, n - d :]], dim=1)
        else:
            x = torch.cat([x[:, :d], mul(spec, x[:, d:], x[:, : n - d])], dim=1)
        d *= 2
    return x


def batch_inv_by(spec: FieldSpec, a: torch.Tensor, mul, inv) -> torch.Tensor:
    """Element-wise inverse of a batch by Montgomery's trick
    (zkarray/ff/fp.py:batch_inv): prefix and suffix product scans and one
    inversion; zeros map to zero. ``mul`` and ``inv`` are the product and
    the inverse it runs: the wrappers (ff/fp.py:batch_inv) or the plain
    versions (``mont_div_plain``)."""
    L = spec.num_limbs
    batch_shape = a.shape[1:]
    x = a.reshape(L, -1)
    n = x.shape[1]
    zmask = is_zero(x)
    x = torch.where(zmask[None], const(spec, spec.r_int, (n,), x.device), x)
    pre = _scan_products(spec, mul, x, reverse=False)
    suf = _scan_products(spec, mul, x, reverse=True)
    total_inv = inv(spec, pre[:, -1:])
    one1 = const(spec, spec.r_int, (1,), x.device)
    pre_ex = torch.cat([one1, pre[:, :-1]], dim=1)
    suf_ex = torch.cat([suf[:, 1:], one1], dim=1)
    out = mul(spec, mul(spec, pre_ex, suf_ex), total_inv)
    out = torch.where(zmask[None], torch.zeros_like(out), out)
    return out.reshape((L,) + tuple(batch_shape))


def mont_div_plain(spec: FieldSpec, n0: torch.Tensor, d0: torch.Tensor, n1: torch.Tensor,
                   d1: torch.Tensor) -> torch.Tensor:
    """(n0 / d0, n1 / d1) as one (2, L, *batch) tensor, 0 where a
    denominator is 0, in plain PyTorch: each numerator times its batch
    inverse, the JAX package's to-affine (zkarray/ec/sw.py:174
    xyzz_to_affine). Quotients are unique, so the words are the kernel's."""
    return torch.stack([mont_mul_plain(spec, num, batch_inv_by(spec, den, mont_mul_plain,
                                                               mont_inv_plain))
                        for num, den in ((n0, d0), (n1, d1))])


def _launch_div(spec: FieldSpec, n0: torch.Tensor, d0: torch.Tensor, n1: torch.Tensor,
                d1: torch.Tensor) -> torch.Tensor:
    """One csrc/mont.cu:mont_div_kernel launch: the four operands read in
    place as ``_operand`` allows, the output (2, L, *batch) contiguous."""
    return launch_strided(_build.field_lib(spec.num_limbs // 2), "mont_div", spec.num_limbs,
                          field_words(spec), (n0, d0, n1, d1), out_lead=(2,),
                          extra=(words_ptr(_r2_words(spec)), 0))


def mont_div(spec: FieldSpec, n0: torch.Tensor, d0: torch.Tensor, n1: torch.Tensor,
             d1: torch.Tensor) -> torch.Tensor:
    """n0 / d0 and n1 / d1 element-wise for Montgomery words < p of one
    (L, *batch) shape (0 where a denominator is 0), as one (2, L, *batch)
    tensor. CPU tensors: plain version (the batch-inverse route); CUDA
    tensors: csrc/mont.cu:mont_div_kernel, both quotients of every element
    in one launch."""
    if on_cpu(n0, d0, n1, d1):
        return mont_div_plain(spec, n0, d0, n1, d1)
    return _launch_div(spec, n0, d0, n1, d1)


# ---------------------------------------------------------------------------
# field addition and subtraction (csrc/fadd.cu)
# ---------------------------------------------------------------------------

def _launch_addsub(kernel: str, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor,
                   out: torch.Tensor | None) -> torch.Tensor:
    """Launch csrc/fadd.cu's ``kernel`` (fp_add or fp_sub) on (L, *batch)
    inputs of one shape, each read in place as ``_operand`` allows (or
    copied, the copy held until the launch); the output is ``out`` (written
    through the same map, so it must be expressible without a copy) or a new
    contiguous tensor."""
    L = spec.num_limbs
    shape = a.shape
    if shape[0] != L or b.shape != shape:
        raise ValueError(f"{kernel}: expected inputs of one (L={L}, *batch) shape")
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=a.device)
    elif out.shape != shape:
        raise ValueError(f"{kernel}: out {tuple(out.shape)} is not {tuple(shape)}")
    check_cuda_int32(kernel, a, b, out, contiguous=False)
    ops = [_operand(a), _operand(b), _operand(out)]  # held until the launch
    if ops[2][0] is not out:
        raise ValueError(f"{kernel}: out's strides {out.stride()} cannot be written in place")
    desc = operand_words(ops)
    lib = _build.load("fadd")
    with torch.cuda.device(out.device):
        err = getattr(lib, f"zk_{kernel}")(words_ptr(desc), out[0].numel(), L // 2,
                                           words_ptr(field_words(spec)),
                                           torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, kernel)
    _build.LAUNCHES[kernel] += 1
    return out


def _addsub(kernel: str, plain, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor,
            out: torch.Tensor | None) -> torch.Tensor:
    if on_cpu(a, b, *(() if out is None else (out,))):
        r = plain(spec, a, b)
        return r if out is None else out.copy_(r)
    a, b = align(spec.num_limbs, a, b)
    return _launch_addsub(kernel, spec, a, b, out)


def fp_add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """(a + b) mod p over (L, *batch) int32 limb tensors broadcast as align
    does, into ``out`` when given. CPU tensors: ``add_plain``; CUDA tensors:
    csrc/fadd.cu:fp_add, one launch."""
    return _addsub("fp_add", add_plain, spec, a, b, out)


def fp_sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """(a - b) mod p; dispatch as ``fp_add`` (csrc/fadd.cu:fp_sub)."""
    return _addsub("fp_sub", sub_plain, spec, a, b, out)


def fp_neg(spec: FieldSpec, a: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """-a mod p (0 stays 0) as ``fp_sub`` of 0 - a, the 0 a stride-0
    constant: ``sub_plain`` on CPU tensors, one csrc/fadd.cu:fp_sub launch
    on CUDA tensors."""
    return _addsub("fp_sub", sub_plain, spec, const(spec, 0, a.shape[1:], a.device), a, out)


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
    lib = _build.load(_build.ntt_lib("ntt", L // 2))
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
    lib = _build.load(_build.ntt_lib("ntt", L // 2))
    with torch.cuda.device(lo.device):
        err = lib.zk_butterfly_stage(lo.data_ptr(), hi.data_ptr(), w.data_ptr(), out_a.data_ptr(),
                                     out_b.data_ptr(), lo.numel() // L, L // 2,
                                     words_ptr(field_words(spec)),
                                     torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "butterfly_stage")
    _build.LAUNCHES["butterfly_stage"] += 1
    return out_a, out_b


# ---------------------------------------------------------------------------
# power tables and the twiddle multiply (csrc/twiddle.cu)
# ---------------------------------------------------------------------------

# csrc/twiddle.cu:POW_TABLE_BITS: a pow_table has at most 2^16 entries
POW_TABLE_MAX = 1 << 16
# Bytes of built tables that cached_pow_table keeps: a 2^16-entry table is
# 4 MiB at L = 16 and 12 MiB at L = 48; a 2^24 fft's three are 384 KiB.
TABLE_CACHE_BYTES = 256 << 20

# (field, w, n, scale, packed, device) -> a built table, least recently used first
_tables: "collections.OrderedDict[tuple, torch.Tensor]" = collections.OrderedDict()


@functools.lru_cache(maxsize=256)
def _pow_words(spec: FieldSpec, w_int: int, n: int, scale_int) -> tuple:
    """(words, nbits): host words s | w^(2^b) for b < nbits, Montgomery form,
    NW = L/2 32-bit words each (csrc/twiddle.cu:zk_pow_table), nbits the
    bits of the largest index n - 1. Cached per arguments, so read-only."""
    p = spec.modulus
    nbits = max(n - 1, 0).bit_length()
    vals = [(1 if scale_int is None else scale_int) % p]
    v = w_int % p
    for _ in range(nbits):
        vals.append(v)
        v = v * v % p
    nbytes = 2 * spec.num_limbs
    words = np.frombuffer(b"".join(spec.to_mont_int(x).to_bytes(nbytes, "little") for x in vals),
                          dtype="<u4").astype(np.uint32)
    words.flags.writeable = False
    return words, nbits


def pow_table_plain(spec: FieldSpec, w_int: int, n: int, device, scale_int=None,
                    packed: bool = False) -> torch.Tensor:
    """pow_table in plain PyTorch: entry j is s times w^(2^b) for each set
    bit b of j, multiplied in bit by bit (the kernel forms the same fully
    reduced words by another chain of products)."""
    words, nbits = _pow_words(spec, w_int, n, scale_int)
    nw = spec.num_limbs // 2
    consts = unpack_pairs(torch.from_numpy(words.view(np.int32).copy()).reshape(nbits + 1, nw).T)
    consts = consts.to(device)
    j = torch.arange(n, device=device)
    t = consts[:, :1].expand(spec.num_limbs, n)
    for b in range(nbits):
        t = torch.where(((j >> b) & 1).bool()[None], mont_mul_plain(spec, t, consts[:, b + 1 : b + 2]), t)
    t = t.contiguous()
    return pack_pairs(t).T.contiguous() if packed else t


def pow_table(spec: FieldSpec, w_int: int, n: int, device, scale_int=None,
              packed: bool = False) -> torch.Tensor:
    """[s·w^0, ..., s·w^(n-1)] in Montgomery form (s = scale_int, canonical;
    default 1) for n <= POW_TABLE_MAX, built on ``device`` into a new tensor:
    (L, n) planar limbs, or (n, L/2) packed words when ``packed``
    (twiddle_mul's tables). The CPU: plain version; a CUDA device:
    csrc/twiddle.cu:pow_table_kernel, one launch. ``cached_pow_table`` keeps
    the tables it builds."""
    if not 0 <= n <= POW_TABLE_MAX:
        raise ValueError(f"pow_table: {n} entries; at most {POW_TABLE_MAX}")
    device = torch.device(device)
    if device.type == "cpu":
        return pow_table_plain(spec, w_int, n, device, scale_int, packed)
    L = spec.num_limbs
    words, nbits = _pow_words(spec, w_int, n, scale_int)
    out = torch.empty((n, L // 2) if packed else (L, n), dtype=torch.int32, device=device)
    lib = _build.load(_build.ntt_lib("twiddle", L // 2))
    with torch.cuda.device(device):
        err = lib.zk_pow_table(out.data_ptr(), n, int(packed), words_ptr(words), nbits, L // 2,
                               words_ptr(field_words(spec)), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "pow_table")
    _build.LAUNCHES["pow_table"] += 1
    return out


def _device_key(device) -> str:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def cached_pow_table(spec: FieldSpec, w_int: int, n: int, device, scale_int=None,
                     packed: bool = False) -> torch.Tensor:
    """pow_table's table for these arguments, built by pow_table on the
    first call and then kept, keyed by (field, w, n, s, packed, device):
    the same words a new build would write. Tables beyond TABLE_CACHE_BYTES
    in all are dropped least recently used first (a table larger than that
    alone is not kept). READ-ONLY: a caller that hands the table to code
    that may write into it hands on a copy."""
    p = spec.modulus
    dkey = _device_key(device)
    key = (spec, w_int % p, n, None if scale_int is None else scale_int % p, bool(packed), dkey)
    t = _tables.get(key)
    if t is not None:
        _tables.move_to_end(key)
        return t
    t = pow_table(spec, w_int, n, dkey, scale_int, packed)
    if t.numel() * t.element_size() <= TABLE_CACHE_BYTES:  # else not kept
        _tables[key] = t
        while sum(v.numel() * v.element_size() for v in _tables.values()) > TABLE_CACHE_BYTES:
            _tables.popitem(last=False)
    return t


def clear_table_cache():
    """Drop every table cached_pow_table keeps (the next call builds anew)."""
    _tables.clear()


def cached_tables() -> dict:
    """The cached tables by key (a snapshot of the cache's entries)."""
    return dict(_tables)


class Twiddles(NamedTuple):
    """twiddle_mul's tables for exponents up to ``e_max`` of a base w: ``lo``
    = [s·w^j, j < 2^h] and ``hi`` = [(w^(2^h))^j], packed words, so that
    s·w^e = hi[e >> h] · lo[e & (2^h - 1)]."""
    h: int
    lo: torch.Tensor
    hi: torch.Tensor
    e_max: int


def twiddle_tables(spec: FieldSpec, w_int: int, e_max: int, device, scale_int=None) -> Twiddles:
    """The two pow_tables that cover every exponent 0 <= e <= e_max < 2^32,
    with h = ceil(bits(e_max) / 2), so neither has more than 2^16 entries;
    ``scale_int`` (canonical), when given, is folded into ``lo``. Both come
    from cached_pow_table: read-only, as twiddle_mul reads them."""
    if not 0 <= e_max < 1 << 32:
        raise ValueError(f"twiddle_tables: exponents up to {e_max}; at most 2^32 - 1")
    h = (e_max.bit_length() + 1) // 2
    lo = cached_pow_table(spec, w_int, min(1 << h, e_max + 1), device, scale_int, packed=True)
    hi = cached_pow_table(spec, pow(w_int, 1 << h, spec.modulus), (e_max >> h) + 1, device,
                          packed=True)
    return Twiddles(h, lo, hi, e_max)


def twiddle_mul_plain(spec: FieldSpec, x: torch.Tensor, tw: Twiddles, r0: int, c0: int,
                      out: torch.Tensor) -> torch.Tensor:
    """twiddle_mul in plain PyTorch: the same two products per element."""
    _, R, C = x.shape
    dev = x.device
    e = (r0 + torch.arange(R, device=dev))[:, None] * (c0 + torch.arange(C, device=dev))[None, :]
    lo = unpack_pairs(tw.lo.T)[:, e & ((1 << tw.h) - 1)]
    hi = unpack_pairs(tw.hi.T)[:, e >> tw.h]
    out.copy_(mont_mul_plain(spec, x, mont_mul_plain(spec, hi, lo)))
    return out


def twiddle_mul(spec: FieldSpec, x: torch.Tensor, tw: Twiddles, r0: int = 0, c0: int = 0,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """out[:, r, c] = x[:, r, c] · s·w^((r0 + r)(c0 + c)) for an (L, R, C)
    input x, read in place as ``_operand`` allows (slices, broadcasts), with
    the tables ``tw`` of twiddle_tables(w, e_max, scale s). ``out``: None for
    a new contiguous tensor, or an (L, R, C) int32 tensor with a contiguous
    last axis (a column block of a wider one, or x itself), written and
    returned. CPU tensors: plain version; CUDA tensors:
    csrc/twiddle.cu:twiddle_mul_kernel, one launch."""
    L = spec.num_limbs
    if x.dim() != 3 or x.shape[0] != L:
        raise ValueError(f"twiddle_mul: x {tuple(x.shape)} is not (L={L}, R, C)")
    _, R, C = x.shape
    if r0 < 0 or c0 < 0 or (R and C and (r0 + R - 1) * (c0 + C - 1) > tw.e_max):
        raise ValueError(f"twiddle_mul: rows {r0}+{R}, columns {c0}+{C} exceed the tables' "
                         f"exponents (up to {tw.e_max})")
    if out is None:
        out = torch.empty((L, R, C), dtype=torch.int32, device=x.device)
    elif out.shape != x.shape or (C > 1 and out.stride(2) != 1):
        raise ValueError(f"twiddle_mul: out {tuple(out.shape)} is not {tuple(x.shape)} with a "
                         "contiguous last axis")
    if on_cpu(x, out, tw.lo, tw.hi):
        return twiddle_mul_plain(spec, x, tw, r0, c0, out)
    check_cuda_int32("twiddle_mul", x, out, tw.lo, tw.hi, contiguous=False)
    desc = operand_words([_operand(x)])
    lib = _build.load(_build.ntt_lib("twiddle", L // 2))
    with torch.cuda.device(out.device):
        err = lib.zk_twiddle_mul(words_ptr(desc), out.data_ptr(), out.stride(0), out.stride(1),
                                 tw.lo.data_ptr(), tw.lo.shape[0], tw.hi.data_ptr(), tw.hi.shape[0],
                                 tw.h, R, C, r0, c0, L // 2, words_ptr(field_words(spec)),
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "twiddle_mul")
    _build.LAUNCHES["twiddle_mul"] += 1
    return out
