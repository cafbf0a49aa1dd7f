"""Small-field element-wise operations and NTT butterflies: CUDA kernels and
plain PyTorch versions.

Neither kernel has a Pallas counterpart. The JAX package's small fields
(zkarray/ff/smallfp.py, fp64.py, smallfp64.py) are jitted element-wise
chains of 25 to 60 u32 operations that XLA fuses into one pass; run as
PyTorch eager ops they would be one launch per operation, over int64 lanes
that emulate u32 wraparound with masks. ``sf_op`` (csrc/smallfp.cu) is one
launch per public call; ``sf_butterfly`` is one radix-2 DIT stage of
ff/smallfp.py:ntt and ff/fp64.py:ntt.

Four families of fields, each a template of the kernels:

    family  element                          module                 ops
    u32     uint32, Montgomery R = 2^32      ff/smallfp.py          mul sqr add sub neg pow
    m31     uint32, canonical, p = 2^31 - 1  ff/smallfp.py:m31_mul  mul
    gl64    (lo, hi) uint32 planes, canon.   ff/fp64.py             mul sqr add sub neg pow
    u64     (lo, hi) uint32 planes, R = 2^64 ff/smallfp64.py        mul sqr add sub neg pow

Arrays are ``torch.uint32``: ``(*batch)`` for the one-plane families,
``(2, *batch)`` (row 0 the low words, row 1 the high) for the two-plane
ones, as the JAX package's uint32 arrays are. Each op computes the JAX
function's own word sequence (its carries, wraps and selects), so the
words agree with it for every input it accepts, words >= p included; the
plain versions are that sequence transliterated onto int64 lanes that hold
32-bit words. ``pow`` runs each module's own ladder: left to right for u32
and gl64, right to left (a square per bit) for u64.

Each wrapper takes the plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device (or raises); there is no other rule and
no fallback.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from zkarray_torch.kernels import _build
from zkarray_torch.kernels import mont as km

M32 = 0xFFFFFFFF
M16 = 0xFFFF
# csrc/smallfp.cu:MAX_EXP_WORDS x 32: the longest exponent one pow launch takes
MAX_EXP_BITS = 64 * 32

FAMILIES = {"u32": 0, "m31": 1, "gl64": 2, "u64": 3}
OPS = {"mul": 0, "sqr": 1, "add": 2, "sub": 3, "neg": 4, "pow": 5}
ARITY = {"mul": 2, "sqr": 1, "add": 2, "sub": 2, "neg": 1, "pow": 1}
PLANES = {"u32": 1, "m31": 1, "gl64": 2, "u64": 2}


class Consts(NamedTuple):
    """A field's constants as the kernels read them: p, R mod p (the
    Montgomery one; 1 for a canonical family) and -p^-1 mod 2^32."""
    p: int
    r: int
    inv32: int


GL64 = Consts((1 << 64) - (1 << 32) + 1, 1, 0)
M31 = Consts((1 << 31) - 1, 1, 0)


# ---------------------------------------------------------------------------
# plain versions: 32-bit words in int64 lanes
# ---------------------------------------------------------------------------

def _mul_wide(a, b):
    """Exact 32 x 32 -> (hi, lo) words by 16-bit halves (every partial
    product fits an int64)."""
    al, ah = a & M16, a >> 16
    bl, bh = b & M16, b >> 16
    mid = al * bh + ah * bl
    lo_full = al * bl + ((mid & M16) << 16)
    return ah * bh + (mid >> 16) + (lo_full >> 32), lo_full & M32


def _addc(a_lo, a_hi, b_lo, b_hi):
    """(a + b) on two words: (lo, hi, carry out of 2^64)."""
    lo = a_lo + b_lo
    hi = a_hi + b_hi + (lo >> 32)
    return lo & M32, hi & M32, hi >> 32


def _subb(a_lo, a_hi, b_lo, b_hi):
    """(a - b) on two words: (lo, hi, borrow)."""
    lo = a_lo - b_lo
    hi = a_hi - b_hi - (lo < 0).to(torch.int64)
    return lo & M32, hi & M32, (hi < 0).to(torch.int64)


def _geq(lo, hi, p):
    p_lo, p_hi = p & M32, p >> 32
    return (hi > p_hi) | ((hi == p_hi) & (lo >= p_lo))


def _cond_sub(lo, hi, p, take=None):
    d_lo, d_hi, _ = _subb(lo, hi, p & M32, p >> 32)
    take = _geq(lo, hi, p) if take is None else take
    return torch.where(take, d_lo, lo), torch.where(take, d_hi, hi)


def _u32_mul(c: Consts, a, b):
    """zkarray/ff/smallfp.py:mont_mul: its u32 wraps kept."""
    hi, lo = _mul_wide(a, b)
    m = (lo * c.inv32) & M32
    mp_hi, mp_lo = _mul_wide(m, torch.full_like(a, c.p))
    carry = (((lo + mp_lo) & M32) < lo).to(torch.int64)
    t = (hi + mp_hi + carry) & M32
    return torch.where(t >= c.p, t - c.p, t)


def _u32_add(c: Consts, a, b):
    s = (a + b) & M32
    ge = (s < a) | (s >= c.p)
    return torch.where(ge, (s - c.p) & M32, s)


def _u32_sub(c: Consts, a, b):
    d = (a - b) & M32
    return torch.where(a < b, (d + c.p) & M32, d)


def _u32_neg(c: Consts, a):
    return torch.where(a == 0, a, (c.p - a) & M32)


def _m31_mul(c: Consts, a, b):
    """zkarray/ff/smallfp.py:m31_mul: the shift folds, u32 wraps kept."""
    p = c.p
    hi, lo = _mul_wide(a, b)
    t = ((lo & p) + (lo >> 31) + (((hi << 1) & M32) & p) + (hi >> 30)) & M32
    t = ((t & p) + (t >> 31)) & M32
    t = ((t & p) + (t >> 31)) & M32
    return torch.where(t == p, torch.zeros_like(t), t)


def _mul64_words(a_lo, a_hi, b_lo, b_hi):
    """Exact 64 x 64 -> 128-bit product as words w0..w3."""
    ll_hi, ll_lo = _mul_wide(a_lo, b_lo)
    lh_hi, lh_lo = _mul_wide(a_lo, b_hi)
    hl_hi, hl_lo = _mul_wide(a_hi, b_lo)
    hh_hi, hh_lo = _mul_wide(a_hi, b_hi)
    s1 = ll_hi + lh_lo + hl_lo
    s2 = lh_hi + hl_hi + hh_lo + (s1 >> 32)
    return ll_lo, s1 & M32, s2 & M32, hh_hi + (s2 >> 32)


def _gl_mul(c: Consts, a, b):
    """zkarray/ff/fp64.py:mul and _reduce128 (2^64 = eps, 2^96 = -1)."""
    w0, w1, w2, w3 = _mul64_words(a[0], a[1], b[0], b[1])
    t_lo, t_hi, br = _subb(w0, w1, w3, torch.zeros_like(w3))
    t_lo, t_hi, _ = _subb(t_lo, t_hi, br * M32, torch.zeros_like(t_lo))
    m_hi, m_lo = _mul_wide(w2, torch.full_like(w2, M32))
    r_lo, r_hi, cy = _addc(t_lo, t_hi, m_lo, m_hi)
    r_lo, r_hi, _ = _addc(r_lo, r_hi, cy * M32, torch.zeros_like(r_lo))
    return torch.stack(_cond_sub(r_lo, r_hi, c.p))


def _gl_add(c: Consts, a, b):
    lo, hi, cy = _addc(a[0], a[1], b[0], b[1])
    lo, hi, c2 = _addc(lo, hi, cy * M32, torch.zeros_like(lo))
    return torch.stack(_cond_sub(lo, hi, c.p, _geq(lo, hi, c.p) | (c2 == 1)))


def _gl_sub(c: Consts, a, b):
    lo, hi, br = _subb(a[0], a[1], b[0], b[1])
    lo, hi, _ = _addc(lo, hi, br * (c.p & M32), br * (c.p >> 32))
    return torch.stack([lo, hi])


def _neg2(sub, c: Consts, a):
    out = sub(c, torch.zeros_like(a), a)
    isz = (a[0] == 0) & (a[1] == 0)
    return torch.where(isz[None], a, out)


def _u64_mont_step(c: Consts, w0, w1, w2, w3):
    """One base-2^32 Montgomery step of zkarray/ff/smallfp64.py:mont_mul:
    (w + m p) >> 32 with m = w0 * inv32, the top word wrapping."""
    m = (w0 * c.inv32) & M32
    mp_hi, mp_lo = _mul_wide(m, torch.full_like(m, c.p & M32))
    mp2_hi, mp2_lo = _mul_wide(m, torch.full_like(m, c.p >> 32))
    mid = mp_hi + mp2_lo
    hi2 = mp2_hi + (mid >> 32)
    t1 = w1 + (mid & M32) + ((w0 + mp_lo) >> 32)
    t2 = w2 + hi2 + (t1 >> 32)
    return t1 & M32, t2 & M32, (w3 + (t2 >> 32)) & M32


def _u64_mul(c: Consts, a, b):
    w = _mul64_words(a[0], a[1], b[0], b[1])
    u1, u2, u3 = _u64_mont_step(c, *w)
    lo, hi, v3 = _u64_mont_step(c, u1, u2, u3, torch.zeros_like(u3))
    f_lo, f_hi, _ = _addc(lo, hi, torch.full_like(lo, c.r & M32), torch.full_like(hi, c.r >> 32))
    lo, hi = torch.where(v3 != 0, f_lo, lo), torch.where(v3 != 0, f_hi, hi)
    lo, hi = _cond_sub(lo, hi, c.p)
    return torch.stack(_cond_sub(lo, hi, c.p))


def _u64_add(c: Consts, a, b):
    lo, hi, cy = _addc(a[0], a[1], b[0], b[1])
    f_lo, f_hi, _ = _addc(lo, hi, torch.full_like(lo, c.r & M32), torch.full_like(hi, c.r >> 32))
    lo, hi = torch.where(cy != 0, f_lo, lo), torch.where(cy != 0, f_hi, hi)
    return torch.stack(_cond_sub(lo, hi, c.p))


def _u64_sub(c: Consts, a, b):
    lo, hi, br = _subb(a[0], a[1], b[0], b[1])
    f_lo, f_hi, _ = _addc(lo, hi, torch.full_like(lo, c.p & M32), torch.full_like(hi, c.p >> 32))
    return torch.stack([torch.where(br != 0, f_lo, lo), torch.where(br != 0, f_hi, hi)])


_PLAIN = {
    ("u32", "mul"): _u32_mul, ("u32", "add"): _u32_add, ("u32", "sub"): _u32_sub,
    ("u32", "neg"): _u32_neg, ("m31", "mul"): _m31_mul,
    ("gl64", "mul"): _gl_mul, ("gl64", "add"): _gl_add, ("gl64", "sub"): _gl_sub,
    ("gl64", "neg"): lambda c, a: _neg2(_gl_sub, c, a),
    ("u64", "mul"): _u64_mul, ("u64", "add"): _u64_add, ("u64", "sub"): _u64_sub,
    ("u64", "neg"): lambda c, a: _neg2(_u64_sub, c, a),
}


def _one_words(fam: str, c: Consts, like: torch.Tensor) -> torch.Tensor:
    """The family's one (R mod p, or 1) broadcast like an int64 operand."""
    if PLANES[fam] == 1:
        return torch.full_like(like, c.r)
    return torch.stack([torch.full_like(like[0], c.r & M32), torch.full_like(like[0], c.r >> 32)])


def _pow_plain(fam: str, c: Consts, a: torch.Tensor, e: int) -> torch.Tensor:
    mul = _PLAIN[(fam, "mul")]
    res = _one_words(fam, c, a)
    if e == 0:
        return res
    if fam == "u64":  # zkarray/ff/smallfp64.py:pow_const, low bit first
        base = a
        for i in range(e.bit_length()):
            if (e >> i) & 1:
                res = mul(c, res, base)
            base = mul(c, base, base)
        return res
    for bit in bin(e)[2:]:  # smallfp.py / fp64.py:pow_const, high bit first
        res = mul(c, res, res)
        if bit == "1":
            res = mul(c, res, a)
    return res


def sf_op_plain(fam: str, c: Consts, op: str, a: torch.Tensor, b: Optional[torch.Tensor] = None,
                exponent: Optional[int] = None) -> torch.Tensor:
    """The plain version of ``sf_op``: the JAX function's word sequence on
    int64 lanes, on the tensors' device; operands broadcast as in
    ``sf_op``."""
    planes = PLANES[fam]
    x = a.to(torch.int64)
    y = None if b is None else b.to(torch.int64)
    if y is not None:
        x, y = _broadcast(planes, x, y)
    if op == "pow":
        out = _pow_plain(fam, c, x, exponent)
    elif op == "sqr":
        out = _PLAIN[(fam, "mul")](c, x, x)
    elif op == "neg":
        out = _PLAIN[(fam, op)](c, x)
    else:
        out = _PLAIN[(fam, op)](c, x, y)
    return out.to(torch.uint32)


def _broadcast(planes: int, a: torch.Tensor, b: torch.Tensor):
    """Broadcast two operands' batch shapes (trailing dims padded, as the
    JAX package's element-wise ops broadcast: numpy rules on the batch)."""
    if a.shape == b.shape:
        return a, b
    if planes == 1:
        return torch.broadcast_tensors(a, b)
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    return a.expand((2,) + batch), b.expand((2,) + batch)


# ---------------------------------------------------------------------------
# sf_op: one launch per element-wise call
# ---------------------------------------------------------------------------

def _check(what: str, planes: int, *ts: torch.Tensor):
    for t in ts:
        if t.dtype != torch.uint32:
            raise TypeError(f"{what}: expected torch.uint32 tensors, got {t.dtype}")
        if planes == 2 and (t.dim() < 1 or t.shape[0] != 2):
            raise ValueError(f"{what}: expected (2, *batch) planes, got {tuple(t.shape)}")
        if t.device != ts[0].device:
            raise ValueError(f"{what}: tensors on different devices")


def _operand(t: torch.Tensor, planes: int, batch: tuple, n: int):
    """(tensor kept alive, element stride, plane stride) of an operand read
    at the n elements of ``batch``: stride 0 for one element broadcast,
    else 1 over a plane whose elements are contiguous (a partial broadcast
    is expanded and copied first)."""
    lead = (2,) if planes == 2 else ()
    own = tuple(t.shape[planes - 1:])
    if n != 1 and np.prod(own, dtype=np.int64) == 1:
        return t, 0, (t.stride(0) if planes == 2 else 0)
    if own != batch:
        t = t.expand(lead + batch)
    if not (t if planes == 1 else t[0]).is_contiguous():
        t = t.contiguous()
    return t, 1, (t.stride(0) if planes == 2 else 0)


def _exp_words(e: int) -> np.ndarray:
    nw = max((e.bit_length() + 31) // 32, 1)
    return np.asarray([(e >> (32 * i)) & M32 for i in range(nw)], dtype=np.uint32)


def _launch_op(fam: str, c: Consts, op: str, a, b, exponent, out):
    """Launch csrc/smallfp.cu:sf_op_kernel; ``out`` (given or made) is the
    result. Separate so that a recorder can wrap the launch."""
    planes = PLANES[fam]
    ins = [a] if b is None else [a, b]
    batch = tuple(torch.broadcast_shapes(*(t.shape[planes - 1:] for t in ins)))
    shape = ((2,) if planes == 2 else ()) + batch
    n = int(np.prod(batch, dtype=np.int64))
    if out is None:
        out = torch.empty(shape, dtype=torch.uint32, device=a.device)
    elif tuple(out.shape) != shape or not (out if planes == 1 else out[0]).is_contiguous():
        raise ValueError(f"sf_op: out must be {shape} with each plane contiguous")
    elif not km.distinct_addresses(out.shape, out.stride()):  # two planes on one address
        raise ValueError(f"sf_op: out's strides {out.stride()} cannot be written in place")
    if n == 0:
        return out
    ops = [_operand(t, planes, batch, n) for t in ins]
    a_t, a_es, a_ps = ops[0]
    b_t, b_es, b_ps = ops[1] if b is not None else (a_t, 0, 0)
    e = exponent if op == "pow" else 0
    words = _exp_words(e)
    lib = _build.load("smallfp")
    with torch.cuda.device(a.device):
        err = lib.zk_sf_op(FAMILIES[fam], OPS[op], out.data_ptr(),
                           out.stride(0) if planes == 2 else 0, a_t.data_ptr(), a_es, a_ps,
                           b_t.data_ptr(), b_es, b_ps, n, c.p, c.r, c.inv32,
                           words.ctypes.data_as(ctypes.c_void_p), e.bit_length(),
                           torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"sf_op {fam} {op}")
    _build.LAUNCHES["sf_op"] += 1
    return out


def sf_op(fam: str, c: Consts, op: str, a: torch.Tensor, b: Optional[torch.Tensor] = None,
          exponent: Optional[int] = None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One element-wise small-field op (``op`` in OPS) of family ``fam`` over
    uint32 tensors, the two operands broadcast over their batch shapes.
    ``exponent`` is pow's (0 <= e < 2^MAX_EXP_BITS). ``out``: a tensor of the
    result's shape with contiguous planes to write into, two planes not on
    one address (CUDA: refused before the launch; the plain version returns
    a new tensor and the wrapper copies, which refuses it too). CPU
    tensors: ``sf_op_plain``; CUDA tensors: csrc/smallfp.cu:sf_op_kernel,
    one launch."""
    if fam not in FAMILIES or op not in OPS:
        raise ValueError(f"sf_op: unknown family {fam!r} or op {op!r}")
    if fam == "m31" and op != "mul":
        raise ValueError("sf_op: the m31 family has mul only (its other ops are the u32 family's)")
    if (b is None) != (ARITY[op] == 1):
        raise ValueError(f"sf_op: {op} takes {ARITY[op]} operand(s)")
    if op == "pow" and (exponent is None or exponent < 0 or exponent.bit_length() > MAX_EXP_BITS):
        raise ValueError(f"sf_op: pow takes an exponent 0 <= e < 2^{MAX_EXP_BITS}")
    planes = PLANES[fam]
    ins = (a,) if b is None else (a, b)
    _check(f"sf_op {fam} {op}", planes, *ins, *(() if out is None else (out,)))
    if km.on_cpu(*ins):
        res = sf_op_plain(fam, c, op, a, b, exponent)
        return res if out is None else out.copy_(res)
    return _launch_op(fam, c, op, a, b, exponent, out)


# ---------------------------------------------------------------------------
# sf_butterfly: one radix-2 DIT stage, in place
# ---------------------------------------------------------------------------

BUTTERFLY_FAMILIES = ("u32", "gl64")


def sf_butterfly_plain(fam: str, c: Consts, y: torch.Tensor, tw: torch.Tensor, m: int) -> torch.Tensor:
    """One DIT stage of size m over the n rows of y, in place, as the JAX
    stage computes it: for each block of m rows, t = mul(hi, w_j) with
    w_j = tw[j n/m], then (add(lo, t), sub(lo, t)). u32: y (n, B), tw
    (n/2,); gl64: y (2, n), tw (2, n/2)."""
    half = m // 2
    if fam == "u32":
        n = y.shape[0]
        ys = y.to(torch.int64).reshape(n // m, 2, half, -1)
        w = tw[:: n // m][:half].to(torch.int64).reshape(1, half, 1)
        lo, hi = ys[:, 0], ys[:, 1]
        t = _u32_mul(c, hi, w.expand_as(hi))
        res = torch.stack([_u32_add(c, lo, t), _u32_sub(c, lo, t)], dim=1)
    else:
        n = y.shape[1]
        ys = y.to(torch.int64).reshape(2, n // m, 2, half)
        w = tw[:, :: n // m][:, :half].to(torch.int64).reshape(2, 1, half).expand(2, n // m, half)
        lo, hi = ys[:, :, 0], ys[:, :, 1]
        t = _gl_mul(c, hi, w)
        res = torch.stack([_gl_add(c, lo, t), _gl_sub(c, lo, t)], dim=2)
    y.copy_(res.reshape(y.shape).to(torch.uint32))
    return y


def _launch_butterfly(fam: str, c: Consts, y: torch.Tensor, tw: torch.Tensor, m: int):
    n, B = (y.shape[0], y[0].numel()) if fam == "u32" else (y.shape[1], 1)
    lib = _build.load("smallfp")
    with torch.cuda.device(y.device):
        err = lib.zk_sf_butterfly(FAMILIES[fam], y.data_ptr(), tw.data_ptr(), n, B, m,
                                  tw.stride(0) if fam == "gl64" else 0, c.p, c.r, c.inv32,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"sf_butterfly {fam}")
    _build.LAUNCHES["sf_butterfly"] += 1
    return y


def sf_butterfly(fam: str, c: Consts, y: torch.Tensor, tw: torch.Tensor, m: int) -> torch.Tensor:
    """One radix-2 DIT stage of size m (2 <= m <= n, a power of two) in place
    over a contiguous uint32 y: (n, *batch) for the u32 family, (2, n) for
    gl64, with the power table tw of max(n/2, 1) entries (a stage reads
    every (n/m)-th). CPU tensors: ``sf_butterfly_plain``; CUDA tensors:
    csrc/smallfp.cu:sf_butterfly_kernel, one launch."""
    if fam not in BUTTERFLY_FAMILIES:
        raise ValueError(f"sf_butterfly: families {BUTTERFLY_FAMILIES}, not {fam!r}")
    planes = PLANES[fam]
    _check(f"sf_butterfly {fam}", planes, y, tw)
    n = y.shape[0] if planes == 1 else y.shape[1]
    if (n & (n - 1) or m < 2 or m > n or m & (m - 1) or not y.is_contiguous()
            or tw.shape[planes - 1] < max(n // 2, 1) or not (tw if planes == 1 else tw[0]).is_contiguous()):
        raise ValueError(f"sf_butterfly: contiguous y over n = {n} rows (a power of two), "
                         f"2 <= m = {m} <= n a power of two, a table of n/2 entries")
    if planes == 2 and y.dim() != 2:
        raise ValueError("sf_butterfly: gl64 takes y of shape (2, n)")
    if km.on_cpu(y, tw):
        return sf_butterfly_plain(fam, c, y, tw, m)
    return _launch_butterfly(fam, c, y, tw, m)
