"""XYZZ mixed add, full add and doubling, MSM bucket accumulation and window
Horner: CUDA kernels and plain versions.

Counterparts of zkarray/kernels/sw.py:xyzz_add_affine, xyzz_accum_grid,
xyzz_accum_tiles and horner_windows. ``xyzz_add_affine`` is element-wise
(``csrc/madd.cu``, one thread per point), and so are ``xyzz_add`` and
``xyzz_double`` (``csrc/xyzz.cu``), which have no Pallas counterpart: they
run ec/sw.py's full add and doubling in one launch each, where the JAX
package leaves XLA to fuse the jitted formulas around its product kernels.
``xyzz_tree_sum`` (``csrc/xyzz.cu``, no Pallas counterpart either) runs the
levels of ec/msm.py's last-axis tree sum over rows of at most
``TREE_SUM_MAX`` points in one launch, one block per row, and
``xyzz_bit_horner`` (``csrc/sw.cu``, none either) runs ec/msm.py's
bit-Horner over the per-bit partials in one launch, one warp per window,
on horner_windows' chain. One CUDA kernel
(``csrc/sw.cu:xyzz_accum_kernel``) serves both accumulation wrappers: the
port drops the TPU's (8, 128) block tiling, so the grid sweep and the
residual tiles share one flat layout over S bucket slots:

    state  int32[2L, S]     packed 32-bit words, X | Y | ZZ | ZZZ (L/2 each)
    coords int32[L, R, S]   round r's affine x | y packed words per slot
    valid  int32[R, S]      bit0: the slot has a point that round; bit1: negate y

Wrappers take the plain version for CPU tensors and launch the kernel for
CUDA tensors (or raise). The plain versions mirror _madd_core, _dbl_core and
_fadd_core, select order included, with the plain Montgomery product, so
they are independent of the kernels they are checked against.
"""

from __future__ import annotations

import torch

from zkarray_torch.core import limbs as lb
from zkarray_torch.kernels import _build
from zkarray_torch.kernels import mont as km


def _ops(curve):
    f = curve.base
    return (
        lambda u, v: km.mont_mul_plain(f, u, v),
        lambda u: km.mont_sqr_plain(f, u),
        lambda u, v: km.add_plain(f, u, v),
        lambda u, v: km.sub_plain(f, u, v),
    )


def _sel(mask, a, b):
    return tuple(torch.where(mask[None], x, y) for x, y in zip(a, b))


def _inf(curve, batch, device):
    f = curve.base
    one = km.const(f, f.r_int, batch, device)
    zero = lb.zeros(f.num_limbs, batch, device)
    return one, one, zero, zero


def _a_const(curve, like):
    """The curve's a in Montgomery form, shaped like ``like``."""
    f = curve.base
    return km.const(f, f.to_mont_int(curve.a_int), like.shape[1:], like.device)


def _madd_plain(curve, st, AX, AY, a_inf, always_dbl=False):
    """XYZZ += affine (mmadd-xyzz), edge selects as _madd_core: doubling,
    cancel, P = inf, A = inf. The doubling candidate is computed only when
    some slot needs it, as the TPU kernel's lazy_dbl does per block; with
    ``always_dbl`` on every call (the same words, no host branch on them)."""
    mul, sqr, add, sub = _ops(curve)
    X1, Y1, ZZ1, ZZZ1 = st
    U2 = mul(AX, ZZ1)
    S2 = mul(AY, ZZZ1)
    Pp = sub(U2, X1)
    R = sub(S2, Y1)
    PP = sqr(Pp)
    PPP = mul(Pp, PP)
    Q = mul(X1, PP)
    X3 = sub(sub(sqr(R), PPP), add(Q, Q))
    Y3 = sub(mul(R, sub(Q, X3)), mul(Y1, PPP))
    out = (X3, Y3, mul(ZZ1, PP), mul(ZZZ1, PPP))

    p0 = lb.is_zero(Pp)
    r0 = lb.is_zero(R)
    p_inf = lb.is_zero(ZZ1)
    both = ~p_inf & ~a_inf
    is_dbl = both & p0 & r0
    is_cancel = both & p0 & ~r0
    inf = _inf(curve, AX.shape[1:], AX.device)

    if always_dbl or bool(is_dbl.any()):
        U = add(AY, AY)
        V = sqr(U)
        Wr = mul(U, V)
        S = mul(AX, V)
        XX = sqr(AX)
        M = add(add(XX, XX), XX)
        if not curve.a_is_zero:
            M = add(M, _a_const(curve, AX))
        X3d = sub(sqr(M), add(S, S))
        Y3d = sub(mul(M, sub(S, X3d)), mul(Wr, AY))
        dbl_bad = a_inf | lb.is_zero(AY)
        out = _sel(is_dbl, _sel(dbl_bad, inf, (X3d, Y3d, V, Wr)), out)
    out = _sel(is_cancel, inf, out)
    one_or_zero = torch.where(a_inf[None], inf[2], inf[0])
    out = _sel(p_inf, (AX, AY, one_or_zero, one_or_zero), out)
    out = _sel(a_inf, st, out)
    return out


def _dbl_plain(curve, st):
    """Full XYZZ doubling, edge-complete (_dbl_core)."""
    mul, sqr, add, sub = _ops(curve)
    X1, Y1, ZZ1, ZZZ1 = st
    U = add(Y1, Y1)
    V = sqr(U)
    Wr = mul(U, V)
    S = mul(X1, V)
    XX = sqr(X1)
    M = add(add(XX, XX), XX)
    if not curve.a_is_zero:
        M = add(M, mul(_a_const(curve, X1), sqr(ZZ1)))
    X3 = sub(sqr(M), add(S, S))
    Y3 = sub(mul(M, sub(S, X3)), mul(Wr, Y1))
    out = (X3, Y3, mul(V, ZZ1), mul(Wr, ZZZ1))
    bad = lb.is_zero(ZZ1) | lb.is_zero(Y1)
    return _sel(bad, _inf(curve, X1.shape[1:], X1.device), out)


def _fadd_plain(curve, st, st2):
    """Full XYZZ + XYZZ, edge-complete (_fadd_core)."""
    mul, sqr, add, sub = _ops(curve)
    X1, Y1, ZZ1, ZZZ1 = st
    X2, Y2, ZZ2, ZZZ2 = st2
    U1 = mul(X1, ZZ2)
    U2 = mul(X2, ZZ1)
    S1 = mul(Y1, ZZZ2)
    S2 = mul(Y2, ZZZ1)
    Pp = sub(U2, U1)
    R = sub(S2, S1)
    PP = sqr(Pp)
    PPP = mul(Pp, PP)
    Q = mul(U1, PP)
    X3 = sub(sub(sqr(R), PPP), add(Q, Q))
    Y3 = sub(mul(R, sub(Q, X3)), mul(S1, PPP))
    out = (X3, Y3, mul(mul(ZZ1, ZZ2), PP), mul(mul(ZZZ1, ZZZ2), PPP))

    p0 = lb.is_zero(Pp)
    r0 = lb.is_zero(R)
    p_inf = lb.is_zero(ZZ1)
    q_inf = lb.is_zero(ZZ2)
    both = ~p_inf & ~q_inf
    is_dbl = both & p0 & r0
    if bool(is_dbl.any()):
        out = _sel(is_dbl, _dbl_plain(curve, st), out)
    out = _sel(both & p0 & ~r0, _inf(curve, X1.shape[1:], X1.device), out)
    out = _sel(p_inf, st2, out)
    out = _sel(q_inf, st, out)
    return out


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def xyzz_accum_plain(curve, state, coords, valid):
    """R sequential bucket rounds over S slots (layout in the module doc)."""
    L = curve.base.num_limbs
    Lp = L // 2
    st = tuple(lb.unpack_pairs(state[i * Lp : (i + 1) * Lp]) for i in range(4))
    zero = lb.zeros(L, state.shape[1:], state.device)
    for r in range(coords.shape[1]):
        st = accum_round_plain(curve, st, coords[:, r], valid[r], zero)
    return torch.cat([lb.pack_pairs(v) for v in st], dim=0)


def accum_round_plain(curve, st, cd, v, zero, always_dbl=False):
    """One bucket round of ``xyzz_accum_plain``: the unpacked XYZZ state
    ``st`` += the round's affine points ``cd`` (packed X | Y, (L, S)),
    negated where bit 1 of ``v`` is set, skipped where bit 0 is clear
    (``_madd_plain``; ``always_dbl`` as there)."""
    f = curve.base
    Lp = f.num_limbs // 2
    AX = lb.unpack_pairs(cd[:Lp])
    AY = lb.unpack_pairs(cd[Lp:])
    a_inf = (v & 1) == 0
    sign = ((v >> 1) & 1) != 0
    AY = torch.where(sign[None], km.sub_plain(f, zero, AY), AY)
    return _madd_plain(curve, st, AX, AY, a_inf, always_dbl)


def horner_windows_plain(curve, win, c: int):
    """total = sum_w 2^(c w) win_w; win int32[W, 4L] (X | Y | ZZ | ZZZ limbs
    per window) -> int32[4L]."""
    L = curve.base.num_limbs
    W = win.shape[0]

    def point(w):
        return tuple(win[w, i * L : (i + 1) * L, None] for i in range(4))

    st = point(W - 1)
    for wi in range(W - 1):
        for _ in range(c):
            st = _dbl_plain(curve, st)
        st = _fadd_plain(curve, st, point(W - 2 - wi))
    return torch.cat([v[:, 0] for v in st]).to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _curve_words(curve):
    f = curve.base
    return km.field_words(f, f.to_mont_int(curve.a_int))


def _accum(curve, state, coords, valid, what):
    L = curve.base.num_limbs
    if km.on_cpu(state, coords, valid):
        return xyzz_accum_plain(curve, state, coords, valid)
    km.check_cuda_int32(what, state, coords, valid)
    S = state.shape[1]
    R = coords.shape[1]
    if state.shape != (2 * L, S) or coords.shape != (L, R, S) or valid.shape != (R, S):
        raise ValueError(
            f"{what}: shapes state {tuple(state.shape)}, coords {tuple(coords.shape)}, "
            f"valid {tuple(valid.shape)} do not match (2L, S), (L, R, S), (R, S) for L={L}"
        )
    out = torch.empty_like(state)
    lib = _build.load("sw")
    words = _curve_words(curve)
    with torch.cuda.device(state.device):
        err = lib.zk_xyzz_accum(
            state.data_ptr(), out.data_ptr(), coords.data_ptr(), valid.data_ptr(), R, S,
            L // 2, km.words_ptr(words), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, what)
    _build.LAUNCHES["xyzz_accum"] += 1
    return out


def xyzz_accum_grid(curve, state, coords, valid):
    """A whole band of bucket rounds in one launch (msm band 1 and band 2)."""
    return _accum(curve, state, coords, valid, "xyzz_accum_grid")


def xyzz_accum_tiles(curve, state, coords, valid):
    """T residual bucket rounds in one launch (msm's residual loop)."""
    return _accum(curve, state, coords, valid, "xyzz_accum_tiles")


def xyzz_add_affine_plain(curve, P, AX, AY, a_inf):
    """Element-wise XYZZ += affine: _madd_plain over one batch."""
    return _madd_plain(curve, tuple(P), AX, AY, a_inf)


def xyzz_add_affine(curve, P, AX, AY, a_inf):
    """Element-wise XYZZ += affine (mmadd-xyzz with _madd_core's edges) over
    (L, *batch) coordinates P = (X, Y, ZZ, ZZZ), AX, AY and a bool a_inf of
    the batch shape; returns the four new coordinates. CPU tensors: plain
    version; CUDA tensors: csrc/madd.cu."""
    L = curve.base.num_limbs
    if km.on_cpu(*P, AX, AY, a_inf):
        return xyzz_add_affine_plain(curve, P, AX, AY, a_inf)
    shape = AX.shape
    coords = [t.contiguous() for t in (*P, AX, AY)]
    km.check_cuda_int32("xyzz_add_affine", *coords)
    if (shape[0] != L or any(t.shape != shape for t in coords) or a_inf.shape != shape[1:]
            or a_inf.device != AX.device):
        raise ValueError(f"xyzz_add_affine: coordinates must all be (L={L}, *batch) of one "
                         f"shape and a_inf batch-shaped, on one device")
    inf = a_inf.to(torch.bool).contiguous()
    outs = [torch.empty_like(coords[0]) for _ in range(4)]
    lib = _build.load("madd")
    with torch.cuda.device(AX.device):
        err = lib.zk_xyzz_add_affine(*(t.data_ptr() for t in coords), inf.data_ptr(),
                                     *(t.data_ptr() for t in outs), AX.numel() // L, L // 2,
                                     km.words_ptr(_curve_words(curve)),
                                     torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "xyzz_add_affine")
    _build.LAUNCHES["xyzz_add_affine"] += 1
    return tuple(outs)


def _launch_xyzz(kernel: str, curve, *coords: torch.Tensor):
    """Run the element-wise kernel ``kernel`` of csrc/xyzz.cu on XYZZ points
    given as their (L, *batch) coordinates, X, Y, ZZ, ZZZ per point, all of
    one shape; returns the four output coordinates (views of one contiguous
    (4, L, *batch) tensor)."""
    out = km.launch_strided("xyzz", kernel, curve.base.num_limbs, _curve_words(curve), coords,
                            out_lead=(4,))
    return tuple(out.unbind(0))


def xyzz_add(curve, P, Q):
    """Full XYZZ + XYZZ with _fadd_core's edges over (L, *batch) coordinates
    P = (X, Y, ZZ, ZZZ) and Q, broadcast to one batch shape; returns the four
    sum coordinates. CPU tensors: ``_fadd_plain``; CUDA tensors:
    csrc/xyzz.cu:xyzz_add_kernel."""
    if km.on_cpu(*P, *Q):
        return _fadd_plain(curve, tuple(P), tuple(Q))
    return _launch_xyzz("xyzz_add", curve, *km.align(curve.base.num_limbs, *P, *Q))


def xyzz_double(curve, P):
    """XYZZ doubling (inf or y = 0 -> inf) over (L, *batch) coordinates of one
    shape. CPU tensors: ``_dbl_plain``; CUDA tensors:
    csrc/xyzz.cu:xyzz_double_kernel."""
    if km.on_cpu(*P):
        return _dbl_plain(curve, tuple(P))
    return _launch_xyzz("xyzz_double", curve, *km.align(curve.base.num_limbs, *P))


# csrc/xyzz.cu:TREE_MAX_WIDTH, the widest row xyzz_tree_sum takes (its
# shared memory holds half a row: 96 KB of BLS12-381 points at 1,024).
TREE_SUM_MAX = 1024


def xyzz_tree_sum_plain(curve, P):
    """Pairwise tree sum over the last axis of (L, *batch, m) coordinates
    P = (X, Y, ZZ, ZZZ), as zkarray/ec/msm.py:_tree_sum_last pairs it:
    element i meets i + m // 2, and an odd last element is carried to the
    next level unchanged. Returns (L, *batch, 1) coordinates."""
    P = tuple(P)
    m = P[0].shape[-1]
    while m > 1:
        h = m // 2
        red = _fadd_plain(curve, tuple(v[..., :h] for v in P), tuple(v[..., h : 2 * h] for v in P))
        if m % 2:
            red = tuple(torch.cat([a, v[..., 2 * h :]], dim=-1) for a, v in zip(red, P))
        m -= h
        P = red
    return P


def xyzz_tree_sum(curve, P):
    """The tree sum of ``xyzz_tree_sum_plain`` in one launch for rows of
    1 <= m <= TREE_SUM_MAX points; inputs strided as kernels.mont._operand
    allows. CPU tensors: the plain version; CUDA tensors:
    csrc/xyzz.cu:xyzz_tree_sum_kernel."""
    if km.on_cpu(*P):
        return xyzz_tree_sum_plain(curve, P)
    L = curve.base.num_limbs
    km.check_cuda_int32("xyzz_tree_sum", *P, contiguous=False)
    shape = P[0].shape
    m = shape[-1] if len(shape) > 1 else 0
    if shape[0] != L or any(t.shape != shape for t in P) or not 1 <= m <= TREE_SUM_MAX:
        raise ValueError(f"xyzz_tree_sum: coordinates must be of one (L={L}, *batch, m) shape "
                         f"with 1 <= m <= {TREE_SUM_MAX}, got {tuple(shape)}")
    ops = [km._operand(t) for t in P]  # held until the launch: a copy may be among them
    desc = km.operand_words(ops)
    out = torch.empty((4,) + tuple(shape[:-1]) + (1,), dtype=torch.int32, device=P[0].device)
    lib = _build.load("xyzz")
    with torch.cuda.device(out.device):
        err = lib.zk_xyzz_tree_sum(km.words_ptr(desc), out.data_ptr(), P[0][0].numel() // m, m,
                                   L // 2, km.words_ptr(_curve_words(curve)),
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "xyzz_tree_sum")
    _build.LAUNCHES["xyzz_tree_sum"] += 1
    return tuple(out.unbind(0))


def xyzz_bit_horner_plain(curve, parts):
    """The bit-Horner of zkarray/ec/msm.py:_weighted_sum_bits over per-bit
    partials ``parts`` = (X, Y, ZZ, ZZZ), each (L, nbits, W): acc =
    parts[:, nbits - 1], then for k = nbits - 2 .. 0 acc = 2 acc (_dbl_plain)
    and acc = acc + parts[:, k] (_fadd_plain). Returns (L, W) coordinates."""
    nbits = parts[0].shape[1]
    acc = tuple(v[:, nbits - 1] for v in parts)
    for k in range(nbits - 2, -1, -1):
        acc = _fadd_plain(curve, _dbl_plain(curve, acc), tuple(v[:, k] for v in parts))
    return acc


def xyzz_bit_horner(curve, parts):
    """The bit-Horner of ``xyzz_bit_horner_plain`` in one launch. CPU
    tensors: the plain version; CUDA tensors: csrc/sw.cu:xyzz_bit_horner_kernel
    (contiguous inputs are read in place)."""
    if km.on_cpu(*parts):
        return xyzz_bit_horner_plain(curve, parts)
    L = curve.base.num_limbs
    parts = [t.contiguous() for t in parts]
    km.check_cuda_int32("xyzz_bit_horner", *parts)
    shape = parts[0].shape
    if len(shape) != 3 or shape[0] != L or any(t.shape != shape for t in parts) or 0 in shape:
        raise ValueError(f"xyzz_bit_horner: coordinates must be of one (L={L}, nbits, W) shape, "
                         f"got {tuple(shape)}")
    _, nbits, W = shape
    out = torch.empty((4, L, W), dtype=torch.int32, device=parts[0].device)
    lib = _build.load("sw")
    with torch.cuda.device(out.device):
        err = lib.zk_xyzz_bit_horner(*(t.data_ptr() for t in parts), out.data_ptr(), nbits, W,
                                     L // 2, km.words_ptr(_curve_words(curve)),
                                     torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "xyzz_bit_horner")
    _build.LAUNCHES["xyzz_bit_horner"] += 1
    return tuple(out.unbind(0))


def horner_windows(curve, win, c: int):
    """Window Horner in one launch: win int32[W, 4L] -> int32[4L]."""
    L = curve.base.num_limbs
    if km.on_cpu(win):
        return horner_windows_plain(curve, win, c)
    win = win.contiguous()
    km.check_cuda_int32("horner_windows", win)
    W = win.shape[0]
    if win.shape != (W, 4 * L) or W < 1:
        raise ValueError(f"horner_windows: win shape {tuple(win.shape)} is not (W, {4 * L})")
    out = torch.empty(4 * L, dtype=torch.int32, device=win.device)
    lib = _build.load("sw")
    words = _curve_words(curve)
    with torch.cuda.device(win.device):
        err = lib.zk_horner_windows(win.data_ptr(), out.data_ptr(), W, c, L // 2,
                                    km.words_ptr(words), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "horner_windows")
    _build.LAUNCHES["horner_windows"] += 1
    return out
