"""An ``out`` whose elements share addresses, refused before the launch by
every wrapper that writes one in place: twiddle_mul
(zkarray_torch/kernels/mont.py) and sf_op (kernels/smallfp.py), driven on the
CPU through stand-ins for their C entries (csrc/twiddle.cu:zk_twiddle_mul,
csrc/smallfp.cu:zk_sf_op) that read the operands and write the output
through the descriptors they are handed, as the card does. A refused out is
left unwritten and the C entry never called; every out the wrappers took
before (a new tensor, x itself, a column block of a wider tensor, a slice
of a table, two planes of a (2, size) table) still goes through, with the
plain version's words; the Fr four-step fft's and the small fields' table
layouts go through the stand-ins unchanged. The rule itself
(kernels/mont.py:distinct_addresses) is held against a brute-force count of
addresses. No JAX function runs."""

import contextlib
import ctypes
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_launch import offsets  # noqa: E402
from zkarray_torch.curves import bls12_381 as tb  # noqa: E402
from zkarray_torch.ff import fp, fp64, smallfp  # noqa: E402
from zkarray_torch.kernels import _build  # noqa: E402
from zkarray_torch.kernels import mont as km  # noqa: E402
from zkarray_torch.kernels import smallfp as ks  # noqa: E402
from zkarray_torch.poly import domain  # noqa: E402

FR = tb.FR
STREAM = 4321
PLAIN_ON_CPU = km.on_cpu


def longs(addr, count):
    return list((ctypes.c_longlong * count).from_address(addr))


def words_at(addr, offs, ctype=ctypes.c_int32):
    """The numpy view of the words at ``addr`` that ``offs`` reach."""
    return np.ctypeslib.as_array((ctype * (int(offs.max()) + 1)).from_address(addr))


class TwiddleStandIn:
    """zk_twiddle_mul on host memory: x through its operand descriptor
    (pointer, ld, inner, outer), the tables by address, the result of
    twiddle_mul_plain written at out[k*out_ld + r*out_row + c]."""

    def __init__(self, spec):
        self.spec, self.calls, self.tables = spec, [], {}

    def zk_twiddle_mul(self, x, out, out_ld, out_row, lo, lo_len, hi, hi_len, h, R, C, r0, c0,
                       nw, consts, stream):
        spec, L = self.spec, self.spec.num_limbs
        assert nw == L // 2 and stream == STREAM
        assert np.array_equal(words_at(consts.value, np.arange(km.field_words(spec).size),
                                       ctypes.c_uint32), km.field_words(spec))
        tw = self.tables[(lo, hi)]
        assert (lo_len, hi_len, h) == (tw.lo.shape[0], tw.hi.shape[0], tw.h)
        base, ld, inner, outer = longs(x.value, 4)
        offs = offsets(L, R * C, ld, inner, outer)
        xs = torch.from_numpy(words_at(base, offs)[offs].copy()).reshape(L, R, C)
        res = km.twiddle_mul_plain(spec, xs, tw, r0, c0, torch.empty_like(xs))
        o = (np.arange(L)[:, None, None] * out_ld + np.arange(R)[None, :, None] * out_row
             + np.arange(C)[None, None, :])
        words_at(out, o)[o] = res.numpy()
        self.calls.append(dict(R=R, C=C, r0=r0, c0=c0, out=out, out_ld=out_ld, out_row=out_row))
        return 0


class SfStandIn:
    """zk_sf_op on host memory: each operand's n elements at element stride
    es (0 or 1) and plane stride ps, sf_op_plain's result written at
    out[plane*out_ps + i]."""

    def __init__(self):
        self.calls = []

    def zk_sf_op(self, family, op, out, out_ps, a, a_es, a_ps, b, b_es, b_ps, n, p, r, inv32,
                 exp, nbits, stream):
        fam = {v: k for k, v in ks.FAMILIES.items()}[family]
        name = {v: k for k, v in ks.OPS.items()}[op]
        planes = ks.PLANES[fam]
        assert stream == STREAM

        def read(ptr, es, ps):
            offs = np.arange(planes)[:, None] * ps + np.arange(n)[None, :] * es
            t = torch.from_numpy(words_at(ptr, offs, ctypes.c_uint32)[offs].copy())
            return t if planes == 2 else t[0]

        A = read(a, a_es, a_ps)
        B = read(b, b_es, b_ps) if ks.ARITY[name] == 2 else None
        words = words_at(exp.value, np.arange(max((nbits + 31) // 32, 1)), ctypes.c_uint32)
        e = sum(int(w) << (32 * j) for j, w in enumerate(words)) if name == "pow" else None
        res = ks.sf_op_plain(fam, ks.Consts(p, r, inv32), name, A, B, e)
        offs = np.arange(planes)[:, None] * out_ps + np.arange(n)[None, :]
        words_at(out, offs, ctypes.c_uint32)[offs] = res.reshape(planes, n).numpy()
        self.calls.append(dict(fam=fam, op=name, n=n, out=out, out_ps=out_ps))
        return 0


@pytest.fixture
def card(monkeypatch):
    """The CUDA branch of twiddle_mul and sf_op on CPU tensors: the device
    decision, the CUDA checks, the device context and the stream replaced,
    the libraries by the stand-ins. Returns the stand-ins."""
    got = types.SimpleNamespace(tw=TwiddleStandIn(FR), sf=SfStandIn())
    libs = {"twiddle": types.SimpleNamespace(zk_twiddle_mul=got.tw.zk_twiddle_mul),
            "smallfp": types.SimpleNamespace(zk_sf_op=got.sf.zk_sf_op)}

    def check_int32(what, *ts, contiguous=True):
        for t in ts:
            assert t.dtype == torch.int32 and (t.is_contiguous() or not contiguous), what

    monkeypatch.setattr(km, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(km, "check_cuda_int32", check_int32)
    monkeypatch.setattr(_build, "load", lambda name: libs[name])
    monkeypatch.setattr(_build, "check", lambda lib, err, what: None if err == 0 else pytest.fail(what))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=STREAM))
    for k in ("twiddle_mul", "sf_op"):
        monkeypatch.setitem(_build.LAUNCHES, k, 0)
    return got


def plain(fn, monkeypatch):
    with monkeypatch.context() as mp:
        mp.setattr(km, "on_cpu", PLAIN_ON_CPU)
        return fn()


def tables(card, spec, e_max, scale=None):
    tw = km.twiddle_tables(spec, spec.root_of_unity(64), e_max, "cpu", scale)
    card.tw.tables[(tw.lo.data_ptr(), tw.hi.data_ptr())] = tw
    return tw


def fr_words(shape, seed):
    rng = np.random.default_rng(seed)
    ints = [int.from_bytes(rng.bytes(40), "little") % FR.modulus for _ in range(int(np.prod(shape)))]
    return fp.from_ints(FR, ints, device="cpu").reshape((FR.num_limbs,) + tuple(shape))


@pytest.mark.parametrize("layout", ["stride-0 rows", "stride-0 limbs", "rows inside a row's span"])
def test_twiddle_mul_refuses_shared_out(layout, card):
    """twiddle_mul into an (L, 4, 4) out whose rows or limbs share addresses
    raises before the C entry is called and leaves the out unwritten."""
    L = FR.num_limbs
    tw = tables(card, FR, 9)
    x = fr_words((4, 4), 1)
    out = {"stride-0 rows": lambda: torch.zeros(L, 1, 4, dtype=torch.int32).expand(L, 4, 4),
           "stride-0 limbs": lambda: torch.zeros(16, dtype=torch.int32).as_strided((L, 4, 4), (0, 4, 1)),
           "rows inside a row's span": lambda: torch.zeros(L * 8 + 8, dtype=torch.int32).as_strided(
               (L, 4, 4), (8, 2, 1))}[layout]()
    before = out.clone()
    with pytest.raises(ValueError, match="cannot be written in place"):
        km.twiddle_mul(FR, x, tw, out=out)
    assert torch.equal(out, before) and card.tw.calls == [] and _build.LAUNCHES["twiddle_mul"] == 0


def test_sf_op_refuses_shared_planes(card):
    """A gl64 add into torch.zeros(1, 3).expand(2, 3) (both planes on one
    address, each contiguous) raises before the C entry is called; the out
    stays unwritten."""
    a = fp64.from_ints([1, 2, 3], "cpu")
    out = torch.zeros(1, 3, dtype=torch.uint32).expand(2, 3)
    before = out.clone()
    with pytest.raises(ValueError, match="cannot be written in place"):
        ks.sf_op("gl64", ks.GL64, "add", a, a, out=out)
    assert torch.equal(out, before) and card.sf.calls == [] and _build.LAUNCHES["sf_op"] == 0


@pytest.mark.parametrize("layout", ["new", "x itself", "column block", "every other row"])
def test_twiddle_mul_accepted_outs_go_through(layout, card, monkeypatch):
    """The outs twiddle_mul took before: a new tensor, x itself (the
    four-step core's in-place twist), a column block of a wider tensor (the
    big four-step's pass 1) and every other row of a taller one, each
    written through its strides by the stand-in with the plain version's
    words, nothing outside the view written."""
    L = FR.num_limbs
    x = fr_words((4, 4), 2)
    tw = tables(card, FR, 5 * 7)
    want = plain(lambda: km.twiddle_mul(FR, x, tw, 1, 2), monkeypatch)
    buf = {"column block": torch.full((L, 6, 12), -1, dtype=torch.int32),
           "every other row": torch.full((L, 8, 4), -1, dtype=torch.int32)}.get(layout)
    out = {"new": None, "x itself": x.clone(), "column block": buf[:, 1:5, 4:8] if buf is not None
           else None, "every other row": buf[:, ::2] if buf is not None else None}[layout]
    got = km.twiddle_mul(FR, out if layout == "x itself" else x, tw, 1, 2, out=out)
    assert torch.equal(got, want) and _build.LAUNCHES["twiddle_mul"] == 1
    if out is not None:
        assert got.data_ptr() == out.data_ptr()
    if buf is not None:
        mask = torch.zeros_like(buf, dtype=torch.bool)
        mask.as_strided(out.shape, out.stride(), out.storage_offset()).fill_(True)
        assert (buf[~mask] == -1).all()
    call = card.tw.calls[-1]
    assert (call["R"], call["C"], call["r0"], call["c0"]) == (4, 4, 1, 2)
    assert (call["out_ld"], call["out_row"]) == (got.stride(0), got.stride(1))


def test_fr_fourstep_layouts_unchanged(card, monkeypatch):
    """fft_fourstep_core's in-place twist and fft_fourstep_big's pass-1
    column blocks (Fr, 2^8 points): each twiddle_mul call the plain fft
    makes, replayed through the stand-in into the same view of a fresh
    buffer, gives the plain call's words and writes only its view."""
    L = FR.num_limbs
    rec = []
    real = km.twiddle_mul

    def record(spec, x, tw, r0=0, c0=0, out=None):
        base = None if out is None else out._base if out._base is not None else out
        rec.append((x.clone(), tw, r0, c0, None if out is None else
                    (tuple(base.shape), tuple(out.shape), out.stride(),
                     out.storage_offset() - base.storage_offset())))
        return real(spec, x, tw, r0, c0, out)

    x = fr_words((256,), 3)
    w = FR.root_of_unity(256)
    with monkeypatch.context() as mp:
        mp.setattr(km, "on_cpu", PLAIN_ON_CPU)
        mp.setattr(km, "twiddle_mul", record)
        domain.fft_fourstep_core(FR, x, 16, 16, w)
        domain.fft_fourstep_big(FR, x, 16, 16, w)
    assert len(rec) == 1 + domain.BIG_CHUNKS
    for xs, tw, r0, c0, lay in rec:
        card.tw.tables[(tw.lo.data_ptr(), tw.hi.data_ptr())] = tw
        want = plain(lambda: real(FR, xs, tw, r0, c0), monkeypatch)
        if lay is None:
            assert torch.equal(real(FR, xs, tw, r0, c0), want)
            continue
        base_shape, shape, stride, off = lay
        buf = torch.full(base_shape, -1, dtype=torch.int32)
        view = buf.as_strided(shape, stride, off)
        assert torch.equal(real(FR, xs, tw, r0, c0, out=view), want)
        mask = torch.zeros(base_shape, dtype=torch.bool)
        mask.as_strided(shape, stride, off).fill_(True)
        assert (buf[~mask] == -1).all()
    assert _build.LAUNCHES["twiddle_mul"] == len(rec)


@pytest.mark.parametrize("fam", ["u32", "gl64"])
def test_sf_op_accepted_outs_go_through(fam, card, monkeypatch):
    """sf_op's outs as the small fields pass them: a new tensor, a
    contiguous out, a slice of a table (BabyBear's T[k:2k]) and two
    contiguous planes of a (2, size) table (Goldilocks' T[:, k:2k]), with a
    broadcast one-element operand: the plain version's words, nothing
    outside the view written."""
    if fam == "u32":
        c = smallfp.BABYBEAR.consts
        a = torch.tensor([1, 2, 3, 2013265920], dtype=torch.uint32)
        one = torch.tensor([5], dtype=torch.uint32)
        T = torch.full((8,), 7, dtype=torch.uint32)
        view = T[4:8]
    else:
        c = ks.GL64
        a = fp64.from_ints([1, 2, 3, (1 << 64) - (1 << 32)], "cpu")
        one = fp64.from_ints([5], "cpu").reshape(2, 1)
        T = torch.full((2, 8), 7, dtype=torch.uint32)
        view = T[:, 4:8]
    want = plain(lambda: ks.sf_op(fam, c, "mul", a, one), monkeypatch)
    assert torch.equal(ks.sf_op(fam, c, "mul", a, one), want)
    assert torch.equal(ks.sf_op(fam, c, "mul", a, one, out=torch.empty_like(a)), want)
    got = ks.sf_op(fam, c, "mul", a, one, out=view)
    assert got.data_ptr() == view.data_ptr() and torch.equal(view, want)
    assert (T[..., :4] == 7).all() and _build.LAUNCHES["sf_op"] == 3
    assert card.sf.calls[-1]["out_ps"] == (T.stride(0) if fam == "gl64" else 0)


def test_small_field_tables_unchanged(card, monkeypatch):
    """BabyBear's and Goldilocks' twiddle tables (phase 15's first ntt
    call: one sf_op a doubling, written into the table's own slices)
    through the stand-in: the plain route's words, one launch a doubling."""
    bb, w, wg = smallfp.BABYBEAR, 31, 7  # any base: the tables are its powers
    want_bb = plain(lambda: smallfp.twiddle_table.__wrapped__(bb, w, 20, "cpu"), monkeypatch)
    want_gl = plain(lambda: fp64.twiddle_table.__wrapped__(wg, 20, "cpu"), monkeypatch)
    assert torch.equal(smallfp.twiddle_table.__wrapped__(bb, w, 20, "cpu"), want_bb)
    assert torch.equal(fp64.twiddle_table.__wrapped__(wg, 20, "cpu"), want_gl)
    assert _build.LAUNCHES["sf_op"] == 2 * 5  # doublings 1, 2, 4, 8, 16
    assert {c_["out_ps"] for c_ in card.sf.calls if c_["fam"] == "gl64"} == {20}


@pytest.mark.parametrize("shape", [(3,), (2, 3), (4, 1, 5), (2, 3, 4)])
def test_distinct_addresses_against_a_count(shape):
    """The rule against counting the addresses of small layouts: every
    stride combination up to 13 on each axis (0 included), True exactly
    when the elements' offsets are all distinct, for every layout that is
    a view of a tensor owning its memory; over-refusing only interleaved
    layouts that no view makes."""
    views = 0
    for strides in itertools.product(range(14), repeat=len(shape)):
        offs = np.zeros(shape, dtype=np.int64)
        for ax, st in enumerate(strides):
            offs = offs + st * np.arange(shape[ax]).reshape([-1 if a == ax else 1
                                                              for a in range(len(shape))])
        distinct = len(np.unique(offs)) == offs.size
        got = km.distinct_addresses(shape, strides)
        assert distinct or not got, (shape, strides)  # never accepts a shared address
        order = sorted((st, s) for s, st in zip(shape, strides) if s > 1)
        nested = all(st > 0 for st, _ in order) and all(
            b[0] % a[0] == 0 and b[0] >= a[0] * a[1] for a, b in zip(order, order[1:]))
        if distinct and nested:
            views += 1
            assert got, (shape, strides)  # a view of a dense tensor goes through
    assert views > 0
