"""The launch of the field additions (zkarray_torch/kernels/mont.py:
AddSubLauncher, csrc/fadd.cu:zk_fp_add_v/zk_fp_sub_v) on the CPU: the
launcher driven end to end through a stand-in for the C entries that reads
each operand and writes the output through the maps it is given, on every
operand layout the paths give an addition (a tower's ``movedim`` view as
input and as ``out`` included), against the plain versions and, on
testing.fadd_edge_words at L = 16 and 24, against the JAX package's
zkarray.ff.fp.add/sub/neg words; an ``out`` that cannot be written in place;
fp.double's one map and fp_neg's cached zero; the memoised ``batch_map``;
and the device decision."""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_launch import distinct, field_tensor, offsets, read_words  # noqa: E402
from zkarray_torch.curves import bls12_381, bn254  # noqa: E402
from zkarray_torch.ff import fp  # noqa: E402
from zkarray_torch.kernels import _build  # noqa: E402
from zkarray_torch.kernels import mont as km  # noqa: E402

torch.set_num_threads(1)

FQ, FR = bls12_381.FQ, bn254.FR
STREAM = 1234


class AddSubStandIn:
    """zk_fp_add_v / zk_fp_sub_v on host memory: reads a and b through the
    maps they are passed, checks the constant words at their address and
    the stream, writes the plain result through out's map."""

    def __init__(self, spec):
        self.spec, self.calls, self.busy = spec, [], False
        self.add = self._entry("fp_add", km.add_plain)
        self.sub = self._entry("fp_sub", km.sub_plain)

    def _entry(self, kernel, plain):
        spec, L = self.spec, self.spec.num_limbs

        def entry(a, a_ld, a_in, a_out, b, b_ld, b_in, b_out, out, o_ld, o_in, o_out, n, nw,
                  consts, stream):
            assert nw == L // 2 and stream == STREAM
            words = km.field_words(spec)
            got = np.ctypeslib.as_array((ctypes.c_uint32 * words.size).from_address(consts))
            assert np.array_equal(got, words)
            self.calls.append(dict(kernel=kernel, a=(a_ld, a_in, a_out), b=(b_ld, b_in, b_out),
                                   out=(o_ld, o_in, o_out), same_ptr=a == b))
            self.busy = True  # the plain version's own align is not the wrapper's
            res = plain(spec, read_words(a, L, n, a_ld, a_in, a_out),
                        read_words(b, L, n, b_ld, b_in, b_out)).numpy()
            self.busy = False
            offs = offsets(L, n, o_ld, o_in, o_out)
            buf = np.ctypeslib.as_array((ctypes.c_int32 * (int(offs.max()) + 1)).from_address(out))
            buf[offs] = res
            return 0

        return entry


def host_launcher(spec, entries):
    """An AddSubLauncher for CPU tensors (device index -1) whose C entries
    are ``entries``: the Python side exactly as it runs on the card."""
    go = object.__new__(km.AddSubLauncher)
    go.spec, go.index, go.L, go.nw, go.lib = spec, -1, spec.num_limbs, spec.num_limbs // 2, None
    go.words = km.field_words(spec)
    go.consts = go.words.ctypes.data
    go.fns = {"fp_add": entries.add, "fp_sub": entries.sub}
    go.current_device, go.raw_stream = (lambda: -1), (lambda index: STREAM)
    return go


@pytest.fixture
def kernel_route(monkeypatch):
    """Puts a stand-in launcher behind the CPU tensors' kernel route for FQ
    and FR; returns {spec: stand-in}."""
    got = {}
    for spec in (FQ, FR):
        got[spec] = AddSubStandIn(spec)
        monkeypatch.setitem(km._ADDSUB_LAUNCHERS, (id(spec), -1), host_launcher(spec, got[spec]))
    monkeypatch.setattr(km, "on_cpu", lambda *ts: False)
    monkeypatch.setitem(_build.LAUNCHES, "fp_add", 0)
    monkeypatch.setitem(_build.LAUNCHES, "fp_sub", 0)
    return got


def layouts(L, make):
    """(name, tensor, copied) for the operand layouts the paths give an
    addition, each of batch shape (4, 6); ``copied``: not addressable by
    the operand map, so the launcher copies it."""
    big = make(L, (5, 4, 12))
    tower = make(L, (2 * 4 * 6,)).reshape(L, 2, 4, 6).movedim(0, 1).contiguous()  # (2, L, 4, 6)
    return [
        ("contiguous", make(L, (4, 6)), False),
        ("first-axis slice", make(L, (6, 6))[:, 1:5], False),
        ("stride-0 constant", make(L, (1,))[:, None].expand(L, 4, 6), False),
        ("stride-0 row over a leading axis", make(L, (6,))[:, None].expand(L, 4, 6), False),
        ("last-axis lower half", big[:, 1, :, :6], False),
        ("last-axis upper half", big[:, 2, :, 6:], False),
        ("tower movedim view, first coefficient", tower.movedim(1, 0)[:, 0], False),
        ("batch transpose", make(L, (6, 4)).transpose(1, 2), True),
    ]


def tower_views(L, make):
    """(name, (L, c..., 4, 6) view) of ff/towers.py:_lin's reading of an
    Fq2 (2, L, 4, 6) and an Fq6 (3, 2, L, 4, 6) element."""
    return [("Fq2 movedim view", make(L, (2 * 24,)).reshape(2, L, 4, 6).movedim(1, 0)),
            ("Fq6 movedim view", make(L, (6 * 24,)).reshape(3, 2, L, 4, 6).movedim(2, 0))]


@pytest.mark.parametrize("spec", [FQ, FR], ids=["L24", "L16"])
def test_launcher_through_wrappers_matches_plain(spec, kernel_route):
    """fp_add, fp_sub, fp_neg and fp.double through _launch_addsub and the
    cached launcher, with the C entries replaced by ``AddSubStandIn``:
    every layout, as a and as b, gives the plain version's words into a
    new contiguous tensor, one count a launch, ``_operand``'s map (the
    fast case's for a contiguous operand, the copy's for a transposed one)."""
    L = spec.num_limbs
    entries = kernel_route[spec]
    rand = lambda L_, shape: field_tensor(spec, shape, L_ + sum(shape))  # noqa: E731
    y = field_tensor(spec, (4, 6), 7)
    launches = 0
    for name, x, copied in layouts(L, rand) + [(n, v, False) for n, v in tower_views(L, rand)]:
        other = y if x.shape == y.shape else field_tensor(spec, x.shape[1:], 8)
        n = x[0].numel()
        want_map = (n, n, 0) if copied else km._operand(x)[1:]
        for kern, plain, args in ((km.fp_add, km.add_plain, (x, other)),
                                  (km.fp_add, km.add_plain, (other, x)),
                                  (km.fp_sub, km.sub_plain, (x, other)),
                                  (km.fp_sub, km.sub_plain, (other, x))):
            got = kern(spec, *args)
            assert got.is_contiguous() and torch.equal(got, plain(spec, *args)), name
            call = entries.calls[-1]
            assert call["a" if args[0] is x else "b"] == want_map, name
            assert call["out"] == (n, n, 0), name
        got = km.fp_neg(spec, x)
        assert torch.equal(got, km.sub_plain(spec, torch.zeros_like(x), x)), name
        assert entries.calls[-1]["kernel"] == "fp_sub" and entries.calls[-1]["b"] == want_map
        assert entries.calls[-1]["a"][1:] == (1, 0), name  # the zero, read at stride 0
        got = fp.double(spec, x)
        assert torch.equal(got, km.add_plain(spec, x, x)), name
        assert entries.calls[-1]["same_ptr"] and entries.calls[-1]["a"] == entries.calls[-1]["b"]
        launches += 6
        assert _build.LAUNCHES["fp_add"] + _build.LAUNCHES["fp_sub"] == launches, name
    assert _build.LAUNCHES["fp_add"] == _build.LAUNCHES["fp_sub"] == launches // 2


@pytest.mark.parametrize("spec", [FQ, FR], ids=["L24", "L16"])
def test_out_written_through_its_map(spec, kernel_route):
    """A given ``out`` is written in place through its map: contiguous, a
    tower's movedim view as ff/towers.py:_lin passes it (Fq2 and Fq6), a
    first-axis slice, every second column; the words are the plain version's, the rest of the
    buffer untouched, the entry given ``_operand``'s map of out."""
    L = spec.num_limbs
    entries = kernel_route[spec]
    for name, a in tower_views(L, distinct):
        a = a % (1 << 15)
        b = field_tensor(spec, a.shape[1:], 3)
        k = a.dim() - 3  # coefficient axes
        buf = torch.full(a.shape[1:k + 1] + (L,) + a.shape[k + 1:], -1, dtype=torch.int32)
        for kern, plain in ((km.fp_add, km.add_plain), (km.fp_sub, km.sub_plain)):
            got = kern(spec, a, b, out=buf.movedim(k, 0))
            assert got.data_ptr() == buf.data_ptr() and torch.equal(got, plain(spec, a, b)), name
            assert entries.calls[-1]["out"] == km._operand(buf.movedim(k, 0))[1:], name
        got = km.fp_neg(spec, a, out=buf.movedim(k, 0))
        assert torch.equal(buf.movedim(k, 0), km.sub_plain(spec, torch.zeros_like(a), a)), name
    x, y = field_tensor(spec, (4, 6), 1), field_tensor(spec, (4, 6), 2)
    wide = torch.full((L, 6, 6), -1, dtype=torch.int32)
    fp.add(spec, x, y, out=wide[:, 1:5])
    assert torch.equal(wide[:, 1:5], km.add_plain(spec, x, y))
    assert (wide[:, 0] == -1).all() and (wide[:, 5] == -1).all()
    flat = torch.empty((L, 24), dtype=torch.int32)
    fp.sub(spec, x, y, out=flat.view(L, 4, 6))
    assert torch.equal(flat.view(L, 4, 6), km.sub_plain(spec, x, y))
    assert entries.calls[-1]["out"] == (24, 24, 0)
    step = torch.full((L, 4, 12), -1, dtype=torch.int32)  # every second column
    fp.add(spec, x, y, out=step[..., ::2])
    assert torch.equal(step[..., ::2], km.add_plain(spec, x, y)) and (step[..., 1::2] == -1).all()
    assert entries.calls[-1]["out"] == (48, 1, 2)


@pytest.mark.parametrize("layout", ["batch transpose", "two-stride layout", "stride-0 axis",
                                    "stride-0 limbs"])
def test_out_that_cannot_be_written_in_place_raises(layout, kernel_route):
    """An ``out`` that the map cannot address, or whose elements share an
    address, raises before any launch; nothing is copied or written."""
    L = FQ.num_limbs
    x, y = field_tensor(FQ, (4, 6), 1), field_tensor(FQ, (4, 6), 2)

    def full(*shape):
        return torch.full(shape, -1, dtype=torch.int32)

    out = {"batch transpose": lambda: full(L, 6, 4).transpose(1, 2),
           "two-stride layout": lambda: torch.as_strided(full(L * 200), (L, 4, 6), (200, 50, 2)),
           "stride-0 axis": lambda: full(L, 1, 6).expand(L, 4, 6),
           "stride-0 limbs": lambda: torch.as_strided(full(24), (L, 4, 6), (0, 6, 1))}[layout]()
    before = out.clone()
    for kern in (km.fp_add, km.fp_sub):
        with pytest.raises(ValueError, match="cannot be written in place"):
            kern(FQ, x, y, out=out)
    with pytest.raises(ValueError, match="cannot be written in place"):
        km.fp_neg(FQ, x, out=out)
    assert torch.equal(out, before)
    assert _build.LAUNCHES["fp_add"] == _build.LAUNCHES["fp_sub"] == 0
    assert kernel_route[FQ].calls == []


def test_double_builds_one_map_and_neg_no_constant(kernel_route, monkeypatch):
    """fp.double's add(a, a) builds one operand map for both operands;
    fp_neg's zero is one cached stride-0 view per (field, device, batch
    shape): a call builds no constant and runs no ``align``."""
    x = field_tensor(FQ, (5, 3), 4)[:, 1:4]  # a slice: not the contiguous fast case
    maps = []
    real_map = km.operand_map
    monkeypatch.setattr(km, "operand_map", lambda t, n: maps.append(t) or real_map(t, n))
    assert torch.equal(fp.double(FQ, x), km.add_plain(FQ, x, x))
    assert len(maps) == 1
    want = km.sub_plain(FQ, torch.zeros_like(x), x)
    monkeypatch.setattr(km, "const", lambda *a, **kw: pytest.fail("fp_neg built a constant"))
    aligned = []
    real_align = km.align
    monkeypatch.setattr(km, "align", lambda *a: aligned.append(kernel_route[FQ].busy)
                        or real_align(*a))
    z1 = km.zero_view(FQ, x)
    for _ in range(3):
        assert torch.equal(km.fp_neg(FQ, x), want)
    assert aligned and all(aligned)  # every align call was the stand-in's
    assert km.zero_view(FQ, x) is z1 and z1.stride()[1:] == (0, 0) and not z1.any()
    assert km.zero_view(FR, field_tensor(FR, (3, 3), 1)) is not z1
    assert km.zero_view(FQ, x[:, :, :2]) is not z1


@pytest.mark.parametrize("k", [0, 3], ids=["bn254.Fr", "bls12_381.Fq"])
def test_launcher_matches_jax_on_edge_words(k, kernel_route):
    """Through the launcher, on testing.fadd_edge_words, all pairs (words >=
    p included), contiguous and through a tower's movedim view and ``out``:
    the JAX package's zkarray.ff.fp.add/sub/neg words, bit for bit."""
    import jax.numpy as jnp

    from test_torch_kernels_mont import _five_fields
    from zkarray.ff import fp as jfp
    from zkarray_torch.core.limbs import ints_to_limbs_np
    from zkarray_torch.interop import limbs_to_numpy
    from zkarray_torch.testing import fadd_edge_words

    jspec, tspec = _five_fields()[k]
    Lk = tspec.num_limbs
    words = fadd_edge_words(tspec, np.random.default_rng(20 + k))  # the shapes its JAX test runs
    m = len(words)
    arr = ints_to_limbs_np(words, Lk)
    ii = np.arange(m * m)
    a_np, b_np = arr[:, ii // m], arr[:, ii % m]
    ta, tb = torch.from_numpy(a_np.astype(np.int32)), torch.from_numpy(b_np.astype(np.int32))
    # the same words as the first coefficient of an Fq2-layout (2, L, m*m) pair
    pa = torch.stack([ta, tb]).movedim(1, 0)
    pb = torch.stack([tb, ta]).movedim(1, 0)
    for jf, wrap, args_j, args_t, args_v in (
            (jfp.add, km.fp_add, (a_np, b_np), (ta, tb), (pa, pb)),
            (jfp.sub, km.fp_sub, (a_np, b_np), (ta, tb), (pa, pb)),
            (jfp.neg, km.fp_neg, (a_np,), (ta,), (pa,))):
        want = np.asarray(jf(jspec, *(jnp.asarray(v) for v in args_j)))
        assert np.array_equal(limbs_to_numpy(wrap(tspec, *args_t)), want)
        out = torch.empty((2, Lk, m * m), dtype=torch.int32)
        wrap(tspec, *args_v, out=out.movedim(1, 0))
        assert np.array_equal(limbs_to_numpy(out[0]), want)
    assert kernel_route[tspec].calls[-1]["out"] == (m * m, m * m, Lk * m * m)


def batch_layouts():
    """(shape, strides) of the batch axes of views that the operand maps
    meet: contiguous, slices, steps, broadcasts, transposes, movedim'd
    tower axes, size-1 axes."""
    t = torch.empty((24, 6, 4, 10))
    views = [t, t[:, 1:4], t[:, :, 1:3], t[..., :5], t[..., 5:], t[..., ::2], t[:, ::2],
             t[:, 0], t[:, :, 0], t[..., 0], t.transpose(1, 2), t.transpose(2, 3),
             t[:, :1], t[:, :1, :1], t[:, :, :, :1].expand(24, 6, 4, 3),
             t[:, :1].expand(24, 5, 4, 10), t[:, 0, :, :1].expand(24, 4, 7),
             t.movedim(1, 3), t.reshape(24, 240)[:, 40:160], t.reshape(24, 24, 10)[:, 3:20, :5],
             torch.empty((2, 3, 24, 5)).movedim(2, 0), torch.empty((2, 24, 8)).movedim(1, 0),
             torch.empty((2, 24, 8)).movedim(1, 0)[:, 1], torch.empty((24, 1)),
             torch.empty((24, 3, 1, 5)), torch.empty((24, 5))[:, None, :].expand(24, 3, 5)]
    return [(tuple(v.shape[1:]), tuple(v.stride()[1:])) for v in views]


def test_memoised_batch_map_equals_direct():
    """km.batch_map_memo (what ``_operand`` and ``out_map`` call) gives
    ``batch_map``'s map on every layout, on the first call and from its
    cache, keyed by a torch.Size as by a tuple."""
    cases = batch_layouts()
    assert len(set(cases)) >= 20
    for shape, strides in cases:
        want = km.batch_map(shape, strides)
        assert km.batch_map_memo(shape, strides) == want
        hits = km.batch_map_memo.cache_info().hits
        assert km.batch_map_memo(torch.Size(shape), strides) == want
        assert km.batch_map_memo.cache_info().hits == hits + 1
    assert {km.batch_map(s, st) is None for s, st in cases} == {True, False}


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors fp_add, fp_sub, fp_neg and fp.double (into a new
    tensor or an ``out``) return the plain version's words without reaching
    a launcher or counting a launch."""

    def refuse(*a, **kw):
        raise AssertionError("a CPU call reached the kernel route")

    monkeypatch.setattr(km, "_launch_addsub", refuse)
    monkeypatch.setattr(km, "addsub_launcher", refuse)
    monkeypatch.setattr(km, "zero_view", refuse)
    before = dict(_build.LAUNCHES)
    a, b = field_tensor(FQ, (3, 5), 1), field_tensor(FQ, (3, 5), 2)
    c = field_tensor(FQ, (1,), 3)
    assert torch.equal(km.fp_add(FQ, a, b), km.add_plain(FQ, a, b))
    assert torch.equal(fp.add(FQ, a, c), km.add_plain(FQ, a, c))
    assert torch.equal(km.fp_sub(FQ, a[:, 1:], b[:, 1:]), km.sub_plain(FQ, a[:, 1:], b[:, 1:]))
    assert torch.equal(fp.neg(FQ, a), km.sub_plain(FQ, torch.zeros_like(a), a))
    assert torch.equal(fp.double(FQ, a), km.add_plain(FQ, a, a))
    out = torch.empty_like(a)
    assert fp.sub(FQ, a, b, out=out) is out and torch.equal(out, km.sub_plain(FQ, a, b))
    assert _build.LAUNCHES == before


def test_mixed_devices_raise():
    """A mix of devices raises before any launch, in any position (out
    too); so does a launcher asked for a non-CUDA device."""
    a = field_tensor(FQ, (4,), 1)
    m = torch.empty(a.shape, dtype=torch.int32, device="meta")
    for kern in (km.fp_add, km.fp_sub):
        for x, y, o in ((a, m, None), (m, a, None), (a, a, m), (m, m, a)):
            with pytest.raises(ValueError, match="devices"):
                kern(FQ, x, y, out=o)
    for x, o in ((m, None), (a, m), (m, a)):
        with pytest.raises(ValueError, match="devices"):
            km.fp_neg(FQ, x, out=o)
    with pytest.raises(ValueError, match="CUDA"):
        km.addsub_launcher(FQ, -1)
