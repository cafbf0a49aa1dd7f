"""The launch of the tower products' linear map (zkarray_torch/kernels/lin.py:
LinLauncher, csrc/flin.cu:zk_fp_lin_v) on the CPU: the launcher driven end
to end through a stand-in for the C entry that decodes the LinCall block and
the map's device table, reads each source and writes the output through the
descriptors it is given, on every layout a tower route gives fp_lin (the
pre-map's movedim'd slab as ``out``, the post-map's movedim'd product, a
()-batch constant, a strided batch, sparse12's broadcast line coefficients)
against fp_lin_plain, and through ff/linmap.py's routes against the JAX
package's BLS12-381 Fq2/Fq6/Fq12 mul and sqr, Granger-Scott square and line
products (at the shapes tests/test_torch_towers.py runs them); an ``out``
whose elements share addresses, or that no map addresses, refused; the C
entry's block layout; the route lookup without ExtOps.__hash__; the device
decision. Every comparison is exact: words equal, bit for bit."""

import ctypes
import random
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_launch import EntryStandIn, field_tensor, offsets  # noqa: E402
from test_torch_launch import host_launcher as product_host_launcher  # noqa: E402
from torch_parity import rand_host, tower_both  # noqa: E402
from zkarray.curves import bls12_381 as jb  # noqa: E402
from zkarray.ff import cyclotomic as jcyc  # noqa: E402
from zkarray.ff import sparse12 as jsp  # noqa: E402
from zkarray_torch.core.fieldspec import FieldSpec  # noqa: E402
from zkarray_torch.curves import bls12_381 as tb  # noqa: E402
from zkarray_torch.curves import bn254  # noqa: E402
from zkarray_torch.ff import cyclotomic as tcyc  # noqa: E402
from zkarray_torch.ff import linmap, towers  # noqa: E402
from zkarray_torch.ff import sparse12 as tsp  # noqa: E402
from zkarray_torch.interop import limbs_to_numpy  # noqa: E402
from zkarray_torch.kernels import _build, lin  # noqa: E402
from zkarray_torch.kernels import mont as km  # noqa: E402
from zkarray_torch.testing import lin_edge_rows  # noqa: E402

torch.set_num_threads(1)

FQ, FR = tb.FQ, bn254.FR
F2, F12 = tb.FQ2, tb.FQ12
STREAM = 1234
PLAIN_ON_CPU = km.on_cpu  # the device decision, before a fixture replaces it


def longs(addr, count):
    return list((ctypes.c_longlong * count).from_address(addr))


def int32s(addr, count):
    return np.ctypeslib.as_array((ctypes.c_int32 * count).from_address(addr)).copy()


class StubLib:
    """The library handle's error strings, as _build.check reads them."""

    @staticmethod
    def zk_error_string(err):
        return b"the stand-in refused the call"


class LinStandIn:
    """zk_fp_lin_v on host memory behind a ctypes prototype, so that the
    launcher's bytes block reaches it as an address, as it reaches the C
    entry: decodes csrc/flin.cu:LinCall and the map's table (checked
    against the map it came from), checks the constant words and the
    stream, reads every slot the table names through its source's
    descriptor and writes fp_lin_plain's result through the output's. A
    failed check returns an error code and is kept in ``errors``."""

    def __init__(self, spec):
        self.spec, self.calls, self.errors, self.busy = spec, [], [], False
        proto = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
        self.entry = proto(self._entry)

    def _entry(self, call, stream):
        try:
            self.busy = True
            self._run(call, stream)
            return 0
        except Exception as exc:  # a ctypes callback cannot raise: hand it to the test
            self.errors.append(exc)
            return 1
        finally:
            self.busy = False

    def _run(self, call, stream):
        spec, L = self.spec, self.spec.num_limbs
        table, consts, m, n, nw, nsrc, lanes = longs(call, 7)
        if n <= 0 or m <= 0:  # as the C entry: nothing to launch
            return
        ops = longs(call + 7 * 8, 5 * (nsrc + 1))
        ops = [tuple(ops[5 * j:5 * j + 5]) for j in range(nsrc + 1)]
        assert nw == L // 2 and stream == STREAM and 0 < nsrc <= lin.MAX_SRC and m > 0
        assert lanes in lin.LANES
        words = km.field_words(spec)
        assert np.array_equal(np.ctypeslib.as_array(
            (ctypes.c_uint32 * words.size).from_address(consts)), words)
        head = int32s(table, 4 * m).reshape(m, 4)
        rows, sizes = [], [0] * nsrc
        for off, nterms, cneg, kbits in head:
            terms = int32s(table + 4 * int(off), 2 * int(nterms)).reshape(-1, 2)
            row = [(int(w) >> 16, int(w) & 0xFFFF, int(c)) for w, c in terms]
            rows.append(row)
            for s, k, _ in row:
                sizes[s] = max(sizes[s], k + 1)
            assert cneg == sum(-c for _, _, c in row if c < 0)
            assert kbits == sum(abs(c) for _, _, c in row).bit_length()
        lmap = lin.LinMap(rows, [max(k, 1) for k in sizes], "decoded")
        srcs = []
        for (base, slot, ld, inner, outer), k in zip(ops, lmap.sizes):
            offs = np.arange(k)[:, None, None] * slot + offsets(L, n, ld, inner, outer)
            buf = np.ctypeslib.as_array((ctypes.c_int32 * (int(offs.max()) + 1)).from_address(base))
            srcs.append(torch.from_numpy(buf[offs].copy()))
        res = lin.fp_lin_plain(spec, lmap, srcs).numpy()
        base, slot, ld, inner, outer = ops[-1]
        offs = np.arange(m)[:, None, None] * slot + offsets(L, n, ld, inner, outer)
        buf = np.ctypeslib.as_array((ctypes.c_int32 * (int(offs.max()) + 1)).from_address(base))
        buf[offs] = res
        self.calls.append(dict(m=m, n=n, rows=rows, srcs=[o[1:] for o in ops[:-1]],
                               out=ops[-1][1:], ptrs=[o[0] for o in ops], table=table,
                               lanes=lanes))


def host_launcher(spec, entries):
    """A LinLauncher for CPU tensors (device index -1) whose C entry is the
    stand-in: the Python side exactly as it runs on the card."""
    go = object.__new__(lin.LinLauncher)
    go.spec, go.index, go.L, go.nw, go.lib = spec, -1, spec.num_limbs, spec.num_limbs // 2, StubLib
    go.words = km.field_words(spec)
    go.consts = go.words.ctypes.data
    go.fn = entries.entry
    go.current_device, go.raw_stream = (lambda: -1), (lambda index: STREAM)
    return go


@pytest.fixture
def kernel_route(monkeypatch):
    """Puts stand-in launchers behind the CPU tensors' kernel route: fp_lin
    for FQ and FR, mont_mul for FQ (the routes' one product). Returns
    {spec: fp_lin stand-in}; fails if a stand-in refused a call."""
    got = {}
    for spec in (FQ, FR):
        got[spec] = LinStandIn(spec)
        monkeypatch.setitem(lin._LIN_LAUNCHERS, (id(spec), -1), host_launcher(spec, got[spec]))
    monkeypatch.setitem(km._PRODUCT_LAUNCHERS, (id(FQ), -1),
                        product_host_launcher(FQ, EntryStandIn(FQ)))
    monkeypatch.setattr(km, "on_cpu", lambda *ts: False)
    for k in ("fp_lin", "mont_mul", "fp_add", "fp_sub"):
        monkeypatch.setitem(_build.LAUNCHES, k, 0)
    yield got
    assert not [e for s in got.values() for e in s.errors]


def plain(fn, monkeypatch):
    """fn() with the CPU tensors' own device decision: the plain versions."""
    with monkeypatch.context() as mp:
        mp.setattr(km, "on_cpu", PLAIN_ON_CPU)
        return fn()


def edge_map(spec, sizes=(3, 2, 1)):
    return lin.LinMap(lin_edge_rows(sizes, np.random.default_rng(spec.num_limbs)), sizes, "edge")


def edge_sources(spec):
    """A contiguous source, a strided batch and a ()-batch constant over
    the batch (4, 6)."""
    L = spec.num_limbs
    a = field_tensor(spec, (3 * 4 * 6,), 1).reshape(L, 3, 4, 6).movedim(1, 0).contiguous()
    b = field_tensor(spec, (2 * 4 * 12,), 2).reshape(L, 2, 4, 12).movedim(1, 0)[..., ::2]
    c = field_tensor(spec, (1,), 3).reshape(1, L)
    return a, b, c


@pytest.mark.parametrize("spec", [FQ, FR], ids=["L24", "L16"])
def test_launcher_sources_and_new_out_match_plain(spec, kernel_route, monkeypatch):
    """A contiguous source (the fast case: no batch_map), a strided batch and
    a ()-batch constant read in place into a new contiguous output: the
    plain version's words, the maps ``_operand`` gives, one count."""
    L = spec.num_limbs
    entries = kernel_route[spec]
    lmap = edge_map(spec)
    a, b, c = edge_sources(spec)
    maps = []
    real = km.batch_map_memo
    with monkeypatch.context() as mp:
        mp.setattr(km, "batch_map_memo",
                   lambda shape, strides: maps.append(tuple(shape)) or real(shape, strides))
        got = lin.fp_lin(spec, lmap, [a, b, c])
    assert got.is_contiguous() and got.shape == (lmap.m, L, 4, 6)
    assert torch.equal(got, lin.fp_lin_plain(spec, lmap, [a, b, c]))
    call = entries.calls[-1]
    assert (call["m"], call["n"]) == (lmap.m, 24) and len(maps) == 2  # b and c only
    assert call["srcs"][0] == (L * 24, 24, 24, 0)
    assert call["srcs"][1] == (b.stride(0), b.stride(1)) + km.batch_map(b.shape[2:], b.stride()[2:])
    assert call["srcs"][2][1:] == (1, 1, 0)  # one element, read at stride 0
    assert call["out"] == (L * 24, 24, 24, 0) and call["ptrs"][-1] == got.data_ptr()
    assert call["rows"] == [[(lmap.used.index(s), k, cf) for s, k, cf in r] for r in lmap.rows]
    assert call["table"] == lmap.table_ptr(-1) and _build.LAUNCHES["fp_lin"] == 1
    # a batch transpose is not addressable: copied, the copy held until the launch
    t = field_tensor(spec, (2 * 6 * 4,), 4).reshape(L, 2, 6, 4).movedim(1, 0).transpose(2, 3)
    got = lin.fp_lin(spec, lmap, [a, t, c])
    assert torch.equal(got, lin.fp_lin_plain(spec, lmap, [a, t, c]))
    assert entries.calls[-1]["srcs"][1] == (L * 24, 24, 24, 0)
    assert entries.calls[-1]["ptrs"][1] != t.data_ptr()


@pytest.mark.parametrize("spec", [FQ, FR], ids=["L24", "L16"])
def test_out_written_in_place(spec, kernel_route):
    """The pre-map's ``slab.movedim(1, 0)`` and a strided slab view as
    ``out``: written in place through their maps, nothing else written."""
    L = spec.num_limbs
    entries = kernel_route[spec]
    lmap = edge_map(spec)
    srcs = list(edge_sources(spec))
    want = lin.fp_lin_plain(spec, lmap, srcs)
    slab = torch.full((L, lmap.m, 4, 6), -1, dtype=torch.int32)
    got = lin.fp_lin(spec, lmap, srcs, out=slab.movedim(1, 0))
    assert got.data_ptr() == slab.data_ptr() and torch.equal(slab.movedim(1, 0), want)
    assert entries.calls[-1]["out"] == (24, lmap.m * 24, 24, 0)
    wide = torch.full((L, 2 * lmap.m, 4, 6), -1, dtype=torch.int32)
    lin.fp_lin(spec, lmap, srcs, out=wide[:, ::2].movedim(1, 0))
    assert torch.equal(wide[:, ::2].movedim(1, 0), want) and (wide[:, 1::2] == -1).all()
    assert entries.calls[-1]["out"] == (48, 2 * lmap.m * 24, 24, 0)


def test_route_layouts_match_plain(kernel_route, monkeypatch):
    """The layouts of the tower routes, each through its route on the
    launchers against the same route on the plain versions: an Fp12
    product and square (the pre-map into the slab's movedim view, the
    post-map from the product's), their inputs a contiguous element, a
    strided batch and F12.one's broadcast constant, and the line products
    with coefficients sliced from a stack and broadcast ((1,)-batch and
    ()-batch against an (n,)-batch f)."""
    entries = kernel_route[FQ]
    rng = random.Random(11)
    L, n = FQ.num_limbs, 4
    f = tower_both(jb.FQ12, [rand_host(F12.host, rng) for _ in range(n)])[1]
    g = torch.stack([f, f.flip(-1)]).movedim(0, -1)[..., 1]  # a strided batch
    coeffs = torch.stack([tower_both(jb.FQ2, [rand_host(F2.host, rng) for _ in range(n)])[1]
                          for _ in range(3)])  # (3, 2, L, n), as G2Prepared holds a step's
    line1 = coeffs[:, :, :, :1]  # (1,)-batch coefficients
    line0 = coeffs[:, :, :, 0]  # ()-batch coefficients
    one = F12.one((n,), "cpu")  # the Miller loop's first f: stride-0 coefficients
    cases = {"mul": lambda: F12.mul(f, g),
             "sqr of one": lambda: F12.sqr(one),
             "mul_by_014": lambda: tsp.fp12_mul_by_014(F12, f, *coeffs),
             "mul_by_014 (1,)-batch lines": lambda: tsp.fp12_mul_by_014(F12, f, *line1),
             "mul_by_014 ()-batch lines": lambda: tsp.fp12_mul_by_014(F12, f, *line0),
             "mul_by_034 ()-batch lines": lambda: tsp.fp12_mul_by_034(F12, f, *line0)}
    for name, fn in cases.items():
        want = plain(fn, monkeypatch)
        before = len(entries.calls)
        got = fn()
        assert torch.equal(got, want), name
        pre, post = entries.calls[before:]
        S = pre["m"] // 2
        assert pre["out"] == (n, 2 * S * n, n, 0), name  # slab.movedim(1, 0), in place
        assert post["srcs"][0] == (n, S * n, n, 0), name  # prod.movedim(1, 0), in place
    assert _build.LAUNCHES["fp_lin"] == 2 * len(cases) and _build.LAUNCHES["mont_mul"] == len(cases)


@pytest.mark.parametrize("k", range(3), ids=["Fq2", "Fq6", "Fq12"])
def test_tower_products_match_jax(k, kernel_route):
    """Fq2/Fq6/Fq12 mul and sqr through the launchers on
    tests/test_torch_towers.py's inputs: the JAX package's words."""
    J, T = [(jb.FQ2, tb.FQ2), (jb.FQ6, tb.FQ6), (jb.FQ12, tb.FQ12)][k]
    rng = random.Random(100 + k)
    xs = [J.host.zero()] + [rand_host(J.host, rng) for _ in range(3)]
    ys = [rand_host(J.host, rng) for _ in range(4)]
    ja, ta = tower_both(J, xs)
    jc, tc = tower_both(J, ys)
    assert np.array_equal(np.asarray(J.mul(ja, jc)), limbs_to_numpy(T.mul(ta, tc)))
    assert np.array_equal(np.asarray(J.sqr(ja)), limbs_to_numpy(T.sqr(ta)))
    assert _build.LAUNCHES["fp_lin"] == 4 and _build.LAUNCHES["mont_mul"] == 2


def test_cyclotomic_and_line_products_match_jax(kernel_route):
    """The Granger-Scott square (tests/test_torch_towers.py's cyclotomic
    element and a random one) and mul_by_014/mul_by_034 (its line inputs)
    through the launchers: the JAX package's words."""
    rng = random.Random(3)
    F12h = F12.host  # the port's host tower: one inverse through the norm, not a Fermat power
    g = rand_host(F12h, rng)
    t = F12h.mul(F12h.frobenius(g, 6), F12h.inv(g))
    jf, tf = tower_both(jb.FQ12, [F12h.mul(F12h.frobenius(t, 2), t), g])
    assert np.array_equal(np.asarray(jcyc.gs_cyclotomic_sqr(jb.FQ12, jf)),
                          limbs_to_numpy(tcyc.gs_cyclotomic_sqr(F12, tf)))
    rng = random.Random(5)
    jf, tf = tower_both(jb.FQ12, [rand_host(F12h, rng) for _ in range(2)])
    cs = [tower_both(jb.FQ2, [rand_host(jb.FQ2.host, rng) for _ in range(2)]) for _ in range(3)]
    jc, tc = [c[0] for c in cs], [c[1] for c in cs]
    assert np.array_equal(np.asarray(jsp.fp12_mul_by_014(jb.FQ12, jf, *jc)),
                          limbs_to_numpy(tsp.fp12_mul_by_014(F12, tf, *tc)))
    assert np.array_equal(np.asarray(jsp.fp12_mul_by_034(jb.FQ12, jf, *jc)),
                          limbs_to_numpy(tsp.fp12_mul_by_034(F12, tf, *tc)))
    assert _build.LAUNCHES["fp_lin"] == 6 and _build.LAUNCHES["mont_mul"] == 3


@pytest.mark.parametrize("layout", ["stride-0 batch axis", "stride-0 rows", "stride-0 limbs",
                                    "batch transpose", "two-stride layout"])
def test_out_that_cannot_be_written_in_place_raises(layout, kernel_route):
    """An ``out`` whose elements share addresses (a stride-0 batch or limb
    axis, a slot stride of 0 over several rows) or that no map addresses
    raises before any launch; nothing is copied or written."""
    L = FQ.num_limbs
    lmap = lin.LinMap([[(0, 0, 1)], [(0, 1, -1)], [(0, 0, 2), (0, 1, 1)]], (2,), "three rows")
    src = field_tensor(FQ, (2 * 8,), 5).reshape(L, 2, 8).movedim(1, 0).contiguous()

    def full(*shape):
        return torch.full(shape, -1, dtype=torch.int32)

    out = {"stride-0 batch axis": lambda: full(L, 1).expand(3, L, 8),
           "stride-0 rows": lambda: full(L, 8).expand(3, L, 8),
           "stride-0 limbs": lambda: torch.as_strided(full(3 * 8), (3, L, 8), (8, 0, 1)),
           "batch transpose": lambda: full(3, L, 4, 2).transpose(2, 3),
           "two-stride layout": lambda: torch.as_strided(full(3 * L * 200), (3, L, 2, 4),
                                                         (L * 200, 200, 50, 2))}[layout]()
    if out.dim() == 4:  # a (2, 4) batch: the source read as one too
        src = src.reshape(2, L, 2, 4)
    before = out.clone()
    with pytest.raises(ValueError, match="cannot be written in place"):
        lin.fp_lin(FQ, lmap, [src], out=out)
    assert torch.equal(out, before) and _build.LAUNCHES["fp_lin"] == 0
    assert kernel_route[FQ].calls == []


def test_c_entry_block_matches_the_packing():
    """csrc/flin.cu's LinCall (seven head words, the lanes last, then
    LIN_MAX_SRC + 1 operands of five words each, the static_assert on its
    size), LIN_MAX_SRC and the lanes the C entry launches against
    kernels/lin.py's packing of k sources and its LANES."""
    src = (_build.CSRC / "flin.cu").read_text()
    assert int(re.search(r"constexpr int LIN_MAX_SRC = (\d+);", src).group(1)) == lin.MAX_SRC
    body = re.search(r"struct LinCall \{(.*?)\};", src, re.S).group(1)
    fields = [ln.split("//")[0].strip() for ln in body.splitlines() if ln.split("//")[0].strip()]
    assert fields == ["const int32_t* table;", "const uint32_t* consts;",
                      "long long m, n, nw, nsrc;", "long long lanes;",
                      "LinOperand op[LIN_MAX_SRC + 1];"]
    op = re.search(r"struct LinOperand \{(.*?)\};", src, re.S).group(1).split()
    assert op == ["int32_t*", "base;", "long", "long", "slot;", "long", "long", "ld;", "long",
                  "long", "inner;", "long", "long", "outer;"]
    assert "sizeof(LinCall) == 8 * (7 + 5 * (LIN_MAX_SRC + 1))" in src
    for k, s in enumerate(lin._CALLS):
        assert s.size == 8 * (7 + 5 * (k + 1)) and s.format.endswith("q")
    entry = src[src.index('extern "C" int zk_fp_lin_v'):]
    cases = re.findall(r"case (\d+): launch_lin<NW, (\d+)>", entry)
    assert [int(a) for a, b in cases] == [int(b) for a, b in cases] == list(lin.LANES)


def test_route_lookup_never_hashes_the_tower(monkeypatch):
    """route() finds a cached route by the tower object's id: no
    ExtOps.__hash__/__eq__ (which recurse to FieldSpec's Python hash); a
    tower product on CPU tensors neither."""
    def refuse(*a):
        raise AssertionError("the tower was hashed or compared")

    r = linmap.route(F12, "mul", towers.ExtOps._mul_sched, (F12, F12))
    monkeypatch.setattr(towers.ExtOps, "__hash__", refuse)
    monkeypatch.setattr(towers.ExtOps, "__eq__", refuse)
    monkeypatch.setattr(FieldSpec, "__hash__", refuse)
    assert linmap.route(F12, "mul", towers.ExtOps._mul_sched, (F12, F12)) is r
    assert linmap._ROUTES[(id(F12), "mul")][0] is F12  # held beside its route


def test_launch_makes_no_lookup_by_field_spec(kernel_route, monkeypatch):
    """A launch through the cached launcher hashes no FieldSpec (the
    launcher is keyed by the spec's id, the map's table by the device
    index); the stand-in's own plain version may."""
    entries = kernel_route[FQ]
    lmap = edge_map(FQ)
    srcs = list(edge_sources(FQ))
    want = lin.fp_lin(FQ, lmap, srcs)  # the table uploaded, the memo warm
    real = FieldSpec.__hash__

    def hashed(self):
        assert entries.busy, "a launch hashed a FieldSpec"
        return real(self)

    monkeypatch.setattr(FieldSpec, "__hash__", hashed)
    monkeypatch.setattr(lin.LinMap, "table_words",
                        lambda self: pytest.fail("the table was rebuilt"))
    assert torch.equal(lin.fp_lin(FQ, lmap, srcs), want)
    assert lmap.table_ptr(-1) == entries.calls[-1]["table"]


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors fp_lin (into a new tensor or an ``out``) and a tower
    product return the plain version's words without reaching a launcher
    or counting a launch."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU call reached the kernel route")

    monkeypatch.setattr(lin, "_launch_lin", refuse)
    monkeypatch.setattr(lin, "lin_launcher", refuse)
    before = dict(_build.LAUNCHES)
    lmap = edge_map(FQ)
    srcs = list(edge_sources(FQ))
    want = lin.fp_lin_plain(FQ, lmap, srcs)
    assert torch.equal(lin.fp_lin(FQ, lmap, srcs), want)
    out = torch.empty_like(want)
    assert lin.fp_lin(FQ, lmap, srcs, out=out) is out and torch.equal(out, want)
    f = tower_both(jb.FQ12, [rand_host(F12.host, random.Random(1)) for _ in range(2)])[1]
    F12.mul(f, f)
    assert _build.LAUNCHES == before


def test_mixed_devices_raise():
    """A mix of devices raises before any launch, a source or ``out`` in
    any position; so does a launcher asked for a non-CUDA device."""
    lmap = edge_map(FQ)
    a, b, c = edge_sources(FQ)
    meta = [t.to("meta") for t in (a, b, c)]
    for srcs, out in (([a, meta[1], c], None), ([meta[0], b, c], None),
                      ([a, b, c], torch.empty((lmap.m, FQ.num_limbs, 4, 6), dtype=torch.int32,
                                              device="meta")),
                      (meta, torch.empty((lmap.m, FQ.num_limbs, 4, 6), dtype=torch.int32))):
        with pytest.raises(ValueError, match="devices"):
            lin.fp_lin(FQ, lmap, srcs, out=out)
    with pytest.raises(ValueError, match="CUDA"):
        lin.lin_launcher(FQ, -1)
