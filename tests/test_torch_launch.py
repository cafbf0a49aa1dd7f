"""The launch of the field product and square (zkarray_torch/kernels/mont.py:
ProductLauncher, csrc/mont.cu:zk_mont_mul_v/zk_mont_sqr_v) on the CPU: the
contiguous fast case's operand map against ``_operand``'s, the maps'
addressing, the C entries' argument lists against ``_build.EXPORTS``, the
launcher driven end to end through a stand-in for the C entries that reads
and writes memory through the maps it is given, and the device decision.
No JAX function runs here."""

import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zkarray_torch.curves import bls12_381, bn254  # noqa: E402
from zkarray_torch.ff import fp  # noqa: E402
from zkarray_torch.kernels import _build  # noqa: E402
from zkarray_torch.kernels import mont as km  # noqa: E402

torch.set_num_threads(1)

FQ, FR = bls12_381.FQ, bn254.FR


def field_tensor(spec, shape, seed):
    """Random canonical limbs (L, *shape), the top limb zero (below p)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, (spec.num_limbs,) + tuple(shape), dtype=np.int32)
    x[-1] = 0
    return torch.from_numpy(x)


def distinct(L, shape):
    """(L, *shape) int32 of distinct values: every element tells where it came from."""
    return torch.arange(L * int(np.prod(shape)), dtype=torch.int32).reshape((L,) + tuple(shape))


def operand_kinds(L, make):
    """(name, tensor, contiguous) for the operand layouts the paths give a
    product: contiguous ones, and those that must go through ``_operand``."""
    big = make(L, (5, 12))
    const = make(L, (1,))
    return [
        ("contiguous", make(L, (4, 6)), True),
        ("contiguous 1-d", make(L, (24,)), True),
        ("contiguous one element", make(L, (1,)), True),
        ("first-axis slice of a contiguous tensor", big[:, 1:3], False),
        ("stride-0 constant", const[:, None].expand(L, 4, 6), False),
        ("stride-0 row over a leading axis", make(L, (6,))[:, None].expand(L, 4, 6), False),
        ("last-axis lower half", big[..., :6], False),
        ("last-axis upper half", big[..., 6:12], False),
        ("batch transpose", make(L, (6, 4)).transpose(1, 2), False),
        ("limb axis last", make(L, (24,)).t().contiguous().t(), False),
    ]


def offsets(L, n, ld, inner, outer):
    """csrc/field.cuh:Operand's offset of limb k, batch element i: (L, n)."""
    k = np.arange(L)[:, None]
    i = np.arange(n)[None, :]
    return k * ld + (i // inner) * outer + i % inner


def storage_view(t, span):
    """The ``span`` int32 words from ``t``'s data pointer on."""
    return torch.as_strided(t, (span,), (1,), t.storage_offset())


@pytest.mark.parametrize("spec", [FQ, FR], ids=["L24", "L16"])
def test_fast_case_only_for_contiguous_operands(spec, monkeypatch):
    """operand_map takes ld = inner = n, outer = 0 for a contiguous operand,
    the map ``_operand`` gives it, without calling ``_operand``; every other
    layout goes through ``_operand`` (the batch transpose is copied); each
    map addresses every element of its operand exactly once."""
    L = spec.num_limbs
    calls = []
    real = km._operand

    def counted(t):
        calls.append(t)
        return real(t)

    monkeypatch.setattr(km, "_operand", counted)
    for name, t, contiguous in operand_kinds(L, distinct):
        n = t[0].numel()
        calls.clear()
        held, ld, inner, outer = km.operand_map(t, n)
        assert (len(calls) == 0) == contiguous, name
        if contiguous:
            assert held is t and (ld, inner, outer) == (n, n, 0), name
            assert (ld, inner, outer) == real(t)[1:], name
        if name == "batch transpose":
            assert held is not t and held.is_contiguous(), name
        offs = offsets(L, n, ld, inner, outer)
        words = storage_view(held, int(offs.max()) + 1)
        got = words[torch.from_numpy(offs)]
        assert torch.equal(got, t.reshape(L, n)), name
        if "stride-0" not in name:  # one address an element, none shared
            assert len(np.unique(offs)) == offs.size, name


def test_c_entries_match_exports():
    """Every extern "C" entry of csrc/mont.cu, csrc/fadd.cu and csrc/flin.cu
    has the argument list its _build.EXPORTS row gives ctypes, and the
    descriptor-array entries of the product, the square, the two additions
    and the linear map are gone."""
    decls = {}
    for lib, entries, gone in (("mont", {"zk_mont_mul_v", "zk_mont_sqr_v"},
                                {"zk_mont_mul", "zk_mont_sqr"}),
                               ("fadd", {"zk_fp_add_v", "zk_fp_sub_v"},
                                {"zk_fp_add", "zk_fp_sub"}),
                               ("flin", {"zk_fp_lin_v"}, {"zk_fp_lin"})):
        src = (_build.CSRC / f"{lib}.cu").read_text()
        found = dict(re.findall(r'extern "C" int (zk_\w+)\(([^)]*)\)', src))
        assert set(found) == set(_build.EXPORTS[lib]) and set(found) >= entries
        assert not gone & set(found)
        decls.update({name: (lib, params) for name, params in found.items()})

    def ctype(param):
        param = " ".join(param.split())
        if "*" in param:
            return ctypes.c_void_p
        if param.startswith("long long"):
            return ctypes.c_longlong
        if param.startswith("int "):
            return ctypes.c_int
        raise AssertionError(f"unexpected parameter {param!r}")

    for name, (lib, params) in decls.items():
        assert [ctype(p) for p in params.split(",")] == _build.EXPORTS[lib][name], name
    for lib in ("mont_w24", "mont_w26"):
        assert _build.EXPORTS[lib] is _build.EXPORTS["mont"]


def read_words(ptr, L, n, ld, inner, outer):
    """(L, n) words read from host memory through an operand map."""
    offs = offsets(L, n, ld, inner, outer)
    buf = np.ctypeslib.as_array((ctypes.c_int32 * (int(offs.max()) + 1)).from_address(ptr))
    return torch.from_numpy(buf[offs].copy())


class EntryStandIn:
    """zk_mont_mul_v / zk_mont_sqr_v on host memory: reads each operand
    through the map it is passed, checks the constant words at their
    address, writes the plain product into the contiguous output."""

    def __init__(self, spec):
        self.spec, self.calls = spec, []

    def _finish(self, ins, out, n, nw, consts, stream):
        spec, L = self.spec, self.spec.num_limbs
        assert nw == L // 2 and stream == 1234
        words = km.field_words(spec)
        got = np.ctypeslib.as_array((ctypes.c_uint32 * words.size).from_address(consts))
        assert np.array_equal(got, words)
        res = km.mont_mul_plain(spec, ins[0], ins[-1]).reshape(-1).numpy()
        np.ctypeslib.as_array((ctypes.c_int32 * (L * n)).from_address(out))[:] = res
        return 0

    def mul(self, a, a_ld, a_in, a_out, b, b_ld, b_in, b_out, out, n, nw, consts, stream):
        L = self.spec.num_limbs
        self.calls.append(((a_ld, a_in, a_out), (b_ld, b_in, b_out)))
        ins = (read_words(a, L, n, a_ld, a_in, a_out), read_words(b, L, n, b_ld, b_in, b_out))
        return self._finish(ins, out, n, nw, consts, stream)

    def sqr(self, a, a_ld, a_in, a_out, out, n, nw, consts, stream):
        self.calls.append(((a_ld, a_in, a_out),))
        ins = (read_words(a, self.spec.num_limbs, n, a_ld, a_in, a_out),)
        return self._finish(ins, out, n, nw, consts, stream)


def host_launcher(spec, entries):
    """A ProductLauncher for CPU tensors (device index -1) whose C entries
    are ``entries``: the Python side exactly as it runs on the card."""
    go = object.__new__(km.ProductLauncher)
    go.spec, go.index, go.L, go.nw, go.lib = spec, -1, spec.num_limbs, spec.num_limbs // 2, None
    go.words = km.field_words(spec)
    go.consts = go.words.ctypes.data
    go.mul_fn, go.sqr_fn = entries.mul, entries.sqr
    go.current_device, go.raw_stream = (lambda: -1), (lambda index: 1234)
    return go


@pytest.mark.parametrize("spec", [FQ, FR], ids=["L24", "L16"])
def test_launcher_through_wrapper_matches_plain(spec, monkeypatch):
    """mont_mul/mont_sqr through _launch and the cached launcher, with the
    C entries replaced by ``EntryStandIn``: every operand layout gives the
    plain version's words, one count a launch, ``_operand``'s map (the fast
    case's for contiguous operands)."""
    L = spec.num_limbs
    entries = EntryStandIn(spec)
    monkeypatch.setitem(km._PRODUCT_LAUNCHERS, (id(spec), -1), host_launcher(spec, entries))
    monkeypatch.setattr(km, "on_cpu", lambda *ts: False)  # the kernel route on CPU tensors
    monkeypatch.setitem(_build.LAUNCHES, "mont_mul", 0)
    monkeypatch.setitem(_build.LAUNCHES, "mont_sqr", 0)
    kinds = operand_kinds(L, lambda L_, shape: field_tensor(spec, shape, L_ + len(shape)))
    y = field_tensor(spec, (4, 6), 7)
    for i, (name, x, contiguous) in enumerate(kinds):
        other = y if x.shape == y.shape else field_tensor(spec, x.shape[1:], 8)
        got = km.mont_mul(spec, x, other)
        assert got.is_contiguous() and torch.equal(got, km.mont_mul_plain(spec, x, other)), name
        assert torch.equal(km.mont_mul(spec, other, x), km.mont_mul_plain(spec, other, x)), name
        assert entries.calls[-1][1] == km._operand(x)[1:], name
        assert torch.equal(km.mont_sqr(spec, x), km.mont_sqr_plain(spec, x)), name
        n = x[0].numel()
        assert entries.calls[-1][0] == km._operand(x)[1:], name
        assert entries.calls[-1][0] == (n, n, 0) or not contiguous, name
        assert _build.LAUNCHES["mont_mul"] == 2 * _build.LAUNCHES["mont_sqr"] == 2 * (i + 1)
    # a broadcast operand of another shape is aligned first, then read at stride 0
    c = field_tensor(spec, (1,), 9)
    assert torch.equal(fp.mont_mul(spec, y, c), km.mont_mul_plain(spec, y, c))
    assert entries.calls[-1][1][1:] == (1, 0)
    with pytest.raises(TypeError):
        km.mont_mul(spec, y, y.to(torch.int64))
    with pytest.raises(ValueError):
        km.mont_sqr(spec, y[:-1])


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors mont_mul and mont_sqr (and ff/fp.py's) return the plain
    version's words without reaching a launcher or counting a launch."""

    def refuse(*a, **kw):
        raise AssertionError("a CPU call reached the kernel route")

    monkeypatch.setattr(km, "_launch", refuse)
    monkeypatch.setattr(km, "product_launcher", refuse)
    before = dict(_build.LAUNCHES)
    a, b = field_tensor(FQ, (3, 5), 1), field_tensor(FQ, (3, 5), 2)
    c = field_tensor(FQ, (1,), 3)
    assert torch.equal(km.mont_mul(FQ, a, b), km.mont_mul_plain(FQ, a, b))
    assert torch.equal(fp.mont_mul(FQ, a, c), km.mont_mul_plain(FQ, a, c))
    assert torch.equal(km.mont_sqr(FQ, a), km.mont_sqr_plain(FQ, a))
    assert torch.equal(fp.mont_sqr(FQ, a[:, 1:]), km.mont_sqr_plain(FQ, a[:, 1:]))
    assert _build.LAUNCHES == before


def test_mixed_devices_raise():
    """A mix of devices raises before any launch, in either order; so does
    a device that is neither the CPU nor CUDA, and a launcher asked for a
    non-CUDA device."""
    a = field_tensor(FQ, (4,), 1)
    m = torch.empty(a.shape, dtype=torch.int32, device="meta")
    for x, y in ((a, m), (m, a)):
        with pytest.raises(ValueError, match="devices"):
            km.mont_mul(FQ, x, y)
    with pytest.raises(ValueError, match="devices"):
        km.mont_sqr(FQ, m)
    with pytest.raises(ValueError, match="CUDA"):
        km.product_launcher(FQ, -1)
