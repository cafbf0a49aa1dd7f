"""The read-only cache of power tables (kernels/mont.py:cached_pow_table).

A transform's tables are built by ``pow_table`` the first time they are
needed and read from the cache after that. These tests hold a cold and a
warm call of every transform route (the flat ladder, a coset, the
degree-aware split, the four-step passes) to the same words, equal to the
JAX package's at shapes its own tests compile (tests/test_domain.py,
test_domain_extras.py); check that a warm call builds no table and that no
cached table changes across the calls; that the public tables
(``power_table``, ``elements()``) are copies a caller may write into; and
that the byte bound evicts the least recently used table. On the CPU the
cache holds the plain version's tables, as it holds the kernel's on the
card."""

import collections
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import both, port_field, same  # noqa: E402
from zkarray.curves import bls12_381 as jcurves  # noqa: E402
from zkarray.curves import bn254 as jbn  # noqa: E402
from zkarray.poly import domain as jdm  # noqa: E402
from zkarray_torch.curves import bls12_381 as tcurves  # noqa: E402
from zkarray_torch.ff import fp as tfp  # noqa: E402
from zkarray_torch.kernels import mont as tkm  # noqa: E402
from zkarray_torch.poly import domain as tdm  # noqa: E402
from zkarray_torch.poly import mixed_radix as tmr  # noqa: E402

JFR, TFR = jcurves.FR, tcurves.FR
JBN, TBN = jbn.FR, port_field(jbn.FR)


@pytest.fixture
def builds(monkeypatch):
    """A fresh, empty cache for the test, and the list of pow_table builds
    (n, packed) it makes."""
    monkeypatch.setattr(tkm, "_tables", collections.OrderedDict())
    made = []
    orig = tkm.pow_table

    def counted(spec, w_int, n, device, scale_int=None, packed=False):
        made.append((n, packed))
        return orig(spec, w_int, n, device, scale_int, packed)

    monkeypatch.setattr(tkm, "pow_table", counted)
    return made


def _snapshot():
    return {k: v.clone() for k, v in tkm.cached_tables().items()}


def _unchanged(snap):
    now = tkm.cached_tables()
    return all(k in now and torch.equal(now[k], v) for k, v in snap.items())


def _ints(spec, n, seed):
    rng = random.Random(seed)
    return [rng.randrange(spec.modulus) for _ in range(n)]


def _case(which):
    """(port run, JAX run or None, reference words or None): each run returns
    a tuple of outputs."""
    if which in ("n256", "n256-coset7"):
        xs = _ints(TFR, 256, 3)
        ja, ta = both(JFR, xs)
        jd, td = jdm.Radix2Domain(JFR, 256), tdm.Radix2Domain(TFR, 256)
        if which == "n256-coset7":
            jd, td = jd.get_coset(7), td.get_coset(7)

        def port():
            ev = td.fft(ta)
            return ev, td.ifft(ev)

        def jax():  # the inverse is exact: the JAX package's ifft(fft(a)) is a's words
            return jd.fft(ja), ja

        return port, jax, [None, xs]
    if which == "degree-aware":  # BN254 Fr, n = 64, offset 5, 9 coefficients (m2 = 16)
        cs = _ints(TBN, 9, 4)
        jc, tc = both(JBN, cs)
        jd, td = jdm.Radix2Domain(JBN, 64, offset_int=5), tdm.Radix2Domain(TBN, 64, offset_int=5)
        return (lambda: (td.fft(tc),)), (lambda: (jd.fft(jc),)), None
    # the four-step passes (k1-twiddles from two packed tables, n^-1 folded
    # into one on the inverse) against the flat ladder
    n1 = n2 = 64
    g = TFR.root_of_unity(n1 * n2)
    a = tfp.from_ints(TFR, _ints(TFR, n1 * n2, 5), device="cpu")
    p = TFR.modulus

    def port():
        ev = tdm.fft_fourstep_big(TFR, a, n1, n2, g)
        return ev, tdm.fft_fourstep_core(TFR, ev, n1, n2, pow(g, -1, p), pow(n1 * n2, -1, p))

    flat = tdm._fft_core(TFR, a, n1 * n2, g, None)
    return port, None, [flat, a]


@pytest.mark.parametrize("which", ["n256", "n256-coset7", "degree-aware", "fourstep"])
def test_cold_and_warm_transforms_match_jax(which, builds):
    port, jax, ref = _case(which)
    cold = port()
    assert builds, "a cold transform builds its tables"
    snap = _snapshot()
    assert snap
    n_cold = len(builds)
    warm = port()
    assert len(builds) == n_cold, "a warm transform builds no table"
    assert all(torch.equal(c, w) for c, w in zip(cold, warm))
    assert _unchanged(snap)
    if jax is not None:
        assert all(same(j, w) for j, w in zip(jax(), warm))
    for want, got in zip(ref or (), warm):
        if want is None:
            continue
        assert (tfp.to_ints(TFR, got) == want) if isinstance(want, list) else torch.equal(got, want)


def test_public_tables_are_copies(builds):
    d = tdm.Radix2Domain(TFR, 256)
    g = d.group_gen_int
    a = tfp.from_ints(TFR, _ints(TFR, 256, 6), device="cpu")
    ev = d.fft(a)
    snap = _snapshot()
    want_el = [pow(g, j, TFR.modulus) for j in range(256)]
    for t in (tdm.power_table(TFR, g, 128, "cpu"), d.elements("cpu"),
              tmr.MixedRadixDomain(TFR, 256).elements("cpu")):
        assert all(t.data_ptr() != c.data_ptr() for c in tkm.cached_tables().values())
        t.fill_(0)  # the fft's own table, the domain's elements: the caller's to write
    assert torch.equal(d.fft(a), ev)
    assert _unchanged(snap)
    assert tfp.to_ints(TFR, d.elements("cpu")) == want_el
    assert tfp.to_ints(TFR, d.get_coset(7).elements("cpu")) == [7 * x % TFR.modulus for x in want_el]


def test_byte_bound_evicts_least_recently_used(builds, monkeypatch):
    entry = 16 * 4 * 16  # a planar table of 16 entries at L = 16
    monkeypatch.setattr(tkm, "TABLE_CACHE_BYTES", 2 * entry)
    ws = [TFR.root_of_unity(32), TFR.root_of_unity(64), TFR.root_of_unity(128)]
    t0 = tkm.cached_pow_table(TFR, ws[0], 16, "cpu")
    tkm.cached_pow_table(TFR, ws[1], 16, "cpu")
    assert tkm.cached_pow_table(TFR, ws[0], 16, "cpu") is t0  # a hit, now the most recent
    tkm.cached_pow_table(TFR, ws[2], 16, "cpu")  # over the bound: ws[1]'s goes
    keys = list(tkm.cached_tables())
    assert [k[1] for k in keys] == [ws[0], ws[2]]
    assert sum(v.numel() * v.element_size() for v in tkm.cached_tables().values()) <= 2 * entry
    assert len(builds) == 3
    again = tkm.cached_pow_table(TFR, ws[1], 16, "cpu")  # rebuilt, the same words
    assert len(builds) == 4
    assert tfp.to_ints(TFR, again) == [pow(ws[1], j, TFR.modulus) for j in range(16)]
    keys = list(tkm.cached_tables())
    monkeypatch.setattr(tkm, "TABLE_CACHE_BYTES", entry)  # a table alone over the bound
    big = tkm.cached_pow_table(TFR, ws[0], 32, "cpu")
    assert list(tkm.cached_tables()) == keys  # not kept, and nothing evicted for it
    assert tfp.to_ints(TFR, big) == [pow(ws[0], j, TFR.modulus) for j in range(32)]
    tkm.clear_table_cache()
    assert tkm.cached_tables() == {}


def test_cache_keys_tell_tables_apart(builds):
    w = TFR.root_of_unity(64)
    p = TFR.modulus
    plain = tkm.cached_pow_table(TFR, w, 8, "cpu")
    scaled = tkm.cached_pow_table(TFR, w, 8, "cpu", scale_int=5)
    packed = tkm.cached_pow_table(TFR, w, 8, "cpu", packed=True)
    assert tkm.cached_pow_table(TFR, w + p, 8, "cpu") is plain  # w reduced mod p in the key
    assert len(builds) == 3 and len({id(plain), id(scaled), id(packed)}) == 3
    assert tfp.to_ints(TFR, scaled) == [5 * pow(w, j, p) % p for j in range(8)]
    assert np.array_equal(tkm.unpack_pairs(packed.T).numpy(), plain.numpy())
