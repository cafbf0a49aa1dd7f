"""Port parity: zkarray_torch.poly (Radix2Domain, the four-step transforms,
Evaluations) against zkarray.poly and Python-int oracles, bit for bit.

The JAX side runs only at shapes the JAX package's own tests compile:
BLS12-381 Fr fft at n = 8 and 32 and fft/ifft at 256 with offsets 1 and 7
(tests/test_domain.py); the degree-aware branch, Lagrange coefficients,
the vanishing polynomial and Evaluations on BN254 Fr at the shapes of
tests/test_domain_extras.py, test_domain.py and test_poly.py (the port's
field code is generic, so it runs BN254 Fr from the same constants). The
four-step transforms are held against the port's own flat ladder, which the
JAX package pins to its four-step the same way. On the CPU every
butterfly stage runs the plain version of the butterfly_dit kernel, and
every table and twiddle multiply the plain versions of pow_table and
twiddle_mul; the kernels themselves are held against them on the card by
chip_smoke.py."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import both, port_field, same  # noqa: E402
from zkarray.curves import bls12_381 as jcurves  # noqa: E402
from zkarray.curves import bn254 as jbn  # noqa: E402
from zkarray.poly import domain as jdm  # noqa: E402
from zkarray.poly.evaluations import Evaluations as JEvaluations  # noqa: E402
from zkarray_torch.curves import bls12_381 as tcurves  # noqa: E402
from zkarray_torch.ff import fp as tfp  # noqa: E402
from zkarray_torch.kernels import mont as tkm  # noqa: E402
from zkarray_torch.poly import domain as tdm  # noqa: E402
from zkarray_torch.poly.evaluations import Evaluations  # noqa: E402

JFR, TFR = jcurves.FR, tcurves.FR
JBN, TBN = jbn.FR, port_field(jbn.FR)


def naive_dft(coeffs, w, p, offset=1):
    n = len(coeffs)
    return [sum(c * pow(offset, j, p) * pow(w, j * k, p) for j, c in enumerate(coeffs)) % p
            for k in range(n)]


@pytest.mark.parametrize("n,offset,inverse", [(8, 1, False), (32, 1, False), (256, 1, True),
                                              (256, 7, True)],
                         ids=["n8", "n32", "n256", "n256-coset7"])
def test_fft_ifft_match_jax(n, offset, inverse):
    p = JFR.modulus
    rng = random.Random(n)
    xs = [rng.randrange(p) for _ in range(n)]
    ja, ta = both(JFR, xs)
    jd, td = jdm.Radix2Domain(JFR, n, offset_int=offset), tdm.Radix2Domain(TFR, n, offset_int=offset)
    assert td.group_gen_int == jd.group_gen_int
    jev, tev = jd.fft(ja), td.fft(ta)
    assert same(jev, tev)
    assert tfp.to_ints(TFR, tev) == naive_dft(xs, td.group_gen_int, p, offset)
    back = td.ifft(tev)
    assert tfp.to_ints(TFR, back) == xs
    if inverse:
        assert same(jd.ifft(jev), back)


def test_degree_aware_fft_matches_jax_and_full():
    # BN254 Fr, n = 64, offset 5, 9 coefficients: m2 = 16 (test_domain_extras)
    rng = np.random.default_rng(0)
    cs = [int(x) for x in rng.integers(1, 1 << 60, size=9)]
    jc, tc = both(JBN, cs)
    jd, td = jdm.Radix2Domain(JBN, 64, offset_int=5), tdm.Radix2Domain(TBN, 64, offset_int=5)
    tev = td.fft(tc)
    assert same(jd.fft(jc), tev)
    assert tfp.to_ints(TBN, tev) == naive_dft(cs + [0] * 55, td.group_gen_int, JBN.modulus, 5)
    # BLS12-381 Fr, n = 32, 5 coefficients (m2 = 8): against the full transform
    p = TFR.modulus
    rng = random.Random(5)
    xs = [rng.randrange(p) for _ in range(5)]
    d = tdm.Radix2Domain(TFR, 32, offset_int=7)
    a = tfp.from_ints(TFR, xs, device="cpu")
    full = d.fft(torch.cat([a, torch.zeros((TFR.num_limbs, 27), dtype=torch.int32)], dim=1))
    assert torch.equal(d.fft(a), full)
    assert tfp.to_ints(TFR, full) == naive_dft(xs + [0] * 27, d.group_gen_int, p, 7)


def _rand_limbs(spec, n, seed):
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(32), "little") % spec.modulus for _ in range(n)]
    return tfp.from_ints(spec, xs, device="cpu")


@pytest.mark.parametrize("which", ["core", "big"])
def test_fourstep_matches_flat_ladder(which):
    n1 = n2 = 64
    n = n1 * n2
    fn = {"core": tdm.fft_fourstep_core, "big": tdm.fft_fourstep_big}[which]
    g = TFR.root_of_unity(n)
    a = _rand_limbs(TFR, n, 12)
    a0 = a.clone()
    got = fn(TFR, a, n1, n2, g, None)
    assert torch.equal(got, tdm._fft_core(TFR, a, n, g, None))
    p = TFR.modulus
    assert torch.equal(fn(TFR, got, n1, n2, pow(g, -1, p), pow(n, -1, p)), a)
    assert torch.equal(a, a0)


def test_lagrange_and_vanishing_match_jax():
    p = JBN.modulus
    # tests/test_domain.py:test_lagrange_coefficients' domain: n = 8, offset 5
    jd, td = jdm.Radix2Domain(JBN, 8, offset_int=5), tdm.Radix2Domain(TBN, 8, offset_int=5)
    tau = random.Random(1).randrange(p)
    elem3 = 5 * pow(td.group_gen_int, 3, p) % p
    for x in (tau, elem3):
        jt, tt = both(JBN, [x])
        got = td.evaluate_all_lagrange_coefficients(tt)
        assert same(jd.evaluate_all_lagrange_coefficients(jt), got)
    assert tfp.to_ints(TBN, got) == [1 if i == 3 else 0 for i in range(8)]
    assert same(jd.elements(), td.elements("cpu"))
    # tests/test_domain.py:test_vanishing_poly's domain: n = 16, offset 3
    jd, td = jdm.Radix2Domain(JBN, 16, offset_int=3), tdm.Radix2Domain(TBN, 16, offset_int=3)
    jx, tx = both(JBN, [5, 123456789])
    got = td.evaluate_vanishing_polynomial(tx)
    assert same(jd.evaluate_vanishing_polynomial(jx), got)
    assert tfp.to_ints(TBN, got) == [(pow(x, 16, p) - pow(3, 16, p)) % p for x in (5, 123456789)]


def test_evaluations_match_jax():
    # tests/test_poly.py:test_evaluations_algebra's shapes: BN254 Fr, n = 16
    p = JBN.modulus
    rng = random.Random(7)
    a = [rng.randrange(p) for _ in range(16)]
    b = [rng.randrange(1, p) for _ in range(16)]
    jdom, tdom = jdm.Radix2Domain(JBN, 16), tdm.Radix2Domain(TBN, 16)
    (ja, ta), (jb, tb) = both(JBN, a), both(JBN, b)
    jea, jeb = JEvaluations(jdom, ja), JEvaluations(jdom, jb)
    tea, teb = Evaluations(tdom, ta), Evaluations(tdom, tb)
    assert same((jea * jeb).evals, (tea * teb).evals)
    assert same((jea / jeb).evals, (tea / teb).evals)
    assert tfp.to_ints(TBN, (tea + teb).evals) == [(x + y) % p for x, y in zip(a, b)]
    assert tfp.to_ints(TBN, (tea - teb).evals) == [(x - y) % p for x, y in zip(a, b)]
    coeffs = tea.interpolate()
    assert same(jea.interpolate(), coeffs)
    back = Evaluations.from_coeffs(tdom, coeffs)
    assert same(JEvaluations.from_coeffs(jdom, jea.interpolate()).evals, back.evals)
    assert tfp.to_ints(TBN, back.evals) == a
    with pytest.raises(ValueError):
        tea + Evaluations(tdom.get_coset(3), tb)


def test_fft_and_ifft_leave_their_input_unchanged():
    d = tdm.Radix2Domain(TFR, 32, offset_int=7)
    for a in (_rand_limbs(TFR, 32, 3), _rand_limbs(TFR, 5, 4)):  # full and degree-aware
        a0 = a.clone()
        ev = d.fft(a)
        assert torch.equal(a, a0)
        ev0 = ev.clone()
        d.ifft(ev)
        assert torch.equal(ev, ev0)


def test_tables_and_constants_match_oracles():
    p = TFR.modulus
    for log_n in (0, 1, 5, 8):
        assert np.array_equal(tdm._bitrev_perm(log_n, "cpu").numpy(), jdm._bitrev_perm(log_n))
    w = TFR.root_of_unity(64)
    assert tfp.to_ints(TFR, tdm.power_table(TFR, w, 13, "cpu")) == [pow(w, j, p) for j in range(13)]
    with pytest.MonkeyPatch.context() as mp:  # a table past one pow_table: twiddle_mul over two
        mp.setattr(tkm, "POW_TABLE_MAX", 8)
        assert tfp.to_ints(TFR, tdm.power_table(TFR, w, 13, "cpu")) == [pow(w, j, p) for j in range(13)]
    T = tdm.twiddle_table(TFR, w, 5, 6, "cpu")
    assert tfp.to_ints(TFR, T) == [pow(w, k1 * i2, p) for k1 in range(5) for i2 in range(6)]
    d = tdm.Radix2Domain(TFR, 8, offset_int=7)
    assert tfp.to_ints(TFR, d.elements("cpu")) == [7 * pow(d.group_gen_int, i, p) % p for i in range(8)]
    big, sub = jdm.Radix2Domain(JFR, 16), jdm.Radix2Domain(JFR, 4)
    tbig, tsub = tdm.Radix2Domain(TFR, 16), tdm.Radix2Domain(TFR, 4)
    assert [tbig.reindex_by_subdomain(tsub, i) for i in range(16)] == [
        big.reindex_by_subdomain(sub, i) for i in range(16)]
    with pytest.raises(ValueError):
        tdm.Radix2Domain(TFR, 1 << 33)
    with pytest.raises(ValueError):
        tdm.Radix2Domain(TFR, 8).ifft(tfp.zero(TFR, (4,), "cpu"))


@pytest.mark.parametrize("which", ["big", "core", "degree-aware"])
def test_forward_ffts_make_no_product_call(which, monkeypatch):
    """The tables and twiddles of a forward fft are pow_table and twiddle_mul
    launches: no mont_mul or mont_sqr call, through ff/fp.py or the kernel
    layer (on the card each would be a launch)."""
    calls = []
    for mod in (tfp, tkm):
        for name in ("mont_mul", "mont_sqr"):
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    n1 = n2 = 64
    g = TFR.root_of_unity(n1 * n2)
    a = _rand_limbs(TFR, n1 * n2, 13)
    if which == "degree-aware":  # 2^10 coefficients on 2^12 points, coset offset 7
        d = tdm.Radix2Domain(TFR, n1 * n2, offset_int=7)
        ev = d.fft(a[:, : n1 * n2 // 4])
    else:
        ev = {"core": tdm.fft_fourstep_core, "big": tdm.fft_fourstep_big}[which](TFR, a, n1, n2, g)
    assert calls == []
    assert ev.shape == (TFR.num_limbs, n1 * n2)
