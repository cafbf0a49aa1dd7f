"""Port parity: the small-subgroup roots of FieldSpec, MixedRadixDomain,
GeneralDomain, the NTT kernels' wrappers at NW = 10 and 24, and
poly/group_domain.py's fft_group, against the JAX package.

The mixed-radix transforms run on MNT6-753 Fr (NW = 24), the JAX package's
own test bed (tests/test_mixed_radix.py), at its sizes 20 and 40, and on
MNT4-298 Fq (NW = 10, q = 7) at 28 (a direct DFT of 7 inside) and 98
(a split of 49 = 7 x 7 with a batched twiddle). fft_group runs on BN254 G1
at n = 8, the shape tests/test_domain_extras.py compiles. On the CPU every
butterfly, table and twiddle multiply is its kernel's plain version; the
kernels are held against them on the card by chip_smoke.py (phase 13)."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)


from torch_parity import both, same  # noqa: E402
from zkarray.curves import bn254 as jbn  # noqa: E402
from zkarray.curves import mnt4_298 as jm4  # noqa: E402
from zkarray.curves import mnt4_753 as jm4b  # noqa: E402
from zkarray.curves import mnt6_298 as jm6  # noqa: E402
from zkarray.curves import mnt6_753 as jm6b  # noqa: E402
from zkarray.ec import sw as jsw  # noqa: E402
from zkarray.poly import domain as jdm  # noqa: E402
from zkarray.poly import mixed_radix as jmr  # noqa: E402
from zkarray.poly.group_domain import SWJacobianCoeff as JCoeff  # noqa: E402
from zkarray.poly.group_domain import fft_group as jfft_group  # noqa: E402
from zkarray_torch.curves import bn254 as tbn  # noqa: E402
from zkarray_torch.curves import mnt4_298 as tm4  # noqa: E402
from zkarray_torch.curves import mnt4_753 as tm4b  # noqa: E402
from zkarray_torch.curves import mnt6_298 as tm6  # noqa: E402
from zkarray_torch.curves import mnt6_753 as tm6b  # noqa: E402
from zkarray_torch.ec import sw as tsw  # noqa: E402
from zkarray_torch.ff import fp as tfp  # noqa: E402
from zkarray_torch.interop import jacobian_from_numpy  # noqa: E402
from zkarray_torch.kernels import _build  # noqa: E402
from zkarray_torch.kernels import mont as km  # noqa: E402
from zkarray_torch.poly import domain as tdm  # noqa: E402
from zkarray_torch.poly import mixed_radix as tmr  # noqa: E402
from zkarray_torch.poly.group_domain import SWJacobianCoeff, fft_group  # noqa: E402

# (JAX field, port field): q = 7 at 298 bits, q = 5 at 753 bits
MNT_FIELDS = {"mnt4_298.Fq": (jm4.FQ, tm4.FQ), "mnt6_298.Fr": (jm6.FR, tm6.FR),
              "mnt4_753.Fq": (jm4b.FQ, tm4b.FQ), "mnt4_753.Fr": (jm4b.FR, tm4b.FR),
              "mnt6_753.Fq": (jm6b.FQ, tm6b.FQ), "mnt6_753.Fr": (jm6b.FR, tm6b.FR)}
JM, TM = jm6b.FR, tm6b.FR  # tests/test_mixed_radix.py's field
JS7, TS7 = jm4.FQ, tm4.FQ


def naive_dft(xs, w, p):
    n = len(xs)
    return [sum(x * pow(w, j * k, p) for j, x in enumerate(xs)) % p for k in range(n)]


@pytest.mark.parametrize("name", list(MNT_FIELDS))
def test_small_subgroup_roots_match_jax(name):
    """Every root the mixed branch gives (each 2^a q^b the field allows) and
    a few power-of-two ones equal the JAX package's; the sizes it refuses,
    it refuses in both."""
    J, T = MNT_FIELDS[name]
    assert (T.small_subgroup_base, T.small_subgroup_base_adicity, T.large_subgroup_root_int) == (
        J.small_subgroup_base, J.small_subgroup_base_adicity, J.large_subgroup_root_int)
    q, s = T.small_subgroup_base, T.two_adicity
    for b in range(T.small_subgroup_base_adicity + 1):
        for a in sorted({0, 1, 2, s // 2, s}):
            n = (1 << a) * q ** b
            w = T.root_of_unity(n)
            assert w == J.root_of_unity(n), n
            assert pow(w, n, T.modulus) == 1 and (n == 1 or pow(w, n // 2 if a else n // q, T.modulus) != 1)
    for bad in ((1 << (s + 1)), q ** (T.small_subgroup_base_adicity + 1), 3 * 11):
        with pytest.raises(ValueError):
            J.root_of_unity(bad)
        with pytest.raises(ValueError):
            T.root_of_unity(bad)


@pytest.mark.parametrize("J,T,n,offset", [(JM, TM, 20, 1), (JM, TM, 40, 1), (JS7, TS7, 28, 1),
                                          (JS7, TS7, 98, 3)],
                         ids=["753-n20", "753-n40", "298-n28", "298-n98-coset3"])
def test_mixed_fft_ifft_match_jax(J, T, n, offset):
    p = T.modulus
    rng = random.Random(n)
    xs = [rng.randrange(p) for _ in range(n)]
    ja, ta = both(J, xs)
    jd, td = jmr.MixedRadixDomain(J, n, offset), tmr.MixedRadixDomain(T, n, offset)
    assert td.group_gen_int == jd.group_gen_int
    jev, tev = jd.fft(ja), td.fft(ta)
    assert same(jev, tev)
    if offset == 1:
        assert tfp.to_ints(T, tev) == naive_dft(xs, td.group_gen_int, p)
    back = td.ifft(tev)
    assert same(jd.ifft(jev), back)
    assert tfp.to_ints(T, back) == xs
    assert same(jd.elements(), td.elements("cpu"))


def test_best_size_and_general_domain():
    assert tmr.best_mixed_domain_size(TM, 20) == jmr.best_mixed_domain_size(JM, 20) == 20
    assert tmr.best_mixed_domain_size(TM, 21) == 25
    for target in (3 * 10 ** 5, 1 << 15, (1 << 15) + 1, 5 << 15):
        assert tmr.best_mixed_domain_size(TM, target) == jmr.best_mixed_domain_size(JM, target)
    d = tdm.GeneralDomain(TM, 6)
    assert isinstance(d, tdm.Radix2Domain) and d.size == 8
    big = tdm.GeneralDomain(TM, (1 << TM.two_adicity) + 1)
    jbig = jdm.GeneralDomain(JM, (1 << JM.two_adicity) + 1)
    assert isinstance(big, tmr.MixedRadixDomain) and big.size == jbig.size
    assert big.group_gen_int == jbig.group_gen_int
    with pytest.raises(ValueError):
        tmr.MixedRadixDomain(TM, 21)


@pytest.mark.parametrize("J,T", [(JS7, TS7), (JM, TM)], ids=["nw10", "nw24"])
def test_ntt_wrappers_at_nw10_and_nw24(J, T):
    """butterfly_dit, butterfly_stage, pow_table and twiddle_mul at the two
    widths phase 13 adds: the CPU takes the plain versions; the width
    groups that hold the kernels on the card are named; NW = 26 has none."""
    L = T.num_limbs
    assert _build.ntt_lib("ntt", L // 2) in _build.SOURCES
    assert _build.ntt_lib("twiddle", L // 2) in _build.SOURCES
    with pytest.raises(ValueError):
        _build.ntt_lib("ntt", 26)
    p = T.modulus
    rng = random.Random(L)
    xs = [rng.randrange(p) for _ in range(16)]
    _, x = both(J, xs)
    w = T.root_of_unity(16)
    tw = km.pow_table(T, w, 8, "cpu")
    assert tfp.to_ints(T, tw) == [pow(w, j, p) for j in range(8)]
    assert torch.equal(km.pow_table(T, w, 8, "cpu", packed=True),
                       km.pow_table_plain(T, w, 8, torch.device("cpu"), packed=True))
    y = x.clone()
    km.butterfly_dit(T, y.view(L, 4, 2, 2, 1), tw, 4)
    want = x.clone()
    km.butterfly_dit_plain(T, want.view(L, 4, 2, 2, 1), tw, 4)
    assert torch.equal(y, want)
    a, b = km.butterfly_stage(T, x[:, :8], x[:, 8:], tw)
    assert tfp.to_ints(T, a) == [(u + v) % p for u, v in zip(xs[:8], xs[8:])]
    assert tfp.to_ints(T, b) == [(u - v) * pow(w, j, p) % p for j, (u, v) in enumerate(zip(xs[:8], xs[8:]))]
    tables = km.twiddle_tables(T, w, 9, "cpu")
    got = km.twiddle_mul(T, x.view(L, 4, 4), tables)
    assert tfp.to_ints(T, got) == [xs[4 * r + c] * pow(w, r * c, p) % p for r in range(4) for c in range(4)]
    if torch.cuda.is_available():  # the card path: each kernel against its plain version
        dev = torch.device("cuda")
        xd, twd = x.to(dev), tw.to(dev)
        yd = xd.clone()
        km.butterfly_dit(T, yd.view(L, 4, 2, 2, 1), twd, 4)
        assert torch.equal(yd.cpu(), want)
        assert torch.equal(km.pow_table(T, w, 8, dev).cpu(), tw)
        assert torch.equal(km.twiddle_mul(T, xd.view(L, 4, 4), km.twiddle_tables(T, w, 9, dev)).cpu(),
                           got)


def _jac_both(curve_j, curve_t, pts):
    J = jsw.from_affine(curve_j, curve_j.affine_from_ints(pts))
    return J, jacobian_from_numpy([np.asarray(v) for v in J], "cpu")


def test_fft_group_matches_jax():
    """BN254 G1 at n = 8 (tests/test_domain_extras.py's shape): the
    forward transform word for word against the JAX package, and against
    the field fft of the discrete logs times G."""
    from zkarray_torch.testing import ec_mul

    jc, tc = jbn.G1, tbn.G1
    n = 8
    a_int, mod = tc.a_int, tc.base.modulus
    gen = (tc.gen_x, tc.gen_y)
    rng = np.random.default_rng(1)
    ks = [int(x) for x in rng.integers(1, 1 << 30, size=n)]
    jP, tP = _jac_both(jc, tc, [ec_mul(gen, k, a_int, mod) for k in ks])
    jd, td = jdm.Radix2Domain(jbn.FR, n), tdm.Radix2Domain(tbn.FR, n)
    got = fft_group(td, SWJacobianCoeff(tc), tP)
    want = jfft_group(jd, JCoeff(jc), jP)
    for j, t in zip(want, got):
        assert same(j, t)
    r = tc.scalar.modulus
    evals = naive_dft(ks, td.group_gen_int, r)
    assert tsw.affine_to_ints(tc, tsw.to_affine(tc, got)) == [ec_mul(gen, e, a_int, mod) for e in evals]


def test_fft_group_inverse_matches_jax():
    """The inverse on a coset at n = 2: the n^-1 offset^-j scale ladder and
    one butterfly stage, word for word, and the round trip."""
    from zkarray_torch.testing import ec_mul

    jc, tc = jbn.G1, tbn.G1
    a_int, mod = tc.a_int, tc.base.modulus
    gen = (tc.gen_x, tc.gen_y)
    pts = [ec_mul(gen, 3, a_int, mod), None]
    jP, tP = _jac_both(jc, tc, pts)
    jd, td = jdm.Radix2Domain(jbn.FR, 2, offset_int=5), tdm.Radix2Domain(tbn.FR, 2, offset_int=5)
    jops, tops = JCoeff(jc), SWJacobianCoeff(tc)
    got = fft_group(td, tops, tP, inverse=True)
    want = jfft_group(jd, jops, jP, inverse=True)
    for j, t in zip(want, got):
        assert same(j, t)
    back = fft_group(td, tops, got)
    assert tsw.affine_to_ints(tc, tsw.to_affine(tc, back)) == pts
