"""Port parity: zkarray_torch.core.bigint, ec.wnaf, ec.fixed_base, ec.glv and
ec.stream_msm against the JAX package, word for word.

The device calls run at the shapes the JAX package's own tests compile:
WnafContext on BN254 G1 (window 4) and the streaming MSMs on BN254 G1
(c = 4, chunks of 8, 24 points) from tests/test_scalar_mul_extras.py,
FixedBaseTable (window 13) and glv_mul on BLS12-381 G1 and glv_mul_ext on
its G2 from tests/test_glv_fixed.py. Where the JAX call is slow on the CPU
(tracing the fixed-base tree, the G2 ladder, the streaming MSMs: ~55 s
together), its words are stored in tests/vectors/scalar_mul_words.npz by
scripts/scalar_mul_words.py, and the slow-marked test rebuilds them. The
tables carried across by zkarray_torch.interop give the same results as
the port's own. On the CPU every field operation is its kernel's plain
version, and every MSM kernel its plain version."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from torch_parity import same  # noqa: E402
from zkarray.core import bigint as jbig  # noqa: E402
from zkarray.curves import bls12_381 as jb  # noqa: E402
from zkarray.curves import bn254 as jbn  # noqa: E402
from zkarray.ec import fixed_base as jfb  # noqa: E402
from zkarray.ec import glv as jglv  # noqa: E402
from zkarray.ec import sw_ext as jsw_ext  # noqa: E402
from zkarray.ec import wnaf as jwnaf  # noqa: E402
from zkarray.ff import fp as jfp  # noqa: E402
from zkarray_torch.core import bigint  # noqa: E402
from zkarray_torch.curves import bls12_381 as tb  # noqa: E402
from zkarray_torch.curves import bn254 as tbn  # noqa: E402
from zkarray_torch.ec import fixed_base, glv, stream_msm, sw, wnaf  # noqa: E402
from zkarray_torch.ff import fp as tfp  # noqa: E402
from zkarray_torch.interop import (affine_from_numpy, ext_affine_from_numpy,  # noqa: E402
                                   fixed_base_table_from_numpy, limbs_from_numpy,
                                   wnaf_context_from_numpy)
from zkarray_torch.testing import ec_add, ec_mul  # noqa: E402


def _words_script():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "scalar_mul_words.py")
    spec = importlib.util.spec_from_file_location("scalar_mul_words", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


WORDS = _words_script()
STORED = dict(np.load(WORDS.OUT))


def _same_stored(prefix, tP):
    names = ("x", "y", "z") if len(tP) == 3 else ("x", "y", "zz", "zzz")
    for n_, t in zip(names, tP):
        assert np.array_equal(STORED[f"{prefix}_{n_}"], t.numpy().view(np.uint32)), (prefix, n_)


def _same_points(jP, tP):
    for j, t in zip(jP, tP):
        assert same(j, t)


def test_bigint_host_recodings():
    rng = random.Random(0)
    xs = [0, 1, 2, 3, 7, 1 << 20, 12345678901234567] + [rng.randrange(1 << 256) for _ in range(20)]
    for x in xs:
        assert bigint.find_naf(x) == jbig.find_naf(x)
        for w in (2, 4, 5):
            assert bigint.find_wnaf(x, w) == jbig.find_wnaf(x, w)
        assert bigint.bits_be(x) == jbig.bits_be(x) and bigint.bits_le(x, 300) == jbig.bits_le(x, 300)
    for w in (2, 4, 5):  # the batch recoding WnafContext.mul uses, digit for digit
        d = bigint.wnaf_digits(xs, w)
        assert d.shape[0] == max(len(jbig.find_wnaf(x, w)) for x in xs)
        for j, x in enumerate(xs):
            want = jbig.find_wnaf(x, w)
            assert d[:, j].tolist() == want + [0] * (d.shape[0] - len(want))
    assert bigint.wnaf_digits([0, 0], 4).shape == (0, 2) and bigint.wnaf_digits([], 4).shape == (1, 0)


def test_bigint_limb_ops_match_jax():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 16, size=(16, 5), dtype=np.uint32)
    b = rng.integers(0, 1 << 16, size=(8, 5), dtype=np.uint32)
    a[:, 0] = 0xFFFF  # carries through every limb
    b[:, 0] = 0xFFFF
    ta, tb_ = limbs_from_numpy(a, "cpu"), limbs_from_numpy(b, "cpu")
    ja, jb_ = jnp.asarray(a), jnp.asarray(b)
    assert same(jbig.mul_wide(ja, jb_), bigint.mul_wide(ta, tb_))
    for k in (0, 5, 16, 21, 40):
        assert same(jbig.shl_limbs(ja, k), bigint.shl_limbs(ta, k)), k
        assert same(jbig.shr_limbs(ja, k), bigint.shr_limbs(ta, k)), k


def test_wnaf_context_matches_jax():
    jc, tc = jbn.G1, tbn.G1
    gen = (tc.gen_x, tc.gen_y)
    ks = [1, 2, 5, 1 << 20, 12345678901234567]
    jctx = jwnaf.WnafContext(jc, gen, window=4)
    tctx = wnaf.WnafContext(tc, gen, window=4, device="cpu")
    assert same(jctx.tx, tctx.tx) and same(jctx.ty, tctx.ty)
    got = tctx.mul(ks)
    _same_points(jctx.mul(ks), got)
    a_int, mod = tc.a_int, tc.base.modulus
    assert sw.affine_to_ints(tc, sw.to_affine(tc, got)) == [ec_mul(gen, k, a_int, mod) for k in ks]
    carried = wnaf_context_from_numpy(tc, np.asarray(jctx.tx), np.asarray(jctx.ty), "cpu")
    assert carried.window == 4
    _same_points(jctx.mul(ks[:1] * 5), carried.mul(ks[:1] * 5))


def test_fixed_base_table_matches_jax():
    """The host table word for word at window 4 (64 rows), carried across
    and applied; batch_mul at window 13 (tests/test_glv_fixed.py's shape)
    against the JAX package's stored words."""
    jc, tc = jb.G1, tb.G1
    gen = (tc.gen_x, tc.gen_y)
    ks = WORDS.fixed_ks(tc.scalar.modulus)
    js = jfp.from_ints(jc.scalar, ks, mont=False)
    ts = limbs_from_numpy(np.asarray(js), "cpu")
    jt4 = jfb.FixedBaseTable(jc, gen, window=4)
    tt4 = fixed_base.FixedBaseTable(tc, gen, window=4, device="cpu")
    assert tt4.outerc == jt4.outerc == 64
    assert same(jt4.tx, tt4.tx) and same(jt4.ty, tt4.ty)
    assert np.array_equal(np.asarray(jt4.tinf), tt4.tinf.numpy())
    carried = fixed_base_table_from_numpy(tc, np.asarray(jt4.tx), np.asarray(jt4.ty),
                                          np.asarray(jt4.tinf), 4, "cpu")
    assert all(torch.equal(u, v) for u, v in zip(carried.batch_mul(ts[:, :2]), tt4.batch_mul(ts[:, :2])))
    got = fixed_base.FixedBaseTable(tc, gen, window=13, device="cpu").batch_mul(ts)
    _same_stored("fixed_base", got)
    a_int, mod = tc.a_int, tc.base.modulus
    assert sw.affine_to_ints(tc, sw.to_affine(tc, got)) == [ec_mul(gen, k, a_int, mod) for k in ks]


@pytest.mark.parametrize("name", ["bls12_381_g1_glv", "bn254_g1_glv", "bls12_377_g1_glv",
                                  "bw6_761_g1_glv", "bls12_381_g2_glv"])
def test_glv_specs_and_decomposition_match_jax(name):
    jg, tg = getattr(jglv, name)(), getattr(glv, name)()
    assert (tg.lam, tg.decomp) == (jg.lam, jg.decomp)
    assert (tg.endo_host if name.endswith("g2_glv") else tg.endo_coeff) == (
        jg.endo_host if name.endswith("g2_glv") else jg.endo_coeff)
    assert tg.curve.scalar.modulus == jg.curve.scalar.modulus
    rng = random.Random(3)
    r = tg.curve.scalar.modulus
    for k in [0, 1, r - 1] + [rng.randrange(r) for _ in range(8)]:
        assert tg.decompose(k) == jg.decompose(k)


def test_glv_mul_g1_matches_jax():
    jc, tc = jb.G1, tb.G1
    a_int, mod = tc.a_int, tc.base.modulus
    gen = (tc.gen_x, tc.gen_y)
    pts = [ec_mul(gen, k, a_int, mod) for k in (1, 2, 7)]
    ks = [0, 1, random.Random(1).randrange(tc.scalar.modulus)]
    jA = jc.affine_from_ints(pts)
    tA = affine_from_numpy(np.asarray(jA.x), np.asarray(jA.y), np.asarray(jA.inf), "cpu")
    got = glv.glv_mul(glv.bls12_381_g1_glv(), tA, ks)
    _same_points(jglv.glv_mul(jglv.bls12_381_g1_glv(), jA, ks), got)
    assert sw.affine_to_ints(tc, sw.to_affine(tc, got)) == [ec_mul(p, k, a_int, mod)
                                                            for p, k in zip(pts, ks)]


def test_glv_mul_g2_matches_jax():
    """glv_mul_ext against the JAX package's stored words; the endomorphism
    against its function."""
    ks = WORDS.g2_ks(jb.G2.scalar.modulus)
    H = jb.G2.generator((1,))
    jA = jsw_ext.ExtAffine(jnp.concatenate([H.x] * len(ks), axis=-1),
                           jnp.concatenate([H.y] * len(ks), axis=-1),
                           jnp.concatenate([H.inf] * len(ks)))
    tA = ext_affine_from_numpy(np.asarray(jA.x), np.asarray(jA.y), np.asarray(jA.inf), "cpu")
    _same_stored("glv_g2", glv.glv_mul_ext(glv.bls12_381_g2_glv(), tA, ks))
    phi = glv.endomorphism_ext(glv.bls12_381_g2_glv(), tA)
    jphi = jglv.endomorphism_ext(jglv.bls12_381_g2_glv(), jA)
    assert same(jphi.x, phi.x) and same(jphi.y, phi.y)


def _affine_of(curve, P):
    return sw.affine_to_ints(curve, sw.xyzz_to_affine(curve, sw.XYZZPoints(*(v[..., None] for v in P))))[0]


def test_stream_pippengers_match_jax():
    tc = tbn.G1
    pts, ks, sums = WORDS.stream_inputs(tc)
    tcp = stream_msm.ChunkedPippenger(tc, chunk_size=8, c=4, device="cpu")
    thp = stream_msm.HashMapPippenger(tc, c=4, device="cpu")
    for p, k in zip(pts[:16], ks[:16]):  # two flushes of 8
        tcp.add(p, k)
    for p, k in zip(pts + pts, ks + ks):  # every base twice
        thp.add(p, k)
    got, got2 = tcp.finalize(), thp.finalize()
    _same_stored("chunked_pippenger", got)
    _same_stored("hashmap_pippenger", got2)
    a_int, mod = tc.a_int, tc.base.modulus
    assert _affine_of(tc, got) == sums[16]
    assert _affine_of(tc, got2) == ec_add(sums[24], sums[24], a_int, mod)


def test_msm_chunks_matches_jax():
    """Two 8-wide chunks carried in one bucket state, then a 24-wide chunk
    (wider than the first) run as its own msm and added in."""
    tc = tbn.G1
    pts, ks, sums = WORDS.stream_inputs(tc)
    tA = sw.affine_from_ints(tc, pts, "cpu")
    ts = tfp.from_ints(tc.scalar, ks, mont=False, device="cpu")

    def chunks():
        for lo in (0, 8):
            yield sw.AffinePoints(tA.x[:, lo:lo + 8], tA.y[:, lo:lo + 8], tA.inf[lo:lo + 8]), ts[:, lo:lo + 8]
        yield tA, ts

    got = stream_msm.msm_chunks(tc, chunks(), c=4, device="cpu")
    _same_stored("msm_chunks", got)
    a_int, mod = tc.a_int, tc.base.modulus
    assert _affine_of(tc, got) == ec_add(sums[24], sums[16], a_int, mod)
    empty = stream_msm.msm_chunks(tc, iter(()), device="cpu")
    assert bool(sw.xyzz_is_inf(sw.XYZZPoints(*(v[..., None] for v in empty)))[0])


@pytest.mark.slow
def test_stored_scalar_mul_words_match_jax():
    """The stored words equal what the JAX package computes now."""
    want = WORDS.words()
    assert sorted(STORED) == sorted(want)
    for k, v in want.items():
        assert STORED[k].dtype == v.dtype and np.array_equal(STORED[k], v), k
