"""Port parity: zkarray_torch.ff.fp against zkarray.ff.fp, bit for bit
(tolerance zero: a wrong limb is a wrong field element), on BLS12-381 Fq and
Fr; and the plain versions of the port's mont_mul/mont_sqr kernels against
the Pallas kernels of zkarray.kernels.mont in interpret mode.

Widths are the ones tests/test_fp.py and tests/test_kernels.py compile: 64
for the element-wise ops, 16 for Fermat inv, 70 with zeros for batch_inv,
700 and 513 at L = 16 for the kernels. The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py.

The field inverse's CUDA kernel (csrc/mont.cu:mont_inv_kernel, a binary GCD
in batches of 30 steps) cannot run here; zkarray_torch/testing.py:
mont_inv_model follows its loop word by word, and is held against Python's
pow and the JAX package's inv on the edge words (0, 1, R mod p, p - 1,
powers of two) and random ones, with its steps until a = 0 under their
stated bound (tests/test_torch_inv.py holds it at every width).

The square-root routes, Legendre symbols, powers and sums on the six fields
of the group path: BN254 Fr and BLS12-381 Fr (Tonelli-Shanks, s = 28 and
32), BN254 Fq and BLS12-381 Fq (3 mod 4), BLS12-377 Fq (Tonelli-Shanks,
s = 46) and 2^255 - 19 (5 mod 8). The JAX package is compiled only at
shapes tests/test_fp.py already compiles (18 elements, n = 23), plus its
sqrt on 2^255 - 19; elsewhere a field value is held against Python ints as
the words to_mont(expected), which is the same bit-for-bit check (every
result is fully reduced), and a square root against a host model of the
JAX package's root choice (testing.sqrt_reference, which chip_smoke.py
uses too), itself held against the JAX package on the four compiled
fields."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import FIELD_IDS, FIELDS, both, port_field, rand_ints, same  # noqa: E402
from zkarray.curves import bls12_381 as jcurves  # noqa: E402
from zkarray.core.fieldspec import FieldSpec as JFieldSpec  # noqa: E402
from zkarray.curves import bls12_377 as jbls377  # noqa: E402
from zkarray.curves import bn254 as jbn254  # noqa: E402
from zkarray.ff import fp as jfp  # noqa: E402
from zkarray.kernels import mont as jkm  # noqa: E402
from zkarray_torch.curves import bls12_377 as tbls377  # noqa: E402
from zkarray_torch.curves import bls12_381 as tcurves  # noqa: E402
from zkarray_torch.curves import bn254 as tbn254  # noqa: E402
from zkarray_torch.ff import fp as tfp  # noqa: E402
from zkarray_torch.kernels import mont as tkm  # noqa: E402
from zkarray_torch.testing import (  # noqa: E402
    fadd_edge_words, mont_inv_edge_words, mont_inv_iteration_bound, mont_inv_model, sqrt_reference)

# Fq and Fr of BLS12-381, and BN254's Fr (the port's field code is generic)
INV_FIELDS = FIELDS + [(jbn254.FR, port_field(jbn254.FR))]
INV_FIELD_IDS = FIELD_IDS + ["bn254-Fr"]


@pytest.mark.parametrize("pair", FIELDS, ids=FIELD_IDS)
def test_fp_ops_match_jax(pair):
    js, ts = pair
    p = js.modulus
    xs, ys = rand_ints(p, 64, 3), rand_ints(p, 64, 4)
    ja, ta = both(js, xs)
    jb, tb = both(js, ys)
    assert same(jfp.mont_mul(js, ja, jb), tfp.mont_mul(ts, ta, tb))
    assert same(jfp.mont_sqr(js, ja), tfp.mont_sqr(ts, ta))
    assert same(jfp.add(js, ja, jb), tfp.add(ts, ta, tb))
    assert same(jfp.sub(js, ja, jb), tfp.sub(ts, ta, tb))
    assert same(jfp.neg(js, ja), tfp.neg(ts, ta))
    assert same(jfp.double(js, ja), tfp.double(ts, ta))
    jc, tc = both(js, xs, mont=False)
    assert same(jfp.to_mont(js, jc), tfp.to_mont(ts, tc))
    assert same(jfp.from_mont(js, ja), tfp.from_mont(ts, ta))
    assert tfp.to_ints(ts, tfp.mont_mul(ts, ta, tb)) == [x * y % p for x, y in zip(xs, ys)]


@pytest.mark.parametrize(
    "pair, inputs",
    [(pair, "random") for pair in FIELDS] + [(pair, "edge") for pair in INV_FIELDS],
    ids=FIELD_IDS + [f"{i}-edge" for i in INV_FIELD_IDS])
def test_fp_inv_and_batch_inv_match_jax(pair, inputs):
    """fp.inv and batch_inv on the CPU against the JAX package: on random
    elements, or on mont_inv_edge_words' 16 edge words (Montgomery words, so
    given as limbs) at the front of both batches."""
    js, ts = pair
    p = js.modulus
    if inputs == "edge":
        edge = mont_inv_edge_words(ts, np.random.default_rng(0), n_random=0)
        assert len(edge) == 16
        xs = ys = [ts.from_mont_int(w) for w in edge]
        ys = ys + rand_ints(p, 70 - len(ys), 6)
    else:
        xs = rand_ints(p, 16, 5)
        ys = rand_ints(p, 70, 6)
        ys[10] = ys[40] = 0  # zeros map to zero
    ja, ta = both(js, xs)
    assert same(jfp.inv(js, ja), tfp.inv(ts, ta))
    jb, tb = both(js, ys)
    got = tfp.batch_inv(ts, tb)
    assert same(jfp.batch_inv(js, jb), got)
    assert tfp.to_ints(ts, got) == [pow(y, -1, p) if y else 0 for y in ys]


@pytest.mark.parametrize("pair", INV_FIELDS, ids=INV_FIELD_IDS)
def test_mont_inv_model_matches_pow_and_jax(pair):
    """The word model of the mont_inv kernel's batched binary GCD against
    pow(a, -1, p)·R mod p and the JAX package's inv (Fermat) on the 16 edge
    words, against pow on 24 random words, and its steps until a = 0 under
    the stated bound; the mont_inv wrapper (its plain version on the CPU)
    against the JAX package too."""
    js, ts = pair
    p = js.modulus
    R = ts.r_int
    edge = mont_inv_edge_words(ts, np.random.default_rng(1), n_random=0)
    words = edge + mont_inv_edge_words(ts, np.random.default_rng(2), n_random=24)[-24:]
    got = []
    for w in words:
        inv_w, iters = mont_inv_model(ts, w)
        assert inv_w == (pow(w * pow(R, -1, p), -1, p) * R % p if w else 0), w
        assert iters < mont_inv_iteration_bound(ts, w), w
        got.append(inv_w)
    ja, ta = both(js, [ts.from_mont_int(w) for w in edge])
    want = jfp.inv(js, ja)
    assert [ts.to_mont_int(v) for v in jfp.to_ints(js, want)] == got[: len(edge)]
    assert same(want, tkm.mont_inv(ts, ta))
    assert same(want, tkm.mont_inv_plain(ts, ta))


@pytest.mark.parametrize("pair", FIELDS, ids=FIELD_IDS)
def test_pow_const_matches_jax(pair):
    """pow_const (on the CPU, the plain version of the mont_pow kernel) for
    e = 0, 1, 2, p - 2 and a seeded 64-bit e, with a = 0 in the batch."""
    js, ts = pair
    p = js.modulus
    xs = rand_ints(p, 16, 10)
    assert 0 in xs
    ja, ta = both(js, xs)
    e64 = int.from_bytes(np.random.default_rng(11).bytes(8), "little")
    for e in (0, 1, 2, p - 2, e64):
        got = tfp.pow_const(ts, ta, e)
        assert same(jfp.pow_const(js, ja, e), got), e
        assert tfp.to_ints(ts, got) == [pow(x, e, p) for x in xs], e
    assert same(jfp.inv(js, ja), tfp.inv(ts, ta))
    with pytest.raises(ValueError):
        tfp.pow_const(ts, ta, -1)


@pytest.mark.parametrize("curve", ["bw6_761", "bw6_767"])
def test_l48_field_kernels_plain_match_jax(curve):
    """The plain versions of the mont.cu kernels at L = 48 (NW = 24, the
    BW6 fields): mont_mul/mont_sqr against the JAX package's on
    mont_inv_edge_words and random words spanning the field, every pair of
    16; pow_const (mont_pow's plain version) at e = 0, 1, 2 and a seeded
    761-bit e; the inverse (mont_inv's plain version, Fermat) against the
    JAX package's inv; and the word model of mont_inv's batched binary GCD
    at NW = 24 against pow on the edge words and 4 random ones, its steps
    until a = 0 under the stated bound, itself at most 2 bits(p) <= 64 NW."""
    import importlib

    js = importlib.import_module(f"zkarray.curves.{curve}").FQ
    ts = importlib.import_module(f"zkarray_torch.curves.{curve}").FQ
    assert ts.num_limbs == js.num_limbs == 48 and interop_same(ts, js)
    p, R = ts.modulus, ts.r_int
    edge = mont_inv_edge_words(ts, np.random.default_rng(3), n_random=4)
    xs = [ts.from_mont_int(w) for w in edge]
    assert max(xs).bit_length() > 700  # the random words span the field
    ja, ta = both(js, xs)
    k = 16
    ii = np.arange(k * k)
    jx, tx = both(js, [xs[i % len(xs)] for i in ii // k])
    jy, ty = both(js, [xs[(3 * i + 1) % len(xs)] for i in ii % k])
    assert same(jfp.mont_mul(js, jx, jy), tkm.mont_mul_plain(ts, tx, ty))
    assert same(jfp.mont_sqr(js, ja), tkm.mont_sqr_plain(ts, ta))
    e761 = int.from_bytes(np.random.default_rng(12).bytes(96), "little") >> 7
    for e in (0, 1, 2, e761):
        got = tfp.pow_const(ts, ta, e)
        assert same(jfp.pow_const(js, ja, e), got), e
    assert same(jfp.inv(js, ja), tkm.mont_inv(ts, ta))  # CPU wrapper = Fermat plain version
    for w in edge:
        inv_w, iters = mont_inv_model(ts, w)
        assert inv_w == (pow(w * pow(R, -1, p), -1, p) * R % p if w else 0), w
        assert iters < mont_inv_iteration_bound(ts, w) <= 64 * (ts.num_limbs // 2), w


@pytest.mark.parametrize("curve", ["mnt4_298", "mnt6_298", "cp6_782"])
def test_l20_l52_field_kernels_plain_match_python_ints(curve):
    """The plain versions of the six field kernels at the widths this port
    added for MNT4/6-298 (L = 20, NW = 10) and CP6-782 (L = 52, NW = 26),
    against Python ints (no new XLA compile): mont_mul/mont_sqr on
    mont_inv_edge_words (every pair of 12), pow_const at e = 0, 1, 2 and
    p - 2, the inverse (mont_inv's plain version, Fermat) against pow,
    fp_add/fp_sub/fp_neg on fadd_edge_words (words >= p too: the sum keeps
    its carry out, the difference is taken modulo 2^(16 L)); and the word
    model of mont_inv's batched binary GCD, its steps until a = 0 under the
    stated bound, itself at most 2 bits(p) <= 64 NW."""
    import importlib

    from zkarray_torch.core.limbs import ints_to_limbs_np, limbs_to_ints

    ts = importlib.import_module(f"zkarray_torch.curves.{curve}").FQ
    assert ts.num_limbs == (52 if curve == "cp6_782" else 20)
    p, R, L = ts.modulus, ts.r_int, ts.num_limbs
    rinv = pow(R, -1, p)
    edge = mont_inv_edge_words(ts, np.random.default_rng(len(curve)), n_random=4)
    w = torch.from_numpy(ints_to_limbs_np(edge, L).astype(np.int32))
    k = min(12, len(edge))
    ii = torch.arange(k * k)
    x, y = w[:, ii // k], w[:, ii % k]
    vals = lambda t: limbs_to_ints(t)  # noqa: E731
    assert vals(tkm.mont_mul_plain(ts, x, y)) == [a * b * rinv % p for a, b in zip(vals(x), vals(y))]
    assert vals(tkm.mont_sqr_plain(ts, w)) == [a * a * rinv % p for a in edge]
    for e in (0, 1, 2, p - 2):
        want = [pow(a * rinv, e, p) * R % p for a in edge]
        assert vals(tkm.mont_pow_plain(ts, w, e)) == want, e
    assert vals(tkm.mont_inv(ts, w)) == [pow(a * rinv, -1, p) * R % p if a else 0 for a in edge]
    for a in edge:
        inv_a, iters = mont_inv_model(ts, a)
        assert inv_a == (pow(a * rinv, -1, p) * R % p if a else 0), a
        assert iters < mont_inv_iteration_bound(ts, a) <= 64 * (L // 2), a
    aw = fadd_edge_words(ts, np.random.default_rng(3))
    xa = torch.from_numpy(ints_to_limbs_np(aw, L).astype(np.int32))
    ka = len(aw)
    ia = torch.arange(ka * ka)
    a_, b_ = xa[:, ia // ka], xa[:, ia % ka]
    av, bv = vals(a_), vals(b_)
    full = 1 << (16 * L)
    assert vals(tkm.fp_add(ts, a_, b_)) == [(u + v - p) % full if u + v >= p else u + v
                                            for u, v in zip(av, bv)]
    assert vals(tkm.fp_sub(ts, a_, b_)) == [(u - v) % full if u >= v else (u - v + p) % full
                                            for u, v in zip(av, bv)]
    assert vals(tkm.fp_neg(ts, xa)) == [(-u + p) % full if u else 0 for u in aw]


def test_field_kernel_widths():
    """The six field kernels are built at NW = 8, 10, 12, 24 and 26
    (csrc/field.cuh:ZK_DISPATCH_NW_FIELD, mont.cu once per width group) and
    every other width raises before a launch; the XYZZ and MSM kernels keep
    NW = 8 and 12 (ZK_DISPATCH_NW); the NTT and twiddle kernels take
    NW = 8, 10, 12 and 24 from two width groups each."""
    import re
    from pathlib import Path

    from zkarray_torch.kernels import _build

    assert {nw: _build.field_lib(nw) for nw in (8, 10, 12, 24, 26)} == {
        8: "mont", 10: "mont", 12: "mont", 24: "mont_w24", 26: "mont_w26"}
    for nw in (0, 6, 9, 11, 16, 20, 25, 27, 32):
        with pytest.raises(ValueError):
            _build.field_lib(nw)
    for lib in ("mont", "mont_w24", "mont_w26"):
        assert _build.source_of(lib)[0] == "mont" and lib in _build.SOURCES
        assert _build.EXPORTS[lib] == _build.EXPORTS["mont"]
    src = (Path(_build.CSRC) / "field.cuh").read_text()
    body = src[src.index("#define ZK_DISPATCH_NW(nw"):src.index("#ifndef ZK_FIELD_WIDTHS")]
    assert sorted(map(int, re.findall(r"case (\d+):", body))) == [8, 12]
    field = src[src.index("#ifndef ZK_FIELD_WIDTHS"):src.index("#define ZK_DISPATCH_NW_FIELD")]
    assert sorted(map(int, re.findall(r"ZK_NW_CASE\((\d+),", field))) == [8, 10, 12, 24, 26]
    for name in ("sw", "xyzz", "madd"):
        assert "ZK_DISPATCH_NW_FIELD" not in (Path(_build.CSRC) / f"{name}.cu").read_text(), name
    for name in ("ntt", "twiddle"):  # the field widths but 26, from two width groups
        text = (Path(_build.CSRC) / f"{name}.cu").read_text()
        assert "ZK_DISPATCH_NW_FIELD(" in text and "ZK_DISPATCH_NW(" not in text, name
        assert {nw: _build.ntt_lib(name, nw) for nw in (8, 10, 12, 24)} == {
            8: name, 10: name, 12: name, 24: f"{name}_w24"}
        for lib in (name, f"{name}_w24"):
            assert lib in _build.SOURCES and _build.EXPORTS[lib] == _build.EXPORTS[name]
        with pytest.raises(ValueError):
            _build.ntt_lib(name, 26)


def interop_same(ts, js):
    from zkarray_torch import interop

    return interop.same_field(ts, js.modulus, js.generator_int, js.r_int, js.r2_int, js.inv16)


def test_plain_mont_kernels_match_pallas_interpret():
    js, ts = jcurves.FR, tcurves.FR
    p = js.modulus
    xs, ys = rand_ints(p, 700, 7), rand_ints(p, 700, 8)
    ja, ta = both(js, xs)
    jb, tb = both(js, ys)
    got = tkm.mont_mul_plain(ts, ta, tb)
    assert same(jkm.mont_mul(js, ja, jb), got)
    assert same(jkm.mont_mul(js, ja, jb), tkm.mont_mul(ts, ta, tb))  # CPU wrapper = plain
    zs = rand_ints(p, 513, 9)
    jz, tz = both(js, zs)
    assert same(jkm.mont_sqr(js, jz), tkm.mont_sqr_plain(ts, tz))


# (JAX spec, port spec) of the six fields of the group path
J25519 = JFieldSpec(2**255 - 19, generator=2, name="curve25519.fq")
ROOT_FIELDS = {
    "bn254-Fr": (jbn254.FR, tbn254.FR), "bn254-Fq": (jbn254.FQ, tbn254.FQ),
    "bls12_381-Fr": (jcurves.FR, tcurves.FR), "bls12_381-Fq": (jcurves.FQ, tcurves.FQ),
    "bls12_377-Fq": (jbls377.FQ, tbls377.FQ), "2^255-19": (J25519, port_field(J25519)),
}
JAX_COMPILED = ("bn254-Fr", "bn254-Fq", "bls12_381-Fr", "bls12_381-Fq")  # tests/test_fp.py's


def mont_words(ts, vals):
    """Expected Montgomery words of canonical ints, as a CPU limb tensor."""
    return tfp.from_ints(ts, vals, device="cpu")


def root_inputs(p):
    """tests/test_fp.py:test_legendre_sqrt's 18 inputs: 0, 1, eight squares,
    eight random elements."""
    rng = random.Random(7)
    sq = [pow(rng.randrange(1, p), 2, p) for _ in range(8)]
    return [0, 1] + sq + [rng.randrange(p) for _ in range(8)]


@pytest.mark.parametrize("name", list(ROOT_FIELDS))
def test_legendre_and_sqrt_match_jax(name):
    """legendre and all three sqrt routes: the symbols, the roots' words and
    the is-square masks, against the JAX package where it is compiled and
    the host model everywhere; non-squares give root 0."""
    js, ts = ROOT_FIELDS[name]
    p = ts.modulus
    xs = root_inputs(p)
    ja, ta = both(js, xs)
    leg = tfp.legendre(ts, ta)
    root, ok = tfp.sqrt(ts, ta)
    want_leg = [0 if x == 0 else (1 if pow(x, (p - 1) // 2, p) == 1 else -1) for x in xs]
    assert leg.dtype == torch.int32 and leg.tolist() == want_leg
    assert ok.tolist() == [v >= 0 for v in want_leg]
    assert torch.equal(root, mont_words(ts, [sqrt_reference(ts, x) for x in xs]))
    if name in JAX_COMPILED or name == "2^255-19":
        jroot, jok = jfp.sqrt(js, ja)
        assert same(jroot, root) and np.array_equal(np.asarray(jok), ok.numpy())
    if name in JAX_COMPILED:
        assert np.array_equal(np.asarray(jfp.legendre(js, ja)), leg.numpy())


@pytest.mark.parametrize("name", list(ROOT_FIELDS))
def test_is_one_pow_u32_and_pow2k_match_oracle(name):
    """is_one; pow_u32 with per-element exponents (0, 1, 2^32 - 1, random)
    and with one broadcast exponent; pow2k at k = 0, 1, 5 and s - 1 (the
    longest Tonelli-Shanks chain)."""
    _, ts = ROOT_FIELDS[name]
    p = ts.modulus
    xs = root_inputs(p)
    ta = mont_words(ts, xs)
    assert tfp.is_one(ts, ta).tolist() == [x == 1 for x in xs]
    rng = np.random.default_rng(3)
    es = [0, 1, (1 << 32) - 1] + [int(e) for e in rng.integers(0, 1 << 32, size=len(xs) - 3)]
    got = tfp.pow_u32(ts, ta, torch.tensor(es, dtype=torch.int64))
    assert torch.equal(got, mont_words(ts, [pow(x, e, p) for x, e in zip(xs, es)]))
    got = tfp.pow_u32(ts, ta, 77)
    assert torch.equal(got, mont_words(ts, [pow(x, 77, p) for x in xs]))
    for k in sorted({0, 1, 5, max(ts.two_adicity - 1, 0)}):
        got = tfp.pow2k(ts, ta, k)
        assert torch.equal(got, mont_words(ts, [pow(x, 1 << k, p) for x in xs])), k


SUM_FIELDS = {  # name: (JAX spec, port spec, n); JAX compiled at n = 23 by tests/test_fp.py
    "bn254-Fr": (jbn254.FR, tbn254.FR, 23),  # k_lazy = 4
    "bls12_381-Fq": (jcurves.FQ, tcurves.FQ, 23),  # k_lazy = 8
    "secp256k1-Fq": (JFieldSpec(2**256 - 2**32 - 977, generator=3, name="secp256k1.Fq"), None, 23),
    "bn254-Fq": (None, tbn254.FQ, 23),  # k_lazy = 4
    "bls12_381-Fr": (None, tcurves.FR, 23),  # k_lazy = 1: the per-product route
    "bls12_377-Fq": (None, tbls377.FQ, 2 * 151 + 9),  # k_lazy = 151, three chunks
}


@pytest.mark.parametrize("name", list(SUM_FIELDS))
def test_sum_of_products_and_tree_sum_match_jax(name):
    """sum_of_products on both routes (lazy columns, and per-product below
    k_lazy = 2) and tree_sum, against the JAX package at its compiled shapes
    and Python ints everywhere; along axis 1 too."""
    js, ts, n = SUM_FIELDS[name]
    ts = ts or port_field(js)
    p = ts.modulus
    xs, ys = rand_ints(p, n, 8), rand_ints(p, n, 9)
    ta, tb = mont_words(ts, xs), mont_words(ts, ys)
    got = tfp.sum_of_products(ts, ta, tb, axis=0)
    assert torch.equal(got, mont_words(ts, [sum(x * y for x, y in zip(xs, ys)) % p])[:, 0])
    got2 = tfp.tree_sum(ts, ta, axis=0)
    assert torch.equal(got2, mont_words(ts, [sum(xs) % p])[:, 0])
    if js is not None:
        ja, jb = jfp.from_ints(js, xs), jfp.from_ints(js, ys)
        assert same(jfp.sum_of_products(js, ja, jb, axis=0), got)
        assert same(jfp.tree_sum(js, ja, axis=0), got2)
    L = ts.num_limbs
    a3, b3 = ta[:, : 3 * (n // 3)].reshape(L, 3, -1), tb[:, : 3 * (n // 3)].reshape(L, 3, -1)
    rows_x = [xs[i * (n // 3) : (i + 1) * (n // 3)] for i in range(3)]
    rows_y = [ys[i * (n // 3) : (i + 1) * (n // 3)] for i in range(3)]
    assert torch.equal(tfp.sum_of_products(ts, a3, b3, axis=1), mont_words(
        ts, [sum(x * y for x, y in zip(rx, ry)) % p for rx, ry in zip(rows_x, rows_y)]))
    assert torch.equal(tfp.tree_sum(ts, a3, axis=1), mont_words(ts, [sum(r) % p for r in rows_x]))


def test_tree_sum_over_two_chunks_matches_oracle():
    """tree_sum of 2^14 + 3 elements: two lazy chunks, then a second level."""
    ts = tbn254.FR
    p = ts.modulus
    rng = np.random.default_rng(12)
    xs = [p - 1 - int(v) for v in rng.integers(0, 1 << 20, size=(1 << 14) + 3)]
    assert torch.equal(tfp.tree_sum(ts, mont_words(ts, xs)),
                       mont_words(ts, [sum(xs) % p])[:, 0])


def test_limb_helpers_match_jax_and_oracle():
    """core/limbs.py: the host conversions against the JAX package's, and
    geq, select, bit and num_bits_total against Python ints; zeros defaults
    to the package's device."""
    from zkarray.core import limbs as jlb
    from zkarray_torch import DEFAULT_DEVICE
    from zkarray_torch.core import limbs as tlb

    rng = np.random.default_rng(4)
    xs = [0, 1, 2, (1 << 16) - 1, 1 << 16, (1 << 255) - 19, (1 << 256) - 1] + [
        int.from_bytes(rng.bytes(int(k)), "little") for k in rng.integers(1, 33, size=9)]
    for x in xs:
        assert np.array_equal(tlb.int_to_limbs_np(x, 16), jlb.int_to_limbs_np(x, 16))
        assert tlb.limbs_to_int(jlb.int_to_limbs_np(x, 16)) == jlb.limbs_to_int(
            jlb.int_to_limbs_np(x, 16)) == x
    with pytest.raises(ValueError):
        tlb.int_to_limbs_np(1 << 256, 16)
    with pytest.raises(ValueError):
        tlb.int_to_limbs_np(-1, 16)
    a = torch.from_numpy(tlb.ints_to_limbs_np(xs, 16).astype(np.int32))
    b = torch.from_numpy(tlb.ints_to_limbs_np(xs[::-1], 16).astype(np.int32))
    assert tlb.limbs_to_ints(a) == jlb.limbs_to_ints(np.asarray(a).astype(np.uint32)) == xs
    assert tlb.geq(a, b).tolist() == [x >= y for x, y in zip(xs, xs[::-1])]
    m = torch.tensor([x % 3 == 0 for x in xs])
    assert tlb.limbs_to_ints(tlb.select(m, a, b)) == [
        x if x % 3 == 0 else y for x, y in zip(xs, xs[::-1])]
    for i in (0, 15, 16, 100, 255):
        assert tlb.bit(a, i).tolist() == [(x >> i) & 1 for x in xs]
    assert tlb.num_bits_total(a).tolist() == [x.bit_length() for x in xs]
    assert tlb.num_bits_total(a).dtype == torch.int32
    assert tlb.zeros.__defaults__ == ((), DEFAULT_DEVICE)
    assert tlb.zeros(4, (2,), "cpu").shape == (4, 2)


@pytest.mark.parametrize("n", [1, 3, 25, 61])
def test_carry_helpers_match_python_ints(n):
    """core/limbs.py's carry lookahead at n limbs against Python ints:
    normalize on nonnegative int64 columns up to 2^62 (the final carry
    dropped), add_with_carry and sub_with_borrow on 16-bit limbs whose
    carries and borrows run across every limb (all-ones, zero, single-limb
    edges, random); more than 61 limbs raises."""
    from zkarray_torch.core import limbs as tlb

    rng = np.random.default_rng(40 + n)
    M = (1 << 16) - 1

    def value(cols):
        return [sum(int(c) << (16 * i) for i, c in enumerate(col)) for col in cols.T.tolist()]

    def ints(limbs):
        return [sum(int(v) << (16 * i) for i, v in enumerate(col)) for col in limbs.T.tolist()]

    cols = np.concatenate([rng.integers(0, 1 << 62, size=(n, 8), dtype=np.int64),
                           rng.integers(0, 1 << 17, size=(n, 8), dtype=np.int64),
                           np.full((n, 1), M, np.int64), np.full((n, 1), 1 << 16, np.int64)], 1)
    out = tlb.normalize(torch.from_numpy(cols), n)
    assert ints(out.numpy()) == [v % (1 << (16 * n)) for v in value(cols)]
    low, top = tlb.normalize(torch.from_numpy(cols), n, carry_out=True)  # the carry kept
    assert torch.equal(low, out)
    assert [v + (t << (16 * n)) for v, t in zip(ints(low.numpy()), top.tolist())] == value(cols)
    if n + 4 <= 61:  # room for every carry: the whole value
        assert ints(tlb.normalize(torch.from_numpy(cols), n + 4).numpy()) == value(cols)
    edge = [0, 1, M, 1 << (16 * n) - 1, (1 << (16 * n)) - 1, (1 << (16 * n)) - 2]
    edge += [M << (16 * k) for k in range(n)] + [1 << (16 * k) for k in range(n)]
    edge += [int.from_bytes(rng.bytes(2 * n), "little") for _ in range(8)]
    k = len(edge)
    limbs = torch.from_numpy(tlb.ints_to_limbs_np(edge, n).astype(np.int64))
    a, b = limbs[:, np.arange(k * k) // k], limbs[:, np.arange(k * k) % k]
    xa, xb = ints(a.numpy()), ints(b.numpy())
    s, c = tlb.add_with_carry(a, b)
    assert ints(s.numpy()) == [(x + y) % (1 << (16 * n)) for x, y in zip(xa, xb)]
    assert c.tolist() == [(x + y) >> (16 * n) for x, y in zip(xa, xb)]
    d, borrow = tlb.sub_with_borrow(a, b)
    assert ints(d.numpy()) == [(x - y) % (1 << (16 * n)) for x, y in zip(xa, xb)]
    assert borrow.tolist() == [y > x for x, y in zip(xa, xb)]
    with pytest.raises(ValueError):
        tlb.sub_with_borrow(torch.zeros(62, 1), torch.zeros(62, 1))
