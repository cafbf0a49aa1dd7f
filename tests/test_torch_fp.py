"""Port parity: zkarray_torch.ff.fp against zkarray.ff.fp, bit for bit
(tolerance zero: a wrong limb is a wrong field element), on BLS12-381 Fq and
Fr; and the plain versions of the port's mont_mul/mont_sqr kernels against
the Pallas kernels of zkarray.kernels.mont in interpret mode.

Widths are the ones tests/test_fp.py and tests/test_kernels.py compile: 64
for the element-wise ops, 16 for Fermat inv, 70 with zeros for batch_inv,
700 and 513 at L = 16 for the kernels. The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py.

The field inverse's CUDA kernel (csrc/mont.cu:mont_inv_kernel, a binary GCD)
cannot run here; zkarray_torch/testing.py:mont_inv_model follows its loop
word by word, and is held against Python's pow and the JAX package's inv on
the edge words (0, 1, R mod p, p - 1, powers of two) and random ones, with
its iteration count under its stated bound."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import FIELD_IDS, FIELDS, both, port_field, rand_ints, same  # noqa: E402
from zkarray.curves import bls12_381 as jcurves  # noqa: E402
from zkarray.curves import bn254 as jbn254  # noqa: E402
from zkarray.ff import fp as jfp  # noqa: E402
from zkarray.kernels import mont as jkm  # noqa: E402
from zkarray_torch.curves import bls12_381 as tcurves  # noqa: E402
from zkarray_torch.ff import fp as tfp  # noqa: E402
from zkarray_torch.kernels import mont as tkm  # noqa: E402
from zkarray_torch.testing import (  # noqa: E402
    mont_inv_edge_words, mont_inv_iteration_bound, mont_inv_model)

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
    """The word model of the mont_inv kernel's binary GCD against
    pow(a, -1, p)·R mod p and the JAX package's inv (Fermat) on the 16 edge
    words, against pow on 24 random words, and its iterations under the
    stated bound; the mont_inv wrapper (its plain version on the CPU) against
    the JAX package too."""
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
