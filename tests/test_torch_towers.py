"""Port parity for the tower layer (ff/towers.py, ff/sparse12.py,
ff/cyclotomic.py): BLS12-381 Fq2/Fq6/Fq12 products, squares, inverses
(zero included), Frobenius at every power, conjugation and the linear ops;
quad_sqrt on squares, non-squares and a1 = 0; the Granger-Scott square on a
cyclotomic element; the sparse line products mul_by_014/mul_by_034; all
against zkarray.ff's functions at shapes tests/test_towers.py uses, bit for
bit. The power ladders (whose JAX counterparts are slow-tier scans) against
the host's HostExt.pow. BLS12-377's towers against their host model."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import nest, rand_host  # noqa: E402
from torch_parity import tower_both as both  # noqa: E402
from zkarray.curves import bls12_381 as jb  # noqa: E402
from zkarray.ff import cyclotomic as jcyc  # noqa: E402
from zkarray.ff import sparse12 as jsp  # noqa: E402
from zkarray.ff.towers import quad_sqrt as jquad_sqrt  # noqa: E402
from zkarray_torch.curves import bls12_377 as t377  # noqa: E402
from zkarray_torch.curves import bls12_381 as tb  # noqa: E402
from zkarray_torch.ff import cyclotomic as tcyc  # noqa: E402
from zkarray_torch.ff import sparse12 as tsp  # noqa: E402
from zkarray_torch.ff.towers import quad_sqrt as tquad_sqrt  # noqa: E402
from zkarray_torch.interop import limbs_to_numpy  # noqa: E402

TOWERS = [(jb.FQ2, tb.FQ2), (jb.FQ6, tb.FQ6), (jb.FQ12, tb.FQ12)]


def same(j, t):
    return np.array_equal(np.asarray(j), limbs_to_numpy(t))


@pytest.mark.parametrize("k", range(3), ids=["Fq2", "Fq6", "Fq12"])
def test_tower_ops_match_jax(k):
    J, T = TOWERS[k]
    rng = random.Random(100 + k)
    xs = [J.host.zero()] + [rand_host(J.host, rng) for _ in range(3)]
    ys = [rand_host(J.host, rng) for _ in range(4)]
    ja, ta = both(J, xs)
    jc, tc = both(J, ys)
    assert T.host.flatten(xs[1]) == J.host.flatten(xs[1]) and T.shape == J.shape
    assert same(J.mul(ja, jc), T.mul(ta, tc))
    assert same(J.sqr(ja), T.sqr(ta))
    assert same(J.inv(ja), T.inv(ta))  # lane 0 is zero: inv(0) = 0
    assert same(J.add(ja, jc), T.add(ta, tc))
    assert same(J.sub(ja, jc), T.sub(ta, tc))
    assert same(J.neg(ja), T.neg(ta))
    assert same(J.double(jc), T.double(tc))
    mask = np.asarray([True, False, True, False])
    assert same(J.select(mask, ja, jc), T.select(torch.from_numpy(mask), ta, tc))
    assert np.array_equal(np.asarray(J.is_zero(ja)), T.is_zero(ta).numpy())
    assert np.array_equal(np.asarray(J.eq(ja, ja)), T.eq(ta, ta).numpy())
    for i in range(J.deg_abs):
        assert same(J.frobenius(ja, i), T.frobenius(ta, i)), i
    if J.deg == 2:
        assert same(J.conjugate(ja), T.conjugate(ta))
    # a ()-batch constant times an (n,)-batch element stays (n,)
    c = T.const(ys[0], (), "cpu")
    got = T.mul(c, ta)
    assert T.batch_shape_of(got) == (4,)
    assert same(J.mul(J.const(ys[0], ()), ja), got)


def test_quad_sqrt_matches_jax():
    """Squares, non-squares, a1 = 0 (a0 square and not) and zero."""
    rng = random.Random(7)
    F2h = jb.FQ2.host
    p = jb.FQ.modulus
    sq = [F2h.mul(x, x) for x in (rand_host(F2h, rng) for _ in range(3))]
    elems = sq + [rand_host(F2h, rng) for _ in range(3)] + [(4, 0), (p - 4, 0), (0, 0), (3, 0)]
    ja, ta = both(jb.FQ2, elems)
    jr, jok = jquad_sqrt(jb.FQ2, ja)
    tr, tok = tquad_sqrt(tb.FQ2, ta)
    assert same(jr, tr) and np.array_equal(np.asarray(jok), tok.numpy())
    assert tok[:3].all() and tok[6:9].all()


def test_cyclotomic_square_and_ladders():
    """gs_cyclotomic_sqr on a cyclotomic element against the JAX package's;
    cyclotomic_exp (NAF, negative digits), cyclotomic_exp_binary and
    fp12_pow_const against HostExt.pow."""
    from zkarray_torch.ec.pairing.bls12 import fp12_pow_const

    rng = random.Random(3)
    F12h = jb.FQ12.host
    p = jb.FQ.modulus
    g = rand_host(F12h, rng)
    # the easy part's exponent (p^6 - 1)(p^2 + 1), by Frobenius and one inverse
    t = F12h.mul(F12h.frobenius(g, 6), F12h.inv(g))
    cyc_elem = F12h.mul(F12h.frobenius(t, 2), t)
    jf, tf = both(jb.FQ12, [cyc_elem, g])
    assert same(jcyc.gs_cyclotomic_sqr(jb.FQ12, jf), tcyc.gs_cyclotomic_sqr(tb.FQ12, tf))
    assert tb.FQ12.eq(tcyc.gs_cyclotomic_sqr(tb.FQ12, tf), tb.FQ12.sqr(tf)).tolist() == [True, False]
    c = tf[..., :1]  # the cyclotomic element
    e = 0b1011101110001  # NAF digits of both signs
    want = both(jb.FQ12, [F12h.pow(cyc_elem, e)])[1]
    assert torch.equal(tcyc.cyclotomic_exp(tb.FQ12, c, e), want)
    assert torch.equal(tcyc.cyclotomic_exp_binary(tb.FQ12, c, e), want)
    assert torch.equal(fp12_pow_const(tb.FQ12, tf, 5),
                       both(jb.FQ12, [F12h.pow(x, 5) for x in (cyc_elem, g)])[1])
    assert torch.equal(tcyc.cyclotomic_exp(tb.FQ12, c, 0), tb.FQ12.one((1,), "cpu"))
    assert tcyc.find_naf(e) == jcyc.find_naf(e)
    assert tcyc.char_sq_mod_6_is_one(p)


def test_sparse_line_products_match_jax():
    """fp12_mul_by_014 (M-twist lines) and fp12_mul_by_034 (D-twist) with
    the sparse Fp6 products inside them, against the JAX package's."""
    rng = random.Random(5)
    F2h, F12h = jb.FQ2.host, jb.FQ12.host
    jf, tf = both(jb.FQ12, [rand_host(F12h, rng) for _ in range(2)])
    cs = [both(jb.FQ2, [rand_host(F2h, rng) for _ in range(2)]) for _ in range(3)]
    jc, tc = [c[0] for c in cs], [c[1] for c in cs]
    assert same(jsp.fp12_mul_by_014(jb.FQ12, jf, *jc), tsp.fp12_mul_by_014(tb.FQ12, tf, *tc))
    assert same(jsp.fp12_mul_by_034(jb.FQ12, jf, *jc), tsp.fp12_mul_by_034(tb.FQ12, tf, *tc))
    ja6, ta6 = jf[0], tf[0]
    assert same(jsp.fp6_mul_by_01(jb.FQ6, ja6, jc[0], jc[1]), tsp.fp6_mul_by_01(tb.FQ6, ta6, tc[0], tc[1]))
    assert same(jsp.fp6_mul_by_1(jb.FQ6, ja6, jc[2]), tsp.fp6_mul_by_1(tb.FQ6, ta6, tc[2]))
    assert same(jsp.fp6_mul_by_fp2(jb.FQ6, ja6, jc[0]), tsp.fp6_mul_by_fp2(tb.FQ6, ta6, tc[0]))


def test_bls12_377_towers_match_host():
    """BLS12-377's towers (beta = -5, Fq6 by u): products, squares,
    inverses and Frobenius against the host model."""
    rng = random.Random(9)
    for T in (t377.FQ2, t377.FQ6, t377.FQ12):
        xs = [rand_host(T.host, rng) for _ in range(2)]
        ys = [rand_host(T.host, rng) for _ in range(2)]
        a = T.from_ints(nest(xs, T.host), "cpu")
        c = T.from_ints(nest(ys, T.host), "cpu")

        def want(es):
            return T.from_ints(nest(es, T.host), "cpu")

        assert torch.equal(T.mul(a, c), want([T.host.mul(x, y) for x, y in zip(xs, ys)]))
        assert torch.equal(T.sqr(a), want([T.host.mul(x, x) for x in xs]))
        assert torch.equal(T.mul(a, T.inv(a)), T.one((2,), "cpu"))
        assert torch.equal(T.frobenius(a, 1), want([T.host.frobenius(x, 1) for x in xs]))
