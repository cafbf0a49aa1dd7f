"""Port parity: zkarray_torch.ec.double_odd and the zoo's jq255s against the
JAX package, word for word ((E : Z : U : T) projective words included), and
against an independent host model of the group (the curve
y^2 = x (x^2 + a x + b)'s own affine law, zkarray_torch/testing.py:
do_mul_host).

Every JAX call runs at 8 lanes, tests/test_double_odd.py's shape. On the
CPU every field operation is its kernel's plain version."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from zkarray.curves import zoo as jzoo  # noqa: E402
from zkarray.ec import double_odd as jdo  # noqa: E402
from zkarray.ff import fp as jfp  # noqa: E402
from zkarray_torch import interop  # noqa: E402
from zkarray_torch.curves import zoo as tzoo  # noqa: E402
from zkarray_torch.ec import double_odd as tdo  # noqa: E402
from zkarray_torch.ff import fp as tfp  # noqa: E402
from zkarray_torch.interop import limbs_from_numpy, limbs_to_numpy  # noqa: E402
from zkarray_torch.testing import do_mul_host, do_same  # noqa: E402

JS, TS = jzoo.JQ255S, tzoo.JQ255S
N = 8


def _t(j):
    return limbs_from_numpy(np.asarray(j), "cpu")


def _same(jP, tP):
    assert len(jP) == len(tP)
    for j, t in zip(jP, tP):
        assert np.array_equal(np.asarray(j), limbs_to_numpy(t))


def _scalars():
    """8 lanes: 0, 1, 2, r - 1, the raw limbs of r itself (r G = O), and
    three random values below r."""
    r = TS.scalar.modulus
    rng = np.random.default_rng(11)
    ks = [0, 1, 2, r - 1, r] + [int.from_bytes(rng.bytes(32), "little") % r for _ in range(3)]
    L = TS.scalar.num_limbs
    limbs = np.asarray([[(k >> (16 * i)) & 0xFFFF for k in ks] for i in range(L)], dtype=np.uint32)
    return ks, limbs


@pytest.fixture(scope="module")
def ladders():
    """The JAX package's and the port's scalar_mul of the generator."""
    ks, limbs = _scalars()
    jP = jdo.scalar_mul(JS, JS.generator((N,)), limbs)
    tP = tdo.scalar_mul(TS, TS.generator((N,), device="cpu"), _t(limbs))
    return ks, jP, tP


def test_jq255s_constants_match_jax():
    assert (TS.name, TS.c_int, TS.cofactor_inv) == (JS.name, JS.c_int, JS.cofactor_inv)
    assert interop.same_do_curve(TS, JS.a_int, JS.b_int, JS.gen_e, JS.gen_u, JS.cofactor)
    for jf, tf in ((JS.base, TS.base), (JS.scalar, TS.scalar)):
        assert interop.same_field(tf, jf.modulus, jf.generator_int, jf.r_int, jf.r2_int, jf.inv16)
    assert not interop.same_do_curve(TS, JS.a_int, JS.b_int + 1, JS.gen_e, JS.gen_u, JS.cofactor)


def test_scalar_mul_matches_jax_and_host(ladders):
    ks, jP, tP = ladders
    _same(jP, tP)
    assert tdo.is_zero(TS, tP).tolist() == [True, False, False, False, True, False, False, False]
    A = tdo.to_affine(TS, tP)
    _same(jdo.to_affine(JS, jP), A)
    assert tdo.is_on_curve(TS, A).all()
    g = (TS.gen_e, TS.gen_u)
    for eu, k in zip(TS.affine_to_ints(A), ks):
        assert do_same(TS, eu, do_mul_host(TS, g, k % TS.scalar.modulus)), k


def test_group_law_matches_jax(ladders):
    """double, add (identities included: complete formulas), add_mixed,
    neg, eq_points and is_zero, projective words equal."""
    _, jP, tP = ladders
    jQ, tQ = jdo.double(JS, jP), tdo.double(TS, tP)
    _same(jQ, tQ)
    jR, tR = jdo.add(JS, jP, jQ), tdo.add(TS, tP, tQ)
    _same(jR, tR)
    # the JAX package's points carried across add to the same words
    tQc = interop.do_projective_from_numpy([np.asarray(v) for v in jQ], "cpu")
    for j, t in zip(jR, interop.do_projective_to_numpy(tdo.add(TS, tP, tQc))):
        assert np.array_equal(np.asarray(j), t)
    jO, tO = jdo.zero(JS, (N,)), tdo.zero(TS, (N,), "cpu")
    _same(jO, tO)
    _same(jdo.add(JS, jO, jP), tdo.add(TS, tO, tP))
    _same(jdo.add(JS, jP, jdo.neg(JS, jP)), tdo.add(TS, tP, tdo.neg(TS, tP)))
    assert tdo.is_zero(TS, tdo.add(TS, tP, tdo.neg(TS, tP))).all()
    jA, tA = jdo.to_affine(JS, jQ), tdo.to_affine(TS, tQ)
    _same(jA, tA)
    _same(jdo.add(JS, jP, jdo.from_affine(JS, jA)), tdo.add_mixed(TS, tP, tA))
    assert tdo.eq_points(TS, tdo.add_mixed(TS, tP, tA), tR).all()
    _same(jdo.neg_affine(JS, jA), tdo.neg_affine(TS, tA))
    want = np.asarray(jdo.eq_points(JS, jR, jdo.add(JS, jQ, jP))).tolist()
    assert tdo.eq_points(TS, tR, tdo.add(TS, tQ, tP)).tolist() == want == [True] * N
    assert not tdo.eq_points(TS, tP, tQ)[[1, 2, 3, 5, 6, 7]].any()


@pytest.mark.parametrize("k", [5, -6])
def test_scalar_mul_const_matches_jax_ladder(ladders, k):
    """scalar_mul_const against the JAX package's double and add stepped
    over k's bits on the host (its select keeps the doubling at a clear
    bit); negative k negates."""
    _, jP, tP = ladders
    acc = jdo.zero(JS, (N,))
    for bit in bin(abs(k))[2:]:
        acc = jdo.double(JS, acc)
        if bit == "1":
            acc = jdo.add(JS, acc, jP)
    if k < 0:
        acc = jdo.neg(JS, acc)
    _same(acc, tdo.scalar_mul_const(TS, tP, k))
    _same(tdo.zero(TS, (N,), "cpu"), tdo.scalar_mul_const(TS, tP, 0))


def test_get_e_from_u_matches_jax(ladders):
    """The root and the ok mask on 8 lanes: the ladder's u (ok, e = +-the
    point's e; the identities' u = 0) with two lanes replaced by u whose
    c u^4 - 2a u^2 + 1 is no square."""
    _, jP, _ = ladders
    A = jdo.to_affine(JS, jP)
    p = TS.base.modulus
    us = [int(v) for v in jfp.to_ints(JS.base, A.u)]
    bad = [u for u in range(2, 200)
           if pow((TS.c_int * u ** 4 - 2 * TS.a_int * u * u + 1) % p, (p - 1) // 2, p) == p - 1]
    us[6], us[7] = bad[:2]
    ju = jfp.from_ints(JS.base, us)
    je, jok = jdo.get_e_from_u(JS, ju)
    te, tok = tdo.get_e_from_u(TS, _t(ju))
    _same((je,), (te,))
    assert tok.tolist() == np.asarray(jok).tolist() == [True] * 6 + [False] * 2
    es = tfp.to_ints(TS.base, te)
    for i, (e, _) in enumerate(TS.affine_to_ints(tdo.to_affine(TS, tdo.DOProjective(*(
            _t(v) for v in jP))))[:6]):
        assert es[i] in (e, (-e) % p)
