"""Port parity: zkarray_torch.poly.{sparse,dense,mle} and Radix2Domain's
vanishing and filter polynomials against the JAX package, word for word.

Every call runs the JAX function and the port's on the same inputs, at the
shapes tests/test_poly.py and test_domain_extras.py compile (BN254 Fr), so
the JAX side hits the shared XLA cache. On the CPU every product, sum and
difference is the plain version of its field kernel, and ``dense.mul``'s
transforms run the plain butterfly_dit, pow_table and twiddle_mul."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from torch_parity import both, same  # noqa: E402
from zkarray.curves import bn254 as jbn  # noqa: E402
from zkarray.ff import fp as jfp  # noqa: E402
from zkarray.poly import dense as jdense  # noqa: E402
from zkarray.poly import domain as jdm  # noqa: E402
from zkarray.poly import mle as jmle  # noqa: E402
from zkarray.poly import sparse as jsparse  # noqa: E402
from zkarray_torch.curves import bn254 as tbn  # noqa: E402
from zkarray_torch.ff import fp as tfp  # noqa: E402
from zkarray_torch.interop import limbs_from_numpy, sparse_mv_from_numpy, sparse_uv_from_numpy  # noqa: E402
from zkarray_torch.poly import dense, mle, sparse  # noqa: E402
from zkarray_torch.poly import domain as tdm  # noqa: E402

JS, TS = jbn.FR, tbn.FR
P = JS.modulus


def poly_eval(cs, x):
    acc = 0
    for c in reversed(cs):
        acc = (acc * x + c) % P
    return acc


def test_dense_evaluate_and_ring_ops():
    rng = random.Random(0)
    cs = [rng.randrange(P) for _ in range(37)]
    taus = [0, 1, rng.randrange(P), rng.randrange(P)]
    (jc, tc), (jt, tt) = both(JS, cs), both(JS, taus)
    got = dense.evaluate(TS, tc, tt)
    assert same(jdense.evaluate(JS, jc, jt), got)
    assert tfp.to_ints(TS, got) == [poly_eval(cs, t) for t in taus]
    assert dense.degree(TS, tc) == jdense.degree(JS, jc) == 36
    short = tc[:, :20]
    for jr, tr in ((jdense.add(JS, jc, jc[:, :20]), dense.add(TS, tc, short)),
                   (jdense.sub(JS, jc[:, :20], jc), dense.sub(TS, short, tc)),
                   (jdense.neg(JS, jc), dense.neg(TS, tc)),
                   (jdense.scale(JS, jc, jt[:, 2]), dense.scale(TS, tc, tt[:, 2]))):
        assert same(jr, tr)


def test_dense_mul_naive_and_fft():
    rng = random.Random(1)
    for na, nb in ((7, 5), (20, 15)):  # target 11: schoolbook; 34: the fft route
        a = [rng.randrange(P) for _ in range(na)]
        b = [rng.randrange(P) for _ in range(nb)]
        (ja, ta), (jb, tb) = both(JS, a), both(JS, b)
        got = dense.mul(TS, ta, tb)
        assert same(jdense.mul(JS, ja, jb), got)
        want = [0] * (na + nb - 1)
        for i, x in enumerate(a):
            for j, y in enumerate(b):
                want[i + j] = (want[i + j] + x * y) % P
        assert tfp.to_ints(TS, got) == want
    assert same(jdense.naive_mul(JS, ja[:, :7], jb[:, :5]), dense.naive_mul(TS, ta[:, :7], tb[:, :5]))


def test_divide_by_vanishing_and_mul_by_vanishing():
    rng = random.Random(2)
    n = 8
    cs = [rng.randrange(P) for _ in range(29)]
    jc, tc = both(JS, cs)
    (jq, jr), (tq, tr) = jdense.divide_by_vanishing_poly(JS, jc, n), dense.divide_by_vanishing_poly(TS, tc, n)
    assert same(jq, tq) and same(jr, tr)
    qi, ri = tfp.to_ints(TS, tq), tfp.to_ints(TS, tr)
    x = rng.randrange(P)
    assert poly_eval(cs, x) == (poly_eval(qi, x) * (pow(x, n, P) - 1) + poly_eval(ri, x)) % P
    # a quotient of one stripe, and a dividend shorter than the domain
    for m in (12, 6):
        (jq, jr), (tq, tr) = (jdense.divide_by_vanishing_poly(JS, jc[:, :m], n),
                              dense.divide_by_vanishing_poly(TS, tc[:, :m], n))
        assert same(jq, tq) and same(jr, tr)
    assert same(jdense.mul_by_vanishing_poly(JS, jc, n), dense.mul_by_vanishing_poly(TS, tc, n))


@pytest.mark.parametrize("na,nb", [(13, 5), (3, 5)], ids=["deg12-by-deg4", "deg-a-below-deg-b"])
def test_long_division(na, nb):
    rng = random.Random(3)
    a = [rng.randrange(P) for _ in range(na)]
    b = [rng.randrange(P) for _ in range(nb)]
    (ja, ta), (jb, tb) = both(JS, a), both(JS, b)
    (jq, jr), (tq, tr) = jdense.divide_with_q_and_r(JS, ja, jb), dense.divide_with_q_and_r(TS, ta, tb)
    assert same(jq, tq) and same(jr, tr)
    qi, ri = tfp.to_ints(TS, tq), tfp.to_ints(TS, tr)
    x = rng.randrange(P)
    assert poly_eval(a, x) == (poly_eval(qi, x) * poly_eval(b, x) + poly_eval(ri, x)) % P
    if na < nb:
        assert qi == [0] and ri == a


def test_mle_fold_eval_and_table_ops():
    rng = random.Random(4)
    k = 4
    evals = [rng.randrange(P) for _ in range(1 << k)]
    pt = [rng.randrange(P) for _ in range(k)]
    (je, te), (jp, tp) = both(JS, evals), both(JS, pt)
    got = mle.evaluate(TS, te, tp)
    assert same(jmle.evaluate(JS, je, jp), got)
    want = 0
    for bidx, e in enumerate(evals):
        term = e
        for j in range(k):
            term = term * ((pt[j] if (bidx >> j) & 1 else 1 - pt[j]) % P) % P
        want = (want + term) % P
    assert tfp.to_ints(TS, got) == [want]
    assert same(jmle.fix_variables(JS, je, jp[:, :2]), mle.fix_variables(TS, te, tp[:, :2]))
    assert mle.num_vars(te) == jmle.num_vars(je) == k
    assert same(jmle.relabel(JS, je, 0, 2, 2), mle.relabel(TS, te, 0, 2, 2))
    assert same(jmle.concat(JS, [je, je[:, :3]]), mle.concat(TS, [te, te[:, :3]]))
    for jf, tf in ((jmle.add, mle.add), (jmle.sub, mle.sub), (jmle.mul, mle.mul)):
        assert same(jf(JS, je, je[:, ::-1]), tf(TS, te, te.flip(1)))


def test_eq_table_index_order():
    """Bit j of the index is x_j: a table built with the variables in the
    wrong order has the right values at the wrong (transposed) indices."""
    rng = random.Random(9)
    r = [rng.randrange(P) for _ in range(3)]
    jr, tr = both(JS, r)
    got = mle.eq_table(TS, tr)
    assert same(jmle.eq_table(JS, jr), got)
    vals = tfp.to_ints(TS, got)
    for x in range(8):
        want = 1
        for j in range(3):
            want = want * (r[j] if (x >> j) & 1 else 1 - r[j]) % P
        assert vals[x] == want, x
    assert vals[1] != vals[4]  # x = (1,0,0) and (0,0,1) differ


def test_sparse_mle():
    nv = 4
    entries = {0: 7, 3: 11, 9: 5, 14: 13}
    keys = sorted(entries)
    jd, td = both(JS, [entries.get(i, 0) for i in range(1 << nv)])
    jidx = jnp.asarray(np.asarray(keys, dtype=np.int32))
    tidx = torch.tensor(keys, dtype=torch.int64)
    jv, tv = both(JS, [entries[i] for i in keys])
    jr, tr = both(JS, [21, 34])
    jni, jnv = jmle.fix_variables_sparse(JS, jidx, jv, jr, 2)
    tni, tnv = mle.fix_variables_sparse(TS, tidx, tv, tr, 2)
    assert np.array_equal(np.asarray(jni), tni.numpy()) and same(jnv, tnv)
    got = mle.sparse_to_dense(TS, tni, tnv, nv - 2)
    assert same(jmle.sparse_to_dense(JS, jni, jnv, nv - 2), got)
    assert same(jmle.fix_variables(JS, jd, jr), got)
    jp, tp = both(JS, [3, 1, 4, 1])
    assert same(jmle.evaluate_sparse(JS, jidx, jv, jp), mle.evaluate_sparse(TS, tidx, tv, tp))


def _uv_both(terms):
    jd, jc = jsparse.uv_from_terms(JS, terms)
    return (jd, jc), sparse_uv_from_numpy(np.asarray(jd), np.asarray(jc), "cpu")


def _mv_both(terms):
    jp, jc = jsparse.mv_from_terms(JS, 3, terms)
    return (jp, jc), sparse_mv_from_numpy(np.asarray(jp), np.asarray(jc), "cpu")


def _same_terms(jt, tt):
    return np.array_equal(np.asarray(jt[0]).astype(np.int64), tt[0].numpy()) and same(jt[1], tt[1])


def test_sparse_univariate():
    rng = random.Random(5)
    terms = [(0, 5), (3, rng.randrange(P)), (100, rng.randrange(P))]
    ju, tu = _uv_both(terms)
    assert _same_terms(ju, sparse.uv_from_terms(TS, terms, "cpu"))
    taus = [2, rng.randrange(P)]
    jt, tt = both(JS, taus)
    got = sparse.uv_evaluate(TS, *tu, tt)
    assert same(jsparse.uv_evaluate(JS, *ju, jt), got)
    assert tfp.to_ints(TS, got) == [sum(c * pow(t, d, P) for d, c in terms) % P for t in taus]
    assert same(jsparse.uv_to_dense(JS, *ju), sparse.uv_to_dense(TS, *tu))
    # like terms combined, an exact cancellation dropped, a - a empty
    c3 = rng.randrange(1, P)
    ja, ta = _uv_both([(0, 5), (3, c3), (9, 11)])
    jb, tb = _uv_both([(3, P - c3), (4, 2), (9, 1)])
    s = sparse.uv_add(TS, ta, tb)
    assert _same_terms(jsparse.uv_add(JS, ja, jb), s) and s[0].tolist() == [0, 4, 9]
    assert _same_terms(jsparse.uv_sub(JS, ja, jb), sparse.uv_sub(TS, ta, tb))
    assert _same_terms(jsparse.uv_neg(JS, ja), sparse.uv_neg(TS, ta))
    assert sparse.uv_sub(TS, ta, ta)[0].shape[0] == 0


def test_sparse_multivariate():
    rng = random.Random(6)
    ta_terms = [(5, []), (2, [(0, 2), (2, 1)]), (7, [(1, 1)])]
    tb_terms = [(P - 7, [(1, 1)]), (3, [(0, 2), (2, 1)]), (1, [(2, 3)])]
    (ja, ta), (jb, tb) = _mv_both(ta_terms), _mv_both(tb_terms)
    assert _same_terms(ja, sparse.mv_from_terms(TS, 3, ta_terms, "cpu"))
    pt = [rng.randrange(P) for _ in range(3)]
    jp, tp = both(JS, pt)
    got = sparse.mv_evaluate(TS, *ta, tp)
    assert same(jsparse.mv_evaluate(JS, *ja, jp), got)
    assert tfp.to_ints(TS, got) == [(5 + 2 * pow(pt[0], 2, P) * pt[2] + 7 * pt[1]) % P]
    s = sparse.mv_add(TS, ta, tb)
    assert _same_terms(jsparse.mv_add(JS, ja, jb), s) and s[0].shape[0] == 3
    d = sparse.mv_sub(TS, ta, tb)
    assert _same_terms(jsparse.mv_sub(JS, ja, jb), d)
    assert same(jsparse.mv_evaluate(JS, *jsparse.mv_sub(JS, ja, jb), jp), sparse.mv_evaluate(TS, *d, tp))
    # a batch of points: each column equals the one-point evaluation
    pts = tp[:, :, None].expand(-1, -1, 2).contiguous()
    batch = sparse.mv_evaluate(TS, *ta, pts)
    assert batch.shape == (TS.num_limbs, 2) and torch.equal(batch[:, :1], got)


def test_sparse_evaluate_over_domain():
    terms = [(0, 7), (3, 11), (17, 123456789), (31, 5)]
    ju, tu = _uv_both(terms)
    for offset in (1, 5):
        jd, td = jdm.Radix2Domain(JS, 32, offset_int=offset), tdm.Radix2Domain(TS, 32, offset_int=offset)
        got = sparse.uv_evaluate_over_domain(TS, *tu, td)
        assert same(jsparse.uv_evaluate_over_domain(JS, *ju, jd), got)
        assert same(jsparse.uv_evaluate(JS, *ju, jd.elements()), got)


def test_domain_vanishing_and_filter_polynomials():
    for n, m, off in ((16, 4, 1), (16, 4, 7)):
        jd, td = jdm.Radix2Domain(JS, n, offset_int=off), tdm.Radix2Domain(TS, n, offset_int=off)
        js_, ts_ = jdm.Radix2Domain(JS, m, offset_int=off), tdm.Radix2Domain(TS, m, offset_int=off)
        assert _same_terms(jd.vanishing_polynomial(), td.vanishing_polynomial("cpu"))
        assert same(jd.filter_polynomial(js_), td.filter_polynomial(ts_, "cpu"))
        # at points of the subdomain (1), of the domain only (0) and elsewhere
        pts = jfp.to_ints(JS, jd.elements())[:2] + [12345]
        jt, tt = both(JS, pts)
        got = td.evaluate_filter_polynomial(ts_, tt)
        assert same(jd.evaluate_filter_polynomial(js_, jt), got)
        assert tfp.to_ints(TS, got)[:2] == [1, 0]
    with pytest.raises(ValueError):
        tdm.Radix2Domain(TS, 16).filter_polynomial(tdm.Radix2Domain(TS, 4, offset_int=3))


def test_interop_sparse_terms():
    ju, tu = _uv_both([(2, 9), (40, 3)])
    assert tu[0].dtype == torch.int64 and tu[0].tolist() == [2, 40]
    assert torch.equal(tu[1], limbs_from_numpy(np.asarray(ju[1]), "cpu"))
