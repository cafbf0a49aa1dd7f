"""fp_lin's narrow body (csrc/flin.cu with G > 1 lanes a (row, element)) on
the CPU: the rule that picks the body (kernels/lin.py:lanes) pinned on both
sides of its crossover and at the paths' own launch shapes; the lanes the
launcher packs into the LinCall block, decoded by
tests/test_torch_lin_launch.py's stand-in for the C entry; a BLS12-381 Fp12
product, square and Granger-Scott square at gt_msm's narrow batches (), (7,)
and (7, 3) through the launchers, against the plain route and the port's
host tower on Python ints; and maps with rows of 33 and 70 terms at the
coefficient bound (testing.lin_edge_rows) at one element and on both sides
of the crossover, against fp_lin_plain and Python ints. No JAX function
runs; every comparison is exact."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_lin_launch import kernel_route  # noqa: E402,F401 (a fixture)
from test_torch_lin_launch import plain  # noqa: E402
from torch_parity import nest, rand_host  # noqa: E402
from zkarray_torch.curves import bls12_381 as tb  # noqa: E402
from zkarray_torch.ff import cyclotomic, fp, linmap  # noqa: E402
from zkarray_torch.kernels import _build, lin  # noqa: E402
from zkarray_torch.testing import lanes_crossover as crossover  # noqa: E402
from zkarray_torch.testing import lin_edge_rows, lin_edge_words  # noqa: E402

FQ, F12 = tb.FQ, tb.FQ12
H12 = F12.host


def routes():
    return {"mul": linmap.route(F12, "mul", type(F12)._mul_sched, (F12, F12)),
            "sqr": linmap.route(F12, "sqr", type(F12)._sqr_sched, (F12,)),
            "gs_sqr": linmap.route(F12, "gs_sqr", cyclotomic._gs_sched, (F12,))}


@pytest.mark.parametrize("m,max_terms", [(12, 36), (108, 8), (12, 7), (15, 70), (6, 12), (2, 2)])
def test_lanes_rule_both_sides_of_the_crossover(m, max_terms):
    """At one element the rule gives the power of two that covers the
    longest row, at most 32; G never grows with n; the widths on both sides
    of each crossover: the last with four lanes or more and the next (two
    lanes) straddle FILL_THREADS lanes, the last with two lanes or more and
    the next (one thread a row) PAIR_ELEMENTS pairs; far past them, one
    thread a row."""
    top = min(32, 1 << (max_terms - 1).bit_length())
    assert lin.lanes(1, m, max_terms) == top and top in lin.LANES
    n_star = crossover(m, max_terms)
    assert lin.lanes(n_star, m, max_terms) >= 2 and lin.lanes(n_star + 1, m, max_terms) == 1
    if top >= 4:  # the first crossover: four lanes or more, then two
        n4 = max(n for n in range(1, n_star + 1) if lin.lanes(n, m, max_terms) >= 4)
        assert lin.lanes(n4 + 1, m, max_terms) == 2
        assert m * n4 * lin.lanes(n4, m, max_terms) <= lin.FILL_THREADS < m * (n4 + 1) * 4
    assert m * n_star <= lin.PAIR_ELEMENTS < m * (n_star + 1)
    gs = [lin.lanes(n, m, max_terms) for n in range(1, 2 * n_star + 2, max(1, n_star // 64))]
    assert gs == sorted(gs, reverse=True) and set(gs) <= set(lin.LANES)
    assert lin.lanes(1 << 20, m, max_terms) == 1


def test_lanes_rule_at_the_path_shapes():
    """The paths' launches: a one-row map of one term and two-term rows at
    one element; the Fp12 product's and the Granger-Scott square's maps at
    one element and 64 lanes take the narrow body; the pairing's widest
    launch (the pre-map at 2^12) keeps one thread a row."""
    r = routes()
    assert lin.lanes(1, 3, 1) == 1 and lin.lanes(1, 4, 2) == 2
    for name, lmap in (("mul post", r["mul"].post), ("mul pre", r["mul"].pre),
                       ("gs_sqr post", r["gs_sqr"].post)):
        for n in (1, 7, 64):
            assert lin.lanes(n, lmap.m, lmap.max_terms) > 1, (name, n)
    assert (r["mul"].post.max_terms, r["mul"].pre.max_terms) == (36, 8)
    assert lin.lanes(1, r["mul"].post.m, 36) == 32 and lin.lanes(1, r["mul"].pre.m, 8) == 8
    assert lin.lanes(1 << 12, r["mul"].pre.m, r["mul"].pre.max_terms) == 1


def host_cyclotomic(rng):
    g = rand_host(H12, rng)
    t = H12.mul(H12.frobenius(g, 6), H12.inv(g))  # g^(p^6 - 1)
    return H12.mul(H12.frobenius(t, 2), t)  # ... ^(p^2 + 1): in the cyclotomic subgroup


def tensor_of(elems, batch):
    t = F12.from_ints(nest(elems, H12), "cpu")
    return t[..., 0] if batch == () else t.reshape(t.shape[:-1] + batch)


def ints_of(t):
    flat = t.reshape(t.shape[:4] + (-1,))
    return F12.to_ints(flat)


@pytest.mark.parametrize("batch", [(), (7,), (7, 3)], ids=["()", "(7,)", "(7,3)"])
@pytest.mark.parametrize("op", ["mul", "sqr", "gs_sqr"])
def test_fp12_narrow_batches(op, batch, kernel_route, monkeypatch):
    """An Fp12 product, square or Granger-Scott square at gt_msm's narrow
    batches through the launchers: the plain route's words, the host
    tower's on Python ints, and in each fp_lin launch the lanes the rule
    gives its shape (the narrow body on both maps)."""
    rng = random.Random(hash((op, batch)) % 1000)
    k = int(np.prod(batch))
    if op == "gs_sqr":
        xs = [host_cyclotomic(rng) for _ in range(k)]
    else:
        xs = [rand_host(H12, rng) for _ in range(k)]
    ys = [rand_host(H12, rng) for _ in range(k)]
    a, b = tensor_of(xs, batch), tensor_of(ys, batch)
    fn = {"mul": lambda: F12.mul(a, b), "sqr": lambda: F12.sqr(a),
          "gs_sqr": lambda: cyclotomic.gs_cyclotomic_sqr(F12, a)}[op]
    want_host = [H12.mul(x, y if op == "mul" else x) for x, y in zip(xs, ys)]
    got = fn()
    assert torch.equal(got, plain(fn, monkeypatch))
    assert ints_of(got) == nest(want_host, H12)
    calls = kernel_route[FQ].calls
    assert len(calls) == 2 and _build.LAUNCHES["fp_lin"] == 2
    for c in calls:
        longest = max(len(r) for r in c["rows"])
        assert c["n"] == k and c["lanes"] == lin.lanes(k, c["m"], longest) > 1


@pytest.mark.parametrize("spec", [FQ, tb.FR], ids=["L24", "L16"])
def test_long_rows_both_sides_of_the_crossover(spec, monkeypatch):
    """Rows of 33 and 70 terms whose |c| sum to 2^16 - 1 (mixed signs),
    with testing.lin_edge_rows' edge rows, over edge words: at one element
    (32 lanes, each walking up to three terms), at the last width with two
    lanes or more and at the first with one thread a row, through the
    launcher and tests/test_torch_lin_launch.py's stand-in, against
    fp_lin_plain and, on 16 lanes, Python ints."""
    from test_torch_lin_launch import LinStandIn, host_launcher

    entries = LinStandIn(spec)
    monkeypatch.setitem(lin._LIN_LAUNCHERS, (id(spec), -1), host_launcher(spec, entries))
    monkeypatch.setattr(lin.km, "on_cpu", lambda *ts: False)
    sizes = (40, 40, 1)
    rng = np.random.default_rng(spec.num_limbs)
    words = lin_edge_words(spec, rng)
    lmap = lin.LinMap(lin_edge_rows(sizes, rng, long_rows=(33, 70)), sizes, "long rows")
    assert lmap.max_terms == 70 and sorted(lmap.sum_abs)[-1] == (1 << 16) - 1
    k, p = len(words), spec.modulus
    x = fp.from_ints(spec, words, mont=False, device="cpu")
    n_star = crossover(lmap.m, lmap.max_terms)
    for n, lanes in ((1, 32), (n_star, None), (n_star + 1, 1)):
        ii = torch.arange(n)
        a = torch.stack([x[:, (ii * (2 * j + 1) + j) % k] for j in range(40)])
        b = torch.stack([x[:, (ii * (3 * j + 2) + 5 * j) % k] for j in range(40)])
        c = x[None, :, k // 2]
        got = lin.fp_lin(spec, lmap, [a, b, c])
        assert torch.equal(got, lin.fp_lin_plain(spec, lmap, [a, b, c]))
        m_ = min(n, 16)
        src = [[fp.to_ints(spec, t[j, :, :m_], mont=False) for j in range(t.shape[0])]
               for t in (a, b)] + [[[words[k // 2]] * m_]]
        assert [fp.to_ints(spec, got[i, :, :m_], mont=False) for i in range(lmap.m)] == [
            [sum(cf * src[s][j][e] for s, j, cf in r) % p for e in range(m_)] for r in lmap.rows]
        packed = entries.calls[-1]["lanes"]
        assert packed == lin.lanes(n, lmap.m, 70) and (lanes is None or packed == lanes)
        assert packed >= 2 if n == n_star else True
    assert not entries.errors
