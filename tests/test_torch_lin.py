"""The linear-map route of the port's tower products (kernels/lin.py,
ff/linmap.py): fp_lin's plain version against Python ints at one field of
each width NW = 8, 10, 12, 24, 26, on maps at the coefficient bound and on
edge words, with broadcast and strided sources; the maps that ff/linmap.py
traces for every tower of the port (and the Granger-Scott square and the
sparse line products), evaluated on the host, and the route on CPU tensors,
against tower_host.HostExt; the tracer's refusals; and the launches of a
BLS12-381 Fp12 product, square, Granger-Scott square, line product and
f^|X| chain, counted at the wrappers. No JAX function runs here: the
existing test_torch_towers/pairing/gt/bw6/mnt/cp6 files hold the route's
words against the JAX package's."""

import collections
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from zkarray_torch.curves import (bls12_377, bls12_381, bn254, bw6_761, bw6_767,  # noqa: E402
                                  cp6_782, mnt4_298, mnt4_753, mnt6_298, mnt6_753)
from zkarray_torch.ff import cyclotomic as cyc  # noqa: E402
from zkarray_torch.ff import fp, linmap  # noqa: E402
from zkarray_torch.ff import sparse12 as sp  # noqa: E402
from zkarray_torch.kernels import lin  # noqa: E402
from zkarray_torch.kernels import mont as km  # noqa: E402
from zkarray_torch.testing import lin_edge_rows, lin_edge_words  # noqa: E402

# one field of each width NW = L/2 that the kernel is built for
WIDTH_FIELDS = [bn254.FQ, mnt4_298.FQ, bls12_381.FQ, bw6_761.FQ, cp6_782.FQ]


def ints_of(spec, t):
    """(k, L, *batch) -> k lists of canonical ints (no Montgomery map)."""
    return [fp.to_ints(spec, t[i], mont=False) for i in range(t.shape[0])]


def limbs(spec, vals):
    """k lists of ints -> a (k, L, n) int32 tensor of their limbs."""
    return torch.stack([fp.from_ints(spec, v, mont=False, device="cpu") for v in vals])


@pytest.mark.parametrize("spec", WIDTH_FIELDS, ids=lambda f: f"nw{f.num_limbs // 2}")
def test_fp_lin_plain_matches_ints(spec):
    p = spec.modulus
    rng = np.random.default_rng(spec.num_limbs)
    words = lin_edge_words(spec, rng)
    n = len(words)
    sizes = (3, 2, 1)
    rows = lin_edge_rows(sizes, rng) + [[(2, 0, 7), (0, 1, -3), (1, 1, 2)]]
    lmap = lin.LinMap(rows, sizes, "edge")
    a = limbs(spec, [words, words[::-1], [words[(i * 7) % n] for i in range(n)]])
    wide = limbs(spec, [[words[(i * 5) % n] for i in range(2 * n)] for _ in range(2)])
    b = wide[..., ::2]  # a strided batch
    c = limbs(spec, [[words[-1]]])[..., 0]  # a ()-batch constant, broadcast
    got = lin.fp_lin(spec, lmap, [a, b, c])
    assert got.shape == (lmap.m, spec.num_limbs, n) and got.dtype == torch.int32
    va, vb, vc = ints_of(spec, a), ints_of(spec, b), [[words[-1]] * n]
    src = [va, vb, vc]
    want = [[sum(cf * src[s][k][e] for s, k, cf in r) % p for e in range(n)] for r in lmap.rows]
    assert ints_of(spec, got) == want
    # into a strided view of a wider output, as the tower route writes its slab
    slab = torch.full((spec.num_limbs, 2 * lmap.m, n), -1, dtype=torch.int32)
    lin.fp_lin(spec, lmap, [a, b, c], out=slab[:, ::2].movedim(1, 0))
    assert torch.equal(slab[:, ::2].movedim(1, 0), got) and (slab[:, 1::2] == -1).all()


def test_lin_map_bounds():
    assert lin.LinMap([[(0, 0, (1 << 16) - 1)]], (1,)).kbits == [16]
    with pytest.raises(ValueError):
        lin.LinMap([[(0, 0, 1 << 15), (0, 1, -(1 << 15))]], (2,))  # sum |c| = 2^16
    with pytest.raises(ValueError):
        lin.LinMap([[(0, 2, 1)]], (2,))  # no such slot
    with pytest.raises(ValueError):
        lin.LinMap([[(s, 0, 1) for s in range(5)]], (1,) * 5)  # five sources
    with pytest.raises(ValueError):
        lin.LinMap([[]], (1,))  # reads nothing


# every tower of the port: (module, tower names)
TOWERS = [(bls12_381, ("FQ2", "FQ6", "FQ12")), (bls12_377, ("FQ2", "FQ6", "FQ12")),
          (bn254, ("FQ2", "FQ6", "FQ12")), (bw6_761, ("FQ3", "FQ6")), (bw6_767, ("FQ3", "FQ6")),
          (mnt4_298, ("FQ2", "FQ4")), (mnt4_753, ("FQ2", "FQ4")), (mnt6_298, ("FQ3", "FQ6")),
          (mnt6_753, ("FQ3", "FQ6")), (cp6_782, ("FQ3", "FQ6"))]
TOWER_CASES = [(mod, t) for mod, ts in TOWERS for t in ts]


def rand_host(host, rng):
    if not hasattr(host, "deg"):
        return rng.randrange(host.p)
    return tuple(rand_host(host.base, rng) for _ in range(host.deg))


def nest(elems, host):
    if not hasattr(host, "deg"):
        return list(elems)
    return [nest([e[j] for e in elems], host.base) for j in range(host.deg)]


def tensor_of(ops, elems):
    return ops.from_ints(nest(elems, ops.host), device="cpu")


def host_route(route, p, inputs):
    """A route's two maps and its products on host ints: ``inputs`` are the
    op's flattened canonical coefficients, one list per source."""
    xy = [sum(c * inputs[s][k] for s, k, c in r) % p for r in route.pre.rows]
    prods = [xy[i] * xy[route.s + i] % p for i in range(route.s)]
    src = [prods] + list(inputs)
    return [sum(c * src[s][k] for s, k, c in r) % p for r in route.post.rows]


def flat_out(ops, t):
    """(c..., L, n) -> per lane the flat canonical coefficients."""
    t = t.reshape((-1,) + tuple(t.shape[-2:]))
    cols = [fp.to_ints(ops.spec, t[i]) for i in range(t.shape[0])]
    return [[c[e] for c in cols] for e in range(len(cols[0]))]


@pytest.mark.parametrize("mod,name", TOWER_CASES, ids=[f"{m.__name__.split('.')[-1]}-{t}"
                                                      for m, t in TOWER_CASES])
def test_traced_maps_match_host(mod, name):
    """mul and sqr: the traced maps on host ints, and the route on CPU
    tensors, against HostExt's mul on random elements (zero included)."""
    T = getattr(mod, name)
    H = T.host
    p = T.spec.modulus
    rng = random.Random(T.name)
    xs = [H.zero()] + [rand_host(H, rng) for _ in range(2)]
    ys = [rand_host(H, rng) for _ in range(3)]
    mul = linmap.route(T, "mul", type(T)._mul_sched, (T, T))
    sqr = linmap.route(T, "sqr", type(T)._sqr_sched, (T,))
    for x, y in zip(xs, ys):
        want = H.flatten(H.mul(x, y))
        assert host_route(mul, p, [H.flatten(x), H.flatten(y)]) == want
        assert host_route(sqr, p, [H.flatten(y)]) == H.flatten(H.mul(y, y))
    ta, tb = tensor_of(T, xs), tensor_of(T, ys)
    assert flat_out(T, T.mul(ta, tb)) == [H.flatten(H.mul(x, y)) for x, y in zip(xs, ys)]
    assert flat_out(T, T.sqr(tb)) == [H.flatten(H.mul(y, y)) for y in ys]
    # a ()-batch constant meets the (3,)-batch element
    got = T.mul(T.const(ys[0], (), "cpu"), ta)
    assert flat_out(T, got) == [H.flatten(H.mul(ys[0], x)) for x in xs]


def cyclotomic_host(F12h, f):
    """f^((p^6 - 1)(p^2 + 1)) on the host: conj(f) f^-1, then r^(p^2) r."""
    r = F12h.mul((f[0], F12h.base.neg(f[1])), F12h.inv(f))
    return F12h.mul(F12h.frobenius(r, 2), r)


@pytest.mark.parametrize("mod", [bls12_381, bls12_377, bn254], ids=["bls12_381", "bls12_377", "bn254"])
def test_traced_pairing_ops_match_host(mod):
    """The Granger-Scott square on cyclotomic elements, mul_by_014 and
    mul_by_034, the Fp6 sparse products and an Fp6 mul_base by an Fp2
    element, each as a host map and on tensors, against HostExt."""
    F12, F6, F2 = mod.FQ12, mod.FQ6, mod.FQ2
    H12, H6, H2 = F12.host, F6.host, F2.host
    p = F12.spec.modulus
    rng = random.Random(5)
    fs = [cyclotomic_host(H12, rand_host(H12, rng)) for _ in range(2)]
    gs = linmap.route(F12, "gs_sqr", cyc._gs_sched, (F12,))
    for f in fs:
        assert host_route(gs, p, [H12.flatten(f)]) == H12.flatten(H12.mul(f, f))
    tf = tensor_of(F12, fs)
    assert flat_out(F12, cyc.gs_cyclotomic_sqr(F12, tf)) == [H12.flatten(H12.mul(f, f)) for f in fs]

    z2 = H2.zero()
    c = [[rand_host(H2, rng) for _ in range(2)] for _ in range(3)]
    tc = [tensor_of(F2, cs) for cs in c]
    lines = {"mul_by_014": (sp._by_014, sp.fp12_mul_by_014,
                            lambda c0, c1, c4: ((c0, c1, z2), (z2, c4, z2))),
             "mul_by_034": (sp._by_034, sp.fp12_mul_by_034,
                            lambda c0, c3, c4: ((c0, z2, z2), (c3, c4, z2)))}
    for op, (sched, public, line) in lines.items():
        r = linmap.route(F12, op, sched, (F12, F2, F2, F2))
        want = [H12.flatten(H12.mul(f, line(*(cs[i] for cs in c)))) for i, f in enumerate(fs)]
        assert [host_route(r, p, [H12.flatten(f)] + [H2.flatten(cs[i]) for cs in c])
                for i, f in enumerate(fs)] == want
        assert flat_out(F12, public(F12, tf, *tc)) == want

    a6 = [rand_host(H6, rng) for _ in range(2)]
    ta6 = tensor_of(F6, a6)
    for public, el in ((sp.fp6_mul_by_1, lambda c0, c1: (z2, c1, z2)),
                       (sp.fp6_mul_by_01, lambda c0, c1: (c0, c1, z2)),
                       (sp.fp6_mul_by_fp2, lambda c0, c1: (c0, z2, z2))):
        args = tc[:2] if public is sp.fp6_mul_by_01 else tc[1:2] if public is sp.fp6_mul_by_1 else tc[:1]
        want = [H6.flatten(H6.mul(a, el(c[0][i], c[1][i]))) for i, a in enumerate(a6)]
        assert flat_out(F6, public(F6, ta6, *args)) == want
    want = [H6.flatten(H6.mul_scalar(a, c[0][i])) for i, a in enumerate(a6)]
    assert flat_out(F6, F6.mul_base(ta6, tc[0])) == want


def test_tracer_refuses():
    """Two product layers, a constant operand and a large coefficient are
    refused."""
    F2 = bls12_381.FQ2
    with pytest.raises(linmap.NotLinear):
        linmap.derive(F2, "cube", lambda T, a: T.mul(T.mul(a, a), a), (F2,))
    with pytest.raises(linmap.NotLinear):
        linmap.derive(F2, "by_const", lambda T, a: T.mul(a, T.const((3, 4), (), "cpu")), (F2,))
    with pytest.raises(linmap.NotLinear):
        linmap.derive(F2, "big", lambda T, a: T._stack([T.base.mul_const(T.mul(a, a)[0], 1 << 20),
                                                      a[1]]), (F2,))


@pytest.fixture
def launches(monkeypatch):
    """Counts of the kernel wrappers' calls (the CPU takes their plain
    versions) and of torch.stack, by name."""
    counts = collections.Counter()

    def count(mod, name, key=None):
        fn = getattr(mod, name)

        def call(*args, **kwargs):
            counts[key or name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, call)

    for name in ("mont_mul", "mont_sqr", "mont_inv", "mont_pow"):
        count(km, name)
    count(lin, "fp_lin")
    count(torch, "stack")
    addsub = km._addsub

    def counted_addsub(kernel, *args, **kwargs):
        counts[kernel] += 1
        return addsub(kernel, *args, **kwargs)
    monkeypatch.setattr(km, "_addsub", counted_addsub)
    return counts


def test_tower_product_launches(launches):
    """A BLS12-381 Fp12 mul, sqr, Granger-Scott square and mul_by_014: one
    mont_mul, at most three fp_lin, no fp_add/fp_sub and no stack each; an
    f^|X| chain at most 300 launches (3,567 before the route)."""
    F12, F2 = bls12_381.FQ12, bls12_381.FQ2
    rng = random.Random(9)
    f = tensor_of(F12, [cyclotomic_host(F12.host, rand_host(F12.host, rng)) for _ in range(2)])
    g = tensor_of(F12, [rand_host(F12.host, rng) for _ in range(2)])
    c = [tensor_of(F2, [rand_host(F2.host, rng) for _ in range(2)]) for _ in range(3)]
    ops = {"mul": lambda: F12.mul(f, g), "sqr": lambda: F12.sqr(g),
           "gs_sqr": lambda: cyc.gs_cyclotomic_sqr(F12, f),
           "mul_by_014": lambda: sp.fp12_mul_by_014(F12, g, *c)}
    for op, fn in ops.items():
        fn()  # the route's map is traced once, before counting
        launches.clear()
        fn()
        assert launches["mont_mul"] == 1, (op, dict(launches))
        assert launches["fp_lin"] <= 3, (op, dict(launches))
        for k in ("fp_add", "fp_sub", "stack", "mont_sqr"):
            assert launches[k] == 0, (op, dict(launches))
    launches.clear()
    cyc.cyclotomic_exp_binary(F12, f, bls12_381.PAIRING.x_abs)
    assert launches["mont_mul"] == 68 and launches["stack"] == 0, dict(launches)
    assert sum(launches[k] for k in ("mont_mul", "mont_sqr", "fp_lin", "fp_add", "fp_sub")) <= 300
