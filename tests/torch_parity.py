"""Shared inputs and comparisons for the port's parity tests (test_torch_*.py).

Import this module only after ``pytest.importorskip("torch")``.
"""

import numpy as np

from zkarray.curves import bls12_381 as jcurves
from zkarray.ff import fp as jfp
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.curves import bls12_381 as tcurves
from zkarray_torch.interop import affine_from_numpy, limbs_from_numpy, limbs_to_numpy
from zkarray_torch.testing import ec_mul

FIELDS = [(jcurves.FQ, tcurves.FQ), (jcurves.FR, tcurves.FR)]
FIELD_IDS = ["Fq", "Fr"]

JC, TC = jcurves.G1, tcurves.G1
N, C = 64, 5  # tests/test_msm.py's MSM shape, so the JAX side hits the shared cache
BITS = JC.scalar.bits


def port_field(jspec):
    """The port's FieldSpec of a JAX package field (any prime field: the port's
    field code is generic; only BLS12-381 has a curve module there yet)."""
    return FieldSpec(jspec.modulus, jspec.generator_int, name=jspec.name)


def rand_ints(p, n, seed):
    rng = np.random.default_rng(seed)
    special = [0, 1, 2, p - 1, p - 2, p // 2]
    return special + [int.from_bytes(rng.bytes(48), "little") % p for _ in range(n - len(special))]


def both(jspec, xs, mont=True):
    """The same ints as a JAX array and as a port CPU tensor."""
    j = jfp.from_ints(jspec, xs, mont=mont)
    return j, limbs_from_numpy(np.asarray(j), "cpu")


def same(j, t):
    return np.array_equal(np.asarray(j), limbs_to_numpy(t))


def assert_same_points(jP, tP):
    for j, t in zip(jP, tP):
        assert np.array_equal(np.asarray(j), limbs_to_numpy(t))


def xyzz_coords(pt, lam, mod):
    """Canonical XYZZ coordinates (X, Y, ZZ, ZZZ) of an affine point pt
    (None = infinity, (1, 1, 0, 0)) as the representative ZZ = lam^2,
    ZZZ = lam^3."""
    if pt is None:
        return (1, 1, 0, 0)
    l2 = lam * lam % mod
    l3 = l2 * lam % mod
    return (pt[0] * l2 % mod, pt[1] * l3 % mod, l2, l3)


def xyzz_both(coords, shape):
    """[(X, Y, ZZ, ZZZ) canonical ints] -> the same points as a JAX
    XYZZPoints and a port CPU XYZZPoints of batch ``shape`` (Montgomery form)."""
    from zkarray.ec import sw as jsw
    from zkarray_torch.ec import sw as tsw

    js, ts = [], []
    for k in range(4):
        j, t = both(JC.base, [c[k] for c in coords])
        js.append(j.reshape((j.shape[0],) + tuple(shape)))
        ts.append(t.reshape((t.shape[0],) + tuple(shape)))
    return jsw.XYZZPoints(*js), tsw.XYZZPoints(*ts)


def msm_inputs(seed, n=N, scalars=None, inf_at=()):
    """(points, scalars, JAX affine, JAX scalars, port affine, port scalars)
    for a BLS12-381 G1 MSM over random multiples of the generator."""
    rng = np.random.default_rng(seed)
    gen = (JC.gen_x, JC.gen_y)
    pts = [ec_mul(gen, int(k), 0, JC.base.modulus) for k in rng.integers(1, 1 << 40, size=n)]
    for i in inf_at:
        pts[i] = None
    r = JC.scalar.modulus
    if scalars is None:
        scalars = [0, 1, r - 1, 2, 3] + [
            int.from_bytes(rng.bytes(32), "little") % r for _ in range(n - 5)
        ]
    jA = JC.affine_from_ints(pts)
    js = jfp.from_ints(JC.scalar, scalars, mont=False)
    tA = affine_from_numpy(np.asarray(jA.x), np.asarray(jA.y), np.asarray(jA.inf), "cpu")
    ts = limbs_from_numpy(np.asarray(js), "cpu")
    return pts, scalars, jA, js, tA, ts


# ---- towers: host elements of either package's HostExt ---------------------

def rand_host(host, rng):
    """A random host element of a tower (``rng`` a random.Random)."""
    if not hasattr(host, "deg"):  # either package's HostPrime
        return rng.randrange(host.p)
    return tuple(rand_host(host.base, rng) for _ in range(host.deg))


def nest(elems, host):
    """Host elements -> from_ints' coefficient-major nesting."""
    if not hasattr(host, "deg"):
        return list(elems)
    return [nest([e[j] for e in elems], host.base) for j in range(host.deg)]


def tower_both(J, elems):
    """The same host elements as a JAX tower array and a port CPU tensor."""
    j = J.from_ints(nest(elems, J.host))
    return j, limbs_from_numpy(np.asarray(j), "cpu")


def check_tower_ops(J, T, seed, width=2):
    """The port's tower T against the JAX package's J on ``width`` random
    elements (the first operand's lane 0 zero): mul, sqr, inv (0 -> 0),
    add, sub, neg, double, select, is_zero, eq, the Frobenius map at every
    power, conjugate on a quadratic level and mul_nonresidue on a base
    element, bit for bit."""
    import random

    import torch

    rng = random.Random(seed)
    xs = [J.host.zero()] + [rand_host(J.host, rng) for _ in range(width - 1)]
    ys = [rand_host(J.host, rng) for _ in range(width)]
    ja, ta = tower_both(J, xs)
    jc, tc = tower_both(J, ys)
    assert (T.name, T.deg, T.shape, T.nonresidue_host, T._frob) == (
        J.name, J.deg, J.shape, J.nonresidue_host, J._frob)
    for jr, tr in ((J.mul(ja, jc), T.mul(ta, tc)), (J.sqr(jc), T.sqr(tc)), (J.inv(ja), T.inv(ta)),
                   (J.add(ja, jc), T.add(ta, tc)), (J.sub(ja, jc), T.sub(ta, tc)),
                   (J.neg(jc), T.neg(tc)), (J.double(jc), T.double(tc))):
        assert same(jr, tr)
    mask = np.asarray([i % 2 == 0 for i in range(width)])
    assert same(J.select(mask, ja, jc), T.select(torch.from_numpy(mask), ta, tc))
    assert np.array_equal(np.asarray(J.is_zero(ja)), T.is_zero(ta).numpy())
    assert np.array_equal(np.asarray(J.eq(ja, ja)), T.eq(ta, ta).numpy())
    for i in range(J.deg_abs):
        assert same(J.frobenius(jc, i), T.frobenius(tc, i)), i
    if J.deg == 2:
        assert same(J.conjugate(jc), T.conjugate(tc))
    assert same(J.mul_nonresidue(jc[0]), T.mul_nonresidue(tc[0]))


def words_script():
    """scripts/pairing_bundle_words.py as a module (the JAX package's stored
    pairing words' builder)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "pairing_bundle_words.py")
    spec = importlib.util.spec_from_file_location("pairing_bundle_words", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
