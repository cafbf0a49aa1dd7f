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
