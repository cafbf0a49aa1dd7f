"""Port parity for GT as an additive group (ec/pairing/gt.py): GTGroup's
ops (zero, is_zero, add, neg, sub, double, select, eq) against the JAX
package's GTGroup over BLS12-381's and BN254's Fp12 and BW6-761's Fp6, bit
for bit (JAX stacks carried over by interop.gt_from_numpy), on cyclotomic
elements (host powers of the pairing's E,
testing.py's constants); mul_const, gt_mul_scalar (the double-and-add
ladder over the scalar limbs' bits) and gt_msm (c = 3 windows, one-hot
buckets, the log tree over n, the suffix sum) at n <= 4 against host
powers of E. The JAX package's gt_mul_scalar and gt_msm compile for ~15
minutes (tests/TIMING.md), so the ladders are held against the host;
gt_msm on a 61-bit scalar field (21 windows), gt_mul_scalar on r."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from zkarray.ec.pairing import gt as jgt  # noqa: E402
from zkarray_torch import interop  # noqa: E402
from zkarray_torch import testing as tt  # noqa: E402
from zkarray_torch.core.limbs import ints_to_limbs_np  # noqa: E402
from zkarray_torch.ec.pairing import gt as tgt  # noqa: E402

CURVES = {"bls12_381": "E_BLS12_381", "bn254": "E_BN254", "bw6_761": "E_BW6_761"}


def _groups(name):
    import importlib

    jm = importlib.import_module(f"zkarray.curves.{name}")
    tm = importlib.import_module(f"zkarray_torch.curves.{name}")
    ext = "FQ6" if name.startswith("bw6") else "FQ12"
    return (jgt.GTGroup(getattr(jm, ext), jm.FR), tgt.GTGroup(getattr(tm, ext), tm.FR),
            getattr(tt, CURVES[name]))


def _elems(T, e_flat, ks):
    """E^k for each k as a port CPU tensor (host powers)."""
    return tt.fp12_tensor(T, tt.gt_powers(T.host, e_flat, ks), "cpu")


@pytest.mark.parametrize("name", list(CURVES))
def test_gt_group_ops_match_jax(name):
    """The group ops on E^k for seeded k and on zero (= 1), against the JAX
    package's GTGroup, and against the host's tower arithmetic."""
    jG, tG, e = _groups(name)
    r = tG.scalar.modulus
    rng = random.Random(7)
    ks = [0, 1, rng.randrange(r), rng.randrange(r)]
    ta = _elems(tG.ext, e, ks)
    tb = ta.roll(1, -1)
    ja, jb = (jnp.asarray(interop.limbs_to_numpy(t)) for t in (ta, tb))

    def same(j, t):
        return np.array_equal(np.asarray(j), interop.limbs_to_numpy(t) if t.dtype == torch.int32
                              else t.numpy())

    for jr, tr in ((jG.add(ja, jb), tG.add(ta, tb)), (jG.neg(ja), tG.neg(ta)),
                   (jG.sub(ja, jb), tG.sub(ta, tb)), (jG.double(ja), tG.double(ta)),
                   (jG.is_zero(ja), tG.is_zero(ta)), (jG.eq(ja, jb), tG.eq(ta, tb)),
                   (jG.zero((4,)), tG.zero((4,), "cpu"))):
        assert same(jr, tr)
    assert torch.equal(interop.gt_from_numpy(tG.ext, np.asarray(jG.add(ja, jb)), "cpu"), tG.add(ta, tb))
    with pytest.raises(ValueError):  # a stack of another tower
        interop.gt_from_numpy(tG.ext, np.asarray(ja)[0], "cpu")
    mask = np.asarray([True, False, False, True])
    assert same(jG.select(mask, ja, jb), tG.select(torch.from_numpy(mask), ta, tb))
    H = tG.ext.host
    xs = [tt.fp12_from_flat(H, f) for f in tt.fp12_to_flat(tG.ext, ta)]
    ys = xs[-1:] + xs[:-1]
    flat = lambda es: [tuple(H.flatten(x)) for x in es]  # noqa: E731
    want = flat([H.mul(x, y) for x, y in zip(xs, ys)] + [H.mul(x, (y[0], H.base.neg(y[1]))) for x, y in zip(xs, ys)]
                + [H.mul(x, x) for x in xs])
    got = tt.fp12_to_flat(tG.ext, torch.cat([tG.add(ta, tb), tG.sub(ta, tb), tG.double(ta)], -1))
    assert got == want  # y's conjugate is its inverse: the elements are cyclotomic
    assert tG.is_zero(ta).tolist() == [True, False, False, False]
    assert tt.fp12_to_flat(tG.ext, tG.mul_const(ta, 5 - 2 * r)) == flat([H.pow(x, 5) for x in xs])


def test_gt_mul_scalar_matches_host_powers():
    """gt_mul_scalar on BN254's E^k with scalars 0, r - 1 and a seeded one
    (device bits of canonical limbs) against E^(k s mod r) on the host."""
    _, tG, e = _groups("bn254")
    r = tG.scalar.modulus
    rng = random.Random(11)
    ks = [rng.randrange(1, r) for _ in range(3)]
    ss = [0, r - 1, rng.randrange(r)]
    a = _elems(tG.ext, e, ks)
    sc = torch.from_numpy(ints_to_limbs_np(ss, tG.scalar.num_limbs).astype(np.int32))
    got = tgt.gt_mul_scalar(tG, a, sc)
    assert tgt.mul_scalar is tgt.gt_mul_scalar
    assert tt.fp12_to_flat(tG.ext, got) == tt.gt_powers(tG.ext.host, e,
                                                        [k * s % r for k, s in zip(ks, ss)])


def test_gt_msm_matches_host_power():
    """gt_msm at n = 3 (an odd tree level) with c = 3 against E^(sum k_i
    s_i mod r) on BN254's Fp12, scalars max, 0 and a seeded one. The group's
    scalar field is a 61-bit prime here, so the ladder runs 21 windows (r's
    85 take ~20 s on the CPU; chip_smoke.py runs them at 2^12): the windows
    still cross every limb offset (48 bits, 16 windows, a period) and the
    top limb, and E^s for s < 2^61 is E^(s mod r)."""
    from zkarray_torch.core.fieldspec import FieldSpec

    _, tG, e = _groups("bn254")
    r = tG.scalar.modulus
    q = (1 << 61) - 1  # a Mersenne prime
    small = tgt.GTGroup(tG.ext, FieldSpec(q, 37, name="m61"))
    rng = random.Random(13)
    ks = [rng.randrange(1, r) for _ in range(3)]
    ss = [q - 1, 0, rng.randrange(q)]
    pts = _elems(tG.ext, e, ks)
    sc = torch.from_numpy(ints_to_limbs_np(ss, small.scalar.num_limbs).astype(np.int32))
    got = tgt.gt_msm(small, pts, sc, c=3)
    assert tgt.msm is tgt.gt_msm and tuple(got.shape) == tuple(tG.ext.shape) + (16,)
    total = sum(k * s for k, s in zip(ks, ss)) % r
    assert tt.fp12_to_flat(tG.ext, got[..., None]) == tt.gt_powers(tG.ext.host, e, [total])
