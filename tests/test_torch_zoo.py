"""Port parity: zkarray_torch.curves.zoo, ec.cycles and ec.glv's Pallas and
Vesta specs against the JAX package (constants field by field and curve by
curve, the GLV decomposition), and the zoo's curves on the port's group
path and MSM against the host oracle.

The zoo's short-Weierstrass curves reach branches the pairing-friendly
curves never take: a = -3 (secp256r1, secp384r1 at NW = 12) and a = 1 (the
Stark curve) in the Jacobian doubling and in the XYZZ doublings of the MSM
kernels' plain versions (kernels/sw.py: xyzz_accum, horner_windows,
xyzz_add, xyzz_double, xyzz_tree_sum, xyzz_bit_horner), which chip_smoke.py
holds the CUDA kernels against. No JAX function runs on these curves here
beyond tests/test_torch_sw.py's secp256r1 checks; on the CPU every field
operation is its kernel's plain version."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from zkarray.curves import zoo as jzoo  # noqa: E402
from zkarray.ec import cycles as jcycles  # noqa: E402
from zkarray.ec import glv as jglv  # noqa: E402
from zkarray_torch import interop  # noqa: E402
from zkarray_torch.curves import bn254 as tbn  # noqa: E402
from zkarray_torch.curves import zoo as tzoo  # noqa: E402
from zkarray_torch.ec import cycles, glv, msm, sw  # noqa: E402
from zkarray_torch.kernels import sw as ksw  # noqa: E402
from zkarray_torch.core.limbs import unpack_pairs  # noqa: E402
from zkarray_torch.testing import (accum_edge_rounds, accum_feed, ec_add, ec_mul,  # noqa: E402
                                   expected_msm, horner_edge_windows, tiled_inputs)

SW_NAMES = ["SECP256K1", "SECQ256K1", "SECP256R1", "SECP384R1", "PALLAS", "VESTA", "GRUMPKIN",
            "STARKCURVE", "BLS12_377_G1"]


@pytest.mark.parametrize("key", sorted(jzoo.FIELDS))
def test_zoo_fields_match_jax(key):
    """Every field's Montgomery, 2-adic, small-subgroup and square-root
    constants; roots of unity of mixed orders where a small subgroup is set
    (secp256k1's Fr and BN254's Fr, base 3); the Stark curve's Fr, whose
    generator is p - 2."""
    jf, tf = jzoo.FIELDS[key], tzoo.FIELDS[key]
    assert interop.same_field(tf, jf.modulus, jf.generator_int, jf.r_int, jf.r2_int, jf.inv16)
    names = ("name", "bits", "num_limbs", "two_adicity", "trace", "two_adic_root_int",
             "small_subgroup_base", "small_subgroup_base_adicity", "large_subgroup_root_int",
             "sqrt_mode", "sqrt_exp", "sqrt_qnr", "has_spare_bit")
    assert [getattr(tf, n) for n in names] == [getattr(jf, n) for n in names]
    sizes = [1 << k for k in (1, min(4, tf.two_adicity))]
    if tf.small_subgroup_base:
        q = tf.small_subgroup_base
        sizes += [q, q ** tf.small_subgroup_base_adicity, 2 * q]
    for n in sizes:
        assert tf.root_of_unity(n) == jf.root_of_unity(n), n
    if key == "starkcurve.fr":
        assert tf.generator_int == tf.modulus - 2


@pytest.mark.parametrize("name", SW_NAMES)
def test_zoo_curves_match_jax_and_oracle(name):
    jc, tc = getattr(jzoo, name), getattr(tzoo, name)
    assert tc.name == jc.name
    assert tc.base is tzoo.FIELDS[jc.base.name] and tc.scalar is tzoo.FIELDS[jc.scalar.name]
    assert interop.same_curve(tc, jc.a_int, jc.b_int, jc.gen_x, jc.gen_y, jc.cofactor)
    assert (tc.base.modulus, tc.scalar.modulus) == (jc.base.modulus, jc.scalar.modulus)
    mod, a = tc.base.modulus, tc.a_int
    g = (tc.gen_x, tc.gen_y)
    assert ec_mul(g, tc.scalar.modulus, a, mod) is None
    assert tc.a_is_zero == (jc.a_int == 0)


@pytest.mark.parametrize("name", ["STARKCURVE", "SECP384R1", "GRUMPKIN"])
def test_zoo_jacobian_group_law_against_oracle(name):
    """a = 1, a = -3 at NW = 12, b = -17: jac_add_mixed, jac_add, jac_double
    (dbl-2007-bl where a != 0), scalar_mul_const and to_affine at 4 lanes,
    the doubling and cancelling lanes included."""
    tc = getattr(tzoo, name)
    mod, a = tc.base.modulus, tc.a_int
    g = (tc.gen_x, tc.gen_y)
    ps = [ec_mul(g, k, a, mod) for k in (3, 5, 7, 11)]
    qs = [ec_mul(g, 9, a, mod), ps[1], (ps[2][0], (-ps[2][1]) % mod), ec_mul(g, 13, a, mod)]
    P = sw.from_affine(tc, sw.affine_from_ints(tc, ps, device="cpu"))
    Q = sw.affine_from_ints(tc, qs, device="cpu")
    want = [ec_add(p, q, a, mod) for p, q in zip(ps, qs)]
    assert sw.affine_to_ints(tc, sw.to_affine(tc, sw.jac_add_mixed(tc, P, Q))) == want
    assert sw.affine_to_ints(tc, sw.to_affine(tc, sw.jac_add(tc, P, sw.from_affine(tc, Q)))) == want
    assert sw.affine_to_ints(tc, sw.to_affine(tc, sw.jac_double(tc, P))) == [
        ec_add(p, p, a, mod) for p in ps]
    assert sw.affine_to_ints(tc, sw.to_affine(tc, sw.scalar_mul_const(tc, P, 100003))) == [
        ec_mul(p, 100003, a, mod) for p in ps]
    assert sw.is_on_curve(tc, sw.affine_from_ints(tc, ps + qs, device="cpu")).all()


def test_cycles():
    """pasta and BN254/Grumpkin are cycles; a pair that is not one raises,
    as in the JAX package."""
    pc = cycles.pasta_cycle()
    assert (pc.e1, pc.e2) == (tzoo.PALLAS, tzoo.VESTA)
    assert repr(pc) == repr(jcycles.pasta_cycle())
    bc = cycles.bn254_grumpkin_cycle()
    assert (bc.e1, bc.e2) == (tbn.G1, tzoo.GRUMPKIN)
    assert repr(bc) == repr(jcycles.bn254_grumpkin_cycle())
    pf = cycles.PairingFriendlyCycle(tzoo.VESTA, tzoo.PALLAS, "e1", "e2")
    assert (pf.engine1, pf.engine2) == ("e1", "e2")
    for e1, e2 in ((tzoo.PALLAS, tzoo.SECP256K1), (tzoo.PALLAS, tzoo.PALLAS)):
        with pytest.raises(ValueError, match="not a cycle"):
            cycles.CurveCycle(e1, e2)
    with pytest.raises(ValueError, match="not a cycle"):
        jcycles.CurveCycle(jzoo.PALLAS, jzoo.SECP256K1)


@pytest.mark.parametrize("name", ["pallas_glv", "vesta_glv"])
def test_pasta_glv_specs_and_decomposition_match_jax(name):
    jg, tg = getattr(jglv, name)(), getattr(glv, name)()
    assert (tg.endo_coeff, tg.lam, tg.decomp) == (jg.endo_coeff, jg.lam, jg.decomp)
    assert tg.curve.name == jg.curve.name
    r = tg.curve.scalar.modulus
    rng = random.Random(7)
    for k in [0, 1, 2, r - 1, r // 2] + [rng.randrange(r) for _ in range(64)]:
        k1, k2 = tg.decompose(k)
        assert (k1, k2) == jg.decompose(k)
        assert max(abs(k1), abs(k2)).bit_length() <= (r.bit_length() + 1) // 2 + 2


def test_pallas_glv_mul_against_oracle():
    """glv_mul on Pallas at 3 lanes (0, r - 1, random): the endomorphism
    phi(x, y) = (beta x, y) is lambda P on the curve."""
    g = glv.pallas_glv()
    tc = g.curve
    mod, r = tc.base.modulus, tc.scalar.modulus
    gen = (tc.gen_x, tc.gen_y)
    pts = [ec_mul(gen, k, 0, mod) for k in (1, 2, 3)]
    ks = [0, r - 1, random.Random(8).randrange(r)]
    A = sw.affine_from_ints(tc, pts, device="cpu")
    phi = glv.endomorphism(g, A)
    assert sw.affine_to_ints(tc, phi) == [ec_mul(p, g.lam, 0, mod) for p in pts]
    got = sw.affine_to_ints(tc, sw.to_affine(tc, glv.glv_mul(g, A, ks)))
    assert got == [ec_mul(p, k, 0, mod) for p, k in zip(pts, ks)]


def test_msm_plain_path_general_a_against_oracle():
    """The MSM path at a = -3 (secp256r1) through the kernels' plain
    versions: xyzz_accum on testing.accum_edge_rounds (doubling and cancel
    with ZZ = 1 and ZZ != 1, infinity, skips), horner_windows on
    testing.horner_edge_windows, xyzz_double, and a whole msm of 64 tiled
    points, each against the host oracle."""
    tc = tzoo.SECP256R1
    mod, a = tc.base.modulus, tc.a_int
    rng = np.random.default_rng(31)
    S, R = 45, 3
    P0, rounds = accum_edge_rounds(tc, S, R, rng)
    state, coords, valid = accum_feed(tc, P0, rounds)
    got = ksw.xyzz_accum_plain(tc, state, coords, valid)
    L = tc.base.num_limbs
    res = sw.XYZZPoints(*(unpack_pairs(got[i * L // 2:(i + 1) * L // 2]) for i in range(4)))
    want = []
    for s in range(S):
        acc = P0[s]
        for pts, sign, skip in rounds:
            if not skip[s]:
                pt = pts[s] if not sign[s] else (pts[s][0], (-pts[s][1]) % mod)
                acc = ec_add(acc, pt, a, mod)
        want.append(acc)
    assert sw.affine_to_ints(tc, sw.xyzz_to_affine(tc, res)) == want

    W, c = 7, 2
    win, total = horner_edge_windows(tc, W, c, np.random.default_rng(32))
    got = ksw.horner_windows_plain(tc, win, c)
    res = sw.XYZZPoints(*(got[i * L:(i + 1) * L, None] for i in range(4)))
    assert sw.affine_to_ints(tc, sw.xyzz_to_affine(tc, res)) == [total]

    gen = (tc.gen_x, tc.gen_y)
    ps = [ec_mul(gen, k, a, mod) for k in (2, 3)] + [None]
    X = sw.xyzz_from_affine(tc, sw.affine_from_ints(tc, ps, device="cpu"))
    D = sw.xyzz_double(tc, sw.xyzz_add(tc, X, X))
    assert sw.affine_to_ints(tc, sw.xyzz_to_affine(tc, D)) == [
        None if p is None else ec_mul(p, 4, a, mod) for p in ps]

    px, py, sc, ks, bits = tiled_inputs(tc, 64, np.random.default_rng(33))
    A = interop.affine_from_numpy(px, py, np.zeros(64, bool), "cpu")
    out = msm.msm(tc, A, interop.limbs_from_numpy(sc, "cpu"), c=5)
    got = sw.affine_to_ints(tc, sw.xyzz_to_affine(tc, sw.XYZZPoints(*(v[:, None] for v in out))))
    assert got == [expected_msm(tc, ks, sc)]
