"""Port parity for the BN254 pairing (ec/pairing/bn.py, curves/bn254.py):
the towers Fq2/Fq6/Fq12 (beta = -1, xi = 9 + u and its hook, Fq12 by v)
against the JAX package's at width 2; the spec's constants; g2_prepare
(every doubling's coefficients, the add steps' at the 21 nonzero digits of
6X + 2), multi_miller_loop(combine=False), pairing_each and pairing on
tests/pairing_bundle.py's four pairs, word for word against the JAX
package's words for them (tests/vectors/bn254_pairing_bundle.npz, written
by scripts/pairing_bundle_words.py: building the BN254 bundle in a test
worker is what crashes XLA:CPU in test_bn_pairing_bilinear); the interop
converter's choice of add slots. The test marked slow rebuilds the words
with the JAX package. The port's CPU path is the plain versions: one
pairing_each takes ~10 s here."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import check_tower_ops, words_script  # noqa: E402
from zkarray.curves import bn254 as jbn  # noqa: E402
from zkarray_torch import interop  # noqa: E402
from zkarray_torch import testing as tt  # noqa: E402
from zkarray_torch.curves import bn254 as tbn  # noqa: E402
from zkarray_torch.ec.pairing import bn as tpbn  # noqa: E402

VEC = os.path.join(os.path.dirname(__file__), "vectors", "bn254_pairing_bundle.npz")


def words():
    ref = np.load(VEC)
    return {k: (ref[k].astype(np.uint32) if ref[k].dtype == np.uint16 else ref[k]) for k in ref.files}


def bundle(ref, check=False):
    """The stored pairs (G, H), (2G, H), (G, 2H), (infinity, H); with
    ``check``, held against the port's own generators and doublings."""
    from zkarray_torch.ec import sw as tsw
    from zkarray_torch.ec import sw_ext as tsw_ext

    P = interop.affine_from_numpy(ref["p_x"], ref["p_y"], ref["p_inf"], "cpu")
    Q = interop.ext_affine_from_numpy(ref["q_x"], ref["q_y"], ref["q_inf"], "cpu")
    if not check:
        return P, Q
    G, H = tbn.G1.generator((1,), "cpu"), tbn.G2.generator((1,), "cpu")
    G2 = tsw.to_affine(tbn.G1, tsw.jac_double(tbn.G1, tsw.from_affine(tbn.G1, G)))
    H2 = tsw_ext.to_affine(tbn.G2, tsw_ext.double(tbn.G2, tsw_ext.from_affine(tbn.G2, H)))
    assert torch.equal(P.x[:, :3], torch.cat([G.x, G2.x, G.x], 1)) and P.inf.tolist() == [0, 0, 0, 1]
    assert torch.equal(Q.x, torch.cat([H.x, H.x, H2.x, H.x], -1))
    assert torch.equal(Q.y, torch.cat([H.y, H.y, H2.y, H.y], -1))
    return P, Q


@pytest.mark.parametrize("level", ["Fq2", "Fq6", "Fq12"])
def test_bn254_towers_match_jax(level):
    """Products, squares, inverses (zero too), the linear ops, Frobenius at
    every power, conjugation and the nonresidue products (Fq6's is the
    xi = 9 + u hook, Fq12's the shuffle) against the JAX package."""
    check_tower_ops(getattr(jbn, level.upper()), getattr(tbn, level.upper()), 40 + len(level))


def test_bn254_spec_matches_jax():
    """G2, the loop's digits and the pairing constants equal the JAX
    package's; 21 of the 64 digits are nonzero."""
    jg, tg = jbn.G2, tbn.G2
    assert (tg.a_host, tg.b_host, tg.gen_x, tg.gen_y, tg.cofactor) == (
        jg.a_host, jg.b_host, jg.gen_x, jg.gen_y, jg.cofactor)
    jp, tp = jbn.PAIRING, tbn.PAIRING
    assert tbn.ATE_LOOP_COUNT == jbn.ATE_LOOP_COUNT
    assert (tp.x, tp.x_abs, tp.x_neg, tp.twist_type, tp.digits, tp.two_inv_int,
            tp.twist_mul_by_q_x, tp.twist_mul_by_q_y) == (
        jp.x, jp.x_abs, jp.x_neg, jp.twist_type, jp.digits, jp.two_inv_int,
        jp.twist_mul_by_q_x, jp.twist_mul_by_q_y)
    assert tp.add_digits == [i for i, d in enumerate(jp.digits) if d] and len(tp.add_digits) == 21
    assert interop.same_field(tbn.FQ, jbn.FQ.modulus, jbn.FQ.generator_int, jbn.FQ.r_int,
                              jbn.FQ.r2_int, jbn.FQ.inv16)


def test_bn254_g2_prepare_and_miller_loop_match_jax():
    """The stored pairs are the port's (G, H), (2G, H), (G, 2H), (inf, H);
    g2_prepare and multi_miller_loop(combine=False) on them word for word;
    the converter keeps the JAX package's slots at the
    nonzero digits (and refuses a wrong slot count)."""
    ref = words()
    P, Q = bundle(ref, check=True)
    spec = tbn.PAIRING
    Qp = tpbn.g2_prepare(spec, Q)
    want = interop.bn_g2_prepared_from_numpy(spec, ref["dbl_coeffs"], ref["add_coeffs"],
                                             ref["q1_coeffs"], ref["q2_coeffs"], ref["q_inf"], "cpu")
    assert Qp.add_coeffs.shape[0] == 21 and ref["add_coeffs"].shape[0] == 64
    assert all(torch.equal(a, b) for a, b in zip(Qp, want))
    # the JAX package's zero-digit slots are not the port's: they are dropped
    assert not np.array_equal(ref["add_coeffs"][:21], interop.limbs_to_numpy(Qp.add_coeffs))
    with pytest.raises(ValueError):
        interop.bn_g2_prepared_from_numpy(spec, ref["dbl_coeffs"], ref["add_coeffs"][1:],
                                          ref["q1_coeffs"], ref["q2_coeffs"], ref["q_inf"], "cpu")
    f = tpbn.multi_miller_loop(spec, P, Qp, combine=False)
    assert np.array_equal(interop.limbs_to_numpy(f), ref["miller"])


def test_bn254_pairing_each_matches_jax():
    """pairing_each on the bundle's pairs word for word; lane 0 is
    testing.E_BN254, E^r = 1, E != 1, and the lanes are E, E^2, E^2, 1."""
    ref = words()
    P, Q = bundle(ref)
    gts = tpbn.pairing_each(tbn.PAIRING, P, Q)
    assert np.array_equal(interop.limbs_to_numpy(gts), ref["gts"])
    F12h = tbn.FQ12.host
    one = tuple(F12h.flatten(F12h.one()))
    e2, e_r = tt.gt_powers(F12h, tt.E_BN254, [2, tbn.FR.modulus])
    assert tt.fp12_to_flat(tbn.FQ12, gts) == [tt.E_BN254, e2, e2, one]
    assert e_r == one != tt.E_BN254


def test_bn254_pairing_matches_jax():
    """pairing (the product over the pairs, in the log tree) word for word:
    Ethereum's ecPairing check is whether it is 1; here E^5."""
    ref = words()
    P, Q = bundle(ref)
    prod = tpbn.pairing(tbn.PAIRING, P, Q)
    assert np.array_equal(interop.limbs_to_numpy(prod), ref["prod"])
    assert tt.fp12_to_flat(tbn.FQ12, prod[..., None]) == tt.gt_powers(tbn.FQ12.host, tt.E_BN254, [5])


@pytest.mark.slow
def test_stored_bn254_words_match_jax():
    """tests/vectors/bn254_pairing_bundle.npz equals what the JAX package
    computes now (~7 minutes of XLA compile on a CPU)."""
    mod = words_script()
    want = mod.words_bn254()
    ref = np.load(mod.OUT["bn254"])
    assert sorted(ref.files) == sorted(want)
    for k, v in want.items():
        assert ref[k].dtype == v.dtype and np.array_equal(ref[k], v), k
