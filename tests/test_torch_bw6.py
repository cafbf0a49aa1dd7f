"""Port parity for the BW6 pairings (ec/pairing/bw6.py, curves/bw6_761.py,
curves/bw6_767.py, ec/pairing/mnt.py:ext_pow_const) at L = 48: the towers
Fq3 and Fq6 against the JAX package's at width 2; the specs' constants
(Python's floor division in d1, d2 and (x - 1)/3 with BW6-767's negative
h_t, h_y and x); g2_prepare (both loops' doublings, the add steps at the
set bits of u and the nonzero digits of loop 2, the extra line), the Miller
value (combine=False; a lane at infinity gives 1) and the final
exponentiation, each held word for word against the JAX package's words on
the pairs (G, H) and (2G, 2H) (tests/vectors/bw6_761_pairing.npz and
bw6_767_pairing.npz, written by scripts/pairing_bundle_words.py); E =
e(G, H) against testing.E_BW6_761/767. BW6-761 takes Algorithm 4.4 of the
final exponentiation and BW6-767 (t = 0 mod r, loop 1 negated)
Algorithm 4.3. The pieces are tested apart: a whole pairing on the CPU's
plain versions takes ~30 s; chip_smoke.py runs whole pairings on the card.
The tests marked slow rebuild the words with the JAX package."""

import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import check_tower_ops, words_script  # noqa: E402
from zkarray_torch import interop  # noqa: E402
from zkarray_torch import testing as tt  # noqa: E402
from zkarray_torch.ec.pairing import bw6 as tbw6  # noqa: E402
from zkarray_torch.ec import sw as tsw  # noqa: E402
from zkarray_torch.ec.pairing import mnt as tmnt  # noqa: E402

CURVES = ["bw6_761", "bw6_767"]
VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")


def mods(name):
    return (importlib.import_module(f"zkarray.curves.{name}"),
            importlib.import_module(f"zkarray_torch.curves.{name}"))


def words(name):
    ref = np.load(os.path.join(VEC_DIR, f"{name}_pairing.npz"))
    return {k: (ref[k].astype(np.uint32) if ref[k].dtype == np.uint16 else ref[k]) for k in ref.files}


def pairs(name, ref):
    """The stored pairs (G, H), (2G, 2H), held against the port's
    generators and the host's doublings."""
    _, tm = mods(name)
    P = interop.affine_from_numpy(ref["p_x"], ref["p_y"], np.zeros(2, bool), "cpu")
    Q = interop.affine_from_numpy(ref["q_x"], ref["q_y"], np.zeros(2, bool), "cpu")
    for A, C in ((P, tm.G1), (Q, tm.G2)):
        g = (C.gen_x, C.gen_y)
        assert tsw.affine_to_ints(C, A) == [g, tt.ec_add(g, g, C.a_int, C.base.modulus)]
    return P, Q


def prepared(ref):
    return tbw6.G2Prepared(*(interop.limbs_from_numpy(ref[k], "cpu")
                             for k in ("dbl_1", "add_1", "extra", "dbl_2", "add_2")),
                           torch.zeros(2, dtype=torch.bool))


@pytest.mark.parametrize("level", ["Fq3", "Fq6"])
@pytest.mark.parametrize("name", CURVES)
def test_bw6_towers_match_jax(name, level):
    """Fq3 (u^3 = -4 or 3) and Fq6 (v^2 = u, its nonresidue product a
    shuffle and one Fq product here, a full Fq3 product in the JAX package)
    against the JAX package at width 2."""
    jm, tm = mods(name)
    check_tower_ops(getattr(jm, level.upper()), getattr(tm, level.upper()), 60 + len(name + level))


@pytest.mark.parametrize("name", CURVES)
def test_bw6_spec_matches_jax(name):
    """Fields, curves and the pairing spec's constants equal the JAX
    package's, floor divisions included."""
    jm, tm = mods(name)
    for js, ts in ((jm.FQ, tm.FQ), (jm.FR, tm.FR)):
        assert interop.same_field(ts, js.modulus, js.generator_int, js.r_int, js.r2_int, js.inv16)
    assert tm.FQ.num_limbs == 48
    for jc, tc in ((jm.G1, tm.G1), (jm.G2, tm.G2)):
        assert interop.same_curve(tc, jc.a_int, jc.b_int, jc.gen_x, jc.gen_y, jc.cofactor)
    jp, tp = jm.PAIRING, tm.PAIRING
    fields = ("x", "x_is_neg", "x_abs", "x_minus_1_div_3", "loop_1_bits", "loop_1_neg",
              "ate_loop_count_2", "loop_2_neg", "twist_type", "h_t", "h_y", "t_mod_r_is_zero")
    assert [getattr(tp, k) for k in fields] == [getattr(jp, k) for k in fields]
    assert tp.digits_2 == list(jp.ate_loop_count_2[:-1])[::-1]
    assert tp.t_mod_r_is_zero == tp.loop_1_neg == (name == "bw6_767")
    ref = words(name)
    assert tp.add_rows_1 == ref["add_1_rows"].tolist() and tp.add_rows_2 == ref["add_2_rows"].tolist()


@pytest.mark.parametrize("name", CURVES)
def test_bw6_g2_prepare_matches_jax(name):
    """g2_prepare on Q = (H, 2H) word for word; the converter maps the JAX
    package's per-bit slots onto the port's (a per-bit layout made from the
    stored slots, other slots filled with noise) and refuses a wrong count."""
    _, tm = mods(name)
    ref = words(name)
    _, Q = pairs(name, ref)
    spec = tm.PAIRING
    Qp = tbw6.g2_prepare(spec, Q)
    want = prepared(ref)
    for k in ("dbl_1", "add_1", "extra", "dbl_2", "add_2", "inf"):
        assert torch.equal(getattr(Qp, k), getattr(want, k)), k
    rng = np.random.default_rng(5)
    full = []
    for k, rows, n in (("add_1", spec.add_rows_1, len(spec.loop_1_bits)),
                       ("add_2", spec.add_rows_2, len(spec.digits_2))):
        slots = rng.integers(0, 1 << 16, (n,) + ref[k].shape[1:]).astype(np.uint32)
        slots[rows] = ref[k]
        full.append(slots)
    got = interop.bw6_g2_prepared_from_numpy(spec, ref["dbl_1"], full[0], ref["extra"], ref["dbl_2"],
                                             full[1], np.zeros(2, bool), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        interop.bw6_g2_prepared_from_numpy(spec, ref["dbl_1"], full[0][1:], ref["extra"],
                                           ref["dbl_2"], full[1], np.zeros(2, bool), "cpu")


@pytest.mark.parametrize("name", CURVES)
def test_bw6_miller_loop_matches_jax(name):
    """multi_miller_loop(combine=False) on the stored coefficients word for
    word, with a third lane whose G1 point is at infinity giving 1."""
    _, tm = mods(name)
    ref = words(name)
    P, _ = pairs(name, ref)
    Qp = prepared(ref)
    cat3 = lambda t: torch.cat([t, t[..., :1]], -1)  # noqa: E731
    P3 = P._replace(x=cat3(P.x), y=cat3(P.y), inf=torch.tensor([False, False, True]))
    Qp3 = Qp._replace(**{k: cat3(getattr(Qp, k)) for k in ("dbl_1", "add_1", "extra", "dbl_2", "add_2")},
                      inf=torch.zeros(3, dtype=torch.bool))
    f = tbw6.multi_miller_loop(tm.PAIRING, P3, Qp3, combine=False)
    assert np.array_equal(interop.limbs_to_numpy(f[..., :2]), ref["miller"])
    assert torch.equal(f[..., 2:], tm.FQ6.one((1,), "cpu"))


@pytest.mark.parametrize("name", CURVES)
def test_bw6_final_exponentiation_matches_jax(name):
    """final_exponentiation of the stored Miller values word for word
    (Algorithm 4.4 on BW6-761, 4.3 on BW6-767); lane 0 is E = e(G, H),
    testing's constant, lane 1 is E^4, E^r = 1 and E != 1 on the host;
    ext_pow_const against the host too."""
    _, tm = mods(name)
    ref = words(name)
    spec = tm.PAIRING
    gts = tbw6.final_exponentiation(spec, interop.limbs_from_numpy(ref["miller"], "cpu"))
    assert np.array_equal(interop.limbs_to_numpy(gts), ref["gts"])
    assert np.array_equal(ref["e"], ref["gts"][..., :1])
    E = getattr(tt, f"E_{name.upper()}")
    F6h = tm.FQ6.host
    one = tuple(F6h.flatten(F6h.one()))
    e4, e_r, e13 = tt.gt_powers(F6h, E, [4, tm.FR.modulus, 13])
    assert tt.fp12_to_flat(tm.FQ6, gts) == [E, e4] and e_r == one != E
    assert tt.fp12_to_flat(tm.FQ6, tmnt.ext_pow_const(tm.FQ6, gts[..., :1], 13)) == [e13]
    assert torch.equal(tmnt.ext_pow_const(tm.FQ6, gts, 0), tm.FQ6.one((2,), "cpu"))


@pytest.mark.slow
@pytest.mark.parametrize("name", CURVES)
def test_stored_bw6_words_match_jax(name):
    """The stored BW6 words equal what the JAX package computes now (~10
    minutes of XLA compile each on a CPU)."""
    mod = words_script()
    want = getattr(mod, f"words_{name}")()
    ref = np.load(mod.OUT[name])
    assert sorted(ref.files) == sorted(want)
    for k, v in want.items():
        assert ref[k].dtype == v.dtype and np.array_equal(ref[k], v), k
