"""Port parity for the CP6-782 pairing (ec/pairing/cp6.py,
curves/cp6_782.py) at L = 52, and for the host towers' exact inverse
(ff/tower_host.py:HostExt.inv).

The JAX package's CP6 test is slow-tier, and its host G2 preparation
inverts in Fq3 by Fermat (~2.5 minutes a point on a CPU), so these run no
JAX function: they hold the port against the JAX package's words stored in
tests/vectors/cp6_782_pairing.npz by scripts/pairing_bundle_words.py, on
the pairs (G, H) and (2G, 2H), and against Python ints. One run of
``pairing_each`` is held stage by stage: g2_prepare_host (every doubling
step's gro and gt; the add steps at the set bits of the loop count, the
only slots the loop reads), the Miller values (combine=False) and the
final exponentiation, on the two stored lanes; a third lane whose G1 point
is at infinity runs through the ladder's first steps beside them (a whole
ladder takes ~30 s on the CPU's plain versions, nearly all of it host time
per operation). The test marked slow rebuilds the words with the JAX
package."""

import copy
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import rand_host, words_script  # noqa: E402
from zkarray.curves import cp6_782 as jm  # noqa: E402
from zkarray_torch import interop  # noqa: E402
from zkarray_torch import testing as tt  # noqa: E402
from zkarray_torch.curves import cp6_782 as tm  # noqa: E402
from zkarray_torch.ec import sw as tsw  # noqa: E402
from zkarray_torch.ec.pairing import cp6 as tcp6  # noqa: E402

VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")


def words():
    ref = np.load(os.path.join(VEC_DIR, "cp6_782_pairing.npz"))
    return {k: (ref[k].astype(np.uint32) if ref[k].dtype == np.uint16 else ref[k]) for k in ref.files}


def host_g2():
    g2 = tm.G2
    h = (g2.gen_x, g2.gen_y)
    return [h, tt.ext_ec_add(g2.ops.host, h, h, g2.a_host)]


def test_cp6_spec_matches_jax():
    """Fields (Fr is BLS12-377's Fq, the port's own copy), curves, towers
    and the pairing spec's constants equal the JAX package's; the set bits
    of the loop count are the stored add-step rows."""
    for js, ts in ((jm.FQ, tm.FQ), (jm.FR, tm.FR)):
        assert interop.same_field(ts, js.modulus, js.generator_int, js.r_int, js.r2_int, js.inv16)
    from zkarray_torch.curves import bls12_377
    assert tm.FR.modulus == bls12_377.FQ.modulus and tm.FQ.num_limbs == 52
    assert interop.same_curve(tm.G1, jm.G1.a_int, jm.G1.b_int, jm.G1.gen_x, jm.G1.gen_y,
                              jm.G1.cofactor)
    jg, tg = jm.G2, tm.G2
    assert (tg.a_host, tg.b_host, tg.gen_x, tg.gen_y, tg.cofactor) == (
        jg.a_host, jg.b_host, jg.gen_x, jg.gen_y, jg.cofactor)
    for J, T in ((jm.FQ3, tm.FQ3), (jm.FQ6, tm.FQ6)):
        assert (T.name, T.deg, T.shape, T.nonresidue_host, T._frob) == (
            J.name, J.deg, J.shape, J.nonresidue_host, J._frob)
    jp, tp = jm.PAIRING, tm.PAIRING
    fields = ("name", "twist_host", "ate_loop_count", "w0_abs", "w0_neg", "w1")
    assert [getattr(tp, k) for k in fields] == [getattr(jp, k) for k in fields]
    assert tp.steps_bits == [int(b) for b in bin(jp.ate_loop_count)[3:]]
    assert (len(tp.steps_bits), len(tp.add_rows)) == (781, 393)
    assert tp.add_rows == words()["add_rows"].tolist()


# every degree the port's towers take: quadratic over a prime (MNT4's Fq2,
# BLS12-381's Fp2) and over a cubic (CP6's, MNT6's and BW6's Fq6), cubic
# over a prime (Fq3) and over a quadratic (BLS12-381's Fp6), and the
# degree-4 and degree-12 towers above them
HOST_TOWERS = [("mnt4_753", "FQ2"), ("mnt4_298", "FQ4"), ("cp6_782", "FQ3"), ("cp6_782", "FQ6"),
               ("mnt6_753", "FQ6"), ("bls12_381", "FQ6"), ("bn254", "FQ12")]


@pytest.mark.parametrize("curve,level", HOST_TOWERS, ids=[f"{c}-{lv}" for c, lv in HOST_TOWERS])
def test_host_inverse_matches_fermat(curve, level):
    """HostExt.inv (through the norm: one base-field inverse) equals the
    JAX package's Fermat power a^(p^k - 2) on a random element and on one
    whose constant coefficient is zero; 0 -> 0; a a^-1 = 1."""
    import importlib

    F = getattr(importlib.import_module(f"zkarray_torch.curves.{curve}"), level).host
    rng = random.Random(len(curve + level))
    x = rand_host(F, rng)
    xs = [x, tuple(F.base.zero() if j == 0 else c for j, c in enumerate(x))]
    for a in xs:
        inv = F.inv(a)
        assert inv == F.inv_fermat(a)
        assert F.mul(a, inv) == F.one()
    assert F.inv(F.zero()) == F.zero() == F.inv_fermat(F.zero())


def test_cp6_pairing_matches_jax_words(monkeypatch):
    """One pairing_each over (G, H), (2G, 2H), each stage held word for word
    against the JAX package's stored words: g2_prepare_host, the Miller
    values and the final exponentiation; lane 0 is E = e(G, H), testing's
    constant, lane 1 E^4; E^r = 1 != E on the host. On the ladder's first
    eight steps (three add steps among them), a lane (infinity, H) beside the
    two stays one and leaves theirs as they are. The converters map the JAX
    package's per-step add slots onto the port's rows."""
    ref = words()
    spec = tm.PAIRING
    P = interop.affine_from_numpy(ref["p_x"], ref["p_y"], np.zeros(2, bool), "cpu")
    g = (tm.G1.gen_x, tm.G1.gen_y)
    assert tsw.affine_to_ints(tm.G1, P) == [g, tt.ec_add(g, g, tm.G1.a_int, tm.G1.base.modulus)]
    qs = host_g2()
    Q = tt.g2_affine_from_ints(tm.G2, qs)
    assert np.array_equal(interop.limbs_to_numpy(Q.x), ref["q_x"])
    assert np.array_equal(interop.limbs_to_numpy(Q.y), ref["q_y"])
    seen = {}
    for fn in ("g2_prepare_host", "multi_miller_loop"):
        def wrap(*a, _f=getattr(tcp6, fn), _k=fn, **kw):
            seen[_k] = _f(*a, **kw)
            return seen[_k]
        monkeypatch.setattr(tcp6, fn, wrap)
    with torch.inference_mode():
        gts = tcp6.pairing_each(spec, P, qs)
    two = lambda t: interop.limbs_to_numpy(t[..., :2])  # noqa: E731
    Qp = seen["g2_prepare_host"]
    for k in ("dbl_gro", "dbl_gt", "add_gro", "add_gt"):
        assert np.array_equal(two(getattr(Qp, k)), ref[k]), k
    assert not Qp.inf.any()
    assert np.array_equal(two(seen["multi_miller_loop"]), ref["miller"])
    assert np.array_equal(two(gts), ref["gts"])
    assert np.array_equal(ref["e"], ref["gts"][..., :1])
    F6 = tm.FQ6
    assert gts.shape[-1] == 2
    e4, e_r = tt.gt_powers(F6.host, tt.E_CP6_782, [4, tm.FR.modulus])
    assert tt.fp12_to_flat(F6, gts[..., :2]) == [tt.E_CP6_782, e4]
    assert e_r == tuple(F6.host.flatten(F6.host.one())) != tt.E_CP6_782
    short = copy.copy(spec)
    short.steps_bits = spec.steps_bits[:8]
    assert sum(short.steps_bits) == 3
    cat3 = lambda t: torch.cat([t, t[..., :1]], -1)  # noqa: E731
    P3 = P._replace(x=cat3(P.x), y=cat3(P.y), inf=torch.tensor([False, False, True]))
    Qp3 = tcp6.CP6G2Prepared(*(cat3(v) for v in Qp[:4]), torch.zeros(3, dtype=torch.bool))
    with torch.inference_mode():
        f2 = tcp6.multi_miller_loop(short, P, Qp, False)
        f3 = tcp6.multi_miller_loop(short, P3, Qp3, False)
    assert torch.equal(f3[..., :2], f2) and not torch.equal(f2[..., :1], F6.one((1,), "cpu"))
    assert torch.equal(f3[..., 2:], F6.one((1,), "cpu"))
    # the JAX package's layout: an add slot per step, zeros at a clear bit
    full = {k: np.zeros((781,) + ref[k].shape[1:], np.uint32) for k in ("add_gro", "add_gt")}
    for k in full:
        full[k][spec.add_rows] = ref[k]
    got = interop.cp6_g2_prepared_from_numpy(spec, ref["dbl_gro"], ref["dbl_gt"], full["add_gro"],
                                             full["add_gt"], np.zeros(2, bool), "cpu")
    assert all(np.array_equal(a, b[..., :2]) for a, b in
               zip(interop.cp6_g2_prepared_to_numpy(got)[:4], interop.cp6_g2_prepared_to_numpy(Qp)))
    with pytest.raises(ValueError):
        interop.cp6_g2_prepared_from_numpy(spec, ref["dbl_gro"], ref["dbl_gt"], full["add_gro"][1:],
                                           full["add_gt"], np.zeros(2, bool), "cpu")


@pytest.mark.slow
def test_stored_cp6_words_match_jax():
    """The stored CP6-782 words equal what the JAX package computes now
    (~7 minutes on a CPU, most of it its Fermat inverses on the host)."""
    mod = words_script()
    want = mod.words_cp6_782()
    ref = np.load(mod.OUT["cp6_782"])
    assert sorted(ref.files) == sorted(want)
    for k, v in want.items():
        assert ref[k].dtype == v.dtype and np.array_equal(ref[k], v), k
