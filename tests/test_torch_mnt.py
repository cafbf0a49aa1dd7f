"""Port parity for the MNT4/MNT6 pairings (ec/pairing/mnt.py,
curves/{mnt4_298,mnt6_298,mnt4_753,mnt6_753}.py) at L = 20 and L = 48.

The JAX package's MNT tests are slow-tier (its Miller ladders take minutes
of XLA compile), so these run no JAX function: they hold the port against
the JAX package's words stored in tests/vectors/<curve>_pairing.npz by
scripts/pairing_bundle_words.py, on the pairs (G, H) and (2G, 2H), and
against Python ints (the host towers, E = e(G, H) from those words).
One run of ``pairing_each`` per curve is held stage by stage: g1_prepare,
g2_prepare (every doubling step; the add steps at the nonzero digits, the
only slots the loop reads; final_add on the negative-loop curves MNT6-298
and MNT4-753), the Miller values (combine=False) and the final
exponentiation; on the 298-bit curves with a third lane whose G1 point is
at infinity (the engine is the same at L = 48, where the two stored lanes
run alone). A whole pairing on the CPU's plain versions takes 10-45 s a
curve, nearly all of it host time per operation, so the curves run one
pipeline each. The tests marked slow rebuild the words with the JAX
package."""

import importlib
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import rand_host, words_script  # noqa: E402
from zkarray_torch import interop  # noqa: E402
from zkarray_torch import testing as tt  # noqa: E402
from zkarray_torch.ec import sw as tsw  # noqa: E402
from zkarray_torch.ec.pairing import mnt as tmnt  # noqa: E402

CURVES = ["mnt4_298", "mnt6_298", "mnt4_753", "mnt6_753"]
VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")


def mods(name):
    return (importlib.import_module(f"zkarray.curves.{name}"),
            importlib.import_module(f"zkarray_torch.curves.{name}"))


def words(name):
    ref = np.load(os.path.join(VEC_DIR, f"{name}_pairing.npz"))
    return {k: (ref[k].astype(np.uint32) if ref[k].dtype == np.uint16 else ref[k]) for k in ref.files}


def host_g2(tm):
    """The host points H and 2H of the port's G2."""
    g2 = tm.G2
    h = (g2.gen_x, g2.gen_y)
    return [h, tt.ext_ec_add(g2.ops.host, h, h, g2.a_host)]


def stored_pairs(tm, ref, inf_lane):
    """The stored pairs (G, H), (2G, 2H), held against the port's
    generators and the host's doublings, and with ``inf_lane`` a third lane
    (infinity, H)."""
    P = interop.affine_from_numpy(ref["p_x"], ref["p_y"], np.zeros(2, bool), "cpu")
    g = (tm.G1.gen_x, tm.G1.gen_y)
    assert tsw.affine_to_ints(tm.G1, P) == [g, tt.ec_add(g, g, tm.G1.a_int, tm.G1.base.modulus)]
    Q = tt.g2_affine_from_ints(tm.G2, host_g2(tm))
    assert np.array_equal(interop.limbs_to_numpy(Q.x), ref["q_x"])
    assert np.array_equal(interop.limbs_to_numpy(Q.y), ref["q_y"])
    if not inf_lane:
        return P, Q
    cat3 = lambda t: torch.cat([t, t[..., :1]], -1)  # noqa: E731
    P3 = P._replace(x=cat3(P.x), y=cat3(P.y), inf=torch.tensor([False, False, True]))
    Q3 = Q._replace(x=cat3(Q.x), y=cat3(Q.y), inf=torch.zeros(3, dtype=torch.bool))
    return P3, Q3


@pytest.mark.parametrize("name", CURVES)
def test_mnt_spec_and_towers_match(name):
    """Fields, curves, towers (nonresidues and Frobenius tables) and the
    pairing spec's constants equal the JAX package's; the towers' product,
    square, inverse (0 -> 0), Frobenius maps and conjugate equal the host's
    on random elements."""
    jm, tm = mods(name)
    for js, ts in ((jm.FQ, tm.FQ), (jm.FR, tm.FR)):
        assert interop.same_field(ts, js.modulus, js.generator_int, js.r_int, js.r2_int, js.inv16)
    assert tm.FQ.num_limbs == (20 if name.endswith("298") else 48)
    assert interop.same_curve(tm.G1, jm.G1.a_int, jm.G1.b_int, jm.G1.gen_x, jm.G1.gen_y,
                              jm.G1.cofactor)
    jg, tg = jm.G2, tm.G2
    assert (tg.a_host, tg.b_host, tg.gen_x, tg.gen_y, tg.cofactor) == (
        jg.a_host, jg.b_host, jg.gen_x, jg.gen_y, jg.cofactor)
    jp, tp = jm.PAIRING, tm.PAIRING
    fields = ("name", "twist_host", "twist_inv_host", "twist_coeff_a_host", "ate_loop_count",
              "ate_is_loop_count_neg", "final_exp_last_chunk_1", "final_exp_w0_abs",
              "final_exp_w0_neg")
    assert [getattr(tp, k) for k in fields] == [getattr(jp, k) for k in fields]
    assert tp.ate_is_loop_count_neg == (name in ("mnt6_298", "mnt4_753"))
    assert tp.add_rows == words(name)["add_rows"].tolist()
    rng = random.Random(len(name))
    for J, T in ((jp.tw, tp.tw), (jp.gt, tp.gt)):
        assert (T.name, T.deg, T.shape, T.nonresidue_host, T._frob) == (
            J.name, J.deg, J.shape, J.nonresidue_host, J._frob)
        H = T.host
        xs = [H.zero()] + [rand_host(H, rng) for _ in range(2)]
        ys = [rand_host(H, rng) for _ in range(3)]
        a = T.from_ints(tt_nest(T, xs), "cpu")
        b = T.from_ints(tt_nest(T, ys), "cpu")
        flat = lambda t: tt.fp12_to_flat(T, t)  # noqa: E731
        assert flat(T.mul(a, b)) == [tuple(H.flatten(H.mul(x, y))) for x, y in zip(xs, ys)]
        assert flat(T.sqr(b)) == [tuple(H.flatten(H.mul(y, y))) for y in ys]
        assert flat(T.inv(a)) == [tuple(H.flatten(H.inv(x))) for x in xs]
        for i in range(T.deg_abs):
            assert flat(T.frobenius(b, i)) == [tuple(H.flatten(H.frobenius(y, i))) for y in ys], i
    T = tp.gt
    b = T.from_ints(tt_nest(T, ys), "cpu")
    conj = [tuple(T.host.flatten((y[0], T.host.base.neg(y[1])))) for y in ys]
    assert tt.fp12_to_flat(T, T.conjugate(b)) == conj


def tt_nest(T, elems):
    """Host elements -> from_ints' coefficient-major nesting."""
    def nest(host, vals):
        if not hasattr(host, "deg"):
            return list(vals)
        return [nest(host.base, [v[j] for v in vals]) for j in range(host.deg)]
    return nest(T.host, elems)


@pytest.mark.parametrize("name", CURVES)
def test_mnt_pairing_matches_jax_words(name, monkeypatch):
    """One pairing_each over (G, H), (2G, 2H) and, on the 298-bit curves,
    (infinity, H), each stage held word for word against the JAX package's
    stored words: g1_prepare, g2_prepare (final_add included; the add steps
    the loop reads), the Miller values and the final exponentiation; lane 0
    is E = e(G, H), testing's constant, lane 1 E^4, lane 2 one; E^r = 1 !=
    E on the host."""
    _, tm = mods(name)
    ref = words(name)
    spec = tm.PAIRING
    inf_lane = name.endswith("298")
    P3, Q3 = stored_pairs(tm, ref, inf_lane)
    seen = {}
    for fn in ("g1_prepare", "g2_prepare", "multi_miller_loop", "final_exponentiation"):
        def wrap(*a, _f=getattr(tmnt, fn), _k=fn, **kw):
            seen[_k] = _f(*a, **kw)
            return seen[_k]
        monkeypatch.setattr(tmnt, fn, wrap)
    with torch.inference_mode():
        gts = tmnt.pairing_each(spec, P3, Q3)
    two = lambda t: interop.limbs_to_numpy(t[..., :2])  # noqa: E731
    P1, Qp = seen["g1_prepare"], seen["g2_prepare"]
    assert np.array_equal(two(P1.x_twist), ref["x_twist"])
    assert np.array_equal(two(P1.y_twist), ref["y_twist"])
    for k in ("x_over_twist", "y_over_twist", "dbl_coeffs", "add_coeffs", "final_add"):
        assert np.array_equal(two(getattr(Qp, k)), ref[k]), k
    assert np.array_equal(two(seen["multi_miller_loop"]), ref["miller"])
    assert np.array_equal(two(gts), ref["gts"])
    assert np.array_equal(ref["e"], ref["gts"][..., :1])
    T = spec.gt
    assert gts.shape[-1] == 2 + inf_lane
    if inf_lane:
        assert torch.equal(gts[..., 2:], T.one((1,), "cpu"))
    E = getattr(tt, f"E_{name.upper()}")
    e4, e_r = tt.gt_powers(T.host, E, [4, tm.FR.modulus])
    assert tt.fp12_to_flat(T, gts[..., :2]) == [E, e4]
    assert e_r == tuple(T.host.flatten(T.host.one())) != E
    got = interop.mnt_g2_prepared_to_numpy(Qp)
    want = (ref["x_over_twist"], ref["y_over_twist"], ref["dbl_coeffs"], ref["add_coeffs"],
            ref["final_add"])
    assert all(np.array_equal(g[..., :2], w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", ["mnt4_298"])
def test_mnt_pairing_product_and_interop(name):
    """pairing (the product over the pairs) on the stored prepared words:
    E * E^4 = E^5; the converters map the JAX package's per-digit add slots
    (here the stored rows, other slots noise) onto the port's and refuse a
    wrong count."""
    _, tm = mods(name)
    ref = words(name)
    spec = tm.PAIRING
    steps = len(spec.digits)
    rng = np.random.default_rng(7)
    full = rng.integers(0, 1 << 16, (steps,) + ref["add_coeffs"].shape[1:]).astype(np.uint32)
    full[spec.add_rows] = ref["add_coeffs"]
    args = (ref["x_over_twist"], ref["y_over_twist"], ref["dbl_coeffs"])
    Qp = interop.mnt_g2_prepared_from_numpy(spec, *args, full, ref["final_add"], np.zeros(2, bool),
                                            "cpu")
    assert np.array_equal(interop.mnt_g2_prepared_to_numpy(Qp)[3], ref["add_coeffs"])
    with pytest.raises(ValueError):
        interop.mnt_g2_prepared_from_numpy(spec, *args, full[1:], ref["final_add"],
                                           np.zeros(2, bool), "cpu")
    P1 = interop.mnt_g1_prepared_from_numpy(ref["p_x"], ref["p_y"], ref["x_twist"], ref["y_twist"],
                                            np.zeros(2, bool), "cpu")
    with torch.inference_mode():
        f = tmnt.multi_miller_loop(spec, P1, Qp, combine=True)
        got = tmnt.final_exponentiation(spec, f[..., None])
    T = spec.gt
    assert tt.fp12_to_flat(T, got) == tt.gt_powers(T.host, tt.E_MNT4_298, [5])


@pytest.mark.slow
@pytest.mark.parametrize("name", CURVES)
def test_stored_mnt_words_match_jax(name):
    """The stored MNT words equal what the JAX package computes now (1-4
    minutes of XLA compile each on a CPU)."""
    mod = words_script()
    want = mod.words_mnt(name)
    ref = np.load(mod.OUT[name])
    assert sorted(ref.files) == sorted(want)
    for k, v in want.items():
        assert ref[k].dtype == v.dtype and np.array_equal(ref[k], v), k
