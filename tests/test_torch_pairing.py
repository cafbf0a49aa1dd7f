"""Port parity for the pairing path: ec/sw_ext.py (the G2 group law on its
edge classes, scalar_mul_const by |X|, to_affine, is_on_curve),
ec/pairing/bls12.py (g2_prepare, multi_miller_loop, pairing_each, pairing),
the G2 subgroup check and the G2 encodings, bit for bit against the JAX
package where it runs at these shapes, else against host known answers
(testing.py's E constants, HostExt powers, host G2 arithmetic).

The BLS12-381 slice test takes tests/pairing_bundle.py's width-4 pairs and
the JAX package's words for them, and the BLS12-377 tests the JAX package's
E = e(G, H), both stored by scripts/pairing_bundle_words.py; the tests
marked slow rebuild those words with the JAX package and hold the files
equal to them. The port's CPU path is the plain versions: one pairing takes
~10 s here."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import words_script  # noqa: E402
from zkarray.curves import bls12_381 as jb  # noqa: E402
from zkarray.curves import bls12_381_zcash as jzc  # noqa: E402
from zkarray.ec import fast_checks as jfast  # noqa: E402
from zkarray.ec import point_serde as jps  # noqa: E402
from zkarray.ec import sw_ext as jsw_ext  # noqa: E402
from zkarray_torch import interop  # noqa: E402
from zkarray_torch import testing as tt  # noqa: E402
from zkarray_torch.curves import bls12_377 as t377  # noqa: E402
from zkarray_torch.curves import bls12_381 as tb  # noqa: E402
from zkarray_torch.curves import bls12_381_zcash as tzc  # noqa: E402
from zkarray_torch.ec import fast_checks as tfast  # noqa: E402
from zkarray_torch.ec import point_serde as tps  # noqa: E402
from zkarray_torch.ec import sw_ext as tsw_ext  # noqa: E402
from zkarray_torch.ec.pairing import bls12 as tbls12  # noqa: E402

VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")


def same(j, t):
    """A JAX array and a port tensor (limbs, or a bool mask) hold equal words."""
    if t.dtype == torch.bool:
        return np.array_equal(np.asarray(j), t.numpy())
    return np.array_equal(np.asarray(j), interop.limbs_to_numpy(t))


def bundle_pairs():
    """tests/pairing_bundle.py's four pairs built with the port on the CPU:
    (G, H), (2G, H), (G, 2H), (infinity, H)."""
    from zkarray_torch.ec import sw as tsw

    G = tb.G1.generator((1,), "cpu")
    G2 = tsw.to_affine(tb.G1, tsw.jac_double(tb.G1, tsw.from_affine(tb.G1, G)))
    H = tb.G2.generator((1,), "cpu")
    H2 = tsw_ext.to_affine(tb.G2, tsw_ext.double(tb.G2, tsw_ext.from_affine(tb.G2, H)))
    zero = torch.zeros_like(G.x)
    P = tsw.AffinePoints(torch.cat([G.x, G2.x, G.x, zero], 1), torch.cat([G.y, G2.y, G.y, zero], 1),
                         torch.tensor([False, False, False, True]))
    Q = tsw_ext.ExtAffine(torch.cat([H.x, H.x, H2.x, H.x], -1), torch.cat([H.y, H.y, H2.y, H.y], -1),
                          torch.zeros(4, dtype=torch.bool))
    return P, Q


def test_bls12_381_slice_matches_jax():
    """g2_prepare (every doubling's coefficients, the add steps' at the set
    bits of |X|), multi_miller_loop(combine=False), pairing_each and pairing
    (the product over the pairs, in the log tree) on
    tests/pairing_bundle.py's four pairs, word for word against the JAX
    package's words for them (tests/vectors/bls12_381_pairing_bundle.npz,
    written by scripts/pairing_bundle_words.py from the bundle: building
    the bundle in a test worker costs minutes of XLA compile and can crash
    XLA:CPU in a worker that has compiled much, as test_bn_pairing_bilinear
    does). Lane 0 is E = e(G, H), testing's stored constant; E^r = 1, E != 1
    and the product E^5 on the host."""
    ref = np.load(os.path.join(VEC_DIR, "bls12_381_pairing_bundle.npz"))

    def same16(name, t):
        return np.array_equal(ref[name].astype(np.uint32), interop.limbs_to_numpy(t))

    P, Q = bundle_pairs()
    assert same16("p_x", P.x) and same16("p_y", P.y) and np.array_equal(ref["p_inf"], P.inf.numpy())
    assert same16("q_x", Q.x) and same16("q_y", Q.y) and np.array_equal(ref["q_inf"], Q.inf.numpy())
    spec = tb.PAIRING
    assert spec.add_bits == ref["add_bits"].tolist() == [
        i for i, b in enumerate(jb.PAIRING.x_bits) if b]
    Qp = tbls12.g2_prepare(spec, Q)
    want = interop.g2_prepared_from_numpy(ref["dbl_coeffs"].astype(np.uint32),
                                          ref["add_coeffs"].astype(np.uint32), ref["q_inf"], device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(Qp, want))
    assert all(np.array_equal(a, b) for a, b in zip(interop.g2_prepared_to_numpy(want), (
        ref["dbl_coeffs"], ref["add_coeffs"], ref["q_inf"])))
    assert same16("miller", tbls12.multi_miller_loop(spec, P, Qp, combine=False))
    gts = tbls12.pairing_each(spec, P, Q)
    assert same16("gts", gts)
    prod = tbls12.pairing(spec, P, Q)
    assert same16("prod", prod)
    F12h = tb.FQ12.host
    one = tuple(F12h.flatten(F12h.one()))
    assert tt.fp12_to_flat(tb.FQ12, gts)[0] == tt.E_BLS12_381 != one
    # E^r = 1; pairs (G, H), (2G, H), (G, 2H), (inf, H) multiply to E E^2 E^2 1
    e_r, e_5 = tt.gt_powers(F12h, tt.E_BLS12_381, [tb.FR.modulus, 5])
    assert e_r == one and tt.fp12_to_flat(tb.FQ12, prod[..., None])[0] == e_5


@pytest.mark.slow
@pytest.mark.parametrize("curve", ["bls12_381", "bls12_377"])
def test_stored_pairing_words_match_jax(curve):
    """The stored JAX words (tests/vectors) equal what the JAX package
    computes now: tests/pairing_bundle.py's BLS12-381 bundle with its
    g2_prepare and Miller values, and BLS12-377's pairing_each(G, H) (the
    D-twist path). Minutes of XLA compile each on a CPU."""
    mod = words_script()
    want = {"bls12_381": mod.words_bls12_381, "bls12_377": mod.words_bls12_377}[curve]()
    ref = np.load(mod.OUT[curve])
    assert sorted(ref.files) == sorted(want)
    for k, v in want.items():
        assert ref[k].dtype == v.dtype and np.array_equal(ref[k], v), k


def test_bls12_377_e_constant_matches_jax_words():
    """testing.E_BLS12_377 is the JAX package's pairing_each(G, H) on
    BLS12-377 (tests/vectors/bls12_377_pairing_e.npz), computed on the
    port's generators."""
    ref = np.load(os.path.join(VEC_DIR, "bls12_377_pairing_e.npz"))
    gen1, gen2 = t377.G1.generator((1,), "cpu"), t377.G2.generator((1,), "cpu")
    for name, t in (("g_x", gen1.x), ("g_y", gen1.y), ("h_x", gen2.x), ("h_y", gen2.y)):
        assert np.array_equal(ref[name].astype(np.uint32), interop.limbs_to_numpy(t)), name
    e = interop.limbs_from_numpy(ref["e"].astype(np.uint32), "cpu")
    assert tt.fp12_to_flat(t377.FQ12, e) == [tt.E_BLS12_377]


def test_bls12_377_pairing_each_known_answers():
    """BLS12-377 (D-twist, mul_by_034 lines; its JAX suite is slow-tier):
    pairing_each at width 2 on (G, H) and (aG, bH) gives E, word for word
    the JAX package's (tests/vectors/bls12_377_pairing_e.npz), and E^(ab);
    bilinearity, non-degeneracy and E^r = 1 on the host."""
    rng = np.random.default_rng(377)
    spec = t377.PAIRING
    P, Q, ab, _ = tt.pairing_inputs(spec, 2, rng, base_n=2, inf_every=1 << 30)
    gen1 = t377.G1.generator((1,), "cpu")
    gen2 = t377.G2.generator((1,), "cpu")
    P = P._replace(x=torch.cat([gen1.x, P.x[:, 1:]], 1), y=torch.cat([gen1.y, P.y[:, 1:]], 1))
    Q = Q._replace(x=torch.cat([gen2.x, Q.x[..., 1:]], -1), y=torch.cat([gen2.y, Q.y[..., 1:]], -1))
    gts = tbls12.pairing_each(spec, P, Q)
    ref = np.load(os.path.join(VEC_DIR, "bls12_377_pairing_e.npz"))
    assert np.array_equal(ref["e"].astype(np.uint32), interop.limbs_to_numpy(gts[..., :1]))
    got = tt.fp12_to_flat(t377.FQ12, gts)
    F12h = t377.FQ12.host
    one = tuple(F12h.flatten(F12h.one()))
    e_ab, e_r = tt.gt_powers(F12h, tt.E_BLS12_377, [ab[1], t377.FR.modulus])
    assert got == [tt.E_BLS12_377, e_ab]
    assert got[0] != one and e_r == one


def test_g2_group_law_matches_jax():
    """double and add on the edge classes (generic, P = Q, P = -Q, P, Q or
    both at infinity) with random Z, to_affine and is_on_curve, against the
    JAX package word for word (infinity's non-canonical words included);
    scalar_mul_const by |X| and by -|X| against the host."""
    rng = np.random.default_rng(2)
    F2h = tb.FQ2.host
    p = tb.FQ.modulus
    gen = (tb.G2.gen_x, tb.G2.gen_y)
    pts = [tt.ext_ec_mul(F2h, gen, int(k)) for k in rng.integers(1, 1 << 40, size=4)]
    neg = (pts[0][0], F2h.neg(pts[0][1]))
    ps = [pts[0], pts[0], pts[0], None, pts[1], None, pts[2], pts[3]]
    qs = [pts[1], pts[0], neg, pts[1], None, None, pts[3], pts[2]]

    def jac(pp):
        coords = [[], [], []]
        for q in pp:
            lam = tuple(int.from_bytes(rng.bytes(48), "little") % p for _ in range(2))
            if q is None:
                c = (F2h.one(), F2h.one(), F2h.zero())
            else:
                l2 = F2h.mul(lam, lam)
                c = (F2h.mul(q[0], l2), F2h.mul(q[1], F2h.mul(l2, lam)), lam)
            for k in range(3):
                coords[k].append(c[k])
        return [tb.FQ2.from_ints([[c[j] for c in col] for j in range(2)], "cpu") for col in coords]

    tP, tQ = tsw_ext.ExtJacobian(*jac(ps)), tsw_ext.ExtJacobian(*jac(qs))
    jP = jsw_ext.ExtJacobian(*interop.ext_jacobian_to_numpy(tP))
    jQ = jsw_ext.ExtJacobian(*interop.ext_jacobian_to_numpy(tQ))
    assert all(torch.equal(a, b) for a, b in zip(interop.ext_jacobian_from_numpy(jP, "cpu"), tP))
    for jr, tr in ((jsw_ext.double(jb.G2, jP), tsw_ext.double(tb.G2, tP)),
                   (jsw_ext.add(jb.G2, jP, jQ), tsw_ext.add(tb.G2, tP, tQ))):
        assert all(same(a, b) for a, b in zip(jr, tr))
    tA = tsw_ext.to_affine(tb.G2, tsw_ext.add(tb.G2, tP, tQ))
    jA = jsw_ext.to_affine(jb.G2, jsw_ext.add(jb.G2, jP, jQ))
    assert all(same(a, b) for a, b in zip(jA, tA))
    want = [tt.ext_ec_add(F2h, u, v) for u, v in zip(ps, qs)]
    assert tt.g2_affine_to_ints(tb.G2, tA) == want
    bad = tA._replace(y=tb.FQ2.add(tA.y, tb.FQ2.one((8,), "cpu")))
    for A in (tA, bad):
        assert np.array_equal(np.asarray(jsw_ext.is_on_curve(jb.G2, jsw_ext.ExtAffine(
            *(np.asarray(v) for v in interop.ext_affine_to_numpy(A))))),
            tsw_ext.is_on_curve(tb.G2, A).numpy())
    x_abs = tfast.BLS12_381_X_ABS
    for k in (x_abs, -x_abs):
        R = tsw_ext.to_affine(tb.G2, tsw_ext.scalar_mul_const(tb.G2, tP, k))
        assert tt.g2_affine_to_ints(tb.G2, R) == [tt.ext_ec_mul(F2h, u, k) for u in ps]


def test_g2_subgroup_check_matches_jax():
    """bls12_381_g2_subgroup_check on points in G2, outside it and at
    infinity: the JAX package's mask and the exact one."""
    rng = np.random.default_rng(3)
    F2h = tb.FQ2.host
    gen = (tb.G2.gen_x, tb.G2.gen_y)
    ins = [tt.ext_ec_mul(F2h, gen, int(k)) for k in rng.integers(1, 1 << 40, size=4)]
    off = tt.g2_off_subgroup_points(tb.G2, 3, rng)
    pts = [ins[0], off[0], None, ins[1], off[1], ins[2], off[2], ins[3]]
    A = tt.g2_affine_from_ints(tb.G2, pts)
    got = tfast.bls12_381_g2_subgroup_check(tb.G2, A).numpy()
    jA = jsw_ext.ExtAffine(*(np.asarray(v) for v in interop.ext_affine_to_numpy(A)))
    assert np.array_equal(np.asarray(jfast.bls12_381_g2_subgroup_check(jb.G2, jA)), got)
    assert got.tolist() == [q is None or q in ins for q in pts]


def _vectors(kind):
    width = 96 if kind == "compressed" else 192
    raw = np.fromfile(os.path.join(VEC_DIR, f"g2_{kind}_valid_test_vectors.dat"), dtype=np.uint8)
    return raw.reshape(1000, width)


@pytest.mark.parametrize("compress", [True, False], ids=["compressed", "uncompressed"])
def test_zcash_g2_vectors(compress):
    """The 1,000 zcash G2 vectors (k H, k < 1000): serialized from the host's
    k H byte-exact, all 1,000; the first 64 deserialized with validate=True
    (the psi check) against the JAX package's words and bytes and the host's
    points; uncompressed, all 1,000 deserialized and serialized back
    byte-exact too (compressed decoding of 1,000 on the CPU is ~40 s of
    square roots: chip_smoke.py does it on the card at 2^16)."""
    kind = "compressed" if compress else "uncompressed"
    vec = _vectors(kind)
    F2h = tb.FQ2.host
    want, cur = [None], None
    for _ in range(999):
        cur = tt.ext_ec_add(F2h, cur, (tb.G2.gen_x, tb.G2.gen_y))
        want.append(cur)
    assert np.array_equal(tzc.serialize_g2(tt.g2_affine_from_ints(tb.G2, want), compress), vec)
    if not compress:
        pts, ok = tzc.deserialize_g2(vec, compress=False, validate=False, device="cpu")
        assert ok.all() and np.array_equal(tzc.serialize_g2(pts, False), vec)
    head = vec[:64]
    tp, tok = tzc.deserialize_g2(head, compress=compress, validate=True, device="cpu")
    jp, _ = jzc.deserialize_g2(head, compress=compress, validate=False)
    assert tok.all()
    assert all(same(a, b) for a, b in zip(jp, tp))
    assert np.array_equal(jzc.serialize_g2(jp, compress), tzc.serialize_g2(tp, compress))
    assert tt.g2_affine_to_ints(tb.G2, tp) == want[:64]
    if compress:  # a point outside G2 is rejected, infinity with the sort flag too
        off = tt.g2_affine_from_ints(tb.G2, tt.g2_off_subgroup_points(tb.G2, 1, np.random.default_rng(4)))
        enc = np.concatenate([tzc.serialize_g2(off, True), head[:1].copy()])
        enc[1, 0] |= tzc.SORT_FLAG
        _, bad = tzc.deserialize_g2(enc, compress=True, validate=True, device="cpu")
        assert not bad.any()


def test_canonical_ext_point_serde_matches_jax():
    """serialize_sw_ext/deserialize_sw_ext (arkworks' canonical G2 format)
    on 8 points (infinity first) both ways against the JAX package; a
    compressed cubic-extension point raises as in the reference."""
    F2h = tb.FQ2.host
    pts, cur = [None], None
    for _ in range(7):
        cur = tt.ext_ec_add(F2h, cur, (tb.G2.gen_x, tb.G2.gen_y))
        pts.append(cur)
    A = tt.g2_affine_from_ints(tb.G2, pts)
    jA = jsw_ext.ExtAffine(*(np.asarray(v) for v in interop.ext_affine_to_numpy(A)))
    for compress in (True, False):
        got = tps.serialize_sw_ext(tb.G2, A, compress)
        assert np.array_equal(got, jps.serialize_sw_ext(jb.G2, jA, compress))
        tp, tok = tps.deserialize_sw_ext(tb.G2, got, compress, validate=True, device="cpu")
        jp, jok = jps.deserialize_sw_ext(jb.G2, got, compress, validate=True)
        assert tok.all() and np.array_equal(jok, tok)
        assert all(same(a, b) for a, b in zip(jp, tp))
    cubic = tsw_ext.ExtCurveSpec("cubic", tb.FQ6, tb.FR, ((0, 0),) * 3, ((4, 4),) * 3, None, None)
    with pytest.raises(NotImplementedError):
        tps.deserialize_sw_ext(cubic, np.zeros((1, 288), np.uint8), compress=True, device="cpu")
