#!/usr/bin/env python3
"""Write the JAX package's pairing words that the port's pairing tests hold
it against:

- tests/vectors/bls12_381_pairing_bundle.npz: tests/pairing_bundle.py's four
  BLS12-381 pairs. It builds the bundle (one width-4 pairing_each and one
  pairing, several minutes of XLA compile on a CPU), then runs
  zkarray.ec.pairing.bls12's g2_prepare and multi_miller_loop(combine=False)
  at the same shapes, and stores, as 16-bit limbs: the pairs P (G1) and Q
  (G2), the doubling steps' line coefficients, the add steps' at the set
  bits of |X|, the Miller values, the per-pair pairings and their product.
- tests/vectors/bls12_377_pairing_e.npz: BLS12-377's E = e(G1 generator,
  G2 generator) from pairing_each at width 1 (the D-twist path), with the
  generators it was computed on, as 16-bit limbs.
- tests/vectors/bn254_pairing_bundle.npz: tests/pairing_bundle.py's four
  BN254 pairs, as for BLS12-381, with the ladder's add-step coefficients in
  all 64 slots (one per digit of 6X + 2, zero digits included) and the two
  Frobenius-twist lines.
- tests/vectors/bw6_761_pairing.npz and bw6_767_pairing.npz: the pairs
  (G, H) and (2G, 2H) (host points), with zkarray.ec.pairing.bw6's
  g2_prepare (every doubling of both loops; the add steps at the set bits
  of the seed and at the nonzero digits of loop 2, with their slot
  numbers; the extra line), the Miller values (combine=False), their final
  exponentiations and E = e(G, H), lane 0 of those.
- tests/vectors/{mnt4_298,mnt6_298,mnt4_753,mnt6_753}_pairing.npz: the
  pairs (G, H) and (2G, 2H) (host points), zkarray.ec.pairing.mnt's
  g1_prepare (x_twist, y_twist), g2_prepare (x and y over the twist, every
  doubling step's four coefficients, the add steps' two at the nonzero
  digits with their slot numbers, final_add), the Miller values
  (combine=False), their final exponentiations and E = e(G, H).
- tests/vectors/cp6_782_pairing.npz: the same pairs on CP6-782,
  zkarray.ec.pairing.cp6's g2_prepare_host (each doubling step's gro and gt,
  the add steps' at the ladder's set bits with their slot numbers), the
  Miller values, their final exponentiations and E. Its host ladder inverts
  in Fq3 by Fermat, about 2.5 minutes a point on a CPU.
- tests/vectors/msm_mixed.npz: zkarray.ec.msm.msm_mixed's XYZZ words on
  tests/test_scalar_mul_extras.py's mixed-magnitude BN254 inputs at c = 4
  and c = None, and on the same points with all-zero scalars.
- tests/vectors/weighted_sum_bits.npz: zkarray.ec.msm._weighted_sum_bits on
  tests/test_torch_msm.py's seeded (L, 5, 16) BLS12-381 G1 bucket state
  (weighted_sum_bits_inputs), with that state.
- tests/vectors/horner_reduce.npz: zkarray.ec.msm.msm_reduce at c = 5, 255
  bits, on tests/test_torch_kernels_sw.py's (L, 52, 16) bucket state, the
  XYZZ sums of two seeded affine points a bucket (horner_reduce_inputs),
  with that state.

    JAX_PLATFORMS=cpu python3 scripts/pairing_bundle_words.py [bls12_381|bls12_377|bn254|bw6_761|bw6_767|mnt4_298|mnt6_298|mnt4_753|mnt6_753|cp6_782|msm_mixed|weighted_sum_bits|horner_reduce|all] [XLA cache dir]

Run each target in a process of its own ("all" runs them one by one in
this process): XLA:CPU can abort compiling a further 768-bit Miller graph
in a process that has compiled one. Minutes of compile each on a CPU.

The tests build the inputs themselves and check them against the stored
ones, so a file cannot drift from its inputs unseen; tests marked slow
rebuild the words with the JAX package (``words_<target>``) and hold the
files equal to them.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VEC_DIR = os.path.join(ROOT, "tests", "vectors")
OUT = {"bls12_381": os.path.join(VEC_DIR, "bls12_381_pairing_bundle.npz"),
       "bls12_377": os.path.join(VEC_DIR, "bls12_377_pairing_e.npz"),
       "bn254": os.path.join(VEC_DIR, "bn254_pairing_bundle.npz"),
       "bw6_761": os.path.join(VEC_DIR, "bw6_761_pairing.npz"),
       "bw6_767": os.path.join(VEC_DIR, "bw6_767_pairing.npz"),
       "msm_mixed": os.path.join(VEC_DIR, "msm_mixed.npz")}
OUT["weighted_sum_bits"] = os.path.join(VEC_DIR, "weighted_sum_bits.npz")
OUT["horner_reduce"] = os.path.join(VEC_DIR, "horner_reduce.npz")
MNT = ("mnt4_298", "mnt6_298", "mnt4_753", "mnt6_753")
for _c in MNT + ("cp6_782",):
    OUT[_c] = os.path.join(VEC_DIR, f"{_c}_pairing.npz")


def limbs(a):
    a = np.asarray(a)
    assert a.dtype == np.uint32 and int(a.max(initial=0)) < 1 << 16
    return a.astype(np.uint16)


def words_bls12_381():
    """The JAX package's words for tests/pairing_bundle.py's BLS12-381 pairs."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import pairing_bundle
    from zkarray.ec.pairing import bls12

    bd = pairing_bundle.bls12_381()
    spec = bd["mod"].PAIRING
    Qp = bls12.g2_prepare(spec, bd["Q"])
    f = bls12.multi_miller_loop(spec, bd["P"], Qp, False)
    add_bits = [i for i, b in enumerate(spec.x_bits) if b]
    return dict(
        p_x=limbs(bd["P"].x), p_y=limbs(bd["P"].y), p_inf=np.asarray(bd["P"].inf),
        q_x=limbs(bd["Q"].x), q_y=limbs(bd["Q"].y), q_inf=np.asarray(bd["Q"].inf),
        dbl_coeffs=limbs(Qp.dbl_coeffs), add_coeffs=limbs(np.asarray(Qp.add_coeffs)[add_bits]),
        add_bits=np.asarray(add_bits), miller=limbs(f), gts=limbs(bd["gts"]),
        prod=limbs(bd["prod"]))


def words_bls12_377():
    """The JAX package's E = e(G, H) on BLS12-377 and its inputs."""
    from zkarray.curves import bls12_377
    from zkarray.ec.pairing import bls12

    G = bls12_377.G1.generator((1,))
    H = bls12_377.G2.generator((1,))
    e = bls12.pairing_each(bls12_377.PAIRING, G, H)
    return dict(g_x=limbs(G.x), g_y=limbs(G.y), h_x=limbs(H.x), h_y=limbs(H.y), e=limbs(e))


def words_bn254():
    """The JAX package's words for tests/pairing_bundle.py's BN254 pairs:
    its g2_prepare keeps an add-step slot for each of the 64 digits."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import pairing_bundle
    from zkarray.ec.pairing import bn

    bd = pairing_bundle.bn254()
    spec = bd["mod"].PAIRING
    Qp = bn.g2_prepare(spec, bd["Q"])
    f = bn.multi_miller_loop(spec, bd["P"], Qp, False)
    return dict(
        p_x=limbs(bd["P"].x), p_y=limbs(bd["P"].y), p_inf=np.asarray(bd["P"].inf),
        q_x=limbs(bd["Q"].x), q_y=limbs(bd["Q"].y), q_inf=np.asarray(bd["Q"].inf),
        dbl_coeffs=limbs(Qp.dbl_coeffs), add_coeffs=limbs(Qp.add_coeffs),
        q1_coeffs=limbs(Qp.q1_coeffs), q2_coeffs=limbs(Qp.q2_coeffs), miller=limbs(f),
        gts=limbs(bd["gts"]), prod=limbs(bd["prod"]))


def words_bw6(curve):
    """The JAX package's BW6 words on the pairs (G, H) and (2G, 2H)."""
    import importlib

    from zkarray.ec.pairing import bw6

    b = importlib.import_module(f"zkarray.curves.{curve}")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from ec_oracle import ec_add

    def two(c):
        g = (c.gen_x, c.gen_y)
        return c.affine_from_ints([g, ec_add(g, g, c.a_int, c.base.modulus)])

    spec = b.PAIRING
    P, Q = two(b.G1), two(b.G2)
    Qp = bw6.g2_prepare(spec, Q)
    f = bw6.multi_miller_loop(spec, P, Qp, False)
    gts = bw6.final_exponentiation(spec, f)
    rows1 = [i for i, bit in enumerate(spec.loop_1_bits) if bit]
    rows2 = [i for i, d in enumerate(spec.ate_loop_count_2[:-1][::-1]) if d]
    return dict(
        p_x=limbs(P.x), p_y=limbs(P.y), q_x=limbs(Q.x), q_y=limbs(Q.y),
        dbl_1=limbs(Qp.dbl_1), add_1=limbs(np.asarray(Qp.add_1)[rows1]), add_1_rows=np.asarray(rows1),
        extra=limbs(Qp.extra), dbl_2=limbs(Qp.dbl_2), add_2=limbs(np.asarray(Qp.add_2)[rows2]),
        add_2_rows=np.asarray(rows2), miller=limbs(f), gts=limbs(gts), e=limbs(np.asarray(gts)[..., :1]))


def words_bw6_761():
    return words_bw6("bw6_761")


def words_bw6_767():
    return words_bw6("bw6_767")


def host_pairs(b):
    """The host pairs (G, H) and (2G, 2H) of a curve module whose G2 lies
    over an extension (the doubling by the tower's host arithmetic)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from ec_oracle import ec_add, ec_add_f

    g = (b.G1.gen_x, b.G1.gen_y)
    h = (b.G2.gen_x, b.G2.gen_y)
    H = b.G2.ops.host
    return [g, ec_add(g, g, b.G1.a_int, b.G1.base.modulus)], [h, ec_add_f(H, h, h, b.G2.a_host)]


def ext_affine(curve, pts):
    """Host G2 points [(x, y)] -> the JAX package's ExtAffine."""
    import jax.numpy as jnp

    from zkarray.ec.sw_ext import ExtAffine

    F = curve.ops

    def nest(vals):
        return [[v[j] for v in vals] for j in range(F.deg)]

    return ExtAffine(F.from_ints(nest([p[0] for p in pts])), F.from_ints(nest([p[1] for p in pts])),
                     jnp.zeros((len(pts),), dtype=bool))


def words_mnt(curve):
    """The JAX package's MNT words on the pairs (G, H) and (2G, 2H)."""
    import importlib

    from zkarray.ec.pairing import mnt

    b = importlib.import_module(f"zkarray.curves.{curve}")
    spec = b.PAIRING
    g, h = host_pairs(b)
    P = b.G1.affine_from_ints(g)
    Q = ext_affine(b.G2, h)
    P1 = mnt.g1_prepare(spec, P)
    Qp = mnt.g2_prepare(spec, Q)
    f = mnt.multi_miller_loop(spec, P1, Qp, False)
    gts = mnt.final_exponentiation(spec, f)
    rows = [i for i, d in enumerate(spec.ate_loop_count[1:]) if d]
    return dict(
        p_x=limbs(P.x), p_y=limbs(P.y), q_x=limbs(Q.x), q_y=limbs(Q.y),
        x_twist=limbs(P1.x_twist), y_twist=limbs(P1.y_twist),
        x_over_twist=limbs(Qp.x_over_twist), y_over_twist=limbs(Qp.y_over_twist),
        dbl_coeffs=limbs(Qp.dbl_coeffs), add_coeffs=limbs(np.asarray(Qp.add_coeffs)[rows]),
        add_rows=np.asarray(rows), final_add=limbs(Qp.final_add), miller=limbs(f),
        gts=limbs(gts), e=limbs(np.asarray(gts)[..., :1]))


def words_cp6_782():
    """The JAX package's CP6-782 words on the pairs (G, H) and (2G, 2H)."""
    from zkarray.curves import cp6_782 as b
    from zkarray.ec.pairing import cp6

    spec = b.PAIRING
    g, h = host_pairs(b)
    P = b.G1.affine_from_ints(g)
    Qp = cp6.g2_prepare_host(spec, h)
    f = cp6.multi_miller_loop(spec, P, Qp, False)
    gts = cp6.final_exponentiation(spec, f)
    rows = np.nonzero(np.asarray(Qp.bits))[0]
    return dict(
        p_x=limbs(P.x), p_y=limbs(P.y), q_x=limbs(ext_affine(b.G2, h).x),
        q_y=limbs(ext_affine(b.G2, h).y), dbl_gro=limbs(Qp.dbl_gro), dbl_gt=limbs(Qp.dbl_gt),
        add_gro=limbs(np.asarray(Qp.add_gro)[rows]), add_gt=limbs(np.asarray(Qp.add_gt)[rows]),
        add_rows=rows, miller=limbs(f), gts=limbs(gts), e=limbs(np.asarray(gts)[..., :1]))


def msm_mixed_inputs():
    """tests/test_scalar_mul_extras.py:test_msm_mixed_magnitude_classes's
    host inputs: 32 BN254 G1 points and scalars of four magnitudes."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from ec_oracle import ec_mul

    from zkarray.curves import bn254

    c = bn254.G1
    gen = (c.gen_x, c.gen_y)
    rng = np.random.default_rng(4)
    n = 32
    pts = [ec_mul(gen, int(k), c.a_int, c.base.modulus) for k in rng.integers(1, 1 << 20, n)]
    ks = []
    for i in range(n):
        cls = i % 4
        if cls == 0:
            ks.append(1)
        elif cls == 1:
            ks.append(int(rng.integers(2, 1 << 8)))
        elif cls == 2:
            ks.append(int(rng.integers(1 << 8, 1 << 30)))
        else:
            ks.append(int(rng.integers(1 << 40, 1 << 62)))
    return pts, ks


def words_msm_mixed():
    """The JAX package's msm_mixed at c = 4, c = None and on zero scalars."""
    from zkarray.curves import bn254
    from zkarray.ec import msm
    from zkarray.ff import fp as jfp

    c = bn254.G1
    pts, ks = msm_mixed_inputs()
    A = c.affine_from_ints(pts)
    s = jfp.from_ints(c.scalar, ks, mont=False)
    z = jfp.from_ints(c.scalar, [0] * len(ks), mont=False)
    out = dict(p_x=limbs(A.x), p_y=limbs(A.y), scalars=limbs(s))
    for tag, sc, cw in (("c4", s, 4), ("cnone", s, None), ("zero", z, None)):
        r = msm.msm_mixed(c, A, sc, cw)
        out[tag] = limbs(np.stack([np.asarray(v) for v in r]))
    return out


def xyzz_coords(pt, lam, mod):
    """Canonical XYZZ coordinates (X, Y, ZZ, ZZZ) of an affine point (None =
    infinity, (1, 1, 0, 0)) as the representative ZZ = lam^2, ZZZ = lam^3
    (tests/torch_parity.py:xyzz_coords)."""
    if pt is None:
        return (1, 1, 0, 0)
    l2 = lam * lam % mod
    l3 = l2 * lam % mod
    return (pt[0] * l2 % mod, pt[1] * l3 % mod, l2, l3)


def weighted_sum_bits_inputs():
    """tests/test_torch_msm.py:test_weighted_sum_bits_matches_jax_one_and_
    several_groups's host inputs on BLS12-381 G1 at c = 5: the windows
    (0-2 and the last two), half, and the canonical XYZZ coordinates of a
    (5, half) bucket state: points at infinity, bucket j + 8 holding bucket
    j's point or its negation, random ZZ representatives."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from ec_oracle import ec_mul, ec_neg

    from zkarray.curves import bls12_381
    from zkarray.ec.msm import _window_geometry

    jc = bls12_381.G1
    mod = jc.base.modulus
    W, half, _, _ = _window_geometry(5, jc.scalar.bits)
    wins = [0, 1, 2, W - 2, W - 1]
    rng = np.random.default_rng(40)
    gen = (jc.gen_x, jc.gen_y)
    pool = [ec_mul(gen, int(k), 0, mod) for k in rng.integers(1, 1 << 40, size=6)]
    pts = [[None if rng.random() < 0.3 else pool[rng.integers(len(pool))] for _ in range(half)]
           for _ in wins]
    for w, row in enumerate(pts):
        for j in range(8):
            if row[j] is not None and w % 3:
                row[j + 8] = row[j] if w % 3 == 1 else ec_neg(row[j], mod)
    lams = rng.integers(1, 1 << 62, size=len(wins) * half)
    coords = [xyzz_coords(p, int(lam), mod) for p, lam in zip((p for row in pts for p in row), lams)]
    return wins, half, coords


def words_weighted_sum_bits():
    """The JAX package's _weighted_sum_bits on weighted_sum_bits_inputs()."""
    import jax

    from zkarray.curves import bls12_381
    from zkarray.ec import msm
    from zkarray.ec import sw as jsw
    from zkarray.ff import fp as jfp

    from zkarray_torch.ec.msm import _bucket_weights  # the test's weights (host numpy)

    jc = bls12_381.G1
    wins, half, coords = weighted_sum_bits_inputs()
    st = jsw.XYZZPoints(*(jfp.from_ints(jc.base, [c[k] for c in coords]).reshape(-1, len(wins), half)
                          for k in range(4)))
    weights = _bucket_weights(5, jc.scalar.bits)[wins]
    want = jax.jit(lambda s: msm._weighted_sum_bits(jc, s, weights))(st)
    return dict(state=limbs(np.stack([np.asarray(v) for v in st])),
                want=limbs(np.stack([np.asarray(v) for v in want])))


def horner_reduce_inputs():
    """tests/test_torch_kernels_sw.py:test_horner_plain_matches_jax_msm_reduce's
    host inputs at c = 5, 255 bits (W = 52, half = 16): two lists of W half
    affine BLS12-381 G1 points (None = infinity), each bucket the XYZZ sum
    of one of each."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from ec_oracle import ec_mul

    from zkarray.curves import bls12_381
    from zkarray.ec.msm import _window_geometry

    jc = bls12_381.G1
    W, half, _, _ = _window_geometry(5, 255)
    rng = np.random.default_rng(22)
    gen = (jc.gen_x, jc.gen_y)
    pool = [ec_mul(gen, int(k), 0, jc.base.modulus) for k in rng.integers(1, 1 << 30, size=64)]
    pool += [None] * 8
    P = [pool[i] for i in rng.integers(0, len(pool), size=W * half)]
    Q = [pool[i] for i in rng.integers(0, len(pool), size=W * half)]
    return W, half, P, Q


def words_horner_reduce():
    """The JAX package's msm_reduce on horner_reduce_inputs()'s bucket state."""
    from zkarray.curves import bls12_381
    from zkarray.ec import msm
    from zkarray.ec import sw as jsw

    jc = bls12_381.G1
    W, half, P, Q = horner_reduce_inputs()
    S = jsw.xyzz_add(jc, jsw.xyzz_from_affine(jc, jc.affine_from_ints(P)),
                     jsw.xyzz_from_affine(jc, jc.affine_from_ints(Q)))
    st = jsw.XYZZPoints(*(v.reshape(-1, W, half) for v in S))
    want = msm.msm_reduce(jc, st, 5, 255)
    return dict(state=limbs(np.stack([np.asarray(v) for v in st])),
                want=limbs(np.stack([np.asarray(v) for v in want])))


def main(argv):
    names = (("bls12_381", "bls12_377", "bn254", "bw6_761", "bw6_767") + MNT
             + ("cp6_782", "msm_mixed", "weighted_sum_bits", "horner_reduce"))
    which = argv[0] if argv and argv[0] in names + ("all",) else "all"
    rest = argv[1:] if argv and argv[0] == which else argv
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    from zkarray.jaxcache import setup_cache

    setup_cache(rest[0] if rest else os.environ.get("ZKARRAY_CACHE_DIR", "/tmp/zkarray-xla-cache"))
    build = {"bls12_381": words_bls12_381, "bls12_377": words_bls12_377, "bn254": words_bn254,
             "bw6_761": words_bw6_761, "bw6_767": words_bw6_767, "cp6_782": words_cp6_782,
             "msm_mixed": words_msm_mixed, "weighted_sum_bits": words_weighted_sum_bits,
             "horner_reduce": words_horner_reduce}
    build.update({c: (lambda c=c: words_mnt(c)) for c in MNT})
    for name in build if which == "all" else (which,):
        np.savez_compressed(OUT[name], **build[name]())
        print(OUT[name], os.path.getsize(OUT[name]))


if __name__ == "__main__":
    main(sys.argv[1:])
