#!/usr/bin/env python3
"""Write the JAX package's words that tests/test_torch_scalar_mul.py holds
the port's fixed-base, GLV (G2) and streaming MSMs against, into
tests/vectors/scalar_mul_words.npz:

- fixed_base_{x,y,z}: zkarray.ec.fixed_base.FixedBaseTable(BLS12-381 G1,
  G, window 13).batch_mul on FIXED_KS (tests/test_glv_fixed.py's shape;
  tracing its 19 unrolled Jacobian adds takes ~25 s on a CPU);
- glv_g2_{x,y,z}: zkarray.ec.glv.glv_mul_ext(bls12_381_g2_glv(), H x 4,
  G2_KS) (tests/test_glv_fixed.py's shape);
- chunked_pippenger_*, hashmap_pippenger_*, msm_chunks_*: the XYZZ words
  of ChunkedPippenger (chunks of 8, c = 4) fed the first 16 of
  stream_inputs(), HashMapPippenger (c = 4) fed all 24 twice, and
  msm_chunks (c = 4) over two 8-point chunks and then all 24 (BN254 G1,
  tests/test_scalar_mul_extras.py's inputs and window).

    JAX_PLATFORMS=cpu python3 scripts/scalar_mul_words.py   # ~1.5 minutes on a CPU

The inputs come from the functions below, which the tests call too; the
test marked slow rebuilds the words with the JAX package and holds the
file equal to them.
"""

import os
import random
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "vectors", "scalar_mul_words.npz")


def fixed_ks(r):
    return [0, 1, 2, random.Random(2).randrange(r), r - 1]


def g2_ks(r):
    return [1, 2, 12345, r - 3]


def stream_inputs(curve):
    """24 BN254 points k_i G (k_i < 2^20) and scalars below 2^30, and the
    host sums of the first 16 and of all 24 terms."""
    sys.path.insert(0, ROOT)
    from zkarray_torch.testing import ec_add, ec_mul

    a_int, mod = curve.a_int, curve.base.modulus
    gen = (curve.gen_x, curve.gen_y)
    rng = np.random.default_rng(3)
    pts = [ec_mul(gen, int(k), a_int, mod) for k in rng.integers(1, 1 << 20, 24)]
    ks = [int(k) for k in rng.integers(1, 1 << 30, 24)]
    sums = {}
    acc = None
    for i, (p, k) in enumerate(zip(pts, ks)):
        term = ec_mul(p, k, a_int, mod)
        acc = term if acc is None else ec_add(acc, term, a_int, mod)
        if i + 1 in (16, 24):
            sums[i + 1] = acc
    return pts, ks, sums


def words():
    """{name: uint32 array} computed with the JAX package now."""
    sys.path.insert(0, ROOT)
    import jax.numpy as jnp

    from zkarray.curves import bls12_381 as jb
    from zkarray.curves import bn254 as jbn
    from zkarray.ec import fixed_base, glv, stream_msm, sw, sw_ext
    from zkarray.ff import fp

    out = {}

    def put(prefix, coords, names):
        for n_, v in zip(names, coords):
            out[f"{prefix}_{n_}"] = np.asarray(v).astype(np.uint32)

    g1 = jb.G1
    js = fp.from_ints(g1.scalar, fixed_ks(g1.scalar.modulus), mont=False)
    put("fixed_base", fixed_base.FixedBaseTable(g1, (g1.gen_x, g1.gen_y), window=13).batch_mul(js),
        "xyz")
    ks = g2_ks(jb.G2.scalar.modulus)
    H = jb.G2.generator((1,))
    A = sw_ext.ExtAffine(jnp.concatenate([H.x] * len(ks), axis=-1),
                         jnp.concatenate([H.y] * len(ks), axis=-1), jnp.concatenate([H.inf] * len(ks)))
    put("glv_g2", glv.glv_mul_ext(glv.bls12_381_g2_glv(), A, ks), "xyz")

    c = jbn.G1
    pts, sks, _ = stream_inputs(c)
    cp = stream_msm.ChunkedPippenger(c, chunk_size=8, c=4)
    for p_, k in zip(pts[:16], sks[:16]):
        cp.add(p_, k)
    put("chunked_pippenger", cp.finalize(), ("x", "y", "zz", "zzz"))
    hp = stream_msm.HashMapPippenger(c, c=4)
    for p_, k in zip(pts + pts, sks + sks):
        hp.add(p_, k)
    put("hashmap_pippenger", hp.finalize(), ("x", "y", "zz", "zzz"))
    A = c.affine_from_ints(pts)
    s = fp.from_ints(c.scalar, sks, mont=False)

    def chunks():
        for lo in (0, 8):
            yield sw.AffinePoints(A.x[:, lo:lo + 8], A.y[:, lo:lo + 8], A.inf[lo:lo + 8]), s[:, lo:lo + 8]
        yield A, s

    put("msm_chunks", stream_msm.msm_chunks(c, chunks(), c=4), ("x", "y", "zz", "zzz"))
    return out


def main():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import conftest  # noqa: F401  (the CPU platform and the XLA cache, as the tests set them)

    w = words()
    np.savez_compressed(OUT, **w)
    print(f"wrote {OUT}: {sorted(w)}")


if __name__ == "__main__":
    main()
