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

    JAX_PLATFORMS=cpu python3 scripts/pairing_bundle_words.py [bls12_381|bls12_377|all] [XLA cache dir]

The tests build the inputs themselves and check them against the stored
ones, so a file cannot drift from its inputs unseen; tests marked slow
rebuild the words with the JAX package (``words_bls12_381``,
``words_bls12_377``) and hold the files equal to them.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VEC_DIR = os.path.join(ROOT, "tests", "vectors")
OUT = {"bls12_381": os.path.join(VEC_DIR, "bls12_381_pairing_bundle.npz"),
       "bls12_377": os.path.join(VEC_DIR, "bls12_377_pairing_e.npz")}


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


def main(argv):
    which = argv[0] if argv and argv[0] in ("bls12_381", "bls12_377", "all") else "all"
    rest = argv[1:] if argv and argv[0] == which else argv
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    from zkarray.jaxcache import setup_cache

    setup_cache(rest[0] if rest else os.environ.get("ZKARRAY_CACHE_DIR", "/tmp/zkarray-xla-cache"))
    build = {"bls12_381": words_bls12_381, "bls12_377": words_bls12_377}
    for name in build if which == "all" else (which,):
        np.savez_compressed(OUT[name], **build[name]())
        print(OUT[name], os.path.getsize(OUT[name]))


if __name__ == "__main__":
    main(sys.argv[1:])
