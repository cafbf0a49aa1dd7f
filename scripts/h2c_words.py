#!/usr/bin/env python3
"""Write the JAX package's words that tests/test_torch_h2c.py holds the
port's hash-to-curve maps and pipelines against, into
tests/vectors/h2c_words.npz:

- g1_swu_{x,y}, g1_map_{x,y}: zkarray.ec.h2c.swu.swu_map on the
  11-isogenous curve and bls12_381_g1_wb_map at the 13 lanes of g1_us():
  the RFC 9380 G1 vectors' u, then u = 0 and u = +-sqrt(-1/Z) (both with
  Z^2 u^4 + Z u^2 = 0, the exceptional x1 = b/(Z a));
- g1_q_{x,y,z}, g1_cleared_{x,y,z}, g1_p_{x,y}: the pipeline of
  hash_to_curve_bls12_381_g1 (jac_add_mixed of the two mapped points,
  scalar_mul_const by h_eff, to_affine) over the five vectors at once;
- g2_swu_{x,y}, g2_map_{x,y}: swu_map_ext and bls12_381_g2_wb_map at the
  11 lanes of g2_us() (the G2 vectors' u, then u = 0);
- g2_q_{x,y,z}, g2_qa_{x,y}, g2_cleared_{x,y,z}, g2_p_{x,y}: the pipeline
  of hash_to_curve_bls12_381_g2 (add, to_affine, clear_cofactor_g2,
  to_affine) over the five vectors at once.

    JAX_PLATFORMS=cpu python3 scripts/h2c_words.py   # ~2 minutes on a CPU

The test marked slow rebuilds the words with the JAX package and holds the
file equal to them.
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "vectors", "h2c_words.npz")
VEC = os.path.join(ROOT, "tests", "vectors")


def _vectors(name):
    with open(os.path.join(VEC, name)) as fh:
        return json.load(fh)


def fq2_pair(s):
    c0, c1 = s.split(",")
    return int(c0, 16), int(c1, 16)


def g1_vectors():
    return _vectors("BLS12381G1_XMD-SHA-256_SSWU_RO_.json")


def g2_vectors():
    return _vectors("BLS12381G2_XMD-SHA-256_SSWU_RO_.json")


def g1_us():
    """The vectors' u0 (all), their u1 (all), then 0 and +-sqrt(-1/11)."""
    sys.path.insert(0, ROOT)
    from zkarray_torch.curves import bls12_381 as b381
    from zkarray_torch.testing import sqrt_mod

    p = b381.FQ.modulus
    vs = g1_vectors()["vectors"]
    s = sqrt_mod(-pow(11, -1, p) % p, p)
    return ([int(v["u"][0], 16) for v in vs] + [int(v["u"][1], 16) for v in vs]
            + [0, s, p - s])


def g2_us():
    """The vectors' u0 (all), their u1 (all), then 0, as (c0, c1) pairs."""
    vs = g2_vectors()["vectors"]
    return [fq2_pair(v["u"][0]) for v in vs] + [fq2_pair(v["u"][1]) for v in vs] + [(0, 0)]


def words():
    """{name: uint32 array} computed with the JAX package now."""
    sys.path.insert(0, ROOT)
    from zkarray.curves import bls12_381 as jb
    from zkarray.ec import sw, sw_ext
    from zkarray.ec.h2c import _bls12_381_g2_iso as iso2
    from zkarray.ec.h2c import wb, wb_g2
    from zkarray.ec.h2c.swu import swu_map
    from zkarray.ec.h2c.swu_ext import swu_map_ext
    from zkarray.ff import fp

    out = {}

    def put(prefix, coords, names):
        for n_, v in zip(names, coords):
            out[f"{prefix}_{n_}"] = np.asarray(v).astype(np.uint32)

    us = g1_us()
    u = fp.from_ints(jb.FQ, us)
    put("g1_swu", swu_map(wb.ISO_CURVE, u, wb.iso.ZETA)[:2], "xy")
    put("g1_map", wb.bls12_381_g1_wb_map(u)[:2], "xy")
    n = len(g1_vectors()["vectors"])
    pts = wb.bls12_381_g1_wb_map(u[:, :2 * n])
    p0 = sw.from_affine(jb.G1, sw.AffinePoints(pts.x[:, :n], pts.y[:, :n], pts.inf[:n]))
    q = sw.jac_add_mixed(jb.G1, p0, sw.AffinePoints(pts.x[:, n:], pts.y[:, n:], pts.inf[n:]))
    put("g1_q", q, "xyz")
    cleared = sw.scalar_mul_const(jb.G1, q, 0xD201000000010001)
    put("g1_cleared", cleared, "xyz")
    put("g1_p", sw.to_affine(jb.G1, cleared)[:2], "xy")

    F2 = jb.FQ2
    us2 = g2_us()
    u2 = F2.from_ints([[c[0] for c in us2], [c[1] for c in us2]])
    put("g2_swu", swu_map_ext(F2, u2, iso2.ISO_A, iso2.ISO_B, iso2.ZETA, iso2.NEG_B_OVER_A,
                              iso2.B_OVER_ZA), "xy")
    put("g2_map", wb_g2.bls12_381_g2_wb_map(u2)[:2], "xy")
    n = len(g2_vectors()["vectors"])
    pts = wb_g2.bls12_381_g2_wb_map(u2[..., :2 * n])
    p0 = sw_ext.ExtAffine(pts.x[..., :n], pts.y[..., :n], pts.inf[:n])
    p1 = sw_ext.ExtAffine(pts.x[..., n:], pts.y[..., n:], pts.inf[n:])
    q = sw_ext.add(jb.G2, sw_ext.from_affine(jb.G2, p0), sw_ext.from_affine(jb.G2, p1))
    put("g2_q", q, "xyz")
    qa = sw_ext.to_affine(jb.G2, q)
    put("g2_qa", qa[:2], "xy")
    cleared = wb_g2.clear_cofactor_g2(qa)
    put("g2_cleared", cleared, "xyz")
    put("g2_p", sw_ext.to_affine(jb.G2, cleared)[:2], "xy")
    return out


def main():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import conftest  # noqa: F401  (the CPU platform and the XLA cache, as the tests set them)

    w = words()
    np.savez_compressed(OUT, **w)
    print(f"wrote {OUT}: {sorted(w)}")


if __name__ == "__main__":
    main()
