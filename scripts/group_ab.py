#!/usr/bin/env python3
"""Time the host-bound calls of the group, G2 and pairing paths
(chip_smoke.py phases 8 and 9) and of the field product's launch of this
tree against another checkout's (e.g. the parent commit unpacked with git
archive), in turns, on one NVIDIA GPU.

    python3 scripts/group_ab.py OTHER_CHECKOUT [--pairs 3] [--runs 7] [--calls a,b]

The calls, at 2^16 lanes on BLS12-381 unless stated: ``clear_cofactor``
(G1 points outside the subgroup), ``subgroup_check`` (the generic G1 check)
and ``fast_g1_check`` (``ec.fast_checks``) on lanes mixing multiples of G,
points outside the subgroup and infinity, ``g2_check`` on multiples of the
G2 generator mixed with points outside G2, ``scalar_mul`` on 64 multiples
of G tiled, with 255-bit scalars, ``pairing_each`` over 2^12 pairs
(testing.pairing_inputs: 64 seeded pairs tiled, every 1,024th G1 point at
infinity), ``pairing`` (their product: one final exponentiation on one
element), ``bn254_pairing_each`` (BN254, the same), ``gt_msm`` (c = 3 over
2^12 BLS12-381 GT elements tiled from 64 seeded powers of E with 255-bit
scalars, testing.gt_inputs, as chip_smoke.py phase 10 makes them),
``mnt4_753_pairing_each`` (MNT4-753, 2^12 pairs tiled from 64 seeded pairs
with 64-bit scalars, as chip_smoke.py phase 11 makes them), ``fq12_mul_64``
(PRODUCT_CALLS back-to-back ``FQ12.mul`` calls at 64 lanes: one fp_lin,
one mont_mul, one fp_lin a call), and ``mont_mul_24_1``,
``mont_mul_24_2^16``, ``mont_sqr_24_1``, ``mont_sqr_24_2^16``,
``fp_add_24_1``, ``fp_add_24_2^16``,
``fp_sub_24_2^16``, ``fp_neg_24_2^16``: PRODUCT_CALLS back-to-back
``ff.fp.mont_mul`` / ``mont_sqr`` / ``add`` / ``sub`` / ``neg`` calls on Fq
at (24, 1) and (24, 2^16), timed as one run (its median is then ms per
PRODUCT_CALLS calls). Each pair runs the other
checkout, this tree, this tree, the other checkout, each in a fresh
process that imports its own checkout's zkarray_torch and builds its
kernels before any timing. A process makes its inputs from seed 8, runs
each call once to warm up, then --runs timed calls (host clock to
torch.cuda.synchronize()). Prints one JSON line per process (per call:
the median, the runs, a digest of the result's words) and a summary line:
per call and side the median of the processes' medians, their quartiles,
every process's median, the pairs this tree won and whether both sides'
words agree.
"""

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LOG_N = 16
PAIR_LOG_N = 12
PRODUCT_CALLS = 1000
CALLS = ("clear_cofactor", "subgroup_check", "fast_g1_check", "g2_check", "scalar_mul",
         "pairing_each", "pairing", "bn254_pairing_each", "gt_msm", "mnt4_753_pairing_each", "fq12_mul_64",
         "mont_mul_24_1", "mont_mul_24_2^16",
         "mont_sqr_24_1", "mont_sqr_24_2^16", "fp_add_24_1", "fp_add_24_2^16", "fp_sub_24_2^16",
         "fp_neg_24_2^16")
MNT_SCALAR_BITS = 64  # chip_smoke.py's PAIR_SCALAR_BITS


def worker(checkout, runs, calls):
    sys.path.insert(0, str(checkout))
    import numpy as np
    import torch

    from zkarray_torch.curves import bls12_381 as B
    from zkarray_torch.ec import fast_checks, sw_ext
    from zkarray_torch.ec import sw as tsw
    from zkarray_torch.curves import bn254, mnt4_753
    from zkarray_torch.ec.pairing import bls12, bn, gt, mnt
    from zkarray_torch.ff import fp
    from zkarray_torch.interop import affine_from_numpy, limbs_from_numpy
    from zkarray_torch.kernels import _build
    from zkarray_torch.testing import (E_BLS12_381, ext_ec_mul, g2_affine_from_ints,
                                       g2_off_subgroup_points, group_inputs, gt_inputs,
                                       off_subgroup_points, pairing_inputs)

    if not torch.cuda.is_available():
        raise RuntimeError("group_ab: no CUDA device")
    _build.build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    C, C2, n = B.G1, B.G2, 1 << LOG_N
    t16, cls = torch.arange(n, device=dev) % 16, torch.arange(n, device=dev) % 8

    def tiled(A, idx):
        return A._replace(x=A.x[..., idx], y=A.y[..., idx], inf=A.inf[idx])

    base, px, py, sc = group_inputs(C, n, rng)
    G = tsw.affine_from_ints(C, base[:16], dev)
    off = tiled(tsw.affine_from_ints(C, off_subgroup_points(C, 16, rng), dev), t16)
    inside = tiled(G, t16)
    outside = (cls >= 3) & (cls <= 5)
    mix = tsw.AffinePoints(torch.where(outside, off.x, inside.x), torch.where(outside, off.y, inside.y),
                           inside.inf | (cls == 7))
    A = affine_from_numpy(px, py, np.zeros(n, dtype=bool), dev)
    s = limbs_from_numpy(sc, dev)
    F2h = C2.ops.host
    H = g2_affine_from_ints(C2, [ext_ec_mul(F2h, (C2.gen_x, C2.gen_y), k) for k in range(1, 17)], dev)
    Ho = g2_affine_from_ints(C2, g2_off_subgroup_points(C2, 16, rng), dev)
    out2 = (cls == 5) | (cls == 6)
    Hin, Hout = tiled(H, t16), tiled(Ho, t16)
    Q = sw_ext.ExtAffine(torch.where(out2, Hout.x, Hin.x), torch.where(out2, Hout.y, Hin.y),
                         Hin.inf | (cls == 7))
    PP, PQ, _, _ = pairing_inputs(B.PAIRING, 1 << PAIR_LOG_N, rng, 64, 1024, device=dev)
    if "mnt4_753_pairing_each" in calls:
        MP, MQ, _, _ = pairing_inputs(mnt4_753.PAIRING, 1 << PAIR_LOG_N, rng, 64, 1024, device=dev,
                                      scalar_bits=MNT_SCALAR_BITS)
    if "bn254_pairing_each" in calls:
        BP, BQ, _, _ = pairing_inputs(bn254.PAIRING, 1 << PAIR_LOG_N, rng, 64, 1024, device=dev)
    if "gt_msm" in calls:
        GA, GS, _, _ = gt_inputs(B.FQ12, E_BLS12_381, B.FR, 1 << PAIR_LOG_N, rng, 64, device=dev)
    GTG = gt.GTGroup(B.FQ12, B.FR)
    f12 = torch.stack([fp.from_ints(B.FQ, [int.from_bytes(rng.bytes(48), "little") % B.FQ.modulus
                                            for _ in range(64)], device=dev)
                       for _ in range(12)]).reshape((2, 3, 2, B.FQ.num_limbs, 64))
    F = C.base
    x1, y1 = A.x[:, :1].contiguous(), A.y[:, :1].contiguous()

    def products(fn, *ins):
        def loop():
            for _ in range(PRODUCT_CALLS):
                res = fn(F, *ins)
            return res
        return loop

    def fq12_loop():
        for _ in range(PRODUCT_CALLS):
            res = B.FQ12.mul(f12, f12)
        return res

    fns = {"clear_cofactor": lambda: tsw.clear_cofactor(C, off),
           "subgroup_check": lambda: tsw.subgroup_check(C, mix),
           "fast_g1_check": lambda: fast_checks.bls12_381_g1_subgroup_check(C, mix),
           "g2_check": lambda: fast_checks.bls12_381_g2_subgroup_check(C2, Q),
           "scalar_mul": lambda: tsw.scalar_mul(C, A, s),
           "pairing_each": lambda: bls12.pairing_each(B.PAIRING, PP, PQ),
           "pairing": lambda: bls12.pairing(B.PAIRING, PP, PQ),
           "bn254_pairing_each": lambda: bn.pairing_each(bn254.PAIRING, BP, BQ),
           "gt_msm": lambda: gt.gt_msm(GTG, GA, GS, 3),
           "mnt4_753_pairing_each": lambda: mnt.pairing_each(mnt4_753.PAIRING, MP, MQ),
           "fq12_mul_64": fq12_loop,
           "mont_mul_24_1": products(fp.mont_mul, x1, y1),
           "mont_mul_24_2^16": products(fp.mont_mul, A.x, A.y),
           "mont_sqr_24_1": products(fp.mont_sqr, x1),
           "mont_sqr_24_2^16": products(fp.mont_sqr, A.x),
           "fp_add_24_1": products(fp.add, x1, y1),
           "fp_add_24_2^16": products(fp.add, A.x, A.y),
           "fp_sub_24_2^16": products(fp.sub, A.x, A.y),
           "fp_neg_24_2^16": products(fp.neg, A.x)}

    def tensors(res):
        if isinstance(res, torch.Tensor):
            yield res
        else:
            for r in res:
                yield from tensors(r)

    def digest(res):
        h = hashlib.sha256()
        for t in tensors(res):
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, res

    out = {}
    for name in calls:
        _, res = wall(fns[name])
        ms = [wall(fns[name])[0] for _ in range(runs)]
        out[name] = dict(median=statistics.median(ms), runs=ms, digest=digest(res))
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--calls", default=",".join(CALLS))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    calls = a.calls.split(",")
    if a.worker:
        return worker(a.worker, a.runs, calls)
    sides = {"other": Path(a.other).resolve(), "this": ROOT}
    procs = []
    for _ in range(a.pairs):
        for side in ("other", "this", "this", "other"):
            r = subprocess.run([sys.executable, __file__, "--worker", str(sides[side]),
                                "--runs", str(a.runs), "--calls", a.calls],
                               capture_output=True, text=True, timeout=1200)
            if r.returncode:
                sys.stderr.write(r.stdout[-2000:] + r.stderr[-4000:])
                return 1
            res = json.loads(r.stdout.strip().splitlines()[-1])
            print(json.dumps({"side": side, **res}), flush=True)
            procs.append((side, res))
    summary = {}
    for name in calls:
        med = {side: [res[name]["median"] for s, res in procs if s == side] for side in sides}
        pairs = [(sum(med["other"][2 * i:2 * i + 2]), sum(med["this"][2 * i:2 * i + 2]))
                 for i in range(a.pairs)]
        summary[name] = dict(
            median_ms={side: statistics.median(v) for side, v in med.items()},
            quartiles_ms={side: statistics.quantiles(v, n=4) if len(v) > 1 else v
                          for side, v in med.items()},
            process_medians_ms=med,
            this_won_pairs=sum(t < o for o, t in pairs), pairs=a.pairs,
            same_words=len({res[name]["digest"] for _, res in procs}) == 1)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
