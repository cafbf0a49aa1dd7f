#!/usr/bin/env python3
"""Time the BLS12-381 G1 MSM of 2^20 points of this tree against another
checkout's (e.g. the parent commit unpacked with git archive), in turns, on
one NVIDIA GPU.

    python3 scripts/msm_ab.py OTHER_CHECKOUT [--pairs 8] [--runs 5]

Each side runs in a fresh process that imports its own checkout's
zkarray_torch (pair i runs this tree first when i is even, the other first
when it is odd). A process builds the inputs as chip_smoke.py phase 3 does
(zkarray_torch.testing.tiled_inputs, seed 0, c = 13), runs one MSM to warm
up, then --runs MSMs, each split into accumulate, reduce and to-affine by
the host clock around work ending in torch.cuda.synchronize(), and each
checked against the host known answer. Prints one JSON line per process
and a summary line: per side the median over processes of each process's
median, the other side's quartile spread, and the pairs this tree won.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LOG_N = 20


def worker(checkout, runs):
    sys.path.insert(0, str(checkout))
    import numpy as np
    import torch

    from zkarray_torch.curves import bls12_381 as B
    from zkarray_torch.ec import msm as tmsm
    from zkarray_torch.ec import sw as tsw
    from zkarray_torch.interop import affine_from_numpy, limbs_from_numpy
    from zkarray_torch.testing import expected_msm, tiled_inputs

    if not torch.cuda.is_available():
        raise RuntimeError("msm_ab: no CUDA device")
    dev = torch.device("cuda")
    G1, n = B.G1, 1 << LOG_N
    px, py, sc, ks, bits = tiled_inputs(G1, n, np.random.default_rng(0))
    want = expected_msm(G1, ks, sc)
    A = affine_from_numpy(px, py, np.zeros(n, dtype=bool), dev)
    s = limbs_from_numpy(sc, dev)
    c = tmsm.default_window_size(n)
    W, half, _, _ = tmsm._window_geometry(c, bits)

    def once(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    rows = []
    for r in range(runs + 1):
        st, t_acc = once(lambda: tmsm.msm_accumulate(G1, A, s, c, bits, tsw.xyzz_zero(G1, (W, half), dev)))
        res, t_red = once(lambda: tmsm.msm_reduce(G1, st, c, bits))
        aff, t_aff = once(lambda: tsw.xyzz_to_affine(G1, tsw.XYZZPoints(*(v[:, None] for v in res))))
        if tsw.affine_to_ints(G1, aff)[0] != want:
            raise AssertionError(f"msm_ab: {checkout}: result differs from the host known answer")
        if r:  # the first run warms up
            rows.append(dict(ms=t_acc + t_red + t_aff, accumulate=t_acc, reduce=t_red, to_affine=t_aff))
    return {k: statistics.median(r[k] for r in rows) for k in rows[0]} | dict(runs=rows)


def quartile_spread(xs):
    q = statistics.quantiles(xs, n=4)
    return q[2] - q[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="checkout compared with this tree")
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(Path(args.worker), args.runs)), flush=True)
        return 0
    sides = {"this tree": ROOT, "other": Path(args.other).resolve()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    got = {k: [] for k in sides}
    for i in range(args.pairs):
        order = list(sides) if i % 2 == 0 else list(sides)[::-1]
        for side in order:
            out = subprocess.run([sys.executable, __file__, "--worker", str(sides[side]),
                                  "--runs", str(args.runs)], cwd=sides[side], capture_output=True,
                                 text=True, timeout=900)
            if out.returncode != 0:
                raise RuntimeError(f"msm_ab: {side} failed:\n{out.stderr[-3000:]}")
            row = json.loads(out.stdout.strip().splitlines()[-1])
            got[side].append(row)
            print(json.dumps(dict(pair=i, side=side, card=card, **row)), flush=True)
    summary = dict(card=card, pairs=args.pairs, runs_per_process=args.runs)
    for key in ("ms", "accumulate", "reduce", "to_affine"):
        this = [r[key] for r in got["this tree"]]
        other = [r[key] for r in got["other"]]
        summary[key] = dict(this_tree_median=statistics.median(this),
                            other_median=statistics.median(other),
                            other_quartile_spread=quartile_spread(other) if len(other) > 1 else None,
                            this_tree_wins=sum(a < b for a, b in zip(this, other)))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
