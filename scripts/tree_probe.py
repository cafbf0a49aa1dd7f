#!/usr/bin/env python3
"""Time csrc/xyzz.cu:xyzz_tree_sum on one NVIDIA GPU against the row count
and the order of its rows, to see how its blocks share the SMs.

    python3 scripts/tree_probe.py [--out FILE]

Feeds, BLS12-381 G1 (NW = 12), every result held bit for bit against the
plain version: random points at 66, 132, 198 and 264 rows of 1,024 (one
or two blocks an SM on 132 SMs); the 2^20 msm's own tree input (recorded
from one msm, (L, 13, 20, 1024): rows by weight bit, then window), as it
is and with its rows reordered: windows first ((L, 20, 13, 1024)),
reversed, and interleaved (row j beside row rows - 1 - j); and the rows of
each weight bit alone (20 rows each). Each row's adds that need products
are counted on the host's plain tree (a level's pairs where neither point
is at infinity). Times: CUDA events over 20 launches. Prints one JSON line
each, and all of them to --out when given.
"""

import argparse
import json
import sys
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="JSON file for all rows")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("tree_probe: no CUDA device", file=sys.stderr)
        return 1
    from zkarray_torch import testing as tt
    from zkarray_torch.curves import bls12_381 as B
    from zkarray_torch.ec import msm as tmsm
    from zkarray_torch.ff import fp
    from zkarray_torch.interop import affine_from_numpy, limbs_from_numpy
    from zkarray_torch.kernels import _build
    from zkarray_torch.kernels import sw as ksw

    _build.build(("mont", "sw", "xyzz", "madd"))
    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    G1, f = B.G1, B.FQ
    L = f.num_limbs
    gen = torch.Generator(device=dev).manual_seed(5)
    results = []

    def rand_field(m):
        x = torch.randint(0, 1 << 16, (L, m), generator=gen, device=dev, dtype=torch.int32)
        x[L - 1] = torch.randint(0, f.modulus >> (16 * (L - 1)), (m,), generator=gen, device=dev,
                                 dtype=torch.int32)
        return x

    def timed(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def full_adds(P):
        """Adds of the plain tree whose two points are both finite."""
        n, m = 0, P[0].shape[-1]
        while m > 1:
            h = m // 2
            lo, hi = tuple(v[..., :h] for v in P), tuple(v[..., h : 2 * h] for v in P)
            n += int((~fp.is_zero(f, lo[2]) & ~fp.is_zero(f, hi[2])).sum())
            red = ksw._fadd_plain(G1, lo, hi)
            if m % 2:
                red = tuple(torch.cat([a, v[..., 2 * h :]], dim=-1) for a, v in zip(red, P))
            m -= h
            P = red
        return n

    def row(feed, P):
        P = [v.contiguous() for v in P]
        got, want = ksw.xyzz_tree_sum(G1, P), ksw.xyzz_tree_sum_plain(G1, P)
        if any(not torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"xyzz_tree_sum {feed}: differs from the plain version")
        m = P[0].shape[-1]
        rec = dict(feed=feed, shape=list(P[0].shape), rows=P[0][0].numel() // m,
                   full_adds=full_adds(P), ms=timed(lambda: ksw.xyzz_tree_sum(G1, P)),
                   max_abs_err=0, card=card)
        results.append(rec)
        print(json.dumps(rec), flush=True)

    for rows in (66, 132, 198, 264):
        row(f"random, {rows} rows", [rand_field(rows * 1024).reshape(L, rows, 1024) for _ in range(4)])

    px, py, sc, _, bits = tt.tiled_inputs(G1, 1 << 20, np.random.default_rng(0))
    A = affine_from_numpy(px, py, np.zeros(1 << 20, dtype=bool), dev)
    rec = types.SimpleNamespace(on=True)
    restore = cs.install_msm_recorders(torch, rec)
    try:
        tmsm.msm(G1, A, limbs_from_numpy(sc, dev), max_scalar_bits=bits)
        (P,) = [ins for kernel, ins, _ in rec.msm if kernel == "xyzz_tree_sum"]
    finally:
        restore()
    del A
    q, W = P[0].shape[1], P[0].shape[2]
    row("msm tree input, rows (bit, window)", P)
    row("msm tree input, rows (window, bit)", [v.transpose(1, 2) for v in P])
    flat = [v.reshape(L, q * W, 1024) for v in P]
    row("msm tree input, rows reversed", [v.flip(1) for v in flat])
    n = q * W
    inter = torch.tensor([j // 2 if j % 2 == 0 else n - 1 - j // 2 for j in range(n)], device=dev)
    row("msm tree input, row j beside row rows - 1 - j", [v[:, inter] for v in flat])
    for k in range(q):
        row(f"msm tree input, weight bit {k} alone", [v[:, k] for v in P])
    if args.out:
        Path(args.out).write_text(json.dumps(dict(card=card, rows=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
