#!/usr/bin/env python3
"""chip_smoke.PlainChains (the plain versions' chains replayed step by step
through CUDA graphs) against the eager plain versions on one CUDA card:
every result equal, the seconds of each, and the device memory PyTorch
holds reserved after a run of graphed chains of four shapes.

    python3 scripts/plain_chains_ab.py     # ~1 minute on an H100, no nvcc

Needs no kernel build: the plain versions and their graphs are PyTorch's
own kernels.
"""
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from zkarray_torch import testing as tt  # noqa: E402
from zkarray_torch.curves import bls12_381 as B  # noqa: E402
from zkarray_torch.curves import bn254, cp6_782, mnt6_753  # noqa: E402
from zkarray_torch.kernels import mont as km  # noqa: E402
from zkarray_torch.kernels import sw as ksw  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("plain_chains_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    P = cs.PLAIN

    def rf(spec, shape):
        L, t = spec.num_limbs, (spec.modulus.bit_length() - 1) // 16
        x = torch.randint(0, 1 << 16, (L,) + shape, generator=g, device=dev, dtype=torch.int32)
        x[t] = torch.randint(0, spec.modulus >> (16 * t), shape, generator=g, device=dev,
                             dtype=torch.int32)
        x[t + 1:] = 0
        return x

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def row(kind, want_fn, got_fn, **kw):
        want, te = timed(want_fn)
        got, tg = timed(got_fn)
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        ok = all(a.shape == b.shape and torch.equal(a, b) for a, b in pairs)
        print(json.dumps(dict(kind=kind, **kw, equal=ok, eager_s=te, graphed_s=tg)), flush=True)
        return ok

    ok = True
    for spec, shape, kind in ((B.FQ, (1,), "inv"), (mnt6_753.FQ, (1,), "inv"),
                              (mnt6_753.FQ, (4096,), "inv"), (cp6_782.FQ, (16,), "inv"),
                              (mnt6_753.FQ, (6, 3, 64), "inv"), (mnt6_753.FQ, (16384,), "inv"),
                              (B.FQ, (65552,), "pow"), (bn254.FR, (65536,), "pow")):
        x = rf(spec, shape)
        x[:, ::5] = 0
        e = spec.modulus - 2 if kind == "inv" else (spec.modulus - 1) // 2
        ok &= row(kind, lambda: km.mont_pow_plain(spec, x, e), lambda: P.pow(spec, x, e),
                  field=spec.name, shape=list(shape))
    for n in (1, 4096):
        ins = [rf(B.FQ, (n,)) for _ in range(4)]
        ins[1][:, ::7] = 0
        ok &= row("div", lambda: km.mont_div_plain(B.FQ, *ins), lambda: P.div(B.FQ, *ins),
                  field=B.FQ.name, shape=[n])
    L = B.FQ.num_limbs
    for W, c in ((20, 13), (8, 4)):
        win = torch.cat([rf(B.FQ, (W,)).T for _ in range(4)], 1).contiguous()  # (W, 4L)
        ok &= row("horner", lambda: ksw.horner_windows_plain(B.G1, win, c),
                  lambda: P.horner(B.G1, win, c), W=W, c=c, L=L)
    for S, R in ((1024, 32), (64, 20)):  # testing.accum_edge_rounds: every edge branch
        P0, rounds = tt.accum_edge_rounds(B.G1, S, R, np.random.default_rng(S))
        state, coords, valid = tt.accum_feed(B.G1, P0, rounds, device=dev)
        ok &= row("accum", lambda: ksw.xyzz_accum_plain(B.G1, state, coords, valid),
                  lambda: P.accum(B.G1, state, coords, valid), S=S, R=R)
    reserved = []
    for i in range(24):
        spec, n = ((mnt6_753.FQ, 4096), (B.FQ, 1), (cp6_782.FQ, 16384), (B.FQ, 65536))[i % 4]
        P.pow(spec, rf(spec, (n,)), (1 << 40) + 12345)
        torch.cuda.synchronize()
        reserved.append(round(torch.cuda.memory_reserved() / 2**30, 2))
    print(json.dumps(dict(kind="memory", reserved_gib_after_each_chain=reserved,
                          cache_emptied=P.emptied, graphed=dict(P.graphed), equal=ok)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
