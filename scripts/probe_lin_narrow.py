#!/usr/bin/env python3
"""Run chip_smoke.py's fp_lin narrow-batch checks alone on one CUDA card,
after building csrc/mont.cu at NW = 8, 10 and 12, csrc/fadd.cu,
csrc/flin.cu, csrc/twiddle.cu and csrc/smallfp.cu and the latency probe:
the latency line (dependent carried add, L2 load and warp shuffle, an
empty launch's device ms); the fp_lin_narrow line (a BLS12-381 Fp12
product's maps and the Granger-Scott square's post-map at chip_smoke.py's
widths, 1 to 7 x 2^11 elements, and seven between them; every lanes value
of csrc/flin.cu against fp_lin_plain, its device ms per launch from one
trace a shape, chain bounds); the long-row edge words on both sides of
kernels/lin.py's crossovers; the shared-address ``out`` refusals;
csrc/flin.cu's registers, spills and SASS size per (NW, lanes); one traced
gt_msm (c = 3, 2^12 elements, against the host's known answer: fp_lin's
device ms by body beside the whole busy time); and launch_cost's fp_lin
rows (64 lanes and the pairing's widest launch). With a directory
argument its lines are also teed into DIR/probe_lin_narrow.out.

    python3 scripts/probe_lin_narrow.py [DIR]   # ~2 minutes on an H100, the build included
"""
import collections
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from probe_phase13 import cs, setup  # noqa: E402

if __name__ == "__main__":
    from zkarray_torch.kernels import _build

    h, tee = setup("probe_lin_narrow", ("mont", "fadd", "flin", "twiddle", "smallfp"))
    src = _build.BUILD_DIR / "latency_probe.cu"
    src.write_text(cs.LATENCY_PROBE)
    lib = src.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    clock = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    h.latency = cs.latency_line(torch, lib, clock)
    # chip_smoke.py's widths and those between them: the crossover's data
    cs.LIN_NARROW_N = tuple(sorted(set(cs.LIN_NARROW_N) | {16, 32, 128, 256, 896, 2048, 8192}))
    cs.emit("latency", **h.latency)
    t = time.perf_counter()
    cs.lin_narrow_line(torch, h)
    err = collections.defaultdict(int)
    cs.emit("long_row_edge_words", fields=cs.lin_edge_crossover(torch, h, err), max_abs_err=err["fp_lin"])
    cs.emit("shared_out_refused", kernels=cs.shared_out_refusals(torch, h), correct=True)
    cs.emit("fp_lin_code", instantiations=cs.lin_code())
    tee(json.dumps({"narrow_seconds": time.perf_counter() - t}))

    # gt_msm: launches, a check against the host's known answer, a trace
    from zkarray_torch import kernels
    from zkarray_torch.curves import bls12_381 as B
    from zkarray_torch.ec.pairing import gt
    from zkarray_torch.testing import E_BLS12_381, gt_inputs

    n, r = 1 << cs.PAIR_LOG_N, B.FR.modulus
    A, sc, ks, ss = gt_inputs(B.FQ12, E_BLS12_381, B.FR, n, np.random.default_rng(10), cs.PAIR_BASE,
                              device=h.dev)
    total = sum(ks[i % cs.PAIR_BASE] * ss[i % cs.PAIR_BASE] for i in range(n)) % r
    want = cs.expected_gt(torch, B.FQ12, r, E_BLS12_381, [total], 1, 1 << 62, h.dev)[0][..., 0]
    G = gt.GTGroup(B.FQ12, B.FR)
    kernels.reset_launches()
    got, first_ms = h.once_ms(lambda: gt.gt_msm(G, A, sc, 3))
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if not torch.equal(got, want):
        raise AssertionError("gt_msm differs from the host's known answer")
    _, ms = h.once_ms(lambda: gt.gt_msm(G, A, sc, 3))
    got, tr = cs.device_trace(torch, lambda: gt.gt_msm(G, A, sc, 3), ms)
    if not torch.equal(got, want):
        raise AssertionError("the traced gt_msm differs from the host's known answer")
    cs.emit("gt_msm", ms=ms, first_call_ms=first_ms, launches_per_call=launches, correct=True,
            trace=tr)

    t = time.perf_counter()

    def host_us(fn, calls=200):
        fn()
        h.sync()
        t_ = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t_) * 1e6 / calls
        h.sync()
        return us

    cs.emit("fp_lin_launch_cost", **cs.lin_launch_cost(torch, h, cs.LAUNCH_COST_CALLS, host_us))
    tee(json.dumps({"launch_cost_seconds": time.perf_counter() - t}))
