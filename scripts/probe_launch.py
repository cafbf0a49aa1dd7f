#!/usr/bin/env python3
"""Run chip_smoke.py's launch_cost measurement (phase 8: mont_mul and
mont_sqr through kernels/mont.py:ProductLauncher at (24, 1), (24, 2^16),
(16, 2^16) and BLS12-381 pairing_each's widest product batch; fp_add,
fp_sub and fp_neg through AddSubLauncher at the first three and the
pairing's widest addition, written through a tower view; the host's
pieces of a (24, 1) mont_mul and fp_add call; a batch-transposed operand
against the plain version; an out that cannot be written in place; fp_lin
through LinLauncher at a BLS12-381 Fp12 product's two maps and the
pairing's widest launch) and phase 12's fp_lin_host line (the host's us
of fp_lin's maps, fp_add and an Fp12 product at 64 lanes, with their
pieces) alone on one CUDA card, after building csrc/mont.cu at NW = 8,
10 and 12, csrc/fadd.cu and csrc/flin.cu only. With a directory argument
its lines are also teed into DIR/probe_launch.out.

    python3 scripts/probe_launch.py [DIR]   # ~1 minute on an H100, the build included
"""
import json
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from probe_phase13 import cs, setup  # noqa: E402

if __name__ == "__main__":
    h, tee = setup("probe_launch", ("mont", "fadd", "flin"))
    t = time.perf_counter()
    cs.launch_cost(torch, h)
    tee(json.dumps({"launch_cost_seconds": time.perf_counter() - t}))
    t = time.perf_counter()
    cs.lin_host_line(torch, h)
    tee(json.dumps({"fp_lin_host_seconds": time.perf_counter() - t}))
