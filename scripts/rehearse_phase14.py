#!/usr/bin/env python3
"""Rehearse chip_smoke.py's phase 14 alone on the CPU at small sizes, as
scripts/rehearse_phase13.py rehearses phase 13 (every kernel launch a
counted call of its plain version): it finds wrong paths, shapes, counts
and control flow before a chip call, and says nothing about the CUDA
sources.

    python3 scripts/rehearse_phase14.py   # ~8 minutes on a CPU
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from rehearse_phase13 import run  # noqa: E402

SIZES = dict(
    H2C_G1_LOG_N=3, H2C_G2_LOG_N=1, H2C_G1_KAT=6, H2C_G2_KAT=2, TE_LOG_N=3, TE_WIDE_LOG_N=1,
    TE_KAT=6, TE_ORDER_LANES=1, DO_LOG_N=3, ZOO_LOG_N=6, ZOO_KAT=6,  # tiled_inputs: 64 lanes
    PALLAS_MSM_LOG_N=6, R1_MSM_LOG_N=6, R1_EDGE_SLOTS=45, R1_EDGE_ROUNDS=3, R1_EDGE_LOG_N=7)

if __name__ == "__main__":
    run("curves_h2c_phase", SIZES)
