#!/usr/bin/env python3
"""Rehearse chip_smoke.py's phase 15 (the small fields, the multi-device
layer on a one-rank group, serialization, the xyzz_add_affine feeds at
p >= R/2) alone on the CPU at small sizes, as scripts/rehearse_phase13.py
rehearses phase 13: every kernel launch a counted call of its plain
version, the one-rank group on gloo. It finds wrong paths, shapes, counts
and control flow before a chip call, and says nothing about the CUDA
sources.

    python3 scripts/rehearse_phase15.py   # ~3 minutes on a CPU
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from rehearse_phase13 import run  # noqa: E402

SIZES = dict(SF_NTT_LOG_N=6, SF_NTT_COLS=4, KB_NTT_COLS=2, GL_NTT_LOG_N=7, SF_ELEM_LOG_N=8,
             SF_KAT=32, DIST_MSM_LOG_N=8, DIST_FFT_LOG_N=8, RB_LOG_N=6, RB_KAT=16,
             DERIVE_LOG_N=6, MADD_TOP_LOG_N=7, R1_TIME_LOG_N=7)

if __name__ == "__main__":
    run("smallfield_dist_phase", SIZES)
