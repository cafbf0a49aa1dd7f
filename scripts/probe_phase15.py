#!/usr/bin/env python3
"""Run chip_smoke.py's phase 15 (the small fields and their NTTs, the
multi-device layer on a one-rank NCCL group, serialization, the
xyzz_add_affine feeds at p >= R/2) alone on one CUDA card, as
scripts/probe_phase13.py runs phase 13: the build, main()'s helpers, then
``smallfield_dist_phase``. With a directory argument its lines are also
teed into DIR/probe15.out.

    python3 scripts/probe_phase15.py [DIR]   # a few minutes on an H100, the build included
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from probe_phase13 import run  # noqa: E402

if __name__ == "__main__":
    run("smallfield_dist_phase", "probe15")
