#!/usr/bin/env python3
"""Run chip_smoke.py's phase 14 (the other curve models and hashing to
curves) alone on one CUDA card, as scripts/probe_phase13.py runs phase 13:
the build, main()'s helpers, the field-kernel recorders, then
``curves_h2c_phase``. With a directory argument its lines are also teed
into DIR/probe14.out.

    python3 scripts/probe_phase14.py [DIR]   # ~5 minutes on an H100, the build included
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from probe_phase13 import run  # noqa: E402

if __name__ == "__main__":
    run("curves_h2c_phase", "probe14")
