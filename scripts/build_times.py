#!/usr/bin/env python3
"""Time the CUDA build on the machine that holds the card: csrc/mont.cu
compiled as one unit at all five field widths (ZK_FIELD_WIDTHS=0), alone,
then kernels/_build.build() from nothing (mont.cu as its three width-group
libraries, every other source once, all at once), each library's own
seconds. Prints the card's name and power limit, then one JSON line.

    python3 scripts/build_times.py

Needs nvcc; writes under zkarray_torch/kernels/build/ (git-ignored).
"""

import json
import pathlib
import shutil
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from zkarray_torch.kernels import _build  # noqa: E402


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    root = _build.BUILD_DIR / "build_times"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DZK_FIELD_WIDTHS=0", "-o",
                    str(root / "libmont_all_widths.so"), str(_build.CSRC / "mont.cu")],
                   capture_output=True, text=True, check=True)
    one_unit = time.perf_counter() - t0
    _build.BUILD_DIR = root / "libs"  # lib_path reads it at each call: a build from nothing
    t0 = time.perf_counter()
    built = _build.build()
    whole = time.perf_counter() - t0
    print(json.dumps({"card": card, "mont_cu_one_unit_all_widths_s": one_unit,
                      "build_all_libraries_s": whole,
                      "per_library_s": {k: v["seconds"] for k, v in built.items()}}), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
