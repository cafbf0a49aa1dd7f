#!/usr/bin/env python3
"""Run chip_smoke.main() under a sampling profiler of its main thread: a
thread reads the main thread's stack every ~5 ms and writes, as seconds,
where it stood: by line of main() (the phase), by innermost chip_smoke.py
line, by innermost frame of any file, and inclusive by function.

    python3 scripts/profile_chip_smoke.py profile.json

The profile is written when main() returns or raises; chip_smoke.py's own
lines go to stdout as usual. Sampling costs ~15 % of the run's wall time.
"""
import collections
import json
import os
import sys
import threading
import time

OUT = sys.argv[1] if len(sys.argv) > 1 else "profile.json"
sys.argv = [sys.argv[0]]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

SMOKE = os.path.abspath(chip_smoke.__file__)
main_id = threading.get_ident()
stop = threading.Event()
counts = {k: collections.Counter() for k in ("main_line", "smoke_leaf", "self", "incl")}
n_samples = 0


def sample():
    global n_samples
    while not stop.wait(0.005):
        f = sys._current_frames().get(main_id)
        if f is None:
            continue
        n_samples += 1
        co = f.f_code
        counts["self"][f"{os.path.basename(co.co_filename)}:{co.co_name}:{f.f_lineno}"] += 1
        seen, smoke_leaf, main_line = set(), None, None
        while f is not None:
            co = f.f_code
            if co.co_filename == SMOKE:
                smoke_leaf = smoke_leaf or f"{co.co_name}:{f.f_lineno}"
                if co.co_name == "main":
                    main_line = f.f_lineno
            key = f"{os.path.basename(co.co_filename)}:{co.co_name}"
            if key not in seen:
                seen.add(key)
                counts["incl"][key] += 1
            f = f.f_back
        counts["main_line"][str(main_line)] += 1
        counts["smoke_leaf"][str(smoke_leaf)] += 1
        del f  # hold no frame (and its tensors) between samples


def main():
    th = threading.Thread(target=sample, daemon=True)
    th.start()
    t0 = time.perf_counter()
    try:
        return chip_smoke.main()
    finally:
        stop.set()
        th.join()
        wall = time.perf_counter() - t0
        per = wall / max(n_samples, 1)
        with open(OUT, "w") as fh:
            json.dump(dict(wall_s=wall, samples=n_samples, s_per_sample=per,
                           **{k: [(a, round(b * per, 2)) for a, b in c.most_common(200)]
                              for k, c in counts.items()}), fh, indent=0)


if __name__ == "__main__":
    sys.exit(main())
