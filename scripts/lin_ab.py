#!/usr/bin/env python3
"""Hold this tree's csrc/flin.cu against another checkout's (e.g. the parent
commit unpacked with git archive) in one process on one NVIDIA GPU: the
other source is built beside this tree's (nvcc, the same flags) and both
C entries run on the same inputs, in turns (other, this, this, other).

Launches (the default): the widest fp_lin launch each width's paths record
(chip_smoke.py phases 9-12: a tower product's pre-map, written into the
slab's movedim view as ff/linmap.py:Route writes it) and a BLS12-381 Fp12
product's two maps at one element and at 64 lanes, each turn's words held
against fp_lin_plain. A checkout whose LinCall has no lanes word (six head
words) takes the one-thread body; this tree's takes the lanes
kernels/lin.py:lanes gives. Per shape and side: device ms per launch (the
mean over REPS launches in a trace of their own, per turn) and the lanes.

Paths (``--paths``): BLS12-381 ``pairing`` (one final exponentiation on
one element) and ``pairing_each`` over 2^12 pairs, BN254 ``pairing_each``
and ``gt_msm`` (c = 3, 2^12 elements), made as scripts/group_ab.py makes
them, each run through this tree's Python with the field's LinLauncher
calling one side's C entry: the other build, this one, and this one at one
thread a row on every launch ("one"). Every side goes through the same
shim (unpack the block, drop the lanes word for a six-word entry or set it,
pack, call), so they pay the same host cost a launch and differ only in
the kernel. Per turn and path: the median wall of RUNS timed calls (host
clock to torch.cuda.synchronize()) and of their queueing (host clock to
the call's return), and one traced call's fp_lin device ms and busy ms;
every call's words equal the first's. Prints one JSON line per shape
or turn and a summary line.

    python3 scripts/lin_ab.py OTHER_CHECKOUT            # ~1 minute on an H100, the build included
    python3 scripts/lin_ab.py OTHER_CHECKOUT --paths    # ~3 minutes
"""

import ctypes
import importlib
import json
import math
import pathlib
import re
import statistics
import struct
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from zkarray_torch.ff import linmap  # noqa: E402
from zkarray_torch.kernels import _build, lin  # noqa: E402

REPS = 20
# --paths: ORDER's sides, ROUNDS times; timed calls a turn; "one" is this build at one
# thread a row whatever kernels/lin.py:lanes gives (its lanes word set to 1)
ORDER = ("other", "this", "one", "one", "this", "other")
ROUNDS, RUNS = 2, 5
PAIR_LOG_N = 12
# (label, curve module, tower, op, batch): each width's widest recorded path launch (PERF.md
# row K) and the narrow Fp12 maps
SHAPES = (("nw12 pairing_each widest", "bls12_381", "FQ12", "mul", (4096,)),
          ("nw12 gt_msm tree widest", "bls12_381", "FQ12", "mul", (7, 2048)),
          ("nw8 widest", "bn254", "FQ12", "mul", (4096,)),
          ("nw10 widest", "mnt6_298", "FQ3", "mul", (3, 47, 4096)),
          ("nw24 widest", "mnt6_753", "FQ3", "mul", (3, 64, 4096)),
          ("nw26 widest", "cp6_782", "FQ6", "mul", (4096,)),
          ("Fp12 mul, one element", "bls12_381", "FQ12", "mul", ()),
          ("Fp12 mul, 64 lanes", "bls12_381", "FQ12", "mul", (64,)))


def other_lib(checkout: pathlib.Path):
    """The other checkout's flin.cu built into the build directory, its
    entry's LinCall head words (6 or 7)."""
    src = checkout / "zkarray_torch" / "kernels" / "csrc" / "flin.cu"
    out = _build.BUILD_DIR / "libflin_other.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.zk_fp_lin_v.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.zk_fp_lin_v.restype = ctypes.c_int
    head = 7 if re.search(r"long long lanes;", src.read_text()) else 6
    return lib, head


def shim(entry, head, lanes=None):
    """A C entry of LinCall with ``head`` head words, called with this
    tree's seven-word block: the lanes word dropped for six, or set to
    ``lanes`` for seven."""
    def call(block, stream):
        words = struct.unpack(f"{len(block) // 8}q", block)
        words = words[:6] + (words[6] if lanes is None else lanes,) * (head == 7) + words[7:]
        return entry(struct.pack(f"{len(words)}q", *words), stream)
    return call


def launches(olib, ohead):
    """The launch shapes, each through both C entries in turns."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    rows = []
    for label, curve, tower, op, batch in SHAPES:
        T = getattr(importlib.import_module(f"zkarray_torch.curves.{curve}"), tower)
        spec, L = T.spec, T.spec.num_limbs
        r = linmap.route(T, op, type(T)._mul_sched, (T, T))
        for which, lmap in (("pre", r.pre), ("post", r.post)):
            if which == "post" and batch not in ((), (64,)):
                continue  # the widest launch of each width is a pre-map
            srcs = [rand_words(spec, (s, L) + batch, gen, dev) for s in lmap.sizes]
            if which == "pre":
                out = torch.empty((L, lmap.m) + batch, dtype=torch.int32, device=dev).movedim(1, 0)
            else:
                out = torch.empty((lmap.m, L) + batch, dtype=torch.int32, device=dev)
            want = lin.fp_lin_plain(spec, lmap, srcs)
            g = lin.lanes(math.prod(batch), lmap.m, lmap.max_terms)
            one, _ = cs.lin_forced(torch, lin, spec, lmap, srcs, 1, out)
            this, _ = cs.lin_forced(torch, lin, spec, lmap, srcs, g, out)
            stream = lin.lin_launcher(spec, 0).raw_stream(0)
            other = shim(olib.zk_fp_lin_v, ohead)
            sides = {"other": lambda: other(one.block, stream), "this": this}
            ms = {"other": [], "this": []}
            for side in ("other", "this", "this", "other"):
                out.fill_(-1)
                if sides[side]():
                    raise RuntimeError(f"{label} {which}: the {side} entry refused the launch")
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{label} {which}: the {side} kernel differs from plain")
                ms[side].append(cs.traced_device_ms(torch, "fp_lin", sides[side], REPS, dev)[0])
            row = dict(shape=label, map=lmap.name, launch=[lmap.m, L] + list(batch),
                       lanes_this=g, lanes_other=1, device_ms=ms,
                       this_over_other=statistics.mean(ms["this"]) / statistics.mean(ms["other"]))
            print(json.dumps(row), flush=True)
            rows.append(row)
    return {r["shape"] + " " + r["map"]: round(r["this_over_other"], 3) for r in rows}


def paths(olib, ohead):
    """The pairing and GT paths through both C entries in turns."""
    from zkarray_torch.curves import bls12_381 as B
    from zkarray_torch.curves import bn254
    from zkarray_torch.ec.pairing import bls12, bn, gt
    from zkarray_torch.testing import E_BLS12_381, gt_inputs, pairing_inputs

    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    n = 1 << PAIR_LOG_N
    PP, PQ, _, _ = pairing_inputs(B.PAIRING, n, rng, 64, 1024, device=dev)
    BP, BQ, _, _ = pairing_inputs(bn254.PAIRING, n, rng, 64, 1024, device=dev)
    GA, GS, _, _ = gt_inputs(B.FQ12, E_BLS12_381, B.FR, n, rng, 64, device=dev)
    GTG = gt.GTGroup(B.FQ12, B.FR)
    fns = {"pairing": lambda: bls12.pairing(B.PAIRING, PP, PQ),
           "pairing_each": lambda: bls12.pairing_each(B.PAIRING, PP, PQ),
           "bn254_pairing_each": lambda: bn.pairing_each(bn254.PAIRING, BP, BQ),
           "gt_msm": lambda: gt.gt_msm(GTG, GA, GS, 3)}
    goes = [lin.lin_launcher(B.FQ, 0), lin.lin_launcher(bn254.FQ, 0)]
    entries = {"other": shim(olib.zk_fp_lin_v, ohead), "this": shim(goes[0].fn, 7),
               "one": shim(goes[0].fn, 7, lanes=1)}
    want, turns = {}, []

    def wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        queued = time.perf_counter()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, (queued - t) * 1e3, res

    for _ in range(ROUNDS):
        for side in ORDER:
            for go in goes:
                go.fn = entries[side]
            turn = {"side": side}
            for name, fn in fns.items():
                res = wall(fn)[2]
                res = res if isinstance(res, torch.Tensor) else torch.cat([t.reshape(-1) for t in res])
                if not torch.equal(want.setdefault(name, res), res):
                    raise AssertionError(f"{name}: the {side} kernel's words differ")
                runs = [wall(fn)[:2] for _ in range(RUNS)]
                ms = [r[0] for r in runs]
                _, tr = cs.device_trace(torch, fn, statistics.median(ms))
                k = (tr or {}).get("port_kernels", {}).get("fp_lin", {})
                turn[name] = dict(median_ms=statistics.median(ms), runs_ms=ms,
                                  queued_ms=statistics.median(r[1] for r in runs),
                                  fp_lin_launches=k.get("launches"),
                                  fp_lin_device_ms=k.get("device_ms"),
                                  busy_ms=(tr or {}).get("ms_device_busy"))
            print(json.dumps(turn), flush=True)
            turns.append(turn)
    for go in goes:
        go.fn = go.lib.zk_fp_lin_v

    def per_side(name, key):
        return {s: [t[name][key] or 0 for t in turns if t["side"] == s] for s in entries}

    out = {}
    for name in fns:
        med = per_side(name, "median_ms")
        out[name] = dict(median_ms={s: statistics.median(v) for s, v in med.items()},
                         quartiles_ms={s: statistics.quantiles(v, n=4) for s, v in med.items()},
                         turn_medians_ms=med,
                         **{f"{key}_median": {s: statistics.median(v)
                                              for s, v in per_side(name, key).items()}
                            for key in ("queued_ms", "fp_lin_device_ms", "busy_ms")})
    return out


def main():
    if not torch.cuda.is_available():
        print("lin_ab: no CUDA device", file=sys.stderr)
        return 1
    other = pathlib.Path(sys.argv[1]).resolve()
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    _build.build(("mont", "fadd", "flin") if "--paths" in sys.argv else ("flin",))
    olib, ohead = other_lib(other)
    summary = paths(olib, ohead) if "--paths" in sys.argv else launches(olib, ohead)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


def rand_words(spec, shape, gen, dev):
    """Random words below p of ``shape`` (k, L, *batch), on ``dev``."""
    t = (spec.modulus.bit_length() - 1) // 16
    x = torch.randint(0, 1 << 16, shape, generator=gen, device=dev, dtype=torch.int32)
    x[:, t] = torch.randint(0, spec.modulus >> (16 * t), x[:, t].shape, generator=gen, device=dev,
                            dtype=torch.int32)
    x[:, t + 1:] = 0
    return x


if __name__ == "__main__":
    sys.exit(main())
