#!/usr/bin/env python3
"""Time this tree's field inverse and to-affine division on one NVIDIA GPU
against another checkout's inverse (e.g. the parent commit unpacked with
git archive), and the one-launch to-affine against the batch-inverse route.

    python3 scripts/inv_ab.py OTHER_CHECKOUT [--inv LABEL=CSRC_DIR ...] [--sass DIR]
                              [--out FILE]

Both trees' csrc/mont.cu are compiled with nvcc for NW = 8, 10 and 12 (the
library ``mont``) and called through ctypes on the same device tensors
(zk_mont_inv takes the same arguments in both, and this tree's a lane
count too), as are the mont.cu of each --inv directory. Every result is
held bit for bit against this tree's plain version. Rows, one JSON line
each:
- ``check``: mont_inv (this tree's wrapper) on testing.mont_inv_edge_words
  of BN254 Fr, BLS12-381 Fr and Fq, MNT4-298 Fq and secp256k1's field (p's
  top bit set), each alone and in one launch, against the plain version and
  Python's pow; mont_div on the edge words as denominators (zero among
  them) with random numerators, against the plain version and Python ints;
- ``mont_inv``: BLS12-381 Fq at (24, 1), (24, 2^12) (the pairing's Fp12
  inverse) and (24, 2^20), both trees in turns (this tree, other, other,
  this tree), CUDA events over 20 launches (3 at 2^20), the device ms a
  launch from a trace of 20, this tree's wrapper ms at (24, 1), the chain
  bound (testing.mont_inv_chain x one dependent carried add's latency from
  chip_smoke.LATENCY_PROBE) and the operation bound (testing.mont_inv_ops);
- ``lanes``: this tree's mont_inv with two lanes an element and with one,
  in turns, at 1 to 2^20 elements (where the kernel switches: GCD_WIDE),
  CUDA events and the device ms a launch (trace);
- ``mont_mul``: the wrapper ms and the device ms a launch (trace) at
  (24, 1) and (24, 2^16);
- ``to_affine``: ec.sw.xyzz_to_affine's mont_div launch against the
  batch-inverse route (fp.mont_mul(X, fp.batch_inv(ZZ)) and its twin, this
  tree's kernels) at 1, 2^16 and 2^20 random points with every 64th at
  infinity, in turns: the host wall to the device's end (median of 5),
  CUDA events, the launches by kernel, the device ms of mont_div's launch
  (trace), both routes' words equal.
The libraries go to zkarray_torch/kernels/build/ab/; with --sass DIR,
each library's SASS of the inverse and division kernels at NW = 12 goes to
DIR/<label>_nw12.sass and their instruction counts into the build row.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from zkarray_torch.kernels import _build  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="checkout whose zkarray_torch/kernels/csrc/mont.cu is compared")
    ap.add_argument("--inv", action="append", default=[], help="LABEL=CSRC_DIR")
    ap.add_argument("--sass", help="directory for the NW = 12 kernels' SASS")
    ap.add_argument("--out", help="JSON file for all rows")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("inv_ab: no CUDA device", file=sys.stderr)
        return 1
    from zkarray_torch import kernels
    from zkarray_torch.curves import bls12_381 as B
    from zkarray_torch.curves import bn254, mnt4_298, zoo
    from zkarray_torch.ec import sw as tsw
    from zkarray_torch.ff import fp
    from zkarray_torch.kernels import mont as km
    from zkarray_torch.testing import mont_inv_chain, mont_inv_edge_words, mont_inv_ops

    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    clock_mhz = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    int_ops_per_s = props.multi_processor_count * cs.INT32_LANES_PER_SM * clock_mhz * 1e6
    rows = []

    def emit(kind, **kw):
        row = dict(kind=kind, card=card, **kw)
        rows.append(row)
        print(json.dumps(row), flush=True)

    # builds: the other trees' mont.cu and the latency probe, beside this
    # tree's libraries (all at once)
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    csrcs = {"other": Path(args.other).resolve() / "zkarray_torch" / "kernels" / "csrc"}
    csrcs.update((v.split("=", 1)[0], Path(v.split("=", 1)[1]).resolve()) for v in args.inv)
    procs = {}
    for label, csrc in csrcs.items():
        procs[label] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *_build.source_of("mont")[1], "-o",
             str(out_dir / f"{label}_mont.so"), str(csrc / "mont.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lat_src = out_dir / "latency_probe.cu"
    lat_src.write_text(cs.LATENCY_PROBE)
    lat_lib = lat_src.with_suffix(".so")
    procs["latency probe"] = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lat_lib), str(lat_src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.perf_counter()
    built = _build.build(("mont",))
    for label, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
    ptxas = cs.parse_ptxas(_build.lib_path("mont").with_suffix(".ptxas.txt").read_text())
    libs = {"this tree": _build.lib_path("mont")}
    libs.update((label, out_dir / f"{label}_mont.so") for label in csrcs)
    sass = {}
    for label, path in libs.items():
        funcs = {k: v["instructions"] for k, v in cs.sass_functions([path])[0].items()
                 if ("mont_inv" in k or "mont_div" in k) and "ILi12E" in k}
        sass[label] = funcs
        if args.sass:
            text = subprocess.run([cs.cuobjdump(), "-sass", str(path)], capture_output=True,
                                  text=True, timeout=300, check=True).stdout
            keep, out_lines = False, []
            for line in text.splitlines():
                if "Function : " in line:
                    keep = ("mont_inv" in line or "mont_div" in line) and "ILi12E" in line
                if keep:
                    out_lines.append(line)
            Path(args.sass).mkdir(parents=True, exist_ok=True)
            (Path(args.sass) / f"{label.replace(' ', '_')}_nw12.sass").write_text("\n".join(out_lines))
    emit("build", seconds=time.perf_counter() - t0, this_tree=built.get("mont", {}).get("seconds"),
         ptxas={k: v for k, v in ptxas.items() if "mont_inv" in k or "mont_div" in k},
         sass_instructions_nw12=sass)
    add_cycles = cs.add_latency_cycles(torch, lat_lib)
    lanes_sig = _build.EXPORTS["mont"]["zk_mont_inv"]
    old_sig = lanes_sig[:4] + lanes_sig[5:]  # the parent's: no lane count
    inv_libs = {}
    for label, csrc in csrcs.items():
        lib = ctypes.CDLL(str(out_dir / f"{label}_mont.so"))
        has_lanes = "int lanes," in (csrc / "mont.cu").read_text()
        lib.zk_mont_inv.argtypes = lanes_sig if has_lanes else old_sig
        lib.zk_mont_inv.restype = ctypes.c_int
        inv_libs[label] = (lib, has_lanes)
    this_lib = _build.load("mont")

    def sync():
        torch.cuda.synchronize()

    def events_ms(fn, reps):
        fn()
        sync()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        sync()
        return a.elapsed_time(b) / reps

    def wall_ms(fn, reps=5):
        fn()
        out = []
        for _ in range(reps):
            sync()
            t = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t) * 1e3)
        return statistics.median(out)

    def bound(nbytes, ops):
        tb, to = nbytes / cs.HBM_BYTES_PER_S * 1e3, ops / int_ops_per_s * 1e3
        return max(tb, to), "bytes" if tb >= to else "operations"

    def raw_inv(lib, has_lanes, spec, x, lanes=0):
        out = torch.empty_like(x)
        desc = km.operand_words([km._operand(x)])
        extra = (lanes,) if has_lanes else ()
        err = lib.zk_mont_inv(km.words_ptr(desc), out.data_ptr(), x[0].numel(),
                              km.words_ptr(km._r2_words(spec)), *extra, spec.num_limbs // 2,
                              km.words_ptr(km.field_words(spec)),
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mont_inv: CUDA error {err}")
        return out

    def other_inv(spec, x, label="other"):
        return raw_inv(*inv_libs[label], spec, x)

    def rand_field(spec, n, gen):
        L = spec.num_limbs
        t = (spec.modulus.bit_length() - 1) // 16
        x = torch.randint(0, 1 << 16, (L, n), generator=gen, device=dev, dtype=torch.int32)
        x[t] = torch.randint(0, spec.modulus >> (16 * t), (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        x[t + 1:] = 0
        return x

    def equal(what, got, want):
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{what}: differs from the plain version")

    gen = torch.Generator(device=dev).manual_seed(17)

    # -- checks at NW = 8, 10, 12 ------------------------------------------------
    checked = {}
    for f in (bn254.FR, B.FR, B.FQ, mnt4_298.FQ, zoo.SECP256K1.base):
        p, R = f.modulus, f.r_int
        words = mont_inv_edge_words(f, np.random.default_rng(5), n_random=8)
        xe = fp.from_ints(f, words, mont=False, device=dev)
        got = km.mont_inv(f, xe)
        equal(f"mont_inv {f.name} edge words", got, km.mont_inv_plain(f, xe))
        for j in range(len(words)):
            equal(f"mont_inv {f.name} edge word {j}", km.mont_inv(f, xe[:, j : j + 1]), got[:, j : j + 1])
        if fp.to_ints(f, got, mont=False) != [pow(w * pow(R, -1, p), -1, p) * R % p if w else 0
                                              for w in words]:
            raise AssertionError(f"mont_inv {f.name}: differs from Python's pow")
        nums = rand_field(f, 2 * len(words), gen)
        n0, n1 = nums[:, : len(words)], nums[:, len(words):]
        d1 = xe.flip(1)
        got = km.mont_div(f, n0, xe, n1, d1)
        equal(f"mont_div {f.name} edge words", got, km.mont_div_plain(f, n0, xe, n1, d1))
        for k, (nn, dd) in enumerate(((n0, xe), (n1, d1))):
            nv, dv = fp.to_ints(f, nn, mont=False), fp.to_ints(f, dd, mont=False)
            if fp.to_ints(f, got[k], mont=False) != [a * pow(d, -1, p) * R % p if d else 0
                                                     for a, d in zip(nv, dv)]:
                raise AssertionError(f"mont_div {f.name}: differs from Python ints")
        checked[f.name] = len(words)
    emit("check", correct=True, edge_words=checked)

    # -- mont_inv: both trees in turns ----------------------------------------------
    f = B.FQ
    L = f.num_limbs
    chain_ms = mont_inv_chain(f) * add_cycles / (clock_mhz * 1e3)
    for log_n in (0, 12, 20):
        n = 1 << log_n
        x = rand_field(f, n, gen)
        if n > 1:
            x[:, :: 1001] = 0
        want = km.mont_inv_plain(f, x) if n <= 1 << 12 else None
        mine = km.mont_inv(f, x)
        if want is not None:
            equal(f"mont_inv (24, {n})", mine, want)
        for label in csrcs:
            equal(f"mont_inv (24, {n}) against {label}'s", mine, other_inv(f, x, label))
        reps = 3 if n > 1 << 12 else 20
        t = {"this tree": [], **{label: [] for label in csrcs}}
        for side in ["this tree", *csrcs] + [*csrcs][::-1] + ["this tree"]:
            fn = (lambda: km.mont_inv(f, x)) if side == "this tree" else (
                lambda: other_inv(f, x, side))
            t[side].append(events_ms(fn, reps))
        traced = {side: cs.traced_device_ms(torch, "mont_inv", (lambda: km.mont_inv(f, x)) if side == "this tree"
                                            else (lambda: other_inv(f, x, side)), reps, dev)[0]
                  for side in t}
        b_ms, b_by = bound(2 * L * 4 * n, n * mont_inv_ops(f))
        row = dict(shape=[L, n], events_ms=t, device_ms_traced=traced, batches=km.gcd_batches(f),
                   bound_ms=b_ms, bound_by=b_by)
        if n == 1:
            row.update(wrapper_ms=wall_ms(lambda: km.mont_inv(f, x), 20), chain_bound_ms=chain_ms,
                       chain_instructions=mont_inv_chain(f), cycles_per_dependent_add=add_cycles,
                       share_of_chain_bound=chain_ms / traced["this tree"] if traced["this tree"] else None)
        emit("mont_inv", **row)

    # -- this tree's lane layouts across widths ----------------------------------------
    for log_n in (0, 8, 10, 12, 13, 14, 15, 16, 20):
        n = 1 << log_n
        x = rand_field(f, n, gen)
        one_lane = raw_inv(this_lib, True, f, x, 1)
        equal(f"mont_inv (24, {n}) one lane against two", one_lane, raw_inv(this_lib, True, f, x, 2))
        reps = 3 if n > 1 << 16 else 20
        t = {1: [], 2: []}
        for lanes in (2, 1, 1, 2):
            t[lanes].append(events_ms(lambda: raw_inv(this_lib, True, f, x, lanes), reps))
        traced = {lanes: cs.traced_device_ms(torch, "mont_inv", lambda: raw_inv(this_lib, True, f, x, lanes),
                                             reps, dev)[0] for lanes in (1, 2)}
        emit("lanes", shape=[L, n], two_lanes_ms=t[2], one_lane_ms=t[1],
             two_lanes_device_ms_traced=traced[2], one_lane_device_ms_traced=traced[1],
             auto=1 if n >= km.GCD_WIDE else 2)

    # -- mont_mul: launch against body --------------------------------------------------
    for log_n in (0, 16):
        n = 1 << log_n
        a, b = rand_field(f, n, gen), rand_field(f, n, gen)
        d_ms, _ = cs.traced_device_ms(torch, "mont_mul", lambda: km.mont_mul(f, a, b), 20, dev)
        emit("mont_mul", shape=[L, n], wrapper_ms=wall_ms(lambda: km.mont_mul(f, a, b), 20),
             events_ms=events_ms(lambda: km.mont_mul(f, a, b), 20), device_ms_traced=d_ms)

    # -- to-affine: one mont_div launch against the batch-inverse route ---------------
    G1 = B.G1

    def batch_route(P):
        return (fp.mont_mul(f, P.x, fp.batch_inv(f, P.zz)), fp.mont_mul(f, P.y, fp.batch_inv(f, P.zzz)))

    def counted(fn):
        sync()
        kernels.reset_launches()
        out = fn()
        sync()
        return out, {k: v for k, v in kernels.LAUNCHES.items() if v}

    for log_n in (0, 16, 20):
        n = 1 << log_n
        P = tsw.XYZZPoints(*(rand_field(f, n, gen) for _ in range(4)))
        P.zz[:, ::64] = 0
        P.zzz[:, ::64] = 0
        got, l_div = counted(lambda: tsw.xyzz_to_affine(G1, P))
        (bx, by), l_batch = counted(lambda: batch_route(P))
        equal(f"to-affine at {n} points: x", got.x, bx)
        equal(f"to-affine at {n} points: y", got.y, by)
        if n <= 1 << 16:
            equal(f"mont_div at {n} points", km.mont_div(f, P.x, P.zz, P.y, P.zzz),
                  km.mont_div_plain(f, P.x, P.zz, P.y, P.zzz))
        t = {"mont_div": [], "batch_inv route": []}
        w = {"mont_div": [], "batch_inv route": []}
        reps = 20 if n == 1 else 3
        for side in ("mont_div", "batch_inv route", "batch_inv route", "mont_div"):
            fn = (lambda: tsw.xyzz_to_affine(G1, P)) if side == "mont_div" else (lambda: batch_route(P))
            t[side].append(events_ms(fn, reps))
            w[side].append(wall_ms(fn))
        d_ms, _ = cs.traced_device_ms(torch, "mont_div", lambda: tsw.xyzz_to_affine(G1, P),
                                      20 if n == 1 else 3, dev)
        emit("to_affine", points=n, infinity_every=64, launches_mont_div=l_div,
             launches_batch_route=l_batch, events_ms=t, wall_ms=w, mont_div_device_ms_traced=d_ms)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
