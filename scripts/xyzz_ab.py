#!/usr/bin/env python3
"""Time two builds of the element-wise XYZZ kernels on the same feeds, on one
NVIDIA GPU: this tree's csrc/madd.cu and csrc/xyzz.cu against another
checkout's (e.g. the parent commit unpacked with git archive), and other
versions of either source (a directory holding field.cuh and the source).

    python3 scripts/xyzz_ab.py OTHER_CHECKOUT [--madd LABEL=CSRC_DIR ...]
                                              [--xyzz LABEL=CSRC_DIR ...]

Each build is compiled with nvcc into its own library and called through
ctypes on the same device tensors (the C entries zk_xyzz_add_affine and
zk_xyzz_add take the same arguments in both trees). Every result is held
bit for bit against this tree's plain version. Feeds, all BLS12-381 Fq:
- xyzz_add_affine on 2^20 generic pairs (random finite P and A) and on
  chip_smoke.py phase 7's edge-class feed of 2^20 points;
- xyzz_add on the MSM reduce's first two tree levels, (L, 4, 20, 2048) and
  (L, 4, 20, 1024), whose inputs are the last-axis halves of one tensor,
  and on (L, 20), a bit-Horner add;
- xyzz_tree_sum, where a build has it, on (L, 4, 20, 1024) and
  (L, 13, 20, 1024) random points, and with --path on the MSM's own tree
  inputs: those of this tree's msm at 2^20 (BLS12-381 G1, c = 13: one
  (L, 13, 20, 1024) launch) and of a secp256r1 msm at 2^16 (PlainCallOps,
  p >= R/2), recorded by chip_smoke.install_msm_recorders, each with its
  operation bound counted lane by lane as chip_smoke.py does;
- pow_table (csrc/twiddle.cu, NW = 8, 10, 12) at the argument sets of a
  2^24 BLS12-381 Fr fft's three tables and at 2^16 entries: CUDA events
  over 20 launches through the C entry, and the device time per launch
  from a trace of 20 launches (chip_smoke.traced_device_ms).
Times are CUDA events over 20 launches, in turns (this tree, other, other,
this tree), with each bound as chip_smoke.py counts it. Prints one JSON
line per measurement, and writes them all to --out as one JSON file when
given. The libraries go to zkarray_torch/kernels/build/ab/.
"""

import argparse
import ctypes
import functools
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from zkarray_torch.kernels import _build  # noqa: E402


def build(label, csrc, source, out_dir):
    """Start nvcc on csrc/<source>.cu; returns (library path, process)."""
    lib = out_dir / f"{label}_{source}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.source_of(source)[1], "-o", str(lib),
           str(csrc / f"{source}.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def tree_ops(curve, P, ops_of):
    """32-bit operations of xyzz_tree_sum on these rows, lane class by lane
    class level by level (chip_smoke.py's count): none on a lane at
    infinity, the generic add, or finding P == +-Q and then the doubling."""
    import torch

    from zkarray_torch.ff import fp
    from zkarray_torch.kernels import mont as km
    from zkarray_torch.kernels import sw as ksw

    f = curve.base
    ops, m = 0, P[0].shape[-1]
    while m > 1:
        h = m // 2
        lo, hi = tuple(v[..., :h] for v in P), tuple(v[..., h : 2 * h] for v in P)
        fin = ~fp.is_zero(f, lo[2]) & ~fp.is_zero(f, hi[2])
        p0 = fp.eq(km.mont_mul(f, lo[0], hi[2]), km.mont_mul(f, hi[0], lo[2]))
        r0 = fp.eq(km.mont_mul(f, lo[1], hi[3]), km.mont_mul(f, hi[1], lo[3]))
        dbl = fin & p0 & r0 & ~fp.is_zero(f, lo[1])
        ops += (int((fin & ~p0).sum()) * ops_of("add") + int((fin & p0).sum()) * ops_of("find")
                + int(dbl.sum()) * ops_of("dbl"))
        red = ksw._fadd_plain(curve, lo, hi)
        if m % 2:
            red = tuple(torch.cat([a, v[..., 2 * h :]], dim=-1) for a, v in zip(red, P))
        m -= h
        P = red
    return ops


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="checkout whose zkarray_torch/kernels/csrc is compared")
    ap.add_argument("--madd", action="append", default=[], help="LABEL=CSRC_DIR")
    ap.add_argument("--xyzz", action="append", default=[], help="LABEL=CSRC_DIR")
    ap.add_argument("--path", action="store_true",
                    help="also time xyzz_tree_sum on the MSM's own tree inputs")
    ap.add_argument("--out", help="JSON file for all rows")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("xyzz_ab: no CUDA device", file=sys.stderr)
        return 1
    from zkarray_torch.curves import bls12_381 as B
    from zkarray_torch.ff import fp
    from zkarray_torch.kernels import mont as km
    from zkarray_torch.kernels import sw as ksw

    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    here = ROOT / "zkarray_torch" / "kernels" / "csrc"
    other = Path(args.other).resolve() / "zkarray_torch" / "kernels" / "csrc"
    # (label, source) -> csrc directory
    builds = {(label, source): csrc for label, csrc in (("this tree", here), ("other", other))
              for source in ("madd", "xyzz", "twiddle")}
    for source, specs in (("madd", args.madd), ("xyzz", args.xyzz)):
        for spec in specs:
            label, csrc = spec.split("=", 1)
            builds[(label, source)] = Path(csrc).resolve()
    procs = {(label, source): build(label.replace(" ", "_"), csrc, source, out_dir)
             for (label, source), csrc in builds.items()}
    if args.path:  # the msm's own libraries, built beside the A/B builds
        _build.build(("mont", "sw", "xyzz", "madd"))
    libs, results = {}, []
    for (label, source), (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label} {source}.cu:\n{log}")
        lib = ctypes.CDLL(str(path))
        if source == "madd":
            lib.zk_xyzz_add_affine.argtypes = [ctypes.c_void_p] * 11 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        elif source == "twiddle":
            lib.zk_pow_table.argtypes = _build.EXPORTS["twiddle"]["zk_pow_table"]
        else:
            lib.zk_xyzz_add.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            if hasattr(lib, "zk_xyzz_tree_sum"):
                lib.zk_xyzz_tree_sum.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                                 ctypes.c_void_p]
        libs[(label, source)] = lib
        results.append(dict(build=label, source=source, ptxas=cs.parse_ptxas(log)))
        print(json.dumps(results[-1]), flush=True)

    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    clock_mhz = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    int_ops_per_s = props.multi_processor_count * cs.INT32_LANES_PER_SM * clock_mhz * 1e6
    G1, f = B.G1, B.FQ
    L = f.num_limbs
    n = 1 << 20
    words = ksw._curve_words(G1)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(77)
    mul_ops, add_ops = 4 * (L // 2) ** 2 + 3 * (L // 2), 3 * (L // 2)

    def rand_field(m):
        x = torch.randint(0, 1 << 16, (L, m), generator=gen, device=dev, dtype=torch.int32)
        x[L - 1] = torch.randint(0, f.modulus >> (16 * (L - 1)), (m,), generator=gen, device=dev,
                                 dtype=torch.int32)
        return x

    def bound(nbytes, ops):
        tb, to = nbytes / cs.HBM_BYTES_PER_S * 1e3, ops / int_ops_per_s * 1e3
        return max(tb, to), "bytes" if tb >= to else "operations"

    def timed(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def compare(kernel, feed, labels, run, want, b_ms, b_by, **extra):
        """run(label) -> output tensors; each build checked, then timed in turns."""
        for label in labels:
            got = run(label)
            torch.cuda.synchronize()
            if any(not torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{kernel} {feed}: build {label!r} differs from the plain version")
        ms = {label: [] for label in labels}
        order = labels + labels[::-1]
        for label in order:
            ms[label].append(timed(lambda: run(label)))
        for label in labels:
            row = dict(kernel=kernel, feed=feed, build=label, max_abs_err=0, ms_runs=ms[label],
                       ms=min(ms[label]), bound_ms=b_ms, bound_by=b_by,
                       share_of_bound=b_ms / min(ms[label]), card=card, **extra)
            results.append(row)
            print(json.dumps(row), flush=True)

    # ---- xyzz_add_affine: generic and edge feeds --------------------------
    madd_labels = [label for label, source in builds if source == "madd"]
    xyzz_labels = [label for label, source in builds if source == "xyzz"]
    one = fp.one(f, (n,), dev).contiguous()
    zero = fp.zero(f, (n,), dev)
    for feed in ("generic", "edge classes"):
        X, Y, ZZ, ZZZ, AX, AY = (rand_field(n) for _ in range(6))
        a_inf = torch.zeros(n, dtype=torch.bool, device=dev)
        ops = n * (10 * mul_ops + 7 * add_ops)
        if feed == "edge classes":  # chip_smoke.py phase 7's classes, i % 7
            cls = torch.arange(n, device=dev) % 7

            def on(c):
                return torch.isin(cls, torch.tensor(c, device=dev))

            AY = torch.where(on([6])[None], zero, AY)
            same = on([1, 2, 6])[None]
            X = torch.where(same, AX, X)
            Y = torch.where(on([1, 6])[None], AY, torch.where(on([2])[None], fp.neg(f, AY), Y))
            ZZ, ZZZ = torch.where(same, one, ZZ), torch.where(same, one, ZZZ)
            p_inf = on([3, 5])[None]
            X, Y = torch.where(p_inf, one, X), torch.where(p_inf, one, Y)
            ZZ, ZZZ = torch.where(p_inf, zero, ZZ), torch.where(p_inf, zero, ZZZ)
            a_inf = on([4, 5])
            n_of = lambda cs_: int(on(cs_).sum())  # noqa: E731
            ops = (n_of([0]) * (10 * mul_ops + 7 * add_ops) + n_of([1]) * (8 * mul_ops + 9 * add_ops)
                   + n_of([2, 6]) * (2 * mul_ops + 2 * add_ops))
        ins = [t.contiguous() for t in (X, Y, ZZ, ZZZ, AX, AY)]
        inf8 = a_inf.contiguous()
        want = ksw.xyzz_add_affine_plain(G1, ins[:4], ins[4], ins[5], a_inf)
        outs = [torch.empty_like(ins[0]) for _ in range(4)]

        def run(label):
            lib = libs[(label, "madd")]
            err = lib.zk_xyzz_add_affine(*(t.data_ptr() for t in ins), inf8.data_ptr(),
                                         *(t.data_ptr() for t in outs), n, L // 2,
                                         km.words_ptr(words), stream)
            if err:
                raise RuntimeError(f"xyzz_add_affine {label}: CUDA error {err}")
            return outs

        b_ms, b_by = bound((10 * L * 4 + 1) * n, ops)
        compare("xyzz_add_affine", feed, madd_labels, run, want, b_ms, b_by, n=n)
        del X, Y, ZZ, ZZZ, AX, AY, ins, outs, want

    # ---- xyzz_add: the reduce's widest tree levels and a bit-Horner add ----
    for batch in ((4, 20, 2048), (4, 20, 1024), (20,)):
        m = 1
        for d in batch:
            m *= d
        if len(batch) > 1:  # the halves of one (L, *batch[:-1], 2 h) tensor
            wide = [rand_field(2 * m).reshape((L,) + batch[:-1] + (2 * batch[-1],)) for _ in range(4)]
            P = [v[..., : batch[-1]] for v in wide]
            Q = [v[..., batch[-1]:] for v in wide]
        else:
            P = [rand_field(m) for _ in range(4)]
            Q = [rand_field(m) for _ in range(4)]
        opl = [km._operand(t) for t in P + Q]
        desc = km.operand_words(opl)
        out = torch.empty((4, L) + batch, dtype=torch.int32, device=dev)
        want = ksw._fadd_plain(G1, tuple(P), tuple(Q))

        def run(label):
            lib = libs[(label, "xyzz")]
            err = lib.zk_xyzz_add(km.words_ptr(desc), out.data_ptr(), m, L // 2, km.words_ptr(words),
                                  stream)
            if err:
                raise RuntimeError(f"xyzz_add {label}: CUDA error {err}")
            return out.unbind(0)

        b_ms, b_by = bound(12 * L * m * 4, m * (14 * mul_ops + 7 * add_ops))
        compare("xyzz_add", f"random, batch {batch}", xyzz_labels, run, want, b_ms, b_by, n=m)
        del P, Q, out, want

    # ---- xyzz_tree_sum: one launch per (bit, window) row of 1,024 points ----
    tree_labels = [lb for lb in xyzz_labels if hasattr(libs[(lb, "xyzz")], "zk_xyzz_tree_sum")]

    def tree_feed(curve, P, feed, ops):
        Lc = curve.base.num_limbs
        m = P[0].shape[-1]
        rows = P[0][0].numel() // m
        opl = [km._operand(t) for t in P]
        desc = km.operand_words(opl)
        out = torch.empty((4, Lc) + tuple(P[0].shape[1:-1]) + (1,), dtype=torch.int32, device=dev)
        want = [v for v in ksw.xyzz_tree_sum_plain(curve, P)]
        cwords = ksw._curve_words(curve)

        def run_tree(label):
            lib = libs[(label, "xyzz")]
            err = lib.zk_xyzz_tree_sum(km.words_ptr(desc), out.data_ptr(), rows, m, Lc // 2,
                                       km.words_ptr(cwords), stream)
            if err:
                raise RuntimeError(f"xyzz_tree_sum {label}: CUDA error {err}")
            return out.unbind(0)

        b_ms, b_by = bound(4 * Lc * rows * (m + 1) * 4, ops)
        compare("xyzz_tree_sum", feed, tree_labels, run_tree, want, b_ms, b_by, n=rows * m,
                shape=list(P[0].shape))

    for batch in ((4, 20), (13, 20)):
        rows, m = batch[0] * batch[1], 1024
        P = [rand_field(rows * m).reshape((L,) + batch + (m,)) for _ in range(4)]
        tree_feed(G1, P, f"random, {rows} rows of {m}",
                  rows * (m - 1) * (14 * mul_ops + 7 * add_ops))
        del P
    if args.path:
        from zkarray_torch import testing as tt
        from zkarray_torch.curves import zoo
        from zkarray_torch.ec import msm as tmsm
        from zkarray_torch.interop import affine_from_numpy, limbs_from_numpy

        for curve, log_n in ((G1, 20), (zoo.SECP256R1, 16)):
            px, py, sc, kb, bits = tt.tiled_inputs(curve, 1 << log_n, np.random.default_rng(0))
            A = affine_from_numpy(px, py, np.zeros(1 << log_n, dtype=bool), dev)
            rec = types.SimpleNamespace(on=True)
            restore = cs.install_msm_recorders(torch, rec)
            try:
                tmsm.msm(curve, A, limbs_from_numpy(sc, dev), max_scalar_bits=bits)
                trees = [ins for kernel, ins, _ in rec.msm if kernel == "xyzz_tree_sum"]
            finally:
                restore()
            Lc = curve.base.num_limbs
            nw_ = Lc // 2
            ops_of = functools.partial(cs.xyzz_ops, 4 * nw_ ** 2 + 3 * nw_, 3 * nw_ ** 2 + 4 * nw_,
                                       3 * nw_, a_is_zero=curve.a_is_zero)
            for P in trees:
                ops = tree_ops(curve, P, ops_of)
                tree_feed(curve, P, f"the msm's own tree input, {curve.name} 2^{log_n}", ops)
            del A, trees

    # ---- pow_table: the 2^24 fft's three tables and a 2^16-entry one --------
    pow_labels = [label for label, source in builds if source == "twiddle"]
    FR = B.FR
    Lr = FR.num_limbs
    n1 = 1 << 12
    w = FR.root_of_unity(1 << 24)
    w1 = pow(w, n1, FR.modulus)
    for wi, n_t, packed, scale, what in (
            (w1, n1 // 2, False, None, "fft 2^24: tw1 (planar)"),
            (w, n1, True, None, "fft 2^24: twiddle lo (packed)"),
            (pow(w, n1, FR.modulus), n1, True, None, "fft 2^24: twiddle hi (packed)"),
            (w, n1, True, pow(1 << 24, -1, FR.modulus), "ifft 2^24: twiddle lo, n^-1 folded"),
            (FR.root_of_unity(1 << 17), 1 << 16, False, None, "2^16 entries (planar)")):
        pw, nbits = km._pow_words(FR, wi, n_t, scale)
        out = torch.empty((n_t, Lr // 2) if packed else (Lr, n_t), dtype=torch.int32, device=dev)
        want = [km.pow_table_plain(FR, wi, n_t, dev, scale, packed)]
        fwords = km.field_words(FR)

        def run_pow(label):
            err = libs[(label, "twiddle")].zk_pow_table(
                out.data_ptr(), n_t, int(packed), km.words_ptr(pw), nbits, Lr // 2,
                km.words_ptr(fwords), stream)
            if err:
                raise RuntimeError(f"pow_table {label}: CUDA error {err}")
            return [out]

        traced = {label: cs.traced_device_ms(torch, "pow_table", lambda: run_pow(label), 20, dev)[0]
                  for label in pow_labels}
        b_ms, b_by = bound(n_t * Lr * (2 if packed else 4),
                           max(n_t - 1, 0) * (4 * (Lr // 2) ** 2 + 3 * (Lr // 2)))
        compare("pow_table", what, pow_labels, run_pow, want, b_ms, b_by, n=n_t,
                device_ms_traced=traced)

    if args.out:
        Path(args.out).write_text(json.dumps(
            dict(card=card, at=time.strftime("%Y-%m-%dT%H:%M:%S"), rows=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
