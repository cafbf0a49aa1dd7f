#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (zkarray_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each printing one JSON line and raising on any failure:

1. header: the card (nvidia-smi name and power limit), torch and CUDA
   versions; the nvcc build of every kernel source, started in parallel,
   with its time and each kernel's registers and spills (-Xptxas -v).
2. kernel vs plain: each CUDA kernel against its plain PyTorch version on
   the same device inputs, bit for bit (tolerance zero), with both times:
   mont_mul and mont_sqr on 2^20 Fq and Fr elements; xyzz_accum through both
   wrappers on an edge-class feed (16384 slots x 32 rounds) and at the main
   path's band-1 shape; horner_windows at W = 20, c = 13.
3. main path: BLS12-381 G1 msm at n = 2^20, 254-bit scalars, c = 13, on
   tiled inputs with a host known answer; launch counts from one run, with
   the shape of every mont_mul/mont_sqr launch recorded. Then mont_mul and
   mont_sqr against their plain versions at each of those shapes, the inputs
   non-contiguous halves of a wider tensor as the tree sums slice them, with
   both times; the median of 3 timed runs split into accumulate, reduce and
   to-affine; and one msm_reduce under torch.profiler (CUDA activity only)
   for the device's busy time, idle share and host time per device op.
4. ChunkedMSM at 2^21 as two 2^20 chunks, known-answer checked.
5. the kernels line: per kernel its launches in phase 3, error against the
   plain version, times and bound. For mont_mul and mont_sqr the times and
   bound are means per launch over phase 3's launches, shape by shape.

The last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
before printing any result.
"""

import collections
import json
import math
import os
import platform
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM = 64  # 32-bit integer multiply-add per SM per clock, compute capability 9.0
DEVICE = "cuda"
LOG_N = 20  # main-path MSM size; ChunkedMSM runs two chunks of this size
EDGE_SLOTS, EDGE_ROUNDS = 16384, 32


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi(fields):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def host_cpu_model():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return None


def union_ns(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def parse_ptxas(log):
    """{kernel function: {"registers": n, "spill_stores": b, "spill_loads": b}}."""
    out = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from zkarray_torch import kernels
    from zkarray_torch.core.limbs import pack_pairs
    from zkarray_torch.curves import bls12_381 as B
    from zkarray_torch.ec import msm as tmsm
    from zkarray_torch.ec import sw as tsw
    from zkarray_torch.ff import fp
    from zkarray_torch.interop import affine_from_numpy, limbs_from_numpy
    from zkarray_torch.kernels import _build
    from zkarray_torch.kernels import mont as km
    from zkarray_torch.kernels import sw as ksw
    from zkarray_torch.testing import expected_msm, tiled_inputs

    dev = torch.device(DEVICE)
    G1 = B.G1
    FQ, FR = B.FQ, B.FR
    gen = torch.Generator(device=dev).manual_seed(1234)

    # ---- 1. header and build ----------------------------------------------
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    int_ops_per_s = props.multi_processor_count * INT32_LANES_PER_SM * clock_mhz * 1e6
    emit("header", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         sms=props.multi_processor_count, max_sm_clock_mhz=clock_mhz,
         int32_ops_per_s=int_ops_per_s, hbm_bytes_per_s=HBM_BYTES_PER_S,
         host_cpu=host_cpu_model(), host_arch=platform.machine(),
         host_cpus_usable=len(os.sched_getaffinity(0)))
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name in _build.SOURCES:
        log_path = _build.lib_path(name).with_suffix(".ptxas.txt")
        ptxas.update(parse_ptxas(log_path.read_text()))
    emit("build", seconds=build_s, per_source={k: v["seconds"] for k, v in built.items()},
         ptxas=ptxas)

    # ---- helpers -------------------------------------------------------------
    def sync():
        torch.cuda.synchronize()

    def time_ms(fn, iters):
        fn()
        sync()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / iters

    def once_ms(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t) * 1e3

    def rand_field(spec, n):
        """(L, n) canonical limbs below p (top limb below p's top limb)."""
        L = spec.num_limbs
        x = torch.randint(0, 1 << 16, (L, n), generator=gen, device=dev, dtype=torch.int32)
        top = spec.modulus >> (16 * (L - 1))
        x[L - 1] = torch.randint(0, top, (n,), generator=gen, device=dev, dtype=torch.int32)
        return x

    def max_abs_err(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    def check_equal(what, got, want):
        err = max_abs_err(got, want)
        if err != 0 or got.shape != want.shape:
            raise AssertionError(f"{what}: kernel differs from plain (max abs err {err})")
        return err

    def nw(spec):
        return spec.num_limbs // 2

    def mul_ops(spec):  # 32-bit ops of one CIOS product: 2 NW^2 + 2 NW^2 + NW, cond-sub 2 NW
        return 4 * nw(spec) ** 2 + 3 * nw(spec)

    def add_ops(spec):  # carry chain + conditional subtract/add
        return 3 * nw(spec)

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / int_ops_per_s * 1e3
        return (max(tb, to), "bytes" if tb >= to else "operations")

    report = {}

    # ---- 2. kernel vs plain --------------------------------------------------
    n = 1 << LOG_N
    for spec in (FQ, FR):
        L = spec.num_limbs
        a, b = rand_field(spec, n), rand_field(spec, n)
        for name, kern, plain, args, n_in in (
            ("mont_mul", km.mont_mul, km.mont_mul_plain, (a, b), 2),
            ("mont_sqr", km.mont_sqr, km.mont_sqr_plain, (a,), 1),
        ):
            got = kern(spec, *args)
            want = plain(spec, *args)
            err = check_equal(f"{name} {spec.name}", got, want)
            ms = time_ms(lambda: kern(spec, *args), 20)
            plain_ms = time_ms(lambda: plain(spec, *args), 2)
            b_ms, b_by = bound((n_in + 1) * L * n * 4, n * mul_ops(spec))
            emit("kernel", kernel=name, field=spec.name, n=n, max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            if spec is FQ:
                report[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, shape=f"Fq, {n} elements")
        del a, b

    # xyzz_accum on an edge-class feed: random field elements (the formulas
    # need no curve membership to be compared), with per-slot classes
    f = FQ
    L = f.num_limbs
    S, R = EDGE_SLOTS, EDGE_ROUNDS
    one = fp.one(f, (S,), dev).contiguous()
    zero = fp.zero(f, (S,), dev)
    AX = [rand_field(f, S) for _ in range(R)]
    AY = [rand_field(f, S) for _ in range(R)]
    X, Y, ZZ, ZZZ = (rand_field(f, S) for _ in range(4))
    cls = torch.arange(S, device=dev) % 9
    valid = (torch.rand((R, S), generator=gen, device=dev) < 0.75).to(torch.int32)
    sign = torch.randint(0, 2, (R, S), generator=gen, device=dev, dtype=torch.int32)

    def on(c):
        return torch.isin(cls, torch.tensor(c, device=dev))[None]

    AY[0] = torch.where(on([8]), zero, AY[0])  # doubling a y == 0 point
    same = on([1, 2, 8])  # P == A (sign 0) or P == -A (sign 1) in round 0
    X = torch.where(same, AX[0], X)
    Y = torch.where(same, AY[0], Y)
    ZZ = torch.where(same, one, ZZ)
    ZZZ = torch.where(same, one, ZZZ)
    p_inf = on([3, 5])  # bucket at infinity
    X, Y = torch.where(p_inf, one, X), torch.where(p_inf, one, Y)
    ZZ, ZZZ = torch.where(p_inf, zero, ZZ), torch.where(p_inf, zero, ZZZ)
    valid[0] = torch.where(on([4, 5])[0], 0, 1)  # A at infinity in round 0
    sign[0] = torch.where(on([2, 6])[0], 1, torch.where(on([1, 8])[0], 0, sign[0]))
    valid[:, cls == 7] = 0  # a slot with no point in any round
    state = torch.cat([pack_pairs(v) for v in (X, Y, ZZ, ZZZ)]).contiguous()
    coords = torch.stack([pack_pairs(torch.cat([x, y])) for x, y in zip(AX, AY)], dim=1).contiguous()
    vwords = (valid | (sign << 1)).contiguous()
    want = ksw.xyzz_accum_plain(G1, state, coords, vwords)
    edge_err = 0
    for wrapper in (ksw.xyzz_accum_grid, ksw.xyzz_accum_tiles):
        edge_err = max(edge_err, check_equal(f"xyzz_accum edges via {wrapper.__name__}",
                                             wrapper(G1, state, coords, vwords), want))
    emit("kernel", kernel="xyzz_accum", feed="edge classes", slots=S, rounds=R,
         max_abs_err=edge_err)
    del AX, AY, coords, want

    # xyzz_accum at the main path's band-1 shape (c = 13 at 2^20 points)
    cw = tmsm.default_window_size(n)
    Wb, halfb, _, _ = tmsm._window_geometry(cw, 16 * FR.num_limbs - 2)
    R1, _ = tmsm._accum_bounds(cw, n, tmsm.ACCUM_T)
    S1 = Wb * halfb
    state = torch.cat([pack_pairs(rand_field(f, S1)) for _ in range(4)]).contiguous()
    coords = torch.cat([pack_pairs(rand_field(f, R1 * S1)) for _ in range(2)]).reshape(L, R1, S1)
    valid = (torch.rand((R1, S1), generator=gen, device=dev) < 0.9).to(torch.int32)
    vwords = (valid | (torch.randint(0, 2, (R1, S1), generator=gen, device=dev,
                                     dtype=torch.int32) << 1)).contiguous()
    n_adds = int(valid.sum())
    got = ksw.xyzz_accum_grid(G1, state, coords, vwords)
    ms = time_ms(lambda: ksw.xyzz_accum_grid(G1, state, coords, vwords), 3)
    want, plain_ms = once_ms(lambda: ksw.xyzz_accum_plain(G1, state, coords, vwords))
    err = max(edge_err, check_equal("xyzz_accum band-1 shape", got, want))
    madd_ops = 10 * mul_ops(f) + 7 * add_ops(f)
    b_ms, b_by = bound((coords.numel() + vwords.numel() + 2 * state.numel()) * 4,
                       n_adds * madd_ops)
    emit("kernel", kernel="xyzz_accum", feed="band-1 shape", slots=S1, rounds=R1,
         valid_adds=n_adds, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
         bound_by=b_by, ns_per_add=ms * 1e6 / n_adds)
    report["xyzz_accum"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, shape=f"{S1} slots x {R1} rounds")
    del state, coords, valid, vwords, got, want

    # horner_windows at W = 20, c = 13; window 5 at infinity
    Wh, ch = 20, 13
    win = torch.cat([rand_field(f, Wh) for _ in range(4)]).T.contiguous()  # (W, 4L)
    win[5, 2 * L :] = 0
    got = ksw.horner_windows(G1, win, ch)
    ms = time_ms(lambda: ksw.horner_windows(G1, win, ch), 3)
    want, plain_ms = once_ms(lambda: ksw.horner_windows_plain(G1, win, ch))
    err = check_equal("horner_windows", got, want)
    dbl_ops = 9 * mul_ops(f) + 6 * add_ops(f)
    fadd_ops = 14 * mul_ops(f) + 7 * add_ops(f) + dbl_ops
    b_ms, b_by = bound((win.numel() + got.numel()) * 4, (Wh - 1) * (ch * dbl_ops + fadd_ops))
    emit("kernel", kernel="horner_windows", W=Wh, c=ch, max_abs_err=err, ms=ms,
         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    report["horner_windows"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, shape=f"W={Wh}, c={ch}")

    # ---- 3. main path: msm at 2^20 --------------------------------------------
    rng = np.random.default_rng(0)
    px, py, sc, ks, bits = tiled_inputs(G1, n, rng)
    want_pt = expected_msm(G1, ks, sc)
    A = affine_from_numpy(px, py, np.zeros(n, dtype=bool), dev)
    s = limbs_from_numpy(sc, dev)
    c = tmsm.default_window_size(n)

    def to_affine(res):
        return tsw.xyzz_to_affine(G1, tsw.XYZZPoints(*(v[:, None] for v in res)))

    # every mont_mul/mont_sqr launch's (kernel, field, shape), recorded
    # around the wrappers' own launch function; the counts stay where they are
    mont_shapes = collections.Counter()
    launch = km._launch

    def recording_launch(entry, kernel, spec, *ins):
        mont_shapes[(kernel, spec.name, tuple(ins[0].shape))] += 1
        return launch(entry, kernel, spec, *ins)

    torch.cuda.reset_peak_memory_stats()
    sync()
    km._launch = recording_launch
    try:
        kernels.reset_launches()
        aff = to_affine(tmsm.msm(G1, A, s, c, bits))
        sync()
        launches = dict(kernels.LAUNCHES)
    finally:
        km._launch = launch
    got_pt = tsw.affine_to_ints(G1, aff)[0]
    if got_pt != want_pt:
        raise AssertionError("msm 2^20: result differs from the host known answer")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"msm 2^20: kernels never launched: {missing}")
    for name in ("mont_mul", "mont_sqr"):
        recorded = sum(v for (k, _, _), v in mont_shapes.items() if k == name)
        if recorded != launches[name]:
            raise AssertionError(f"{name}: {recorded} launches recorded, {launches[name]} counted")

    # mont_mul / mont_sqr against their plain versions at every main-path
    # shape, inputs the two halves of a tensor twice as wide in its last axis
    # (non-contiguous, as _tree_sum_last's lo/hi slices)
    specs = {FQ.name: FQ, FR.name: FR}
    kerns = {"mont_mul": (km.mont_mul, km.mont_mul_plain, 2),
             "mont_sqr": (km.mont_sqr, km.mont_sqr_plain, 1)}
    at_shape = {"mont_mul": [], "mont_sqr": []}
    for (name, fname, shape), count in sorted(mont_shapes.items(), key=lambda kv: -math.prod(kv[0][2])):
        spec = specs[fname]
        kern, plain, n_in = kerns[name]
        L, batch = shape[0], shape[1:]
        m = math.prod(batch)
        wide = rand_field(spec, 2 * m).reshape((L,) + batch[:-1] + (2 * batch[-1],))
        halves = (wide[..., : batch[-1]], wide[..., batch[-1] :])[:n_in]
        got = kern(spec, *halves)
        err = check_equal(f"{name} {fname} at {shape}", got, plain(spec, *halves))
        ms = time_ms(lambda: kern(spec, *halves), 20)
        plain_ms = time_ms(lambda: plain(spec, *halves), 2)
        tb, to = ((n_in + 1) * L * m * 4 / HBM_BYTES_PER_S * 1e3, m * mul_ops(spec) / int_ops_per_s * 1e3)
        at_shape[name].append(dict(field=fname, shape=list(shape), launches=count, max_abs_err=err,
                                   ms=ms, plain_ms=plain_ms, bound_bytes_ms=tb, bound_ops_ms=to))
    for name, rows in at_shape.items():
        emit("kernel_main_path_shapes", kernel=name, inputs="non-contiguous halves", rows=rows)
        n_l = sum(r["launches"] for r in rows)
        tb = sum(r["launches"] * r["bound_bytes_ms"] for r in rows)
        to = sum(r["launches"] * r["bound_ops_ms"] for r in rows)
        widest = rows[0]
        report[name].update(
            ms_2e20=report[name]["ms"],
            max_abs_err=max([report[name]["max_abs_err"]] + [r["max_abs_err"] for r in rows]),
            ms=sum(r["launches"] * r["ms"] for r in rows) / n_l,
            plain_ms=sum(r["launches"] * r["plain_ms"] for r in rows) / n_l,
            bound_ms=max(tb, to) / n_l, bound_by="bytes" if tb >= to else "operations",
            ms_main_path_total=sum(r["launches"] * r["ms"] for r in rows),
            ms_widest=widest["ms"], widest_shape=widest["shape"],
            shape=f"mean per launch over the main path's {len(rows)} shapes",
        )

    W, half, _, _ = tmsm._window_geometry(c, bits)
    splits = []
    for _ in range(3):
        st0 = tsw.xyzz_zero(G1, (W, half), dev)
        st, t_acc = once_ms(lambda: tmsm.msm_accumulate(G1, A, s, c, bits, st0))
        res, t_red = once_ms(lambda: tmsm.msm_reduce(G1, st, c, bits))
        aff, t_aff = once_ms(lambda: to_affine(res))
        if tsw.affine_to_ints(G1, aff)[0] != want_pt:
            raise AssertionError("msm 2^20: timed run differs from the known answer")
        splits.append((t_acc + t_red + t_aff, t_acc, t_red, t_aff))
    total, t_acc, t_red, t_aff = sorted(splits)[1]
    emit("msm", n=n, c=c, scalar_bits=bits, correct=True, launches=launches,
         ms_total=total, ms_accumulate=t_acc, ms_reduce=t_red, ms_to_affine=t_aff,
         ms_total_runs=[sp[0] for sp in splits], ms_reduce_runs=[sp[2] for sp in splits],
         pts_per_s=n / (total / 1e3), peak_mem_bytes=torch.cuda.max_memory_allocated(),
         card=card)

    # one msm_reduce under torch.profiler, CUDA activity only (kernels,
    # copies and the runtime calls that launch them): how much of the
    # reduce's wall time the device is busy, and on what. The untraced
    # idle share is an estimate: device time under the trace over the
    # untraced median wall time.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, supported_activities

    if ProfilerActivity.CUDA not in supported_activities():
        emit("reduce_trace", note="this torch build's profiler cannot trace CUDA activity")
    else:
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res2, t_traced = once_ms(lambda: tmsm.msm_reduce(G1, st, c, bits))
        if any(not torch.equal(a, b) for a, b in zip(res2, res)):
            raise AssertionError("msm_reduce under the profiler differs from the untraced run")
        evs = prof.profiler.kineto_results.events()
        dev_iv = [(e.start_ns(), e.end_ns(), e.name()) for e in evs
                  if e.device_type() == DeviceType.CUDA]
        api = collections.Counter(e.name() for e in evs if e.device_type() == DeviceType.CPU)
        by_name = collections.defaultdict(lambda: [0, 0])  # name -> [ops, device ns]
        for a, b, nm in dev_iv:
            by_name[nm][0] += 1
            by_name[nm][1] += b - a
        ours = {}
        for k in kernels.LAUNCHES:
            hits = [v for nm, v in by_name.items() if f"{k}_kernel" in nm]
            if hits:
                n_k, ns_k = sum(h[0] for h in hits), sum(h[1] for h in hits)
                ours[k] = dict(launches=n_k, device_ms=ns_k / 1e6, device_ms_per_launch=ns_k / 1e6 / n_k)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        busy_ms = union_ns([(a, b) for a, b, _ in dev_iv]) / 1e6
        emit("reduce_trace", ms_wall_traced=t_traced, ms_reduce_untraced_median=t_red,
             device_ops=len(dev_iv), port_kernels=ours,
             top_device_ms=[dict(name=nm[:90], ops=v[0], device_ms=v[1] / 1e6) for nm, v in top],
             runtime_calls=dict(api.most_common(6)), ms_device_busy=busy_ms if dev_iv else None,
             device_idle_share=1 - busy_ms / t_traced if dev_iv else None,
             device_idle_share_untraced_est=1 - busy_ms / t_red if dev_iv else None,
             us_wall_per_device_op=t_traced * 1e3 / len(dev_iv) if dev_iv else None,
             us_untraced_wall_per_device_op=t_red * 1e3 / len(dev_iv) if dev_iv else None,
             note=None if dev_iv else "the trace holds no device events")
        for k, v in ours.items():
            report[k]["device_ms_per_launch_in_reduce_trace"] = v["device_ms_per_launch"]
    del A, s

    # ---- 4. ChunkedMSM at 2^21 ------------------------------------------------
    n2 = 2 * n
    px, py, sc, ks, bits = tiled_inputs(G1, n2, np.random.default_rng(1))
    want_pt = expected_msm(G1, ks, sc)
    t = time.perf_counter()
    cm = tmsm.ChunkedMSM(G1, n, max_scalar_bits=bits, device=dev)
    for lo in range(0, n2, n):
        A = affine_from_numpy(px[:, lo : lo + n], py[:, lo : lo + n], np.zeros(n, dtype=bool), dev)
        cm.add_chunk(A, limbs_from_numpy(sc[:, lo : lo + n], dev))
    got_pt = tsw.affine_to_ints(G1, to_affine(cm.result()))[0]
    chunk_s = time.perf_counter() - t
    if got_pt != want_pt:
        raise AssertionError("ChunkedMSM 2^21: result differs from the host known answer")
    emit("chunked_msm", n=n2, chunk=n, correct=True, seconds_with_transfers=chunk_s)

    # ---- 5. kernels line -----------------------------------------------------
    sources = {
        "mont_mul": ("zkarray_torch/kernels/csrc/mont.cu", "zkarray/kernels/mont.py:235"),
        "mont_sqr": ("zkarray_torch/kernels/csrc/mont.cu", "zkarray/kernels/mont.py:254"),
        "xyzz_accum": ("zkarray_torch/kernels/csrc/sw.cu",
                       "zkarray/kernels/sw.py:309 and zkarray/kernels/sw.py:213"),
        "horner_windows": ("zkarray_torch/kernels/csrc/sw.cu", "zkarray/kernels/sw.py:497"),
    }
    rows = []
    for name, (src, repl) in sources.items():
        r = report[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                     "launches": launches[name], "library_ms": None, **r})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
