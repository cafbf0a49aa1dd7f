#!/usr/bin/env python3
"""Run chip_smoke.py's phase 13 (the polynomial layer and the
scalar-multiplication family) alone on one CUDA card, after building every
kernel: main()'s helpers, the field-kernel recorders, then
``poly_scalar_phase``. With a directory argument its lines are also teed
into DIR/probe13.out. ``run`` takes another phase's function
(scripts/probe_phase14.py).

    python3 scripts/probe_phase13.py [DIR]   # ~5 minutes on an H100, the build included
"""
import json
import pathlib
import sys
import time
import types

import torch
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from zkarray_torch.kernels import _build  # noqa: E402
from zkarray_torch.kernels import mont as km  # noqa: E402


def setup(tag: str, names=_build.SOURCES):
    """Build the libraries ``names`` and make main()'s helpers; lines teed
    into DIR/<tag>.out when a directory is given. Returns (helpers, tee)."""
    log = None
    if len(sys.argv) > 1:
        out_dir = pathlib.Path(sys.argv[1])
        out_dir.mkdir(parents=True, exist_ok=True)
        log = open(out_dir / f"{tag}.out", "w")
    _print = print

    def tee(*a, **kw):
        _print(*a, **kw)
        if log is not None:
            kw.pop("file", None)
            _print(*a, **kw, file=log)
            log.flush()

    cs.print = tee
    tee(cs.nvidia_smi("name,power.limit"))
    t0 = time.perf_counter()
    built = _build.build(names)
    tee(json.dumps({"build_s": time.perf_counter() - t0, "per_source": {k: v["seconds"] for k, v in built.items()}}))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    props = torch.cuda.get_device_properties(0)
    clock = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    int_ops = props.multi_processor_count * cs.INT32_LANES_PER_SM * clock * 1e6

    def sync():
        torch.cuda.synchronize()

    def time_ms(fn, iters):
        fn()
        sync()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        sync()
        return s.elapsed_time(e) / iters

    def once_ms(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t) * 1e3

    def rand_field(spec, n):
        L = spec.num_limbs
        t = (spec.modulus.bit_length() - 1) // 16
        x = torch.randint(0, 1 << 16, (L, n), generator=gen, device=dev, dtype=torch.int32)
        x[t] = torch.randint(0, spec.modulus >> (16 * t), (n,), generator=gen, device=dev, dtype=torch.int32)
        x[t + 1:] = 0
        return x

    def check_equal(what, got, want):
        e = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
        if e or got.shape != want.shape:
            raise AssertionError(f"{what}: kernel differs from plain (max abs err {e})")
        return e

    def bound(nbytes, ops):
        tb, to = nbytes / cs.HBM_BYTES_PER_S * 1e3, ops / int_ops * 1e3
        return (max(tb, to), "bytes" if tb >= to else "operations")

    nw = lambda s: s.num_limbs // 2  # noqa: E731
    h = types.SimpleNamespace(
        dev=dev, sync=sync, time_ms=time_ms, once_ms=once_ms, rand_field=rand_field,
        check_equal=check_equal, mul_ops=lambda s: 4 * nw(s) ** 2 + 3 * nw(s),
        sqr_ops=lambda s: 3 * nw(s) ** 2 + 4 * nw(s), pow_ops=None, add_ops=lambda s: 3 * nw(s),
        bound=bound, emit=cs.emit,
        distinct_elems=lambda t: (lambda m: m[2] if m[3] == 0 else t[0].numel())(km._operand(t)))
    return h, tee


def run(phase: str, tag: str):
    """Build, make the helpers, run chip_smoke.<phase> with the recorders;
    lines teed into DIR/<tag>.out when a directory is given."""
    h, tee = setup(tag)
    rec, restore = cs.install_recorders(torch, km)
    t = time.perf_counter()
    try:
        rep = getattr(cs, phase)(torch, h, rec)
    finally:
        restore()
    tee(json.dumps({f"{tag}_seconds": time.perf_counter() - t}))
    tee(json.dumps({"report": rep}, default=str)[:20000])



if __name__ == "__main__":
    run("poly_scalar_phase", "probe13")
