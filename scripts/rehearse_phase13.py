#!/usr/bin/env python3
"""Rehearse chip_smoke.py's phase 13 alone on the CPU at small sizes, with
scripts/rehearse_chip_smoke.py's stubs (every kernel launch a counted call
of its plain version): it finds wrong paths, shapes, counts and control
flow before a chip call, and says nothing about the CUDA sources. ``run``
takes another phase and its sizes (scripts/rehearse_phase14.py).

    python3 scripts/rehearse_phase13.py   # ~10 minutes on a CPU
"""
import pathlib
import sys
import time
import types

import torch
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "scripts"))
import rehearse_chip_smoke as R  # noqa: E402
import chip_smoke as cs  # noqa: E402

from zkarray_torch.kernels import mont as km  # noqa: E402

dev = torch.device("cpu")
gen = torch.Generator().manual_seed(1)


def rand_field(spec, n):
    L = spec.num_limbs
    t = (spec.modulus.bit_length() - 1) // 16
    x = torch.randint(0, 1 << 16, (L, n), generator=gen, dtype=torch.int32)
    x[t] = torch.randint(0, spec.modulus >> (16 * t), (n,), generator=gen, dtype=torch.int32)
    x[t + 1:] = 0
    return x


def once_ms(fn):
    t = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t) * 1e3


def time_ms(fn, iters):
    fn()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) * 1e3 / iters


def check_equal(what, got, want):
    e = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
    if e or got.shape != want.shape:
        raise AssertionError(f"{what}: differs ({e})")
    return e


nw = lambda s: s.num_limbs // 2  # noqa: E731
h = types.SimpleNamespace(
    dev=dev, sync=lambda: None, time_ms=time_ms, once_ms=once_ms, rand_field=rand_field,
    check_equal=check_equal, mul_ops=lambda s: 4 * nw(s) ** 2 + 3 * nw(s),
    sqr_ops=lambda s: 3 * nw(s) ** 2 + 4 * nw(s), pow_ops=None, add_ops=lambda s: 3 * nw(s),
    bound=lambda b, o: (max(b / 3.35e12, o / 16.7e12) * 1e3, "bytes"), emit=cs.emit,
    distinct_elems=lambda t: (lambda m: m[2] if m[3] == 0 else t[0].numel())(km._operand(t)))


def run(phase: str, sizes: dict):
    """Stub the kernels (rehearse_chip_smoke.setup), shrink chip_smoke's
    module sizes to ``sizes``, run chip_smoke.<phase> with the recorders."""
    R.setup()
    torch.set_num_threads(2)
    for name, value in sizes.items():
        setattr(cs, name, value)
    rec, restore = cs.install_recorders(torch, km)
    t = time.perf_counter()
    rep = getattr(cs, phase)(torch, h, rec)
    restore()
    print("REPORT", {k: sorted(v) for k, v in rep.items()})
    print("rehearsal seconds", time.perf_counter() - t)


SIZES = dict(
    POLY_LOG_N=8, EVAL_POINTS=4, DIV_DEGREES=(31, 3), MLE_VARS=8, MLE_FIXED=4, MLE_KAT=20,
    SPARSE_TERMS=4, SPARSE_KAT=10, MV_TERMS=4, MV_LOG_POINTS=4, MV_KAT=4,
    MIXED_DOMAINS=(("mnt6_753", "FR", 3, 25), ("mnt4_298", "FQ", 2, 49)),
    GENERAL_TARGET=(1 << 15) + 1, GENERAL_SIZE=40960, POLY_KAT=4, GFFT_LOG_N=2, GFFT_RT_LOG_N=1,
    GFFT_KAT=2, GLV_LOG_N=6, GLV_SMALL_LOG_N=6, G2_GLV_LOG_N=2, WNAF_LOG_N=2, FIXED_LOG_N=2,
    STREAM_LOG_N=8, STREAM_CHUNK_LOG_N=7, PIPPENGER_LOG_N=6, PIPPENGER_CHUNK=16, SCALAR_KAT=2)

if __name__ == "__main__":
    run("poly_scalar_phase", SIZES)
