#!/usr/bin/env python3
"""Rehearse chip_smoke.py's phase 13 alone on the CPU at small sizes, with
scripts/rehearse_chip_smoke.py's stubs (every kernel launch a counted call
of its plain version): it finds wrong paths, shapes, counts and control
flow before a chip call, and says nothing about the CUDA sources.

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

R.setup()
torch.set_num_threads(2)
cs.POLY_LOG_N, cs.EVAL_POINTS, cs.DIV_DEGREES = 8, 4, (31, 3)
cs.MLE_VARS, cs.MLE_FIXED, cs.MLE_KAT = 8, 4, 20
cs.SPARSE_TERMS, cs.SPARSE_KAT, cs.MV_TERMS, cs.MV_LOG_POINTS, cs.MV_KAT = 4, 10, 4, 4, 4
cs.MIXED_DOMAINS = (("mnt6_753", "FR", 3, 25), ("mnt4_298", "FQ", 2, 49))
cs.GENERAL_TARGET, cs.GENERAL_SIZE = (1 << 15) + 1, 40960
cs.POLY_KAT = 4
cs.GFFT_LOG_N, cs.GFFT_RT_LOG_N, cs.GFFT_KAT = 2, 1, 2
cs.GLV_LOG_N = cs.GLV_SMALL_LOG_N = 6
cs.G2_GLV_LOG_N = 2
cs.WNAF_LOG_N, cs.FIXED_LOG_N = 2, 2
cs.STREAM_LOG_N, cs.STREAM_CHUNK_LOG_N = 8, 7
cs.PIPPENGER_LOG_N, cs.PIPPENGER_CHUNK = 6, 16
cs.SCALAR_KAT = 2
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


from zkarray_torch.kernels import mont as km  # noqa: E402
nw = lambda s: s.num_limbs // 2  # noqa: E731
h = types.SimpleNamespace(
    dev=dev, sync=lambda: None, time_ms=time_ms, once_ms=once_ms, rand_field=rand_field,
    check_equal=check_equal, mul_ops=lambda s: 4 * nw(s) ** 2 + 3 * nw(s),
    sqr_ops=lambda s: 3 * nw(s) ** 2 + 4 * nw(s), pow_ops=None, add_ops=lambda s: 3 * nw(s),
    bound=lambda b, o: (max(b / 3.35e12, o / 16.7e12) * 1e3, "bytes"), emit=cs.emit,
    distinct_elems=lambda t: (lambda m: m[2] if m[3] == 0 else t[0].numel())(km._operand(t)))
rec, restore = cs.install_recorders(torch, km)
t = time.perf_counter()
rep = cs.poly_scalar_phase(torch, h, rec)
restore()
print("REPORT", {k: sorted(v) for k, v in rep.items()})
print("rehearsal seconds", time.perf_counter() - t)
