#!/usr/bin/env python3
"""Rehearse chip_smoke.py's control flow on the CPU at small sizes, with no
GPU and no nvcc: every kernel launch is replaced by a counted call of its
plain version, torch.cuda and nvidia-smi by stubs, and the build by empty
ptxas reports. It finds wrong paths, shapes, counts and control flow before
a chip call; it says nothing about the CUDA sources. About 35 minutes
(phase 8's group path runs its full-length scalar chains at 64 points,
phase 9 nine pairing calls of 8 to 16 pairs, ~10 s each on the CPU, phase
10 twenty-two BN254, GT and BW6 calls of 8 to 16 lanes, phase 11 msm_mixed
at 2^8 points and twenty-five MNT and CP6 calls of 2 to 8 lanes, phase 12
fp_lin's edge words and recorded inputs). The XYZZ and MSM kernels'
stand-ins refuse every width but L = 16 and 24 (NW = 8 and 12), and the
NTT and twiddle kernels' L = 52 (NW = 26), as on the card:

    python3 scripts/rehearse_chip_smoke.py > rehearsal.out
"""

import ctypes
import pathlib
import sys
import tempfile
import types

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from zkarray_torch import kernels  # noqa: E402
from zkarray_torch.kernels import _build  # noqa: E402
from zkarray_torch.kernels import lin  # noqa: E402
from zkarray_torch.kernels import mont as km  # noqa: E402
from zkarray_torch.kernels import smallfp as ksf  # noqa: E402
from zkarray_torch.kernels import sw as ksw  # noqa: E402
from zkarray_torch.poly import domain as dm  # noqa: E402

LAUNCHES = kernels.LAUNCHES


class StubEvent:
    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


class StubSwLib:
    def zk_xyzz_accum_occupancy(self, nw, blocks, threads):
        ctypes.c_int.from_address(blocks).value = 6
        ctypes.c_int.from_address(threads).value = 64
        return 0

    def zk_xyzz_tree_sum_occupancy(self, nw, plain, m, blocks, threads):
        ctypes.c_int.from_address(blocks).value = 2
        ctypes.c_int.from_address(threads).value = 256
        return 0


def counted(name, fn):
    def call(*args, **kw):
        LAUNCHES[name] += 1
        return fn(*args, **kw)
    return call


def launch_mont(kernel, spec, *ins, exponent=None):
    LAUNCHES[kernel] += 1
    if kernel == "mont_pow":
        return km.mont_pow_plain(spec, ins[0], exponent)
    if kernel == "mont_inv":
        return km.mont_inv_plain(spec, ins[0])
    return km.mont_mul_plain(spec, ins[0], ins[-1])


def refuse_nw24(kernel, limbs):
    """The card's XYZZ, MSM, NTT and twiddle kernels are built for NW = 8
    and 12 only: at L = 20, 48 or 52 their C entries return
    cudaErrorInvalidValue."""
    if limbs not in (16, 24):
        raise RuntimeError(f"{kernel}: CUDA launch failed (1: invalid argument)")


def refuse_ntt(kernel, limbs):
    """The card's NTT and twiddle kernels are built for NW = 8, 10, 12 and
    24: at L = 52 the wrapper finds no library and raises."""
    _build.ntt_lib(kernel, limbs // 2)


def field_only(kernel, fn, limbs_of, refuse=refuse_nw24):
    def call(*args, **kw):
        refuse(kernel, limbs_of(*args))
        return fn(*args, **kw)
    return call


def launch_xyzz(kernel, curve, *coords):
    refuse_nw24(kernel, curve.base.num_limbs)
    LAUNCHES[kernel] += 1
    if kernel == "xyzz_add":
        return ksw._fadd_plain(curve, coords[:4], coords[4:])
    return ksw._dbl_plain(curve, coords)


def launch_addsub(kernel, spec, a, b, out):
    if out is not None:
        km.out_map(kernel, out, a[0].numel())  # the launcher's refusals, as on the card
    LAUNCHES[kernel] += 1
    r = (km.add_plain if kernel == "fp_add" else km.sub_plain)(spec, a, b)
    return r if out is None else out.copy_(r)


def launch_lin(spec, lmap, srcs, out):
    if out is not None:
        lin.out_operand(lmap.name, out, out[0, 0].numel())  # the launcher's refusals
    LAUNCHES["fp_lin"] += 1
    return lin.fp_lin_plain(spec, lmap, srcs, out)


def launch_sf_op(fam, c, op, a, b, exponent, out):
    if out is not None and not km.distinct_addresses(out.shape, out.stride()):
        raise ValueError(f"sf_op: out's strides {out.stride()} cannot be written in place")
    LAUNCHES["sf_op"] += 1
    res = ksf.sf_op_plain(fam, c, op, a, b, exponent)
    return res if out is None else out.copy_(res)


def launch_sf_butterfly(fam, c, y, tw, m):
    LAUNCHES["sf_butterfly"] += 1
    return ksf.sf_butterfly_plain(fam, c, y, tw, m)


def accum(curve, state, coords, valid, what):
    LAUNCHES["xyzz_accum"] += 1
    return ksw.xyzz_accum_plain(curve, state, coords, valid)


def setup():
    """Small sizes, the stubs and the counted plain versions."""
    cs.DEVICE = "cpu"
    cs.LOG_N, cs.NTT_LOG_N, cs.COSET_LOG_N, cs.DEG_LOG_M = 8, 12, 10, 9
    cs.KAT_POINTS, cs.ELEM_LOG_N, cs.MADD_KAT_BASE = 20, 8, 8
    cs.EDGE_SLOTS, cs.EDGE_ROUNDS, cs.ORACLE_SLOTS, cs.ORACLE_ROUNDS = 421, 4, 99, 3
    cs.TREE_EDGE_ROWS, cs.TREE_EDGE_WIDTHS, cs.TREE_ROUTE_WIDTHS = 4, (1, 2, 3, 13, 16), (17, 33)
    cs.GROUP_LOG_N, cs.SMALL_LOG_N, cs.FIELD_KAT, cs.GROUP_KAT, cs.OFF_POOL = 6, 5, 16, 8, 4
    cs.PAIR_LOG_N, cs.PAIR_BIG_LOG_N, cs.PAIR_BASE, cs.PAIR_INF_EVERY, cs.G2_LOG_N = 3, 4, 4, 4, 5
    cs.FIELD48_LOG_N = 5
    cs.INV_PAIRING_LOG_N, cs.DIV_LOG_N = 5, 6
    cs.MIXED_LOG_N, cs.MNT_LOG_N, cs.CP6_EACH, cs.CP6_BASE = 8, 3, 2, 2
    cs.SF_NTT_LOG_N, cs.SF_NTT_COLS, cs.KB_NTT_COLS, cs.GL_NTT_LOG_N = 6, 4, 2, 7
    cs.SF_ELEM_LOG_N, cs.SF_KAT, cs.DIST_MSM_LOG_N, cs.DIST_FFT_LOG_N = 8, 32, 8, 8
    cs.RB_LOG_N, cs.RB_KAT, cs.DERIVE_LOG_N, cs.MADD_TOP_LOG_N, cs.R1_TIME_LOG_N = 6, 16, 6, 7, 7
    dm.FOURSTEP_BIG, dm.FOURSTEP_MIN = 1 << 12, 1 << 9
    ksw.TREE_SUM_MAX = 16  # c = 7 at 2^8 points: trees of 64, two element-wise levels

    cu = torch.cuda
    cu.is_available = lambda: True
    cu.Event = StubEvent
    cu.synchronize = lambda *a: None
    cu.reset_peak_memory_stats = lambda *a: None
    cu.max_memory_allocated = lambda *a: 0
    cu.memory_allocated = lambda *a: 0
    cu.get_device_properties = lambda *a: types.SimpleNamespace(multi_processor_count=132)
    cu.get_device_name = lambda *a: "stub"
    cu.device_count = lambda: 1
    cs.nvidia_smi = lambda fields: "1980 MHz" if "clocks" in fields else "stub card, 700.00 W"
    cs.latency_line = lambda torch, lib, clock: dict(  # an H100's, as the card reports them
        cycles_per_dependent_carried_add=5.0, cycles_per_dependent_l2_load=283.0,
        cycles_per_dependent_shuffle=24.0, empty_launch_device_ms=0.00087, max_sm_clock_mhz=clock)
    cs.LIN_NARROW_N = (1, 7, 64)
    cs.sass_functions = lambda paths: [{
        k: dict(instructions=10, imad=5, opcodes={})
        for k in ("probe_none", "probe_fmul", "probe_fmul_wide", "probe_horner_serial")} for _ in paths]

    fake = pathlib.Path(tempfile.mkdtemp(prefix="rehearse_build_"))
    for name in _build.SOURCES:
        (fake / f"lib{name}.ptxas.txt").write_text("")
    _build.build = lambda *a, **kw: {}
    _build.lib_path = lambda name: fake / f"lib{name}.so"
    _build._nvcc = lambda: "true"  # the SASS probe's build is a no-op
    _build.load = lambda name: StubSwLib()
    _build.check = lambda *a: None

    # every wrapper takes its kernel route, which now runs the plain version
    km.on_cpu = lambda *ts: False
    km._launch = launch_mont
    km._launch_div = counted("mont_div", km.mont_div_plain)
    km._launch_addsub = launch_addsub
    ksf._launch_op = launch_sf_op
    ksf._launch_butterfly = launch_sf_butterfly
    lin._launch_lin = launch_lin
    km._launch_dit = field_only("butterfly_dit", counted("butterfly_dit", km.butterfly_dit_plain),
                                lambda spec, *a: spec.num_limbs, refuse_ntt)
    km.butterfly_stage = counted("butterfly_stage", km.butterfly_stage_plain)
    ksw._accum = accum
    ksw._launch_xyzz = launch_xyzz
    curve_limbs = lambda curve, *a: curve.base.num_limbs  # noqa: E731
    ksw.horner_windows = field_only("horner_windows", counted("horner_windows",
                                                              ksw.horner_windows_plain), curve_limbs)
    ksw.xyzz_add_affine = field_only("xyzz_add_affine", counted("xyzz_add_affine",
                                                                ksw.xyzz_add_affine_plain), curve_limbs)
    ksw.xyzz_tree_sum = counted("xyzz_tree_sum", ksw.xyzz_tree_sum_plain)
    ksw.xyzz_bit_horner = counted("xyzz_bit_horner", ksw.xyzz_bit_horner_plain)
    km.pow_table = field_only("pow_table", counted("pow_table", km.pow_table),  # the plain version
                              lambda spec, *a, **kw: spec.num_limbs, refuse_ntt)
    twiddle_mul = km.twiddle_mul

    def twiddle_on_cpu(*args, **kw):
        out = kw.get("out")
        if out is not None and not km.distinct_addresses(out.shape, out.stride()):
            raise ValueError("twiddle_mul: out cannot be written in place")  # as on the card
        km.on_cpu = lambda *ts: True
        try:
            return twiddle_mul(*args, **kw)
        finally:
            km.on_cpu = lambda *ts: False

    km.twiddle_mul = counted("twiddle_mul", twiddle_on_cpu)


def main():
    setup()
    return cs.main()


if __name__ == "__main__":
    sys.exit(main())
