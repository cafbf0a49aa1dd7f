"""Build the CUDA sources with nvcc and bind them with ctypes.

Each library ``<name>`` is one ``csrc/<file>.cu`` built into a shared
library with a plain C interface, ``build/lib<name>-<digest>.so`` beside this
file (the directory is listed in ``.gitignore``). Most libraries are one
source each; ``csrc/mont.cu`` is built three times, once per group of field
widths (``FIELD_LIBS``), and ``ntt.cu`` and ``twiddle.cu`` twice each
(``NTT_LIBS``), so that their wide instantiations compile in parallel. The digest covers every source under ``csrc/`` and every
library's nvcc flags, so an edited source or width group is rebuilt and a
built one is reused. Nothing is built at import time:
the first kernel launch builds what it needs, and ``build()`` builds several
sources in parallel, one ``nvcc`` process each.

The libraries link the CUDA runtime statically and launch on the stream the
caller passes (PyTorch's current stream). Every C entry returns
``cudaGetLastError()`` after its launch; ``check`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("mont", "mont_w24", "mont_w26", "sw", "ntt", "ntt_w24", "madd", "xyzz", "twiddle",
           "twiddle_w24", "fadd", "flin", "smallfp")
# library -> (source stem, extra nvcc flags) where the two differ
VARIANTS = {
    "mont": ("mont", ("-DZK_FIELD_WIDTHS=1",)),
    "mont_w24": ("mont", ("-DZK_FIELD_WIDTHS=24",)),
    "mont_w26": ("mont", ("-DZK_FIELD_WIDTHS=26",)),
    "ntt": ("ntt", ("-DZK_FIELD_WIDTHS=1",)),
    "ntt_w24": ("ntt", ("-DZK_FIELD_WIDTHS=24",)),
    "twiddle": ("twiddle", ("-DZK_FIELD_WIDTHS=1",)),
    "twiddle_w24": ("twiddle", ("-DZK_FIELD_WIDTHS=24",)),
}
# Word counts NW = L/2 of the element-wise field kernels (csrc/field.cuh:
# ZK_DISPATCH_NW_FIELD) and the mont.cu library that holds each; fadd.cu
# and flin.cu hold all of them. The NTT and twiddle kernels take the same
# widths but 26, from their own width groups (NTT_LIBS); the XYZZ and MSM
# kernels take NW = 8 and 12 only.
FIELD_LIBS = {8: "mont", 10: "mont", 12: "mont", 24: "mont_w24", 26: "mont_w26"}
NTT_LIBS = {8: "", 10: "", 12: "", 24: "_w24"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U, _ULL = ctypes.c_uint, ctypes.c_ulonglong
# C entry points of each source and their argument types (every pointer,
# the stream included, as c_void_p so ctypes does not cut it to 32 bits).
EXPORTS = {
    "mont": {
        "zk_mont_mul_v": [_P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _P, _LL, _I, _P, _P],
        "zk_mont_sqr_v": [_P, _LL, _LL, _LL, _P, _LL, _I, _P, _P],
        "zk_mont_pow": [_P, _P, _LL, _P, _I, _I, _P, _P],
        "zk_mont_inv": [_P, _P, _LL, _P, _I, _I, _P, _P],
        "zk_mont_div": [_P, _P, _LL, _P, _I, _I, _P, _P],
    },
    "sw": {
        "zk_xyzz_accum": [_P, _P, _P, _P, _I, _LL, _I, _P, _P],
        "zk_horner_windows": [_P, _P, _I, _I, _I, _P, _P],
        "zk_xyzz_accum_occupancy": [_I, _P, _P],
        "zk_xyzz_bit_horner": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    },
    "ntt": {
        "zk_butterfly_dit": [_P, _P, _LL, _LL, _LL, _LL, _LL, _I, _P, _P],
        "zk_butterfly_stage": [_P, _P, _P, _P, _P, _LL, _I, _P, _P],
    },
    "madd": {
        "zk_xyzz_add_affine": [_P] * 11 + [_LL, _I, _P, _P],
    },
    "xyzz": {
        "zk_xyzz_add": [_P, _P, _LL, _I, _P, _P],
        "zk_xyzz_double": [_P, _P, _LL, _I, _P, _P],
        "zk_xyzz_tree_sum": [_P, _P, _LL, _I, _I, _P, _P],
        "zk_xyzz_tree_sum_occupancy": [_I, _I, _I, _P, _P],
    },
    "twiddle": {
        "zk_pow_table": [_P, _LL, _I, _P, _I, _I, _P, _P],
        "zk_twiddle_mul": [_P, _P, _LL, _LL, _P, _LL, _P, _LL, _I, _LL, _LL, _LL, _LL, _I, _P, _P],
    },
    "fadd": {
        "zk_fp_add_v": [_P, _LL, _LL, _LL] * 3 + [_LL, _I, _P, _P],
        "zk_fp_sub_v": [_P, _LL, _LL, _LL] * 3 + [_LL, _I, _P, _P],
    },
    "flin": {
        "zk_fp_lin_v": [_P, _P],
    },
    "smallfp": {
        "zk_sf_op": [_I, _I, _P, _LL, _P, _I, _LL, _P, _I, _LL, _LL, _ULL, _ULL, _U, _P, _I, _P],
        "zk_sf_butterfly": [_I, _P, _P, _LL, _LL, _LL, _LL, _ULL, _ULL, _U, _P],
    },
}

# Launches per kernel, counted by each wrapper where it launches its kernel.
LAUNCHES = {"mont_mul": 0, "mont_sqr": 0, "xyzz_accum": 0, "horner_windows": 0,
            "butterfly_dit": 0, "butterfly_stage": 0, "xyzz_add_affine": 0,
            "xyzz_add": 0, "xyzz_double": 0, "xyzz_tree_sum": 0, "mont_pow": 0, "pow_table": 0,
            "twiddle_mul": 0, "mont_inv": 0, "xyzz_bit_horner": 0, "fp_add": 0, "fp_sub": 0,
            "fp_lin": 0, "sf_op": 0, "sf_butterfly": 0, "mont_div": 0}

EXPORTS["mont_w24"] = EXPORTS["mont_w26"] = EXPORTS["mont"]
EXPORTS["ntt_w24"] = EXPORTS["ntt"]
EXPORTS["twiddle_w24"] = EXPORTS["twiddle"]

_libs = {}


def source_of(name: str):
    """(source stem, extra nvcc flags) of library ``name``."""
    return VARIANTS.get(name, (name, ()))


def field_lib(nw: int) -> str:
    """The mont.cu library that holds the field kernels at NW words; raises
    for a width that no library builds."""
    try:
        return FIELD_LIBS[nw]
    except KeyError:
        raise ValueError(f"field kernels take NW in {sorted(FIELD_LIBS)}, not {nw}") from None


def ntt_lib(source: str, nw: int) -> str:
    """The library of ``source`` (ntt or twiddle) that holds its kernels at
    NW words; raises for a width that no library builds."""
    try:
        return source + NTT_LIBS[nw]
    except KeyError:
        raise ValueError(f"{source} kernels take NW in {sorted(NTT_LIBS)}, not {nw}") from None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(VARIANTS.items())).encode())  # a library's own flags
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def build(names=SOURCES) -> dict:
    """Compile the named sources that are not built yet, all at once.

    Returns {name: {"seconds": wall time, "ptxas": nvcc's -Xptxas -v report}}
    for the sources it compiled; raises with nvcc's output if one fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        stem, flags = source_of(n)
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        log_file = tmp.with_suffix(".log")
        with open(log_file, "w") as fh:  # a file, not a pipe: the processes are polled
            procs[n] = (tmp, log_file, subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    done = {}
    while len(done) < len(procs):  # each library's own build time
        for n, (_, _, proc) in procs.items():
            if n not in done and proc.poll() is not None:
                done[n] = time.perf_counter() - t0
        time.sleep(0.05)
    out = {}
    errors = []
    for n, (tmp, log_file, proc) in procs.items():
        log = log_file.read_text()
        log_file.unlink()
        secs = done[n]
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n} ({source_of(n)[0]}.cu, rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib_path(n))
        lib_path(n).with_suffix(".ptxas.txt").write_text(log)
        out[n] = {"seconds": secs, "ptxas": log}
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        lib.zk_error_string.argtypes = [ctypes.c_int]
        lib.zk_error_string.restype = ctypes.c_char_p
        for fn, argtypes in EXPORTS[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str):
    if err != 0:
        msg = lib.zk_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")
