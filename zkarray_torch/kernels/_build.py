"""Build the CUDA sources with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``build/lib<name>-<digest>.so`` beside this file (the directory is listed in
``.gitignore``). The digest covers every source under ``csrc/``, so an edited
source is rebuilt and a built one is reused. Nothing is built at import time:
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
SOURCES = ("mont", "sw", "ntt", "madd", "xyzz", "twiddle")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points of each source and their argument types (every pointer,
# the stream included, as c_void_p so ctypes does not cut it to 32 bits).
EXPORTS = {
    "mont": {
        "zk_mont_mul": [_P, _P, _LL, _I, _P, _P],
        "zk_mont_sqr": [_P, _P, _LL, _I, _P, _P],
        "zk_mont_pow": [_P, _P, _LL, _P, _I, _I, _P, _P],
        "zk_mont_inv": [_P, _P, _LL, _P, _I, _P, _P],
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
    },
    "twiddle": {
        "zk_pow_table": [_P, _LL, _I, _P, _I, _I, _P, _P],
        "zk_twiddle_mul": [_P, _P, _LL, _LL, _P, _LL, _P, _LL, _I, _LL, _LL, _LL, _LL, _I, _P, _P],
    },
}

# Launches per kernel, counted by each wrapper where it launches its kernel.
LAUNCHES = {"mont_mul": 0, "mont_sqr": 0, "xyzz_accum": 0, "horner_windows": 0,
            "butterfly_dit": 0, "butterfly_stage": 0, "xyzz_add_affine": 0,
            "xyzz_add": 0, "xyzz_double": 0, "xyzz_tree_sum": 0, "mont_pow": 0, "pow_table": 0,
            "twiddle_mul": 0, "mont_inv": 0, "xyzz_bit_horner": 0}

_libs = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
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
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    errors = []
    for n, (tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib_path(n))
        lib_path(n).with_suffix(".ptxas.txt").write_text(log)
        out[n] = {"seconds": secs, "ptxas": log}
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
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
