"""Fp64: Goldilocks (p = 2^64 - 2^32 + 1) in paired uint32 planes.

Counterpart of zkarray/ff/fp64.py. Arrays are ``torch.uint32`` of shape
``(2, *batch)`` (row 0 the low words, row 1 the high), canonical residues
(no Montgomery form), as the JAX package holds them; inside the kernels an
element is one uint64 and the 128-bit product folds by 2^64 = eps =
2^32 - 1 and 2^96 = -1. Every element-wise function is one launch of
kernels/smallfp.py:sf_op on a CUDA device; ``ntt`` is one bit-reversal
gather, log2 n launches of sf_butterfly and, on the inverse, one sf_op; its
power table is built on the device by doubling (T[k:2k] = T[0:k] * w^k), the
same words as the JAX package's host loop. ``_mul32``, ``_addc`` and
``_subb`` are the two-word helpers ff/smallfp64.py shares, on int64 lanes
that hold 32-bit words.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.ff.smallfp import gather_rows
from zkarray_torch.poly.domain import _bitrev_perm
from zkarray_torch.kernels import smallfp as ks

MASK16 = ks.M16
EPS = ks.M32  # 2^32 - 1


class Fp64Spec:
    def __init__(self, modulus: int, generator: int, name: str = ""):
        if not (1 << 32 < modulus < 1 << 64):
            raise ValueError(f"Fp64Spec: need 2^32 < p < 2^64, got {modulus}")
        self.modulus = modulus
        self.generator_int = generator
        self.name = name or f"fp64_{modulus:#x}"
        t = modulus - 1
        s = 0
        while t % 2 == 0:
            t //= 2
            s += 1
        self.two_adicity, self.trace = s, t
        self.two_adic_root_int = pow(generator, t, modulus)

    def __hash__(self):
        return hash(("fp64", self.modulus, self.generator_int))

    def __eq__(self, o):
        return isinstance(o, Fp64Spec) and o.modulus == self.modulus

    def root_of_unity(self, n: int) -> int:
        k = (n & -n).bit_length() - 1
        if n != 1 << k or k > self.two_adicity:
            raise ValueError(f"{self.name}: no root of unity of order {n}")
        w = self.two_adic_root_int
        for _ in range(self.two_adicity - k):
            w = w * w % self.modulus
        return w


GOLDILOCKS = Fp64Spec((1 << 64) - (1 << 32) + 1, generator=7, name="goldilocks")
_C = ks.GL64


def _mul32(a: torch.Tensor, b: torch.Tensor):
    """u32 x u32 -> (lo32, hi32), words in int64 lanes."""
    hi, lo = ks._mul_wide(a, b)
    return lo, hi


_addc = ks._addc
_subb = ks._subb


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a b) mod p: the full 128-bit product and the Goldilocks fold."""
    return ks.sf_op("gl64", _C, "mul", a, b)


def sqr(a: torch.Tensor) -> torch.Tensor:
    return ks.sf_op("gl64", _C, "sqr", a)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ks.sf_op("gl64", _C, "add", a, b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ks.sf_op("gl64", _C, "sub", a, b)


def neg(a: torch.Tensor) -> torch.Tensor:
    return ks.sf_op("gl64", _C, "neg", a)


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e, left-to-right square and multiply; e = 0 gives one."""
    return ks.sf_op("gl64", _C, "pow", a, exponent=e)


def inv(spec: Fp64Spec, a: torch.Tensor) -> torch.Tensor:
    """a^(p-2); inv(0) = 0."""
    return pow_const(a, spec.modulus - 2)


def one_like(a: torch.Tensor) -> torch.Tensor:
    col = torch.tensor([1, 0], dtype=torch.int64, device=a.device).reshape((2,) + (1,) * (a.dim() - 1))
    return col.expand(a.shape).to(torch.uint32)


def from_ints(xs, device=DEFAULT_DEVICE) -> torch.Tensor:
    xs = [int(x) % GOLDILOCKS.modulus for x in xs]
    lo = np.asarray([x & 0xFFFFFFFF for x in xs], dtype=np.uint32)
    hi = np.asarray([x >> 32 for x in xs], dtype=np.uint32)
    return torch.from_numpy(np.stack([lo, hi])).to(device)


def to_ints(a: torch.Tensor) -> list:
    arr = a.cpu().numpy()
    lo = arr[0].ravel().astype(np.uint64)
    hi = arr[1].ravel().astype(np.uint64)
    return [int(l) | (int(h) << 32) for l, h in zip(lo, hi)]


# ---------------------------------------------------------------------------
# radix-2 NTT over Goldilocks pairs (two-adicity 32)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def twiddle_table(w_int: int, size: int, device: str) -> torch.Tensor:
    """(2, size) table [w^0, ..., w^(size-1)], built on ``device``: T[0] = 1,
    then T[k:2k] = T[0:k] * w^k by one sf_op each (written into T's own
    column slices), the same words as the JAX package's host loop."""
    p = GOLDILOCKS.modulus
    T = torch.empty((2, size), dtype=torch.uint32, device=device)
    T[:, :1] = torch.tensor([[1], [0]], dtype=torch.uint32)
    k = 1
    while k < size:
        m = min(k, size - k)
        wk = from_ints([pow(w_int, k, p)], device).reshape(2, 1)
        ks.sf_op("gl64", _C, "mul", T[:, :m], wk, out=T[:, k:k + m])
        k *= 2
    return T


def ntt(x: torch.Tensor, w_int: int, inverse: bool = False) -> torch.Tensor:
    """In-order radix-2 NTT over axis 1 of uint32 (2, n); the inverse uses
    w^-1 and scales by n^-1."""
    p = GOLDILOCKS.modulus
    n = x.shape[1]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"ntt: n = {n} is not a power of two")
    w = pow(w_int, -1, p) if inverse else w_int
    dev = x.device
    tw = twiddle_table(w, max(n // 2, 1), str(dev))
    y = gather_rows(x, _bitrev_perm(log_n, str(dev)), 1)
    for s in range(1, log_n + 1):
        ks.sf_butterfly("gl64", _C, y, tw, 1 << s)
    if inverse:
        y = mul(y, from_ints([pow(n, -1, p)], dev).reshape(2, 1))
    return y
