"""Generic u64 small fields: Montgomery arithmetic (R = 2^64) for any odd
33-64-bit prime, in paired uint32 planes.

Counterpart of zkarray/ff/smallfp64.py: Goldilocks keeps its eps-fold in
ff/fp64.py, and this module is the generic backend for every other 33-64-bit
prime. Arrays are ``torch.uint32`` of shape ``(2, *batch)`` (row 0 the low
words, row 1 the high) in Montgomery form. Every function is one launch of
kernels/smallfp.py:sf_op on a CUDA device (``pow_const`` and ``inv``
included, the right-to-left ladder of the JAX package in registers); a
CPU tensor takes its plain version. The product is the JAX package's
two-step base-2^32 CIOS, its top word's wrap included.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.kernels import smallfp as ks

MASK16 = ks.M16


class SmallFp64Spec:
    """Config for a generic u64 prime field (Montgomery form, R = 2^64)."""

    def __init__(self, modulus: int, generator: int, name: str = ""):
        if not ((1 << 32) < modulus < (1 << 64) and modulus % 2 == 1):
            raise ValueError(f"SmallFp64Spec: need an odd 2^32 < p < 2^64, got {modulus}")
        self.modulus = modulus
        self.generator_int = generator
        self.name = name or f"smallfp64_{modulus:#x}"
        self.r_int = (1 << 64) % modulus
        self.r2_int = pow(self.r_int, 2, modulus)
        self.inv32 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        t = modulus - 1
        s = 0
        while t % 2 == 0:
            t //= 2
            s += 1
        self.two_adicity, self.trace = s, t
        self.two_adic_root_int = pow(generator, t, modulus)
        self.consts = ks.Consts(modulus, self.r_int, self.inv32)

    def __hash__(self):
        return hash(("smallfp64", self.modulus, self.generator_int))

    def __eq__(self, o):
        return isinstance(o, SmallFp64Spec) and o.modulus == self.modulus

    def root_of_unity(self, n: int) -> int:
        k = (n & -n).bit_length() - 1
        if n != 1 << k or k > self.two_adicity:
            raise ValueError(f"{self.name}: no root of unity of order {n}")
        w = self.two_adic_root_int
        for _ in range(self.two_adicity - k):
            w = w * w % self.modulus
        return w

    def to_mont_int(self, x: int) -> int:
        return (x << 64) % self.modulus

    def from_mont_int(self, x: int) -> int:
        return (x * pow(1 << 64, -1, self.modulus)) % self.modulus


def _split(x: int) -> Tuple[int, int]:
    return x & 0xFFFFFFFF, (x >> 32) & 0xFFFFFFFF


def mont_mul(spec: SmallFp64Spec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b R^-1 mod p over (2, *batch) planes (operands broadcast)."""
    return ks.sf_op("u64", spec.consts, "mul", a, b)


def add(spec: SmallFp64Spec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ks.sf_op("u64", spec.consts, "add", a, b)


def sub(spec: SmallFp64Spec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ks.sf_op("u64", spec.consts, "sub", a, b)


def neg(spec: SmallFp64Spec, a: torch.Tensor) -> torch.Tensor:
    return ks.sf_op("u64", spec.consts, "neg", a)


def one(spec: SmallFp64Spec, batch_shape=(), device=DEFAULT_DEVICE) -> torch.Tensor:
    r_lo, r_hi = _split(spec.r_int)
    return torch.tensor([r_lo, r_hi], dtype=torch.int64, device=device).reshape(
        (2,) + (1,) * len(tuple(batch_shape))).expand((2,) + tuple(batch_shape)).to(torch.uint32)


def pow_const(spec: SmallFp64Spec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e, right-to-left: a product per set bit, a square per bit; e = 0
    gives one."""
    return ks.sf_op("u64", spec.consts, "pow", a, exponent=e)


def inv(spec: SmallFp64Spec, a: torch.Tensor) -> torch.Tensor:
    """a^-1 via Fermat; inv(0) = 0."""
    return pow_const(spec, a, spec.modulus - 2)


def from_ints(spec: SmallFp64Spec, xs, device=DEFAULT_DEVICE) -> torch.Tensor:
    vals = [spec.to_mont_int(int(x) % spec.modulus) for x in xs]
    lo = np.asarray([v & 0xFFFFFFFF for v in vals], dtype=np.uint32)
    hi = np.asarray([v >> 32 for v in vals], dtype=np.uint32)
    return torch.from_numpy(np.stack([lo, hi])).to(device)


def to_ints(spec: SmallFp64Spec, a: torch.Tensor) -> list:
    arr = a.cpu().numpy().astype(np.uint64)
    flat = (arr[0] | (arr[1] << np.uint64(32))).reshape(-1)
    return [spec.from_mont_int(int(v)) for v in flat]
