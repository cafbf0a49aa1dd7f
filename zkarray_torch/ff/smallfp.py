"""SmallFp: fields of one 32-bit word (p < 2^32): M31, BabyBear, KoalaBear.

Counterpart of zkarray/ff/smallfp.py. Arrays are ``torch.uint32`` of shape
``(*batch)``, no limb axis: the JAX package's uint32 words, in Montgomery
form with R = 2^32 (``m31_mul`` takes canonical M31 words). Every
element-wise function is one launch of kernels/smallfp.py:sf_op on a CUDA
device (``pow_const`` and ``inv`` too: the whole ladder in one launch); a
CPU tensor takes its plain version. ``ntt`` is one bit-reversal gather,
log2 n launches of sf_butterfly and, on the inverse, one sf_op scaling by
n^-1; its power table is built on the device by doubling with sf_op
(T[k:2k] = T[0:k] * w^k), the same words as the JAX package's host loop.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.kernels import smallfp as ks
from zkarray_torch.poly.domain import _bitrev_perm


class SmallFieldSpec:
    def __init__(self, modulus: int, generator: int, name: str = ""):
        if not (2 < modulus < 1 << 32 and modulus % 2 == 1):
            raise ValueError(f"SmallFieldSpec: need an odd 2 < p < 2^32, got {modulus}")
        self.modulus = modulus
        self.generator_int = generator
        self.name = name or f"smallfp_{modulus:#x}"
        self.r_int = (1 << 32) % modulus
        self.r2_int = self.r_int * self.r_int % modulus
        self.inv32 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        t = modulus - 1
        s = 0
        while t % 2 == 0:
            t //= 2
            s += 1
        self.two_adicity, self.trace = s, t
        self.two_adic_root_int = pow(generator, t, modulus)
        self.is_mersenne = (modulus & (modulus + 1)) == 0  # p = 2^k - 1
        self.consts = ks.Consts(modulus, self.r_int, self.inv32)

    def __hash__(self):
        return hash(("small", self.modulus, self.generator_int))

    def __eq__(self, o):
        return isinstance(o, SmallFieldSpec) and o.modulus == self.modulus

    def to_mont_int(self, x):
        return x * self.r_int % self.modulus

    def from_mont_int(self, x):
        return x * pow(self.r_int, -1, self.modulus) % self.modulus

    def root_of_unity(self, n: int) -> int:
        k = (n & -n).bit_length() - 1
        if n != 1 << k or k > self.two_adicity:
            raise ValueError(f"{self.name}: no root of unity of order {n}")
        w = self.two_adic_root_int
        for _ in range(self.two_adicity - k):
            w = w * w % self.modulus
        return w


def mont_mul(spec: SmallFieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a b R^-1, R = 2^32 (operands broadcast)."""
    return ks.sf_op("u32", spec.consts, "mul", a, b)


def add(spec: SmallFieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ks.sf_op("u32", spec.consts, "add", a, b)


def sub(spec: SmallFieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ks.sf_op("u32", spec.consts, "sub", a, b)


def neg(spec: SmallFieldSpec, a: torch.Tensor) -> torch.Tensor:
    return ks.sf_op("u32", spec.consts, "neg", a)


def mont_sqr(spec: SmallFieldSpec, a: torch.Tensor) -> torch.Tensor:
    return ks.sf_op("u32", spec.consts, "sqr", a)


def pow_const(spec: SmallFieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e, left-to-right square and multiply (e = 0 gives R mod p)."""
    return ks.sf_op("u32", spec.consts, "pow", a, exponent=e)


def inv(spec: SmallFieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^(p-2); inv(0) = 0."""
    return pow_const(spec, a, spec.modulus - 2)


def from_ints(spec: SmallFieldSpec, xs, mont: bool = True, device=DEFAULT_DEVICE) -> torch.Tensor:
    vals = [spec.to_mont_int(int(x) % spec.modulus) if mont else int(x) % spec.modulus for x in xs]
    return torch.from_numpy(np.asarray(vals, dtype=np.uint32)).to(device)


def to_ints(spec: SmallFieldSpec, a: torch.Tensor, mont: bool = True) -> list:
    vals = [int(v) for v in a.reshape(-1).cpu().numpy()]
    return [spec.from_mont_int(v) if mont else v for v in vals]


M31 = SmallFieldSpec((1 << 31) - 1, generator=7, name="m31")
BABYBEAR = SmallFieldSpec((15 << 27) + 1, generator=31, name="babybear")
KOALABEAR = SmallFieldSpec((1 << 31) - (1 << 24) + 1, generator=3, name="koalabear")


def m31_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical-form M31 product by shift folds (no Montgomery form)."""
    return ks.sf_op("m31", ks.M31, "mul", a, b)


# ---------------------------------------------------------------------------
# radix-2 NTT
# ---------------------------------------------------------------------------

def gather_rows(x: torch.Tensor, perm: torch.Tensor, dim: int) -> torch.Tensor:
    """x's rows along ``dim`` in the order ``perm``, as a new contiguous
    uint32 tensor (the gather runs on the int32 view of the words)."""
    return torch.index_select(x.view(torch.int32), dim, perm).view(torch.uint32).contiguous()


@functools.lru_cache(maxsize=8)
def twiddle_table(spec: SmallFieldSpec, w_int: int, size: int, device: str) -> torch.Tensor:
    """(size,) Montgomery table [w^0, ..., w^(size-1)], built on ``device``:
    T[0] = R mod p, then T[k:2k] = T[0:k] * (w^k R) by one sf_op each, the
    same words as the JAX package's host loop (every product is fully
    reduced)."""
    p = spec.modulus
    T = torch.empty(size, dtype=torch.uint32, device=device)
    T[:1] = torch.tensor([spec.to_mont_int(1)], dtype=torch.uint32)
    k = 1
    while k < size:
        m = min(k, size - k)
        wk = torch.tensor([spec.to_mont_int(pow(w_int, k, p))], dtype=torch.uint32, device=device)
        ks.sf_op("u32", spec.consts, "mul", T[:m], wk, out=T[k:k + m])
        k *= 2
    return T


def ntt(spec: SmallFieldSpec, x: torch.Tensor, w_int: int, inverse: bool = False) -> torch.Tensor:
    """In-order radix-2 NTT over axis 0 of (n,) or (n, *batch) uint32
    Montgomery values; the inverse uses w^-1 and scales by n^-1."""
    n = x.shape[0]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"ntt: n = {n} is not a power of two")
    p = spec.modulus
    if inverse:
        w_int = pow(w_int, -1, p)
    dev = x.device
    tw = twiddle_table(spec, w_int, max(n // 2, 1), str(dev))
    y = gather_rows(x, _bitrev_perm(log_n, str(dev)), 0)
    for s in range(1, log_n + 1):
        ks.sf_butterfly("u32", spec.consts, y, tw, 1 << s)
    if inverse:
        n_inv = torch.tensor([spec.to_mont_int(pow(n, -1, p))], dtype=torch.uint32, device=dev)
        y = mont_mul(spec, y, n_inv)
    return y
