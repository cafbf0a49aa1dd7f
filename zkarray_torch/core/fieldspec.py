"""Per-field Montgomery constants (the port's own copy of the subset it needs).

Counterpart of zkarray/core/fieldspec.py:FieldSpec, with the small-subgroup
roots of mixed-radix domains. Base-2^16 limbs, L =
4·ceil(bits/64), so R = 2^(16 L) equals arkworks' 64-bit-limb radix and
Montgomery-form values match the JAX package's bit for bit.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


class FieldSpec:
    """Constants of one prime field, as plain Python ints."""

    def __init__(
        self,
        modulus: int,
        generator: int,
        name: str = "",
        small_subgroup_base: Optional[int] = None,
        small_subgroup_base_adicity: Optional[int] = None,
    ):
        if modulus < 3 or modulus % 2 == 0:
            raise ValueError("modulus must be an odd prime >= 3")
        self.modulus = modulus
        self.generator_int = generator % modulus
        self.name = name or f"Fp{modulus.bit_length()}"
        self.bits = modulus.bit_length()
        self.n64 = -(-self.bits // 64)
        self.num_limbs = 4 * self.n64
        self.r_bits = LIMB_BITS * self.num_limbs
        self.r_int = (1 << self.r_bits) % modulus
        self.r2_int = (self.r_int * self.r_int) % modulus
        # -p^-1 mod 2^16 and mod 2^32 (the kernels' 32-bit words), and mod R
        # (the plain reduction's whole-vector step)
        self.inv16 = (-pow(modulus, -1, 1 << 16)) % (1 << 16)
        self.inv32 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        self.p_inv_neg_r = (-pow(modulus, -1, 1 << self.r_bits)) % (1 << self.r_bits)  # -p^-1 mod R
        self._rinv = pow(self.r_int, -1, modulus)
        # 2-adicity: p - 1 = 2^s * t with t odd
        t = modulus - 1
        s = 0
        while t % 2 == 0:
            t //= 2
            s += 1
        self.two_adicity = s
        self.trace = t
        self.two_adic_root_int = pow(self.generator_int, t, modulus)
        # optional small subgroup of order q^b dividing p - 1 (mixed-radix
        # domains; zkarray/core/fieldspec.py:82-99)
        self.small_subgroup_base = small_subgroup_base
        self.small_subgroup_base_adicity = small_subgroup_base_adicity
        self.large_subgroup_root_int: Optional[int] = None
        if small_subgroup_base is not None:
            if small_subgroup_base_adicity is None:
                a, tt = 0, t
                while tt % small_subgroup_base == 0:
                    tt //= small_subgroup_base
                    a += 1
                self.small_subgroup_base_adicity = a
            full = (1 << s) * small_subgroup_base ** self.small_subgroup_base_adicity
            self.large_subgroup_root_int = pow(self.generator_int, (modulus - 1) // full, modulus)

        # square-root route (zkarray/core/fieldspec.py:105-126): one power
        # for p = 3 mod 4, Atkin's for p = 5 mod 8, else Tonelli-Shanks with
        # a certified quadratic non-residue (the generator when it is one)
        p = modulus
        if p % 4 == 3:
            self.sqrt_mode, self.sqrt_exp, self.sqrt_qnr = "3mod4", (p + 1) // 4, None
        elif p % 8 == 5:
            self.sqrt_mode, self.sqrt_exp, self.sqrt_qnr = "5mod8", (p + 3) // 8, 2
        else:
            qnr = self.generator_int
            if pow(qnr, (p - 1) // 2, p) != p - 1:
                qnr = 2
                while pow(qnr, (p - 1) // 2, p) != p - 1:
                    qnr += 1
            self.sqrt_mode, self.sqrt_exp, self.sqrt_qnr = "tonelli", (t - 1) // 2, qnr
        self.mod_minus_one_div_two = (p - 1) // 2
        # 2p < R: a product of canonical inputs needs no extra top limb
        self.has_spare_bit = (p << 1) < (1 << self.r_bits)

    def __hash__(self):
        return hash((self.modulus, self.generator_int))

    def __eq__(self, other):
        return (
            isinstance(other, FieldSpec)
            and self.modulus == other.modulus
            and self.generator_int == other.generator_int
        )

    def __repr__(self):
        return f"FieldSpec({self.name}, bits={self.bits}, L={self.num_limbs})"

    def limbs_of(self, x: int):
        """Little-endian base-2^16 limbs of ``x`` (L of them)."""
        return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(self.num_limbs)]

    @functools.cached_property
    def modulus_limbs(self) -> Tuple[int, ...]:
        return tuple(self.limbs_of(self.modulus))

    @functools.cached_property
    def r_limbs(self) -> Tuple[int, ...]:
        return tuple(self.limbs_of(self.r_int))

    @functools.cached_property
    def r2_limbs(self) -> Tuple[int, ...]:
        return tuple(self.limbs_of(self.r2_int))

    def to_mont_int(self, x: int) -> int:
        return (x * self.r_int) % self.modulus

    def from_mont_int(self, x: int) -> int:
        return (x * self._rinv) % self.modulus

    def root_of_unity(self, n: int) -> int:
        """Canonical n-th root of unity for n | 2^s (* q^b), or raise
        (zkarray/core/fieldspec.py:root_of_unity)."""
        if n <= 0:
            raise ValueError("n must be positive")
        k = (n & -n).bit_length() - 1
        rest = n >> k
        if rest == 1:
            if k > self.two_adicity:
                raise ValueError(f"no 2^{k}-th root of unity in {self.name}")
            w = self.two_adic_root_int
            for _ in range(self.two_adicity - k):
                w = (w * w) % self.modulus
            return w
        if self.small_subgroup_base is None:
            raise ValueError(f"domain size {n} unsupported in {self.name}")
        q, a = self.small_subgroup_base, 0
        while rest % q == 0:
            rest //= q
            a += 1
        if rest != 1 or a > self.small_subgroup_base_adicity or k > self.two_adicity:
            raise ValueError(f"domain size {n} unsupported in {self.name}")
        e = (1 << (self.two_adicity - k)) * q ** (self.small_subgroup_base_adicity - a)
        return pow(self.large_subgroup_root_int, e, self.modulus)
