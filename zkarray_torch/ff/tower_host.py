"""Host-side extension-field arithmetic over Python ints: constant
generation only (Frobenius coefficient tables, nonresidue powers) and the
host known answers of the tests and chip_smoke.py. Not a compute path.

The port's own copy of zkarray/ff/tower_host.py (the port imports nothing of
the JAX package). For F = B[u]/(u^d - beta), Frob^i(u) = beta^((p^i - 1)/d) u.

Elements: level 0 = int (canonical); extension = tuple of d base elements.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

Elem = Union[int, Tuple]


class HostPrime:
    def __init__(self, p: int):
        self.p = p
        self.degree = 1  # absolute degree over the prime field

    def zero(self):
        return 0

    def one(self):
        return 1

    def embed(self, x: int):
        return x % self.p

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def neg(self, a):
        return (-a) % self.p

    def mul(self, a, b):
        return (a * b) % self.p

    def inv(self, a):
        return pow(a, -1, self.p)

    def eq(self, a, b):
        return a % self.p == b % self.p

    def flatten(self, a) -> list:
        return [a % self.p]

    def frobenius(self, a, i: int):
        return a % self.p


class HostExt:
    """B[u]/(u^deg - nonresidue)."""

    def __init__(self, base, deg: int, nonresidue: Elem):
        self.base = base
        self.deg = deg
        self.nonresidue = nonresidue
        self.degree = base.degree * deg
        self.p = base.p

    def zero(self):
        return tuple(self.base.zero() for _ in range(self.deg))

    def one(self):
        return (self.base.one(),) + tuple(self.base.zero() for _ in range(self.deg - 1))

    def embed(self, x: int):
        return (self.base.embed(x),) + tuple(
            self.base.zero() for _ in range(self.deg - 1)
        )

    def lift(self, a) -> "Elem":
        """Element of base -> element here (constant embedding)."""
        return (a,) + tuple(self.base.zero() for _ in range(self.deg - 1))

    def add(self, a, b):
        return tuple(self.base.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        return tuple(self.base.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        return tuple(self.base.neg(x) for x in a)

    def mul(self, a, b):
        d = self.deg
        acc = [self.base.zero() for _ in range(2 * d - 1)]
        for i in range(d):
            for j in range(d):
                acc[i + j] = self.base.add(acc[i + j], self.base.mul(a[i], b[j]))
        # reduce u^k for k >= d: u^k = β·u^(k-d)
        for k in range(2 * d - 2, d - 1, -1):
            acc[k - d] = self.base.add(
                acc[k - d], self.base.mul(acc[k], self.nonresidue)
            )
        return tuple(acc[:d])

    def mul_scalar(self, a, s: Elem):
        """a · s with s an element of base."""
        return tuple(self.base.mul(x, s) for x in a)

    def pow(self, a, e: int):
        r = self.one()
        base = a
        while e:
            if e & 1:
                r = self.mul(r, base)
            base = self.mul(base, base)
            e >>= 1
        return r

    def inv(self, a):
        """a^-1 (0 -> 0) through the norm, one inverse in the base (down to
        Python's pow(x, -1, p)), as arkworks' QuadExtField/CubicExtField
        inverse: degree 2 is conj(a) / (a0^2 - beta a1^2); degree 3 the
        adjugate (a0^2 - beta a1 a2, beta a2^2 - a0 a1, a1^2 - a0 a2) over
        a0 c0 + beta (a2 c1 + a1 c2). The inverse is unique, so it equals
        the JAX package's Fermat power a^(p^k - 2) (tower_host.py there),
        at a small fraction of its cost (a 782-bit Fq3 element: ~132 ms by
        Fermat on a CPU)."""
        B = self.base
        beta = self.nonresidue
        if self.deg == 2:
            a0, a1 = a
            norm = B.sub(B.mul(a0, a0), B.mul(beta, B.mul(a1, a1)))
            if B.eq(norm, B.zero()):
                return self.zero()
            ninv = B.inv(norm)
            return (B.mul(a0, ninv), B.neg(B.mul(a1, ninv)))
        a0, a1, a2 = a
        c0 = B.sub(B.mul(a0, a0), B.mul(beta, B.mul(a1, a2)))
        c1 = B.sub(B.mul(beta, B.mul(a2, a2)), B.mul(a0, a1))
        c2 = B.sub(B.mul(a1, a1), B.mul(a0, a2))
        det = B.add(B.mul(a0, c0), B.mul(beta, B.add(B.mul(a2, c1), B.mul(a1, c2))))
        if B.eq(det, B.zero()):
            return self.zero()
        dinv = B.inv(det)
        return (B.mul(c0, dinv), B.mul(c1, dinv), B.mul(c2, dinv))

    def inv_fermat(self, a):
        """a^(p^k - 2): the JAX package's route (0 -> 0), kept as the
        tests' reference for ``inv``."""
        return self.pow(a, self.p ** self.degree - 2)

    def eq(self, a, b):
        return all(self.base.eq(x, y) for x, y in zip(a, b))

    def flatten(self, a) -> list:
        """Nested tuples -> flat canonical int list (leading coeff axis order)."""
        out = []
        for x in a:
            out.extend(self.base.flatten(x))
        return out

    def frobenius_c1(self, i: int) -> Elem:
        """β^((p^i - 1)/deg) ∈ base — the u-coefficient multiplier of
        Frob^i at this level.

        Computed by the recurrence c1(i) = c1(i-1) · Frob^{i-1}(c1(1)) so only
        ONE pow with a ~log2(p)-bit exponent is needed per level (a naive
        β^((p^i-1)/deg) would need multi-thousand-bit host pows)."""
        if not hasattr(self, "_c1_memo"):
            self._c1_memo = {0: self.base.one()}
        memo = self._c1_memo
        if i in memo:
            return memo[i]
        if 1 not in memo:
            e1 = (self.p - 1) // self.deg
            if isinstance(self.base, HostPrime):
                memo[1] = pow(self.nonresidue, e1, self.p)
            else:
                memo[1] = self.base.pow(self.nonresidue, e1)
        for k in range(2, i + 1):
            if k not in memo:
                # Frob^{k-1} over a prime base is the identity
                memo[k] = self.base.mul(
                    memo[k - 1], self.base.frobenius(memo[1], k - 1)
                )
        return memo[i]

    def frobenius(self, a, i: int):
        """Frob^i(Σ a_j u^j) = Σ Frob^i(a_j) · c1(i)^j · u^j."""
        if i == 0:
            return a
        c1 = self.frobenius_c1(i)
        out = []
        cj = self.base.one()
        for j in range(self.deg):
            aj = self.base.frobenius(a[j], i)
            if j > 0:
                cj = self.base.mul(cj, c1)
                aj = self.base.mul(aj, cj)
            out.append(aj)
        return tuple(out)
