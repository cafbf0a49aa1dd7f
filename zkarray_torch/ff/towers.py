"""Extension-field towers as leading-axis coefficient stacks.

Counterpart of zkarray/ff/towers.py. An element of a degree-d extension is
a tensor of shape (d,) + base.shape + (L, *batch): an Fp12 element is
(2, 3, 2, L, *batch), the JAX package's layout, so arrays compare directly.
Products keep the JAX package's schedules (Karatsuba for quadratic levels,
the 6-product Toom-style schedule for cubic ones, the complex and CH-SQR2
squarings; ``_mul_sched``, ``_sqr_sched``, ``_mul_base_sched``), and every
base-field product of one tower product is computed by ONE ``mont_mul``
launch. The schedules are not run on tensors: ff/linmap.py traces each
once per tower into the linear map before the products (their operands)
and the one after them (the result), so ``mul``, ``sqr`` and ``mul_base``
are fp_lin -> mont_mul -> fp_lin, three launches (kernels/lin.py; the same
route on the CPU through the plain versions), where the schedule on tensors
issued ~30 fp_add/fp_sub launches and ~13 stacks around its mont_mul for an
Fp12 product. ``mul_base`` over a prime field needs no map: its operands
and products are strided views, one mont_mul. ``_mul_many`` (the direct
callers' fold: Frobenius, MNT's ladder) still stacks its operands.

Linear ops (``add``, ``sub``, ``neg``, ``double``, ``select``) run as one
call over the whole element: the coefficient axes are moved behind the limb
axis into the batch, a view that ``fp.add``/``fp.sub`` (one csrc/fadd.cu
launch each on a CUDA device) read and write in place through the kernels'
operand map. Where the JAX package recurses to one ``fp.add`` per
coefficient (12 for an Fp12 add), this is one launch.

Values that are fully reduced field elements may be computed by another
exact route than the JAX package's, with the same words: Fp12's
multiplication by its nonresidue v is a coefficient shuffle plus the Fp6
hook here, where the JAX package multiplies by v as a full Fp6 product, and
a tower product's additions are one map.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ff import fp
from zkarray_torch.ff.tower_host import HostExt, HostPrime


def _batch_ndim(x: torch.Tensor, k: int) -> int:
    return x.dim() - k - 1  # batch axes of an element with k coefficient axes


def _pad_batch(xs, k: int):
    """Pad each tensor's batch axes with trailing 1s to one count (the JAX
    package's trailing alignment, so a ()-batch constant meets an (n,) batch)."""
    nb = max(_batch_ndim(x, k) for x in xs)
    return [x.reshape(tuple(x.shape) + (1,) * (nb - _batch_ndim(x, k))) for x in xs]


class PrimeOps:
    """Bottom of the tower: the prime field (shape prefix ())."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.deg_abs = 1
        self.shape = ()
        self.host = HostPrime(spec.modulus)
        self.name = spec.name

    def __hash__(self):
        return hash(("prime", self.spec))

    def __eq__(self, o):
        return isinstance(o, PrimeOps) and o.spec == self.spec

    def __repr__(self):
        return f"PrimeOps({self.name})"

    # tensors (L, *batch)
    def add(self, a, b):
        return fp.add(self.spec, a, b)

    def sub(self, a, b):
        return fp.sub(self.spec, a, b)

    def neg(self, a):
        return fp.neg(self.spec, a)

    def double(self, a):
        return fp.double(self.spec, a)

    def mul(self, a, b):
        return fp.mont_mul(self.spec, a, b)

    def sqr(self, a):
        return fp.mont_sqr(self.spec, a)

    def inv(self, a):
        return fp.inv(self.spec, a)

    def batch_inv(self, a):
        return fp.batch_inv(self.spec, a)

    def zero(self, batch_shape=(), device=DEFAULT_DEVICE):
        return fp.zero(self.spec, batch_shape, device)

    def one(self, batch_shape=(), device=DEFAULT_DEVICE):
        return fp.one(self.spec, batch_shape, device)

    def const(self, host_elem: int, batch_shape=(), device=DEFAULT_DEVICE):
        return fp.const_array(self.spec, host_elem, batch_shape, device)

    def mul_const(self, a, host_elem: int):
        if host_elem % self.spec.modulus == self.spec.modulus - 1:
            return fp.neg(self.spec, a)
        return fp.mont_mul(self.spec, a, fp.const_array(self.spec, host_elem, (), a.device))

    def frobenius(self, a, i: int):
        return a  # the identity on the prime field

    def is_zero(self, a):
        return fp.is_zero(self.spec, a)

    def eq(self, a, b):
        return fp.eq(a, b)

    def select(self, mask, a, b):
        return fp.select(mask, a, b)

    def batch_shape_of(self, a):
        return tuple(a.shape[1:])

    def to_ints(self, a):
        return fp.to_ints(self.spec, a)

    def from_ints(self, xs, device=DEFAULT_DEVICE):
        return fp.from_ints(self.spec, xs, device=device)


class ExtOps:
    """Degree-``deg`` extension of ``base`` by u^deg = nonresidue.

    Tensors: (deg,) + base.shape + (L, *batch). ``nonresidue_host`` is a host
    element of the base field (canonical nested tuples / int).
    """

    def __init__(self, name: str, base, deg: int, nonresidue_host,
                 mul_nonresidue_hook: Optional[Callable] = None):
        assert deg in (2, 3)
        self.name = name
        self.base = base
        self.deg = deg
        self.deg_abs = deg * base.deg_abs
        self.shape = (deg,) + base.shape
        self.spec = base.spec  # the prime field at the bottom
        self.nonresidue_host = nonresidue_host
        self._nr_hook = mul_nonresidue_hook
        self.host = HostExt(base.host, deg, nonresidue_host)
        # Frobenius tables: C_j[i] = beta^(j (p^i - 1)/deg) (base elements), j < deg
        self._frob = []
        for i in range(self.deg_abs):
            c1 = self.host.frobenius_c1(i)
            row = [base.host.one()]
            for _ in range(1, deg):
                row.append(base.host.mul(row[-1], c1))
            self._frob.append(row)

    def __hash__(self):
        return hash(("ext", self.name, self.base, self.deg))

    def __eq__(self, o):
        return isinstance(o, ExtOps) and (o.name, o.deg, o.base) == (self.name, self.deg, self.base)

    def __repr__(self):
        return f"ExtOps({self.name})"

    # ---- structure ----

    def _stack(self, parts):
        return torch.stack(parts, dim=0)

    def zero(self, batch_shape=(), device=DEFAULT_DEVICE):
        return self._stack([self.base.zero(batch_shape, device)] * self.deg)

    def one(self, batch_shape=(), device=DEFAULT_DEVICE):
        return self._stack([self.base.one(batch_shape, device)]
                           + [self.base.zero(batch_shape, device)] * (self.deg - 1))

    def const(self, host_elem, batch_shape=(), device=DEFAULT_DEVICE):
        return self._stack([self.base.const(c, batch_shape, device) for c in host_elem])

    def batch_shape_of(self, a):
        return tuple(a.shape[len(self.shape) + 1:])

    def to_ints(self, a):
        """-> coefficient-major nested lists of canonical int lists."""
        return [self.base.to_ints(a[j]) for j in range(self.deg)]

    def from_ints(self, nested, device=DEFAULT_DEVICE):
        """Nested lists (coefficient-major) of canonical ints -> tensor."""
        return self._stack([self.base.from_ints(c, device) for c in nested])

    # ---- linear ops: one call over the whole element ----

    def _lin(self, fn, *xs):
        """fn(spec, *views, out=view) over the coefficient axes folded into
        the batch: (c..., L, *batch) is read as the (L, c..., *batch) view,
        and the result is written into a new contiguous (c..., L, *batch)."""
        k = len(self.shape)
        vs = [x.movedim(k, 0) for x in _pad_batch(xs, k)]
        shape = vs[0].shape
        if any(v.shape != shape for v in vs[1:]):  # broadcast_shapes costs host time
            shape = torch.broadcast_shapes(*(v.shape for v in vs))
        out = torch.empty(tuple(shape[1:k + 1]) + (shape[0],) + tuple(shape[k + 1:]),
                          dtype=torch.int32, device=xs[0].device)
        fn(self.spec, *vs, out=out.movedim(k, 0))
        return out

    def add(self, a, b):
        return self._lin(fp.add, a, b)

    def sub(self, a, b):
        return self._lin(fp.sub, a, b)

    def neg(self, a):
        return self._lin(fp.neg, a)

    def double(self, a):
        return self._lin(fp.double, a)

    def select(self, mask, a, b):
        return torch.where(mask.reshape((1,) * (len(self.shape) + 1) + tuple(mask.shape)), a, b)

    def mul_base(self, a, s):
        """a * s with s a base-field tensor. Over a prime field, one
        mont_mul of a's coefficients (an (L, deg, *batch) view) by s, the
        result a (deg, L, *batch) view of its output; else the traced route
        of ``_mul_base_sched``."""
        if isinstance(self.base, PrimeOps):
            a, s = _pad_batch([a, s[None]], 1)  # a ()-batch constant meets an (n,) batch
            return fp.mont_mul(self.spec, a.movedim(0, 1), s.movedim(0, 1)).movedim(1, 0)
        return linmap.run(self, "mul_base", ExtOps._mul_base_sched, (a, s), (self, self.base))

    def _mul_base_sched(self, a, s):
        return self._stack(self._mul_many([(a[j], s) for j in range(self.deg)]))

    def mul_nonresidue(self, x):
        """x * beta for x a BASE-field tensor (hot path in mul and sqr)."""
        if self._nr_hook is not None:
            return self._nr_hook(self.base, x)
        if not isinstance(self.base, ExtOps):
            return self.base.mul_const(x, self.nonresidue_host)
        return self.base.mul(x, self.base.const(self.nonresidue_host, (), x.device))

    def mul_const(self, a, host_elem):
        """a * c for a host constant c of THIS field."""
        return self.mul(a, self.const(host_elem, (), a.device))

    # ---- multiplication and squaring ----

    def _mul_many(self, pairs):
        """k base-level products as ONE recursive product (the schedules'
        fold; on tensors only where a caller runs it directly): the operands are
        aligned to one batch shape (a ()-batch constant meets an (n,)-batch
        coordinate without an (n, n) cross product) and stacked on a fresh
        batch axis, so the whole tower product bottoms out in one mont_mul."""
        B = self.base
        ax = len(B.shape) + 1  # after the base's coefficient axes and the limb axis
        ops = [p[i] for p in pairs for i in (0, 1)]
        if any(o.shape != ops[0].shape for o in ops[1:]):
            nb = max(o.dim() - ax for o in ops)
            ops = [o.reshape(tuple(o.shape) + (1,) * (nb - (o.dim() - ax))) for o in ops]
            batch = torch.broadcast_shapes(*(tuple(o.shape[ax:]) for o in ops))
            ops = [o.expand(tuple(o.shape[:ax]) + tuple(batch)) for o in ops]
        xs = torch.stack(ops[0::2], dim=ax)
        ys = torch.stack(ops[1::2], dim=ax)
        prod = B.mul(xs, ys)
        return [prod.select(ax, i) for i in range(len(pairs))]

    def mul(self, a, b):
        """a * b: fp_lin -> mont_mul -> fp_lin, the route of ``_mul_sched``."""
        return linmap.run(self, "mul", ExtOps._mul_sched, (a, b), (self, self))

    def sqr(self, a):
        """a^2: the route of ``_sqr_sched``."""
        return linmap.run(self, "sqr", ExtOps._sqr_sched, (a,), (self,))

    def _mul_sched(self, a, b):
        B = self.base
        if self.deg == 2:
            # Karatsuba (reference quadratic_extension.rs mul)
            v0, v1, v01 = self._mul_many([(a[0], b[0]), (a[1], b[1]),
                                          (B.add(a[0], a[1]), B.add(b[0], b[1]))])
            c0 = B.add(v0, self.mul_nonresidue(v1))
            c1 = B.sub(B.sub(v01, v0), v1)
            return self._stack([c0, c1])
        # cubic: 6-product Toom-style (reference cubic_extension.rs mul)
        v0, v1, v2, m12, m01, m02 = self._mul_many([
            (a[0], b[0]), (a[1], b[1]), (a[2], b[2]),
            (B.add(a[1], a[2]), B.add(b[1], b[2])),
            (B.add(a[0], a[1]), B.add(b[0], b[1])),
            (B.add(a[0], a[2]), B.add(b[0], b[2])),
        ])
        c0 = B.add(v0, self.mul_nonresidue(B.sub(B.sub(m12, v1), v2)))
        c1 = B.add(B.sub(B.sub(m01, v0), v1), self.mul_nonresidue(v2))
        c2 = B.add(B.sub(B.sub(m02, v0), v2), v1)
        return self._stack([c0, c1, c2])

    def _sqr_sched(self, a):
        B = self.base
        if self.deg == 2:
            # complex squaring: 2 base products (reference square_in_place)
            v, t = self._mul_many([(a[0], a[1]),
                                   (B.add(a[0], a[1]), B.add(a[0], self.mul_nonresidue(a[1])))])
            c0 = B.sub(B.sub(t, v), self.mul_nonresidue(v))
            c1 = B.double(v)
            return self._stack([c0, c1])
        # CH-SQR2 (reference cubic_extension.rs square_in_place)
        m = B.add(B.sub(a[0], a[1]), a[2])
        s0, ab, s2, bc, s4 = self._mul_many(
            [(a[0], a[0]), (a[0], a[1]), (m, m), (a[1], a[2]), (a[2], a[2])])
        s1 = B.double(ab)
        s3 = B.double(bc)
        c0 = B.add(s0, self.mul_nonresidue(s3))
        c1 = B.add(s1, self.mul_nonresidue(s4))
        c2 = B.sub(B.add(B.add(s1, s2), s3), B.add(s0, s4))
        return self._stack([c0, c1, c2])

    # ---- inversion (inv(0) = 0 through the tower) ----

    def inv(self, a):
        B = self.base
        if self.deg == 2:
            # norm = c0^2 - beta c1^2 (reference quadratic_extension.rs)
            norm = B.sub(B.sqr(a[0]), self.mul_nonresidue(B.sqr(a[1])))
            ninv = B.inv(norm)
            return self._stack([B.mul(a[0], ninv), B.neg(B.mul(a[1], ninv))])
        # cubic (reference cubic_extension.rs inverse)
        t0, t1, t2 = B.sqr(a[0]), B.sqr(a[1]), B.sqr(a[2])
        t3, t4, t5 = B.mul(a[0], a[1]), B.mul(a[0], a[2]), B.mul(a[1], a[2])
        n0 = B.sub(t0, self.mul_nonresidue(t5))
        n1 = B.sub(self.mul_nonresidue(t2), t3)
        n2 = B.sub(t1, t4)
        det = B.add(B.mul(a[0], n0),
                    self.mul_nonresidue(B.add(B.mul(a[2], n1), B.mul(a[1], n2))))
        dinv = B.inv(det)
        return self._stack([B.mul(n0, dinv), B.mul(n1, dinv), B.mul(n2, dinv)])

    # ---- Frobenius and conjugation ----

    def frobenius(self, a, i: int):
        """a^(p^i), with the coefficient tables."""
        i = i % self.deg_abs
        parts = [self.base.frobenius(a[j], i) for j in range(self.deg)]
        if isinstance(self.base, PrimeOps):
            for j in range(1, self.deg):
                parts[j] = self.base.mul_const(parts[j], self._frob[i][j])
        else:
            dev = a.device
            parts[1:] = self._mul_many([(parts[j], self.base.const(self._frob[i][j], (), dev))
                                        for j in range(1, self.deg)])
        return self._stack(parts)

    def conjugate(self, a):
        """Quadratic conjugate (a0, -a1): the cyclotomic inverse."""
        assert self.deg == 2
        return self._stack([a[0], self.base.neg(a[1])])

    # ---- predicates ----

    def is_zero(self, a):
        return (a == 0).flatten(0, len(self.shape)).all(dim=0)

    def eq(self, a, b):
        return (a == b).flatten(0, len(self.shape)).all(dim=0)


def combine_pairs(ext, f):
    """Product over the pairs axis (the last) of tower elements, in a log
    tree: halves are multiplied, an odd element carried by concatenation
    (the JAX package's order in every pairing family's Miller loop)."""
    n = f.shape[-1]
    while n > 1:
        h = n // 2
        red = ext.mul(f[..., :h], f[..., h:2 * h])
        if n % 2:
            red = torch.cat([red, f[..., 2 * h:]], dim=-1)
            n = h + 1
        else:
            n = h
        f = red
    return f[..., 0]


def mul_by_cubic_generator(cubic: ExtOps, x):
    """x u for x in a cubic extension by u^3 = beta: the coefficient shuffle
    (beta x2, x0, x1). It is the nonresidue product of a quadratic extension
    whose nonresidue is that cubic's generator (Fp12 = Fp6[w]/(w^2 - v);
    BW6's Fp6 = Fp3[v]/(v^2 - u)), where the JAX package multiplies by the
    generator in full; the words are the same."""
    return cubic._stack([cubic.mul_nonresidue(x[2]), x[0], x[1]])


def mul_by_quadratic_generator(quad: ExtOps, x):
    """x u for x in a quadratic extension by u^2 = beta: the shuffle
    (beta x1, x0). It is the nonresidue product of a quadratic extension
    whose nonresidue is that field's generator (MNT4's Fq4 = Fq2[v]/(v^2 -
    u)), where the JAX package multiplies by (0, 1) in full; the words are
    the same."""
    return quad._stack([quad.mul_nonresidue(x[1]), x[0]])


def quad_sqrt(F2: ExtOps, a):
    """Batched square root in Fp2 = Fp[u]/(u^2 - beta) over a prime field:
    ``(root, is_square mask)``, root 0 where ``a`` is not a square
    (zkarray/ff/towers.py:quad_sqrt, the same root). With n = a0^2 - beta
    a1^2 and d = sqrt(n): x0 = sqrt((a0 + d)/2) (or sqrt((a0 - d)/2)), x1 =
    a1/(2 x0); a1 = 0 takes (sqrt(a0), 0) or (0, sqrt(a0/beta)). The root is
    checked by squaring."""
    assert F2.deg == 2 and isinstance(F2.base, PrimeOps)
    spec = F2.spec
    p = spec.modulus
    beta = F2.nonresidue_host
    a0, a1 = a[0], a[1]
    batch, dev = tuple(a0.shape[1:]), a0.device

    n = fp.sub(spec, fp.mont_sqr(spec, a0),
               fp.mont_mul(spec, fp.mont_sqr(spec, a1), fp.const_array(spec, beta % p, (), dev)))
    d, _ = fp.sqrt(spec, n)
    half = fp.const_array(spec, pow(2, -1, p), (), dev)
    r1, ok1 = fp.sqrt(spec, fp.mont_mul(spec, fp.add(spec, a0, d), half))
    r2, _ = fp.sqrt(spec, fp.mont_mul(spec, fp.sub(spec, a0, d), half))
    x0 = fp.select(ok1, r1, r2)
    x1 = fp.mont_mul(spec, a1, fp.inv(spec, fp.double(spec, x0)))

    ra, a0_sq = fp.sqrt(spec, a0)
    rb, _ = fp.sqrt(spec, fp.mont_mul(spec, a0, fp.const_array(spec, pow(beta % p, -1, p), (), dev)))
    a1z = fp.is_zero(spec, a1)
    z = fp.zero(spec, batch, dev)
    c0 = fp.select(a1z, fp.select(a0_sq, ra, z), x0)
    c1 = fp.select(a1z, fp.select(a0_sq, z, rb), x1)
    cand = torch.stack([c0, c1])
    ok = F2.eq(F2.sqr(cand), a)
    return F2.select(ok, cand, F2.zero(batch, dev)), ok


from zkarray_torch.ff import linmap  # noqa: E402  (linmap subclasses ExtOps)
