"""Sparse Fp12/Fp6 products for the pairing's line evaluations.

Counterpart of zkarray/ff/sparse12.py: multiplying the Miller-loop value by
a line whose Fp12 form has only the coefficients {0, 1, 4} (M-twist) or
{0, 3, 4} (D-twist) costs 13 Fp2 products instead of 18. Each public
function is one operation on ff/linmap.py's route, derived from its
schedule (the ``_``-prefixed functions): fp_lin -> one mont_mul -> fp_lin.
"""

from __future__ import annotations

from zkarray_torch.ff import linmap


def _by_1(fq6, a, c1):
    p2, p0, p1 = fq6._mul_many([(a[2], c1), (a[0], c1), (a[1], c1)])
    return fq6._stack([fq6.mul_nonresidue(p2), p0, p1])


def _by_01(fq6, a, c0, c1):
    B = fq6.base
    v0, v1, m12, m01, m02 = fq6._mul_many([
        (a[0], c0),
        (a[1], c1),
        (B.add(a[1], a[2]), c1),
        (B.add(a[0], a[1]), B.add(c0, c1)),
        (B.add(a[0], a[2]), c0),
    ])
    r0 = B.add(v0, fq6.mul_nonresidue(B.sub(m12, v1)))
    r1 = B.sub(B.sub(m01, v0), v1)
    r2 = B.add(B.sub(m02, v0), v1)
    return fq6._stack([r0, r1, r2])


def _by_fp2(fq6, a, c0):
    return fq6._stack(fq6._mul_many([(a[j], c0) for j in range(3)]))


def _by_014(fq12, f, c0, c1, c4):
    fq6 = fq12.base
    a0, a1 = f[0], f[1]
    v0 = _by_01(fq6, a0, c0, c1)
    v1 = _by_1(fq6, a1, c4)
    t = _by_01(fq6, fq6.add(a0, a1), c0, fq6.base.add(c1, c4))
    r1 = fq6.sub(fq6.sub(t, v0), v1)
    r0 = fq6.add(v0, fq12.mul_nonresidue(v1))
    return fq12._stack([r0, r1])


def _by_034(fq12, f, c0, c3, c4):
    fq6 = fq12.base
    a0, a1 = f[0], f[1]
    v0 = _by_fp2(fq6, a0, c0)
    v1 = _by_01(fq6, a1, c3, c4)
    t = _by_01(fq6, fq6.add(a0, a1), fq6.base.add(c0, c3), c4)
    r1 = fq6.sub(fq6.sub(t, v0), v1)
    r0 = fq6.add(v0, fq12.mul_nonresidue(v1))
    return fq12._stack([r0, r1])


def fp6_mul_by_1(fq6, a, c1):
    """a * (0, c1, 0): 3 base products."""
    return linmap.run(fq6, "mul_by_1", _by_1, (a, c1), (fq6, fq6.base))


def fp6_mul_by_01(fq6, a, c0, c1):
    """a * (c0, c1, 0): 5 base products (reference fp6_3over2.rs mul_by_01)."""
    return linmap.run(fq6, "mul_by_01", _by_01, (a, c0, c1), (fq6, fq6.base, fq6.base))


def fp6_mul_by_fp2(fq6, a, c0):
    """a * (c0, 0, 0): 3 base products."""
    return linmap.run(fq6, "mul_by_fp2", _by_fp2, (a, c0), (fq6, fq6.base))


def fp12_mul_by_014(fq12, f, c0, c1, c4):
    """f * [(c0, c1, 0) + (0, c4, 0) w]: the M-twist line (13 Fp2 products)."""
    F2 = fq12.base.base
    return linmap.run(fq12, "mul_by_014", _by_014, (f, c0, c1, c4), (fq12, F2, F2, F2))


def fp12_mul_by_034(fq12, f, c0, c3, c4):
    """f * [(c0, 0, 0) + (c3, c4, 0) w]: the D-twist line (13 Fp2 products)."""
    F2 = fq12.base.base
    return linmap.run(fq12, "mul_by_034", _by_034, (f, c0, c3, c4), (fq12, F2, F2, F2))
