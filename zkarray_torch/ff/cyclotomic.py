"""Cyclotomic-subgroup arithmetic for the pairing's target field.

Counterpart of zkarray/ff/cyclotomic.py: the fast inverse (the conjugate,
for quadratic-topped towers) and the Granger-Scott cyclotomic square for
2over3over2 degree-12 towers (6 Fp2 products, 18 Fp products in one
mont_mul launch, in place of a full square; its additions are two fp_lin
launches, the route ff/linmap.py derives from ``_gs_sched``). After the
easy part of the final exponentiation the Miller value lies in the
cyclotomic subgroup, where these apply.

The powers by a constant exponent run the JAX package's ladders bit by
bit, but where the JAX package computes the product on every bit and
selects, these compute it only on the bits that keep it: the select keeps
the square where a bit is clear (or a digit is 0), so the words are the
same, and |X| of BLS12-381 costs 5 products instead of 63.
"""

from __future__ import annotations

from zkarray_torch.ff import linmap


def char_sq_mod_6_is_one(modulus: int) -> bool:
    """p^2 = 1 (mod 6): where the Granger-Scott square applies."""
    return (modulus * modulus) % 6 == 1


def gs_cyclotomic_sqr(fq12, f):
    """Granger-Scott cyclotomic square in an Fp12 = 2over3over2 tower; ``f``
    must lie in the cyclotomic subgroup: fp_lin -> mont_mul -> fp_lin."""
    return linmap.run(fq12, "gs_sqr", _gs_sched, (f,), (fq12,))


def _gs_sched(fq12, f):
    """The schedule: the coefficient shuffle (r0, r4, r3, r2, r1, r5) is the
    reference's z-ordering."""
    fq6 = fq12.base
    B = fq6.base  # Fp2
    nr = fq6.mul_nonresidue

    r0, r4, r3 = f[0][0], f[0][1], f[0][2]
    r2, r1, r5 = f[1][0], f[1][1], f[1][2]

    def fp4_ops(a, b):
        return [(a, b), (B.add(a, b), B.add(nr(b), a))]

    m01, s01, m23, s23, m45, s45 = fq6._mul_many(fp4_ops(r0, r1) + fp4_ops(r2, r3)
                                                 + fp4_ops(r4, r5))

    def fp4_out(tmp, smul):
        return B.sub(B.sub(smul, tmp), nr(tmp)), B.double(tmp)

    t0, t1 = fp4_out(m01, s01)
    t2, t3 = fp4_out(m23, s23)
    t4, t5 = fp4_out(m45, s45)

    z0 = B.add(B.double(B.sub(t0, r0)), t0)  # 3 t0 - 2 r0
    z1 = B.add(B.double(B.add(t1, r1)), t1)  # 3 t1 + 2 r1
    xt5 = nr(t5)
    z2 = B.add(B.double(B.add(xt5, r2)), xt5)  # 3 xi t5 + 2 r2
    z3 = B.add(B.double(B.sub(t4, r3)), t4)  # 3 t4 - 2 r3
    z4 = B.add(B.double(B.sub(t2, r4)), t2)  # 3 t2 - 2 r4
    z5 = B.add(B.double(B.add(t3, r5)), t3)  # 3 t3 + 2 r5
    return fq12._stack([fq6._stack([z0, z4, z3]), fq6._stack([z2, z1, z5])])


def cyclotomic_sqr(ext, f):
    """Granger-Scott when the tower is 2over3over2 and p^2 = 1 mod 6, else
    a plain square."""
    if (ext.deg == 2 and getattr(ext.base, "deg", 0) == 3
            and getattr(ext.base.base, "deg", 0) == 2 and char_sq_mod_6_is_one(ext.spec.modulus)):
        return gs_cyclotomic_sqr(ext, f)
    return ext.sqr(f)


def cyclotomic_inverse(ext, f):
    """The conjugate: the inverse inside the cyclotomic subgroup."""
    return ext.conjugate(f)


def find_naf(e: int):
    """Signed NAF digits, low first (reference find_naf)."""
    digits = []
    while e > 0:
        if e & 1:
            z = 2 - (e % 4)
            e -= z
            digits.append(z)
        else:
            digits.append(0)
        e >>= 1
    return digits


def cyclotomic_exp(ext, f, e: int):
    """f^e for a constant e >= 0 by the NAF ladder (cyclotomic squares, the
    conjugate for a negative digit); ``f`` in the cyclotomic subgroup. A zero
    digit keeps the square, so no product is computed there. The top digit
    is 1, and the ladder's first square and product of 1 give f itself."""
    if e == 0:
        return ext.one(ext.batch_shape_of(f), f.device)
    finv = cyclotomic_inverse(ext, f)
    r = f
    for d in find_naf(e)[::-1][1:]:
        r = cyclotomic_sqr(ext, r)
        if d > 0:
            r = ext.mul(r, f)
        elif d < 0:
            r = ext.mul(r, finv)
    return r


def cyclotomic_exp_binary(ext, f, e: int):
    """f^e by binary square-and-multiply with cyclotomic squares, high bit
    first, a product only on the set bits (the leading bit's square and
    product of 1 give f itself)."""
    if e == 0:
        return ext.one(ext.batch_shape_of(f), f.device)
    r = f
    for bit in bin(e)[3:]:
        r = cyclotomic_sqr(ext, r)
        if bit == "1":
            r = ext.mul(r, f)
    return r
