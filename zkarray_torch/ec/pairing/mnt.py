"""MNT-family pairing helpers.

Counterpart of zkarray/ec/pairing/mnt.py, so far only ``ext_pow_const``,
which the BW6 final exponentiation takes from there as the JAX package's
does (zkarray/ec/pairing/bw6.py:_cyc_pow). The MNT4/MNT6 engine itself (its
Miller loop, final exponentiation and curve specs) joins this file in a
later slice.
"""

from __future__ import annotations


def ext_pow_const(ops, a, e: int):
    """a^e for a host exponent e >= 0 over any tower: square-and-multiply,
    high bit first. Where the JAX package multiplies on every bit and
    selects, this multiplies on the set bits only: the select keeps the
    square on a clear bit, and the leading bit's square and product of 1
    give a itself, so the words are the same."""
    if e == 0:
        return ops.one(ops.batch_shape_of(a), a.device)
    r = a
    for bit in bin(e)[3:]:
        r = ops.sqr(r)
        if bit == "1":
            r = ops.mul(r, a)
    return r
