"""BLS12-family pairing engine, batched over the pairs axis.

Counterpart of zkarray/ec/pairing/bls12.py: the X-parameterized Miller loop
over G2 line coefficients that a doubling/addition ladder in homogeneous
projective coordinates precomputes (eprint 2013/722 formulas, which fix the
projective scaling of every line coefficient and so the Miller loop's
output word for word), sparse Fp12 line products by twist type, and the
eprint 2020/875 final exponentiation (gurvy schedule). Every step is one
batched tower op across all pairs; the per-pair values combine in a log
tree at the end.

Where the JAX package computes the ladder's add step on every bit of |X|
and selects (a lax.scan), this runs it only on the set bits: the select
keeps the doubled state and the line value where a bit is clear, so the
result is the same. ``G2Prepared.add_coeffs`` therefore holds the add-step
coefficients of the set bits only (5 for BLS12-381, where the JAX package
keeps 63 slots).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from zkarray_torch.ec.sw import AffinePoints
from zkarray_torch.ec.pairing.mnt import ext_pow_const
from zkarray_torch.ec.sw_ext import ExtAffine, ExtCurveSpec
from zkarray_torch.ff import cyclotomic as cyc
from zkarray_torch.ff import fp
from zkarray_torch.ff.sparse12 import fp12_mul_by_014, fp12_mul_by_034
from zkarray_torch.ff.towers import combine_pairs


class Bls12Spec:
    def __init__(self, name, x: int, twist_type: str, fq_spec, fq2, fq6, fq12, g1_curve,
                 g2_curve: ExtCurveSpec):
        assert twist_type in ("M", "D")
        self.name = name
        self.x = x
        self.x_abs = abs(x)
        self.x_neg = x < 0
        self.twist_type = twist_type
        self.fq = fq_spec
        self.fq2 = fq2
        self.fq6 = fq6
        self.fq12 = fq12
        self.g1 = g1_curve
        self.g2 = g2_curve
        self.two_inv_int = pow(2, -1, fq_spec.modulus)
        # bits of |X| below the leading one, high first
        self.x_bits = [int(b) for b in bin(self.x_abs)[3:]]
        self.add_bits = [i for i, b in enumerate(self.x_bits) if b]

    def __hash__(self):
        return hash((self.name, self.x))

    def __eq__(self, o):
        return isinstance(o, Bls12Spec) and o.name == self.name and o.x == self.x

    def __repr__(self):
        return f"Bls12Spec({self.name})"


class G2Prepared(NamedTuple):
    """Line coefficients of the |X| ladder: ``dbl_coeffs`` (nbits, 3, 2, L,
    *batch), one triple per bit below the leading one; ``add_coeffs``
    (len(add_bits), 3, 2, L, *batch), one triple per set bit, in
    ``Bls12Spec.add_bits`` order; ``inf`` the batch-shaped infinity mask."""
    dbl_coeffs: torch.Tensor
    add_coeffs: torch.Tensor
    inf: torch.Tensor


def _double_step(bspec, x, y, z):
    """One ladder doubling: the new (x, y, z) and the line coefficients
    (reference g2.rs double_in_place)."""
    F2 = bspec.fq2
    dev = x.device
    half = fp.const_array(bspec.fq, bspec.two_inv_int, (), dev)
    a = F2.mul_base(F2.mul(x, y), half)
    b = F2.sqr(y)
    c = F2.sqr(z)
    e = F2.mul(F2.const(bspec.g2.b_host, (), dev), F2.add(F2.double(c), c))
    f3 = F2.add(F2.double(e), e)
    g = F2.mul_base(F2.add(b, f3), half)
    h = F2.sub(F2.sqr(F2.add(y, z)), F2.add(b, c))
    i_ = F2.sub(e, b)
    j = F2.sqr(x)
    e2 = F2.sqr(e)
    xn = F2.mul(a, F2.sub(b, f3))
    yn = F2.sub(F2.sqr(g), F2.add(F2.double(e2), e2))
    zn = F2.mul(b, h)
    j3 = F2.add(F2.double(j), j)
    if bspec.twist_type == "M":
        coeffs = (i_, j3, F2.neg(h))
    else:
        coeffs = (F2.neg(h), j3, i_)
    return (xn, yn, zn), coeffs


def _add_step(bspec, x, y, z, qx, qy):
    """The ladder's mixed addition with its line coefficients (reference
    g2.rs add_in_place)."""
    F2 = bspec.fq2
    theta = F2.sub(y, F2.mul(qy, z))
    lam = F2.sub(x, F2.mul(qx, z))
    c = F2.sqr(theta)
    d = F2.sqr(lam)
    e = F2.mul(lam, d)
    f = F2.mul(z, c)
    g = F2.mul(x, d)
    h = F2.sub(F2.add(e, f), F2.double(g))
    xn = F2.mul(lam, h)
    yn = F2.sub(F2.mul(theta, F2.sub(g, h)), F2.mul(e, y))
    zn = F2.mul(z, e)
    j = F2.sub(F2.mul(theta, qx), F2.mul(lam, qy))
    if bspec.twist_type == "M":
        coeffs = (j, F2.neg(theta), lam)
    else:
        coeffs = (lam, F2.neg(theta), j)
    return (xn, yn, zn), coeffs


def g2_prepare(bspec: Bls12Spec, Q: ExtAffine) -> G2Prepared:
    """Run the |X| ladder once, collecting the line coefficients of each
    doubling and of each set bit's addition."""
    F2 = bspec.fq2
    batch = F2.batch_shape_of(Q.x)
    x, y, z = Q.x, Q.y, F2.one(batch, Q.x.device)
    dbls, adds = [], []
    for bit in bspec.x_bits:
        (x, y, z), dc = _double_step(bspec, x, y, z)
        dbls.append(torch.stack(dc))
        if bit:
            (x, y, z), ac = _add_step(bspec, x, y, z, Q.x, Q.y)
            adds.append(torch.stack(ac))
    return G2Prepared(torch.stack(dbls), torch.stack(adds), Q.inf)


def _ell(bspec, f, coeffs, px, py, active):
    """f times the line (coefficients ``coeffs``) at p, kept where
    ``active`` (reference Bls12::ell)."""
    F12, F2 = bspec.fq12, bspec.fq2
    c0, c1, c2 = coeffs[0], coeffs[1], coeffs[2]
    if bspec.twist_type == "M":
        c2 = F2.mul_base(c2, py)
        c1 = F2.mul_base(c1, px)
        nf = fp12_mul_by_014(F12, f, c0, c1, c2)
    else:
        c0 = F2.mul_base(c0, py)
        c1 = F2.mul_base(c1, px)
        nf = fp12_mul_by_034(F12, f, c0, c1, c2)
    return F12.select(active, nf, f)


def multi_miller_loop(bspec: Bls12Spec, P: AffinePoints, Qp: G2Prepared, combine: bool = True):
    """Batched Miller loop over the pairs axis: the Fp12 product over all
    pairs (a pair where either input is infinity contributes 1), or the
    per-pair values when ``combine`` is False."""
    F12 = bspec.fq12
    batch = tuple(P.x.shape[1:])
    active = ~(P.inf | Qp.inf)
    f = F12.one(batch, P.x.device)
    k = 0
    for i, bit in enumerate(bspec.x_bits):
        f = F12.sqr(f)
        f = _ell(bspec, f, Qp.dbl_coeffs[i], P.x, P.y, active)
        if bit:
            f = _ell(bspec, f, Qp.add_coeffs[k], P.x, P.y, active)
            k += 1
    if bspec.x_neg:
        f = F12.conjugate(f)
    if not combine:
        return f
    n = 1
    for s in batch:
        n *= s
    return combine_pairs(F12, f.reshape(tuple(f.shape[: f.dim() - len(batch)]) + (n,)))


# ---------------------------------------------------------------------------
# final exponentiation (eprint 2020/875, gurvy schedule; reference
# bls12/mod.rs:89-157)
# ---------------------------------------------------------------------------

def _cyclotomic_exp_x(bspec, f):
    """f^|X| by cyclotomic squares, conjugated when X < 0."""
    F12 = bspec.fq12
    r = cyc.cyclotomic_exp_binary(F12, f, bspec.x_abs)
    return F12.conjugate(r) if bspec.x_neg else r


def _fe_easy(bspec: Bls12Spec, f):
    """The easy part f^((p^6 - 1)(p^2 + 1)), with the one Fp12 inverse."""
    F12 = bspec.fq12
    r = F12.mul(F12.conjugate(f), F12.inv(f))  # f^(p^6 - 1)
    return F12.mul(F12.frobenius(r, 2), r)


def _fe_hard_glue(bspec: Bls12Spec, r, y1a, y2b, y2c, y2e):
    """The hard part's steps besides its five powers by X."""
    F12 = bspec.fq12
    y0 = cyc.cyclotomic_sqr(F12, r)
    y1 = F12.mul(y1a, F12.conjugate(r))
    y1 = F12.mul(F12.conjugate(y1), y2b)
    y1n = F12.mul(F12.frobenius(y1, 1), y2c)
    r = F12.mul(r, y0)
    y0 = F12.frobenius(y1n, 2)
    y1x = F12.mul(F12.mul(F12.conjugate(y1n), y2e), y0)
    return F12.mul(r, y1x)


def final_exponentiation(bspec: Bls12Spec, f):
    """f^((p^12 - 1)/r) by the gurvy schedule: y1a = r^x; y2b = (y1a
    conj(r))^x; y2c = (conj(y1a conj(r)) y2b)^x; with y1n = frob(.) y2c:
    y2d = y1n^x, y2e = y2d^x."""
    F12 = bspec.fq12
    r = _fe_easy(bspec, f)
    y1a = _cyclotomic_exp_x(bspec, r)
    y1_mid = F12.mul(y1a, F12.conjugate(r))
    y2b = _cyclotomic_exp_x(bspec, y1_mid)
    y1_mid2 = F12.mul(F12.conjugate(y1_mid), y2b)
    y2c = _cyclotomic_exp_x(bspec, y1_mid2)
    y1n = F12.mul(F12.frobenius(y1_mid2, 1), y2c)
    y2d = _cyclotomic_exp_x(bspec, y1n)
    y2e = _cyclotomic_exp_x(bspec, y2d)
    return _fe_hard_glue(bspec, r, y1a, y2b, y2c, y2e)


def pairing(bspec: Bls12Spec, P: AffinePoints, Q: ExtAffine):
    """The product over the pairs of e(P_i, Q_i) (the reference's
    multi_pairing; batch-1 inputs for one pairing)."""
    return final_exponentiation(bspec, multi_miller_loop(bspec, P, g2_prepare(bspec, Q)))


def pairing_each(bspec: Bls12Spec, P: AffinePoints, Q: ExtAffine):
    """Per-pair pairings e(P_i, Q_i), no product across pairs."""
    return final_exponentiation(bspec, multi_miller_loop(bspec, P, g2_prepare(bspec, Q), False))


fp12_pow_const = ext_pow_const  # a^e for any Fp12 element (the JAX package's name)
