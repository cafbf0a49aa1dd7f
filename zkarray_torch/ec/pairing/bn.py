"""BN-family pairing engine (BN254), batched over the pairs axis.

Counterpart of zkarray/ec/pairing/bn.py: the ate loop over the signed
digits of 6X + 2 with the BLS12 engine's homogeneous-projective ladder and
line products (ec/pairing/bls12.py's _double_step, _add_step, _ell and
combine_pairs: the formulas are the family's), then the two
Frobenius-twist lines (q1 = pi(Q), q2 = -pi^2(Q)) and the
Fuentes-Castaneda final exponentiation. Every step is one batched tower op
across all pairs.

Where the JAX package computes the ladder's add step on all 64 digits and
selects (a lax.scan), this runs it only on the 21 nonzero ones, with -Q
where the digit is -1: the select keeps the doubled state and the line
value where a digit is 0, so the words are the same.
``BnG2Prepared.add_coeffs`` therefore holds 21 slots, in digit order, where
the JAX package keeps 64 (``interop.bn_g2_prepared_from_numpy`` maps them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from zkarray_torch.ec.pairing import bls12 as _b
from zkarray_torch.ec.sw import AffinePoints
from zkarray_torch.ec.sw_ext import ExtAffine, ExtCurveSpec
from zkarray_torch.ff import cyclotomic as cyc


class BnSpec:
    def __init__(self, name, x: int, ate_loop_count, twist_type, fq_spec, fq2, fq6, fq12,
                 g1_curve, g2_curve: ExtCurveSpec, twist_mul_by_q_x, twist_mul_by_q_y):
        assert twist_type in ("M", "D")
        self.name = name
        self.x = x
        self.x_abs = abs(x)
        self.x_neg = x < 0
        self.ate_loop_count = list(ate_loop_count)  # arkworks' digit order, low first
        self.twist_type = twist_type
        self.fq = fq_spec
        self.fq2 = fq2
        self.fq6 = fq6
        self.fq12 = fq12
        self.g1 = g1_curve
        self.g2 = g2_curve
        self.twist_mul_by_q_x = twist_mul_by_q_x  # host Fq2 elements
        self.twist_mul_by_q_y = twist_mul_by_q_y
        self.two_inv_int = pow(2, -1, fq_spec.modulus)
        # the loop's digits in execution order: i = len - 1 .. 1 takes digit i - 1
        n = len(self.ate_loop_count)
        self.digits = [self.ate_loop_count[i - 1] for i in range(n - 1, 0, -1)]
        self.add_digits = [i for i, d in enumerate(self.digits) if d]

    def __hash__(self):
        return hash((self.name, self.x))

    def __eq__(self, o):
        return isinstance(o, BnSpec) and o.name == self.name and o.x == self.x

    def __repr__(self):
        return f"BnSpec({self.name})"


class BnG2Prepared(NamedTuple):
    """Line coefficients of the 6X + 2 ladder: ``dbl_coeffs`` (64, 3, 2, L,
    *batch), one triple per digit; ``add_coeffs`` (len(add_digits), 3, 2,
    L, *batch), one per nonzero digit in ``BnSpec.add_digits`` order;
    ``q1_coeffs``/``q2_coeffs`` (3, 2, L, *batch) the two Frobenius-twist
    lines; ``inf`` the batch-shaped infinity mask."""
    dbl_coeffs: torch.Tensor
    add_coeffs: torch.Tensor
    q1_coeffs: torch.Tensor
    q2_coeffs: torch.Tensor
    inf: torch.Tensor


def _mul_by_char(bspec: BnSpec, Q: ExtAffine) -> ExtAffine:
    """pi(Q): coordinate-wise Frobenius times the twist constants
    (reference bn/g2.rs mul_by_char)."""
    F2 = bspec.fq2
    dev = Q.x.device
    x = F2.mul(F2.frobenius(Q.x, 1), F2.const(bspec.twist_mul_by_q_x, (), dev))
    y = F2.mul(F2.frobenius(Q.y, 1), F2.const(bspec.twist_mul_by_q_y, (), dev))
    return ExtAffine(x, y, Q.inf)


def g2_prepare(bspec: BnSpec, Q: ExtAffine) -> BnG2Prepared:
    """Run the 6X + 2 ladder once, collecting every doubling's line
    coefficients and each nonzero digit's addition (of Q, or -Q on a -1),
    then the additions of q1 = pi(Q) and q2 = -pi^2(Q)."""
    F2 = bspec.fq2
    batch = F2.batch_shape_of(Q.x)
    y_neg = F2.neg(Q.y)
    x, y, z = Q.x, Q.y, F2.one(batch, Q.x.device)
    dbls, adds = [], []
    for d in bspec.digits:
        (x, y, z), dc = _b._double_step(bspec, x, y, z)
        dbls.append(torch.stack(dc))
        if d:
            (x, y, z), ac = _b._add_step(bspec, x, y, z, Q.x, Q.y if d > 0 else y_neg)
            adds.append(torch.stack(ac))
    if bspec.x_neg:
        y = F2.neg(y)
    q1 = _mul_by_char(bspec, Q)
    q2 = _mul_by_char(bspec, q1)
    (x, y, z), c1 = _b._add_step(bspec, x, y, z, q1.x, q1.y)
    _, c2 = _b._add_step(bspec, x, y, z, q2.x, F2.neg(q2.y))
    return BnG2Prepared(torch.stack(dbls), torch.stack(adds), torch.stack(c1), torch.stack(c2),
                        Q.inf)


def multi_miller_loop(bspec: BnSpec, P: AffinePoints, Qp: BnG2Prepared, combine: bool = True):
    """Batched Miller loop over the pairs axis: the Fp12 product over all
    pairs (a pair where either input is infinity contributes 1), or the
    per-pair values when ``combine`` is False."""
    F12 = bspec.fq12
    batch = tuple(P.x.shape[1:])
    active = ~(P.inf | Qp.inf)
    f = F12.one(batch, P.x.device)
    k = 0
    for i, d in enumerate(bspec.digits):
        f = F12.sqr(f)  # the first squares 1: exact, as in the JAX package
        f = _b._ell(bspec, f, Qp.dbl_coeffs[i], P.x, P.y, active)
        if d:
            f = _b._ell(bspec, f, Qp.add_coeffs[k], P.x, P.y, active)
            k += 1
    if bspec.x_neg:
        f = F12.conjugate(f)
    f = _b._ell(bspec, f, Qp.q1_coeffs, P.x, P.y, active)
    f = _b._ell(bspec, f, Qp.q2_coeffs, P.x, P.y, active)
    if not combine:
        return f
    n = 1
    for s in batch:
        n *= s
    return _b.combine_pairs(F12, f.reshape(tuple(f.shape[: f.dim() - len(batch)]) + (n,)))


# ---------------------------------------------------------------------------
# final exponentiation (Fuentes-Castaneda; reference bn/mod.rs:107-166)
# ---------------------------------------------------------------------------

def _exp_by_neg_x(bspec: BnSpec, f):
    """f^(-X) by cyclotomic squares over |X| (28 set bits of 63: 62
    Granger-Scott squares and 27 products), conjugated when X > 0."""
    F12 = bspec.fq12
    r = cyc.cyclotomic_exp_binary(F12, f, bspec.x_abs)
    return r if bspec.x_neg else F12.conjugate(r)


def _fe_easy(bspec: BnSpec, f):
    """The easy part f^((p^6 - 1)(p^2 + 1)), with the one Fp12 inverse."""
    F12 = bspec.fq12
    r = F12.mul(F12.conjugate(f), F12.inv(f))
    return F12.mul(F12.frobenius(r, 2), r)


def _fe_prep1(bspec: BnSpec, y0):
    """y3 = y2 y1 with y1 = y0^2, y2 = y1^2 (between the first two powers)."""
    F12 = bspec.fq12
    y1 = cyc.cyclotomic_sqr(F12, y0)
    y2 = cyc.cyclotomic_sqr(F12, y1)
    return F12.mul(y2, y1), y1


def _fe_hard_glue(bspec: BnSpec, r, y1, y3, y4, y6):
    """The hard part's steps after its three powers, in the JAX package's
    product order."""
    F12 = bspec.fq12
    y3 = F12.conjugate(y3)
    y6 = F12.conjugate(y6)
    y7 = F12.mul(y6, y4)
    y8 = F12.mul(y7, y3)
    y9 = F12.mul(y8, y1)
    y10 = F12.mul(y8, y4)
    y11 = F12.mul(y10, r)
    y12 = F12.frobenius(y9, 1)
    y13 = F12.mul(y12, y11)
    y14 = F12.mul(F12.frobenius(y8, 2), y13)
    y15 = F12.frobenius(F12.mul(F12.conjugate(r), y9), 3)
    return F12.mul(y15, y14)


def final_exponentiation(bspec: BnSpec, f):
    """f^((p^12 - 1)/r): the easy part, then the Fuentes-Castaneda hard part
    with three powers by -X."""
    F12 = bspec.fq12
    r = _fe_easy(bspec, f)
    y0 = _exp_by_neg_x(bspec, r)
    y3, y1 = _fe_prep1(bspec, y0)
    y4 = _exp_by_neg_x(bspec, y3)
    y5 = cyc.cyclotomic_sqr(F12, y4)
    y6 = _exp_by_neg_x(bspec, y5)
    return _fe_hard_glue(bspec, r, y1, y3, y4, y6)


def pairing(bspec: BnSpec, P: AffinePoints, Q: ExtAffine):
    """The product over the pairs of e(P_i, Q_i) (Ethereum's ecPairing
    check; batch-1 inputs for one pairing)."""
    return final_exponentiation(bspec, multi_miller_loop(bspec, P, g2_prepare(bspec, Q)))


def pairing_each(bspec: BnSpec, P: AffinePoints, Q: ExtAffine):
    """Per-pair pairings e(P_i, Q_i), no product across pairs."""
    return final_exponentiation(bspec, multi_miller_loop(bspec, P, g2_prepare(bspec, Q), False))
