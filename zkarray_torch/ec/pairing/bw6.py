"""BW6-family pairing engine (BW6-761, BW6-767), batched over the pairs
axis.

Counterpart of zkarray/ec/pairing/bw6.py: the optimal-ate pairing of
eprint 2020/351 (El Housni's thesis, formulas 4.15 and 4.17). G2 lies over
the same prime field as G1, so the ladder's doubling and addition steps are
Fq arithmetic (eprint 2013/722's homogeneous-projective formulas, which fix
every line coefficient's scaling and so the Miller value's words); the
Miller value is two loops, over the seed u and over u^2 - u - 1 reusing
f_u, joined by the extra line l([u]Q, Q); the target field is Fp6 =
2-over-3, and the final exponentiation's hard part is Algorithm 4.3 (t = 0
mod r) or 4.4 of the thesis. Every step is one batched tower op across all
pairs; per-pair values combine in a log tree.

Where the JAX package computes the add steps on every bit of u and every
digit of u^2 - u - 1 and selects (two lax.scans), this runs them only on the
set bits and the nonzero digits (-[u]Q on a -1): the select keeps the
doubled state and value there, so the words are the same.
``G2Prepared.add_1``/``add_2`` therefore hold only those slots, in order
(``interop.bw6_g2_prepared_from_numpy`` maps the JAX package's per-bit
slots onto them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from zkarray_torch.ec.pairing.mnt import ext_pow_const
from zkarray_torch.ec.sw import AffinePoints, SWCurveSpec
from zkarray_torch.ff import fp
from zkarray_torch.ff.towers import combine_pairs


class BW6Spec:
    def __init__(self, name: str, x: int, x_is_neg: bool, ate_loop_count_2, loop_2_neg: bool,
                 twist_type: str, h_t: int, h_y: int, t_mod_r_is_zero: bool, fq_spec, fq3, fq6,
                 g1_curve: SWCurveSpec, g2_curve: SWCurveSpec, loop_1_neg: bool = False):
        assert twist_type in ("M", "D")
        self.name = name
        self.x = x
        self.x_is_neg = x_is_neg
        self.x_abs = abs(x)
        # Python's floor division, as written in the JAX package (h_t, h_y < 0 on BW6-767)
        self.x_minus_1_div_3 = (abs(x) + 1) // 3 if x_is_neg else (x - 1) // 3
        self.loop_1_bits = [int(b) for b in bin(self.x_abs)[3:]]  # below the leading one
        self.loop_1_neg = loop_1_neg
        self.ate_loop_count_2 = tuple(ate_loop_count_2)  # low first
        self.loop_2_neg = loop_2_neg
        self.twist_type = twist_type
        self.h_t = h_t
        self.h_y = h_y
        self.t_mod_r_is_zero = t_mod_r_is_zero
        self.fq = fq_spec
        self.fq3 = fq3
        self.fq6 = fq6
        self.g1 = g1_curve
        self.g2 = g2_curve
        # loop 2 runs the digits below the leading one, high first
        self.digits_2 = list(self.ate_loop_count_2[:-1])[::-1]
        self.add_rows_1 = [i for i, b in enumerate(self.loop_1_bits) if b]
        self.add_rows_2 = [i for i, d in enumerate(self.digits_2) if d]

    def __hash__(self):
        return hash((self.name, self.x))

    def __eq__(self, o):
        return isinstance(o, BW6Spec) and o.name == self.name and o.x == self.x

    def __repr__(self):
        return f"BW6Spec({self.name})"


class G2Prepared(NamedTuple):
    """Line coefficients of both ladders, each triple (3, L, *batch):
    ``dbl_1`` one per bit of u below the leading one, ``add_1`` one per set
    bit (``BW6Spec.add_rows_1``), ``extra`` the line l([u]Q, Q), ``dbl_2``
    one per digit of loop 2, ``add_2`` one per nonzero digit
    (``add_rows_2``); ``inf`` the batch-shaped infinity mask."""
    dbl_1: torch.Tensor
    add_1: torch.Tensor
    extra: torch.Tensor
    dbl_2: torch.Tensor
    add_2: torch.Tensor
    inf: torch.Tensor


def _double_step(bspec, x, y, z):
    """One ladder doubling over Fq with its line coefficients (reference
    bw6/g2.rs double_in_place)."""
    f = bspec.fq
    a = fp.mont_mul(f, x, y)
    b = fp.mont_sqr(f, y)
    b4 = fp.double(f, fp.double(f, b))
    c = fp.mont_sqr(f, z)
    e = fp.mont_mul(f, fp.const_array(f, bspec.g2.b_int, (), x.device), fp.add(f, fp.double(f, c), c))
    f3 = fp.add(f, fp.double(f, e), e)
    g = fp.add(f, b, f3)
    h = fp.sub(f, fp.mont_sqr(f, fp.add(f, y, z)), fp.add(f, b, c))
    i_ = fp.sub(f, e, b)
    j = fp.mont_sqr(f, x)
    e2sq = fp.mont_sqr(f, fp.double(f, e))
    xn = fp.mont_mul(f, fp.double(f, a), fp.sub(f, b, f3))
    yn = fp.sub(f, fp.mont_sqr(f, g), fp.add(f, fp.double(f, e2sq), e2sq))
    zn = fp.mont_mul(f, b4, h)
    j3 = fp.add(f, fp.double(f, j), j)
    if bspec.twist_type == "M":
        coeffs = (i_, j3, fp.neg(f, h))
    else:
        coeffs = (fp.neg(f, h), j3, i_)
    return (xn, yn, zn), coeffs


def _add_step(bspec, x, y, z, qx, qy):
    """The ladder's mixed addition over Fq with its line coefficients
    (reference g2.rs add_in_place)."""
    f = bspec.fq
    theta = fp.sub(f, y, fp.mont_mul(f, qy, z))
    lam = fp.sub(f, x, fp.mont_mul(f, qx, z))
    c = fp.mont_sqr(f, theta)
    d = fp.mont_sqr(f, lam)
    e = fp.mont_mul(f, lam, d)
    ff = fp.mont_mul(f, z, c)
    g = fp.mont_mul(f, x, d)
    h = fp.sub(f, fp.add(f, e, ff), fp.double(f, g))
    xn = fp.mont_mul(f, lam, h)
    yn = fp.sub(f, fp.mont_mul(f, theta, fp.sub(f, g, h)), fp.mont_mul(f, e, y))
    zn = fp.mont_mul(f, z, e)
    j = fp.sub(f, fp.mont_mul(f, theta, qx), fp.mont_mul(f, lam, qy))
    if bspec.twist_type == "M":
        coeffs = (j, fp.neg(f, theta), lam)
    else:
        coeffs = (lam, fp.neg(f, theta), j)
    return (xn, yn, zn), coeffs


def g2_prepare(bspec: BW6Spec, Q: AffinePoints) -> G2Prepared:
    """Both ate ladders (reference bw6/g2.rs From<G2Affine>): loop 1 over the
    bits of u from Q; [u]Q made affine (negated when loop 1 is) and the extra
    line l([u]Q, Q), which does not advance the ladder; loop 2 over the
    digits of u^2 - u - 1 from [u]Q."""
    f = bspec.fq
    batch, dev = tuple(Q.x.shape[1:]), Q.x.device
    one = fp.one(f, batch, dev)
    x, y, z = Q.x, Q.y, one
    dbl1, add1 = [], []
    for bit in bspec.loop_1_bits:
        (x, y, z), dc = _double_step(bspec, x, y, z)
        dbl1.append(torch.stack(dc))
        if bit:
            (x, y, z), ac = _add_step(bspec, x, y, z, Q.x, Q.y)
            add1.append(torch.stack(ac))
    zinv = fp.inv(f, z)
    qux = fp.mont_mul(f, x, zinv)
    quy = fp.mont_mul(f, y, zinv)
    if bspec.loop_1_neg:
        quy = fp.neg(f, quy)
    quy_neg = fp.neg(f, quy)
    _, extra = _add_step(bspec, qux, quy, one, Q.x, Q.y)
    x, y, z = qux, quy, one
    dbl2, add2 = [], []
    for d in bspec.digits_2:
        (x, y, z), dc = _double_step(bspec, x, y, z)
        dbl2.append(torch.stack(dc))
        if d:
            (x, y, z), ac = _add_step(bspec, x, y, z, qux, quy if d > 0 else quy_neg)
            add2.append(torch.stack(ac))
    return G2Prepared(torch.stack(dbl1), torch.stack(add1), torch.stack(extra), torch.stack(dbl2),
                      torch.stack(add2), Q.inf)


def _ell(bspec, fv, coeffs, px, py, active):
    """fv times the line (prime-field coefficients ``coeffs``) at P, kept
    where ``active`` (reference bw6/mod.rs ell): the line is the Fp6
    element ((c0, c1 px, 0), (0, c2 py, 0)) on the M-twist, ((c0 py, 0, 0),
    (c1 px, c2, 0)) on the D-twist, multiplied in as a full Fp6 product, as
    the JAX package does."""
    f = bspec.fq
    F6 = bspec.fq6
    c0, c1, c2 = coeffs[0], coeffs[1], coeffs[2]
    z3 = torch.zeros_like(c0)
    if bspec.twist_type == "M":
        m1, m2 = fp.mont_mul(f, torch.stack([c1, c2], 1), torch.stack([px, py], 1)).unbind(1)
        line = torch.stack([torch.stack([c0, m1, z3]), torch.stack([z3, m2, z3])])
    else:
        m0, m1 = fp.mont_mul(f, torch.stack([c0, c1], 1), torch.stack([py, px], 1)).unbind(1)
        line = torch.stack([torch.stack([m0, z3, z3]), torch.stack([m1, c2, z3])])
    return F6.select(active, F6.mul(fv, line), fv)


def multi_miller_loop(bspec: BW6Spec, P: AffinePoints, Qp: G2Prepared, combine: bool = True):
    """Per-pair optimal-ate Miller values f_1 Frob(f_2) (or Frob(f_1) f_2
    when t = 0 mod r), 1 where either input is infinity; their product over
    the pairs when ``combine`` (reference bw6/mod.rs multi_miller_loop)."""
    F6 = bspec.fq6
    batch = tuple(P.x.shape[1:])
    active = ~(P.inf | Qp.inf)
    one6 = F6.one(batch, P.x.device)
    fv = one6
    k = 0
    for i, bit in enumerate(bspec.loop_1_bits):
        fv = F6.sqr(fv)
        fv = _ell(bspec, fv, Qp.dbl_1[i], P.x, P.y, active)
        if bit:
            fv = _ell(bspec, fv, Qp.add_1[k], P.x, P.y, active)
            k += 1
    # the conjugate stands for the cyclotomic inverse: the unitary error lies
    # in Fp3 and the easy part removes it (the reference does the same)
    if bspec.loop_1_neg:
        f_u, f_u_inv = F6.conjugate(fv), fv
    else:
        f_u, f_u_inv = fv, F6.conjugate(fv)
    f_1 = _ell(bspec, f_u, Qp.extra, P.x, P.y, active)
    fv = f_u
    k = 0
    for i, d in enumerate(bspec.digits_2):
        fv = F6.sqr(fv)
        fv = _ell(bspec, fv, Qp.dbl_2[i], P.x, P.y, active)
        if d:
            fm = _ell(bspec, F6.mul(fv, f_u if d > 0 else f_u_inv), Qp.add_2[k], P.x, P.y, active)
            fv = F6.select(active, fm, fv)
            k += 1
    f_2 = F6.conjugate(fv) if bspec.loop_2_neg else fv
    if bspec.t_mod_r_is_zero:
        f_1 = F6.frobenius(f_1, 1)
    else:
        f_2 = F6.frobenius(f_2, 1)
    fv = F6.select(active, F6.mul(f_1, f_2), one6)
    if not combine:
        return fv
    n = 1
    for s in batch:
        n *= s
    return combine_pairs(F6, fv.reshape(tuple(fv.shape[: fv.dim() - len(batch)]) + (n,)))


# ---------------------------------------------------------------------------
# final exponentiation (reference bw6/mod.rs:226-330: the easy part and the
# thesis' Algorithm 4.3 or 4.4)
# ---------------------------------------------------------------------------

def _cyc_pow(F6, a, e: int):
    """a^|e|, conjugated when e < 0 (a cyclotomic input)."""
    r = ext_pow_const(F6, a, abs(e))
    return F6.conjugate(r) if e < 0 else r


def _exp_by_x(bspec, a):
    r = _cyc_pow(bspec.fq6, a, bspec.x_abs)
    return bspec.fq6.conjugate(r) if bspec.x_is_neg else r


def _exp_by_x_plus_1(bspec, a):
    return bspec.fq6.mul(_exp_by_x(bspec, a), a)


def _exp_by_x_minus_1(bspec, a):
    return bspec.fq6.mul(_exp_by_x(bspec, a), bspec.fq6.conjugate(a))


def _exp_by_x_minus_1_div_3(bspec, a):
    r = _cyc_pow(bspec.fq6, a, bspec.x_minus_1_div_3)
    return bspec.fq6.conjugate(r) if bspec.x_is_neg else r


def final_exponentiation(bspec: BW6Spec, f):
    """f^((p^6 - 1)/r): the easy part f^((p^3 - 1)(p + 1)), then the hard
    part by Algorithm 4.3 (t = 0 mod r, BW6-767) or 4.4 (BW6-761), in the
    JAX package's order of products."""
    F6 = bspec.fq6
    g = F6.mul(F6.conjugate(f), F6.inv(f))
    m = F6.mul(F6.frobenius(g, 1), g)

    a = _exp_by_x_minus_1(bspec, m)
    a = _exp_by_x_minus_1(bspec, a)
    d2 = (bspec.h_t * bspec.h_t + 3 * bspec.h_y * bspec.h_y) // 4

    if bspec.t_mod_r_is_zero:  # Algorithm 4.3
        a = F6.mul(F6.conjugate(F6.mul(m, a)), F6.frobenius(m, 1))
        b = F6.mul(_exp_by_x_plus_1(bspec, a), m)
        a = F6.conjugate(F6.mul(F6.sqr(a), a))
        c = _exp_by_x_minus_1_div_3(bspec, b)
        d = _exp_by_x_minus_1(bspec, c)
        e = F6.mul(_exp_by_x_minus_1(bspec, _exp_by_x_minus_1(bspec, d)), d)
        fe = F6.mul(F6.conjugate(F6.mul(_exp_by_x_plus_1(bspec, e), c)), d)
        gg = F6.mul(F6.mul(F6.conjugate(_exp_by_x_plus_1(bspec, F6.mul(fe, d))), c), b)
        d1 = (bspec.h_t - bspec.h_y) // 2
        h = F6.mul(_cyc_pow(F6, fe, d1), e)
        h = F6.mul(F6.mul(F6.mul(F6.sqr(h), h), b), _cyc_pow(F6, gg, d2))
        return F6.mul(a, h)

    # Algorithm 4.4
    a = F6.mul(a, F6.frobenius(m, 1))
    b = F6.mul(_exp_by_x_plus_1(bspec, a), F6.conjugate(m))
    a = F6.mul(F6.sqr(a), a)
    c = _exp_by_x_minus_1_div_3(bspec, b)
    d = _exp_by_x_minus_1(bspec, c)
    e = F6.mul(_exp_by_x_minus_1(bspec, _exp_by_x_minus_1(bspec, d)), d)
    d = F6.conjugate(d)
    fc = F6.mul(d, b)
    gg = F6.mul(_exp_by_x_plus_1(bspec, e), fc)
    h = F6.mul(gg, c)
    i = F6.mul(_exp_by_x_plus_1(bspec, F6.mul(gg, d)), F6.conjugate(fc))
    d1 = (bspec.h_t + bspec.h_y) // 2
    j = F6.mul(_cyc_pow(F6, h, d1), e)
    k = F6.mul(F6.mul(F6.mul(F6.sqr(j), j), b), _cyc_pow(F6, i, d2))
    return F6.mul(a, k)


def pairing(bspec: BW6Spec, P: AffinePoints, Q: AffinePoints):
    """The product over the pairs of e(P_i, Q_i) (a multi-pairing; batch-1
    inputs for one pairing)."""
    return final_exponentiation(bspec, multi_miller_loop(bspec, P, g2_prepare(bspec, Q)))


def pairing_each(bspec: BW6Spec, P: AffinePoints, Q: AffinePoints):
    """Per-pair pairings e(P_i, Q_i), no product across pairs."""
    return final_exponentiation(bspec, multi_miller_loop(bspec, P, g2_prepare(bspec, Q), False))
