"""MNT4/MNT6-family pairing engine (MNT4/6-298, MNT4/6-753), batched over
the pairs axis.

Counterpart of zkarray/ec/pairing/mnt.py: one engine for both families,
generic over the twist field (Fq2 for MNT4, Fq3 for MNT6), whose quadratic
extension is the target (Fq4, Fq6 = 2-over-3). G2 preparation runs the
flipped-ate ladder once, in extended (x, y, z, t = z^2) coordinates,
stacking every step's line coefficients; the Miller loop consumes them with
one batched tower op per step across all pairs; the final exponentiation is
the reference's two chunks (the easy part by conjugation and Frobenius, the
hard part a power by w1 = 1 of the Frobenius and by |w0|). Every product of
a tower op is one mont_mul launch on a CUDA device, every linear op one
fp_add or fp_sub launch (ff/towers.py).

Where the JAX package computes the add step at every digit and selects (a
lax.scan over uniform steps), this runs it only at the nonzero digits: the
select keeps the doubled state and the Miller value there, so the words are
the same. ``G2Prepared.add_coeffs`` therefore holds only those slots, in
order (``MNTSpec.add_rows``; ``interop.mnt_g2_prepared_from_numpy`` maps the
JAX package's per-digit slots onto them); the JAX package's slots at zero
digits hold coefficients that it never reads.

``ext_pow_const`` also serves the BW6 final exponentiation, as the JAX
package's does (zkarray/ec/pairing/bw6.py:_cyc_pow).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from zkarray_torch.ec.sw import AffinePoints, SWCurveSpec
from zkarray_torch.ec.sw_ext import ExtAffine, ExtCurveSpec
from zkarray_torch.ff.towers import combine_pairs


class MNTSpec:
    """Family constants (reference MNT4Config/MNT6Config)."""

    def __init__(self, name: str, fq_spec, fq_tw, fq_target, g1_curve: SWCurveSpec,
                 g2_curve: ExtCurveSpec, twist_host, twist_coeff_a_host, ate_loop_count,
                 ate_is_loop_count_neg: bool, final_exp_last_chunk_1: int, final_exp_w0_abs: int,
                 final_exp_w0_neg: bool):
        self.name = name
        self.fq = fq_spec
        self.tw = fq_tw  # twist field: Fq2 (MNT4) or Fq3 (MNT6)
        self.gt = fq_target  # its quadratic extension: Fq4 or Fq6
        self.g1 = g1_curve
        self.g2 = g2_curve
        self.twist_host = twist_host
        self.twist_inv_host = fq_tw.host.inv(twist_host)
        self.twist_coeff_a_host = twist_coeff_a_host
        self.ate_loop_count = tuple(ate_loop_count)  # signed digits, high first, leading 1
        self.ate_is_loop_count_neg = ate_is_loop_count_neg
        self.final_exp_last_chunk_1 = final_exp_last_chunk_1
        self.final_exp_w0_abs = final_exp_w0_abs
        self.final_exp_w0_neg = final_exp_w0_neg
        self.digits = self.ate_loop_count[1:]  # one ladder step each
        self.add_rows = [i for i, d in enumerate(self.digits) if d]

    def __hash__(self):
        return hash((self.name, self.ate_loop_count))

    def __eq__(self, o):
        return isinstance(o, MNTSpec) and o.name == self.name

    def __repr__(self):
        return f"MNTSpec({self.name})"


class G1Prepared(NamedTuple):
    x: torch.Tensor  # Fq (L, *batch)
    y: torch.Tensor
    x_twist: torch.Tensor  # twist field
    y_twist: torch.Tensor
    inf: torch.Tensor


class G2Prepared(NamedTuple):
    """``dbl_coeffs`` (steps, 4, *twist element) holds c_h, c_4c, c_j, c_l
    per digit; ``add_coeffs`` (nonzero digits, 2, *twist element) c_l1,
    c_rz per nonzero digit (``MNTSpec.add_rows``); ``final_add`` (2, *twist
    element) the extra addition of a negative loop count (zeros otherwise,
    as in the JAX package)."""
    x_over_twist: torch.Tensor
    y_over_twist: torch.Tensor
    dbl_coeffs: torch.Tensor
    add_coeffs: torch.Tensor
    final_add: torch.Tensor
    inf: torch.Tensor


def g1_prepare(mspec: MNTSpec, P: AffinePoints) -> G1Prepared:
    """x_twist = TWIST x, y_twist = TWIST y (reference mnt4/g1.rs From)."""
    F = mspec.tw
    tw = F.const(mspec.twist_host, (), P.x.device)
    return G1Prepared(P.x, P.y, F.mul_base(tw, P.x), F.mul_base(tw, P.y), P.inf)


def _double_step(mspec, r, twa):
    """Flipped-Miller doubling in extended (x, y, z, t = z^2) coordinates
    (reference mnt4/mod.rs doubling_for_flipped_miller_loop), its products
    grouped by dependency level into four calls; ``twa`` TWIST_COEFF_A
    broadcast to the batch."""
    F = mspec.tw
    x, y, z, t = r
    a, b, c, zz = mspec.gt._mul_many([(t, t), (x, x), (y, y), (z, z)])
    xc, yz = F.add(x, c), F.add(y, z)
    d, xc2, yz2, ta = mspec.gt._mul_many([(c, c), (xc, xc), (yz, yz), (twa, a)])
    e = F.sub(F.sub(xc2, b), d)
    f3 = F.add(F.add(F.double(b), b), ta)
    zn = F.sub(F.sub(yz2, c), zz)
    f3t, f3x = F.add(f3, t), F.add(f3, x)
    g, tn, f3t2, f3x2 = mspec.gt._mul_many([(f3, f3), (zn, zn), (f3t, f3t), (f3x, f3x)])
    d8 = F.double(F.double(F.double(d)))
    xn = F.sub(g, F.double(F.double(e)))
    znt = F.add(zn, t)
    m, znt2 = mspec.gt._mul_many([(f3, F.sub(F.double(e), xn)), (znt, znt)])
    yn = F.add(F.neg(d8), m)
    c_h = F.sub(F.sub(znt2, tn), a)
    c_4c = F.double(F.double(c))
    c_j = F.sub(F.sub(f3t2, g), a)
    c_l = F.sub(F.sub(f3x2, g), b)
    return (xn, yn, zn, tn), (c_h, c_4c, c_j, c_l)


def _add_step(mspec, qx, qy, qy2, r):
    """Flipped-Miller mixed addition (reference mnt4/mod.rs
    mixed_addition_for_flipped_miller_loop), its products grouped into
    four calls; ``qy2`` = qy^2, the same for qy and -qy."""
    F = mspec.tw
    x, y, z, t = r
    zq = F.add(z, qy)
    b, zq2 = mspec.gt._mul_many([(t, qx), (zq, zq)])
    h = F.sub(b, x)
    d, i_ = mspec.gt._mul_many([(F.sub(F.sub(zq2, qy2), t), t), (h, h)])
    e = F.double(F.double(i_))
    zh = F.add(z, h)
    j, v, zh2 = mspec.gt._mul_many([(h, e), (x, e), (zh, zh)])
    ry2 = F.double(y)
    l1 = F.sub(d, ry2)
    zn = F.sub(F.sub(zh2, t), i_)
    l1sq, tn, jr = mspec.gt._mul_many([(l1, l1), (zn, zn), (j, ry2)])
    xn = F.sub(F.sub(l1sq, j), F.double(v))
    yn = F.sub(F.mul(l1, F.sub(v, xn)), jr)
    return (xn, yn, zn, tn), (l1, zn)


def g2_prepare(mspec: MNTSpec, Q: ExtAffine) -> G2Prepared:
    """Run the ate ladder once, stacking each step's line coefficients
    (reference mnt4/g2.rs From<G2Affine>); with a negative loop count, the
    extra addition of -R made affine (x/z^2, -y/z^3)."""
    F = mspec.tw
    batch, dev = F.batch_shape_of(Q.x), Q.x.device
    tw_inv = F.const(mspec.twist_inv_host, batch, dev)
    x_ot, y_ot = mspec.gt._mul_many([(Q.x, tw_inv), (Q.y, tw_inv)])
    qy_neg = F.neg(Q.y)
    qy2 = F.sqr(Q.y)
    twa = F.const(mspec.twist_coeff_a_host, batch, dev)
    one = F.one(batch, dev)
    r = (Q.x, Q.y, one, one)
    dbls, adds = [], []
    for dig in mspec.digits:
        r, dc = _double_step(mspec, r, twa)
        dbls.append(torch.stack(dc))
        if dig:
            r, ac = _add_step(mspec, Q.x, qy_neg if dig < 0 else Q.y, qy2, r)
            adds.append(torch.stack(ac))
    if mspec.ate_is_loop_count_neg:
        x, y, z, _ = r
        zinv = F.inv(z)
        zinv2 = F.sqr(zinv)
        mx, zinv3 = mspec.gt._mul_many([(x, zinv2), (zinv, zinv2)])
        my = F.neg(F.mul(y, zinv3))
        _, fac = _add_step(mspec, mx, my, F.sqr(my), r)
        final_add = torch.stack(fac)
    else:
        final_add = torch.stack((F.zero(batch, dev), F.zero(batch, dev)))
    return G2Prepared(x_ot, y_ot, torch.stack(dbls), torch.stack(adds), final_add, Q.inf)


# rows x pairs of line values built per call of _line_rows: at 2^12 pairs,
# 64 ladder rows at once (~0.2 GB of MNT6-753 or CP6 lines, ~2 GB with the
# product's temporaries); at 2 pairs, a whole ladder
LINE_ELEMS = 1 << 18


def row_chunks(rows: int, lanes: int):
    """(start, stop) of consecutive row blocks of at most LINE_ELEMS // lanes
    rows (at least one)."""
    step = max(1, LINE_ELEMS // max(1, lanes))
    return [(s, min(rows, s + step)) for s in range(0, rows, step)]


def _rows_view(F, coeff_rows):
    """(k, *F element) rows -> (*F.shape, L, k, *batch): the rows as a
    batch axis behind the limbs."""
    return coeff_rows.movedim(0, len(F.shape) + 1)


def _line_rows(mspec, Pp, Qp, l1_coeff, y_ot_neg, active, kind, s, e):
    """The Miller loop's line values for ladder rows s..e, each a target
    element, where ``active`` (else 1), (k, *T element), from one batched
    product call: at a doubling row (c_l - c_4c - c_j x_twist, c_h y_twist),
    at an add row (c_rz y_twist, -(y c_rz + l1_coeff c_l1)), y the
    y_over_twist of the digit's sign."""
    F, T = mspec.tw, mspec.gt
    k = e - s
    ax = len(F.shape) + 1

    def rows(v):  # a per-pair F element broadcast over the k rows
        return v.unsqueeze(ax).expand(v.shape[:ax] + (k,) + v.shape[ax:])

    if kind == "dbl":
        c = Qp.dbl_coeffs[s:e]
        c_h, c_4c, c_j, c_l = (_rows_view(F, c[:, j]) for j in range(4))
        m0, m1 = T._mul_many([(c_j, rows(Pp.x_twist)), (c_h, rows(Pp.y_twist))])
        g = T._stack([F.sub(F.sub(c_l, c_4c), m0), m1])
    else:
        c = Qp.add_coeffs[s:e]
        c_l1, c_rz = _rows_view(F, c[:, 0]), _rows_view(F, c[:, 1])
        neg = torch.tensor([mspec.digits[i] < 0 for i in mspec.add_rows[s:e]], device=c.device)
        neg = neg.reshape((1,) * ax + (k,) + (1,) * (c_rz.dim() - ax - 1))
        y_sel = torch.where(neg, rows(y_ot_neg), rows(Qp.y_over_twist))
        m0, m1, m2 = T._mul_many([(c_rz, rows(Pp.y_twist)), (y_sel, c_rz), (rows(l1_coeff), c_l1)])
        g = T._stack([m0, F.neg(F.add(m1, m2))])
    if kind == "dbl":
        one = T.one(tuple(g.shape[len(T.shape) + 1:]), g.device)
        g = T.select(active, g, one)
    return g.movedim(len(T.shape) + 1, 0).contiguous()


def multi_miller_loop(mspec: MNTSpec, Pp: G1Prepared, Qp: G2Prepared, combine: bool = True):
    """Batched flipped-ate Miller loop (reference mnt4/mod.rs
    ate_miller_loop): per-pair values, 1 where either input is infinity, or
    their product over the pairs when ``combine``. The line values depend
    on Q and P only, so they are built for blocks of ladder rows at once
    (_line_rows); each step is then a square and a product of the target
    field, and a product at each nonzero digit."""
    F = mspec.tw
    T = mspec.gt
    batch, dev = tuple(Pp.x.shape[1:]), Pp.x.device
    lanes = 1
    for s in batch:
        lanes *= s
    active = ~(Pp.inf | Qp.inf)
    # l1_coeff = embed(px) - x_over_twist; embed as 1 px = (px, 0, ...)
    l1_coeff = F.sub(F.mul_base(F.one(batch, dev), Pp.x), Qp.x_over_twist)
    y_ot_neg = F.neg(Qp.y_over_twist)

    def lines(kind, nrows):
        for s, e in row_chunks(nrows, lanes):
            yield from _line_rows(mspec, Pp, Qp, l1_coeff, y_ot_neg, active, kind, s, e).unbind(0)

    dbl_lines = lines("dbl", len(mspec.digits))
    add_lines = lines("add", len(mspec.add_rows))
    f = T.one(batch, dev)
    for dig in mspec.digits:
        f = T.mul(T.sqr(f), next(dbl_lines))
        if dig:
            f = T.select(active, T.mul(f, next(add_lines)), f)
    if mspec.ate_is_loop_count_neg:
        c_l1, c_rz = Qp.final_add
        m0, m1, m2 = T._mul_many([(c_rz, Pp.y_twist), (Qp.y_over_twist, c_rz), (l1_coeff, c_l1)])
        g_rnegr = T._stack([m0, F.neg(F.add(m1, m2))])
        f = T.select(active, T.inv(T.mul(f, g_rnegr)), f)
    if not combine:
        return f
    return combine_pairs(T, f.reshape(tuple(f.shape[: f.dim() - len(batch)]) + (lanes,)))


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


def _first_chunk(mspec, elt, elt_inv):
    """MNT4: elt^(q^2 - 1); MNT6: elt^((q^3 - 1)(q + 1)) (reference
    final_exponentiation_first_chunk): Frobenius^(deg/2) of the quadratic
    target is the conjugate."""
    T = mspec.gt
    t = T.mul(T.conjugate(elt), elt_inv)
    if mspec.tw.deg == 3:
        t = T.mul(T.frobenius(t, 1), t)
    return t


def _last_chunk(mspec, elt, elt_inv):
    T = mspec.gt
    w1 = ext_pow_const(T, T.frobenius(elt, 1), mspec.final_exp_last_chunk_1)
    w0 = ext_pow_const(T, elt_inv if mspec.final_exp_w0_neg else elt, mspec.final_exp_w0_abs)
    return T.mul(w1, w0)


def final_exponentiation(mspec: MNTSpec, f):
    T = mspec.gt
    f_inv = T.inv(f)
    return _last_chunk(mspec, _first_chunk(mspec, f, f_inv), _first_chunk(mspec, f_inv, f))


def pairing(mspec: MNTSpec, P: AffinePoints, Q: ExtAffine):
    """The product over the pairs of e(P_i, Q_i) (a multi-pairing)."""
    return final_exponentiation(
        mspec, multi_miller_loop(mspec, g1_prepare(mspec, P), g2_prepare(mspec, Q)))


def pairing_each(mspec: MNTSpec, P: AffinePoints, Q: ExtAffine):
    """Per-pair pairings e(P_i, Q_i), no product across pairs."""
    return final_exponentiation(
        mspec, multi_miller_loop(mspec, g1_prepare(mspec, P), g2_prepare(mspec, Q), False))
