"""GLV scalar multiplication on curves with an efficient endomorphism.

Counterpart of zkarray/ec/glv.py: each scalar split on the host into
k = k1 + lambda k2 (mod r) with |k1|, |k2| ~ sqrt(r) by the lattice basis
and exact rational rounding, then one joint double-and-add ladder over the
half-length scalars shared by the batch, the addend picked per point from
{P, phi(P), P + phi(P)} with phi(x, y) = (beta x, y). On a CUDA device each
ladder step is a chain of field kernel launches (ec/sw.py, ec/sw_ext.py);
the ladder is about half as long as ec/sw.py:scalar_mul's.

The specs of BLS12-381, BN254, BLS12-377, BW6-761, Pallas and Vesta G1
and of BLS12-381 G2 are here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from zkarray_torch.core import limbs as lb
from zkarray_torch.ec import sw, sw_ext
from zkarray_torch.ec.sw import AffinePoints, JacobianPoints
from zkarray_torch.ff import fp


def _round_div(a: int, b: int) -> int:
    d, m = divmod(a, b)
    return d + (1 if 2 * m > b else 0)


class GLVSpec:
    def __init__(self, curve, endo_coeff, lam: int, decomp):
        """decomp: [(sign, abs), ...], the 2 x 2 basis row-major
        [n11, n12, n21, n22] (sign True for nonnegative)."""
        self.curve = curve
        self.endo_coeff = endo_coeff
        self.lam = lam
        self.decomp = [(s if isinstance(s, bool) else s >= 0, abs(v)) for s, v in decomp]

    def __hash__(self):
        return hash((self.curve, self.lam))

    def __eq__(self, o):
        return type(o) is type(self) and (o.curve, o.lam) == (self.curve, self.lam)

    def decompose(self, k: int) -> Tuple[int, int]:
        """k = k1 + lambda k2 (mod r); signed (k1, k2), |ki| ~ sqrt(r)."""
        r = self.curve.scalar.modulus
        n11, n12, n21, n22 = (v if s else -v for s, v in self.decomp)
        beta_1 = _round_div(k * n22, r)
        beta_2 = _round_div(k * (-n12), r)
        k1 = k - (beta_1 * n11 + beta_2 * n21)
        k2 = -(beta_1 * n12 + beta_2 * n22)
        assert (k1 + self.lam * k2 - k) % r == 0
        return k1, k2


class GLVSpecExt(GLVSpec):
    """GLV on a curve over an extension field (G2): phi(x, y) = (ENDO x, y)
    with ENDO a host element of the field."""

    def __init__(self, curve, endo_host, lam: int, decomp):
        super().__init__(curve, endo_host, lam, decomp)
        self.endo_host = endo_host


def endomorphism(g: GLVSpec, A: AffinePoints) -> AffinePoints:
    """phi(x, y) = (beta x, y)."""
    f = g.curve.base
    return AffinePoints(fp.mont_mul(f, A.x, fp.const_array(f, g.endo_coeff, (), A.x.device)),
                        A.y, A.inf)


def endomorphism_ext(g: GLVSpecExt, A: sw_ext.ExtAffine) -> sw_ext.ExtAffine:
    F = g.curve.ops
    return sw_ext.ExtAffine(F.mul(A.x, F.const(g.endo_host, F.batch_shape_of(A.x), A.x.device)),
                            A.y, A.inf)


def _split(g: GLVSpec, scalars, device):
    """Host decomposition: (|k1| limbs, |k2| limbs, k1 < 0, k2 < 0, ladder bits)."""
    curve = g.curve
    r = curve.scalar.modulus
    parts = [g.decompose(int(k) % r) for k in scalars]
    L = curve.scalar.num_limbs

    def limbs(vals):
        return torch.from_numpy(lb.ints_to_limbs_np(vals, L).astype(np.int32)).to(device)

    def signs(vals):
        return torch.from_numpy(np.asarray(vals, dtype=bool)).to(device)

    return (limbs([abs(k1) for k1, _ in parts]), limbs([abs(k2) for _, k2 in parts]),
            signs([k1 < 0 for k1, _ in parts]), signs([k2 < 0 for _, k2 in parts]),
            (curve.scalar.bits + 1) // 2 + 2)


def _ladder_bits(k1, k2, nbits: int):
    """Per step, most significant first: (b1, b2) bool rows of the halves."""
    for i in range(nbits):
        limb, shift = divmod(nbits - 1 - i, 16)
        yield ((k1[limb] >> shift) & 1) == 1, ((k2[limb] >> shift) & 1) == 1


def glv_mul(g: GLVSpec, A: AffinePoints, scalars) -> JacobianPoints:
    """k_i P_i for host-int scalars: decomposition on the host, the joint
    ladder on the points' device."""
    k1, k2, s1, s2, nbits = _split(g, scalars, A.x.device)
    return _glv_ladder(g, A, k1, k2, s1, s2, nbits)


def _glv_ladder(g: GLVSpec, A: AffinePoints, k1, k2, s1, s2, nbits: int) -> JacobianPoints:
    curve = g.curve
    f = curve.base
    P = AffinePoints(A.x, fp.select(s1, fp.neg(f, A.y), A.y), A.inf)
    phiA = endomorphism(g, A)
    Q = AffinePoints(phiA.x, fp.select(s2, fp.neg(f, phiA.y), phiA.y), phiA.inf)
    PQ = sw.to_affine(curve, sw.jac_add_mixed(curve, sw.from_affine(curve, P), Q))
    acc = sw.jac_zero(curve, A.x.shape[1:], A.x.device)
    for b1, b2 in _ladder_bits(k1, k2, nbits):
        acc = sw.jac_double(curve, acc)
        both, only1 = b1 & b2, b1 & ~b2
        addend = AffinePoints(fp.select(both, PQ.x, fp.select(only1, P.x, Q.x)),
                              fp.select(both, PQ.y, fp.select(only1, P.y, Q.y)),
                              torch.where(both, PQ.inf, torch.where(only1, P.inf, Q.inf)))
        acc = sw.select_jac(b1 | b2, sw.jac_add_mixed(curve, acc, addend), acc)
    return acc


def glv_mul_ext(g: GLVSpecExt, A: sw_ext.ExtAffine, scalars) -> sw_ext.ExtJacobian:
    """k_i P_i on a G2-style curve: host decomposition, joint ladder."""
    k1, k2, s1, s2, nbits = _split(g, scalars, A.x.device)
    return _glv_ladder_ext(g, A, k1, k2, s1, s2, nbits)


def _glv_ladder_ext(g: GLVSpecExt, A, k1, k2, s1, s2, nbits: int) -> sw_ext.ExtJacobian:
    curve = g.curve
    F = curve.ops
    P = sw_ext.ExtAffine(A.x, F.select(s1, F.neg(A.y), A.y), A.inf)
    phiA = endomorphism_ext(g, A)
    Q = sw_ext.ExtAffine(phiA.x, F.select(s2, F.neg(phiA.y), phiA.y), phiA.inf)
    PQ = sw_ext.to_affine(curve, sw_ext.add(curve, sw_ext.from_affine(curve, P),
                                            sw_ext.from_affine(curve, Q)))

    def sel_aff(mask, a, b):
        return sw_ext.ExtAffine(F.select(mask, a.x, b.x), F.select(mask, a.y, b.y),
                                torch.where(mask, a.inf, b.inf))

    acc = sw_ext.zero(curve, F.batch_shape_of(A.x), A.x.device)
    for b1, b2 in _ladder_bits(k1, k2, nbits):
        acc = sw_ext.double(curve, acc)
        addend = sel_aff(b1 & b2, PQ, sel_aff(b1 & ~b2, P, Q))
        added = sw_ext.add(curve, acc, sw_ext.from_affine(curve, addend))
        acc = sw_ext._sel(curve, b1 | b2, added, acc)
    return acc


# ---- parameter sets (the JAX package's, zkarray/ec/glv.py:140-372) ----

def bls12_381_g1_glv() -> GLVSpec:
    from zkarray_torch.curves import bls12_381 as b

    return GLVSpec(
        b.G1,
        endo_coeff=793479390729215512621379701633421447060886740281060493010456487427281649075476305620758731620350,
        lam=52435875175126190479447740508185965837461563690374988244538805122978187051009,
        decomp=[(True, 228988810152649578064853576960394133504), (True, 1), (False, 1),
                (True, 228988810152649578064853576960394133503)],
    )


def bn254_g1_glv() -> GLVSpec:
    from zkarray_torch.curves import bn254 as b

    return GLVSpec(
        b.G1,
        endo_coeff=21888242871839275220042445260109153167277707414472061641714758635765020556616,
        lam=21888242871839275217838484774961031246154997185409878258781734729429964517155,
        decomp=[(False, 147946756881789319000765030803803410728), (True, 9931322734385697763),
                (False, 9931322734385697763), (False, 147946756881789319010696353538189108491)],
    )


def bls12_377_g1_glv() -> GLVSpec:
    from zkarray_torch.curves import bls12_377 as b

    return GLVSpec(
        b.G1,
        endo_coeff=258664426012969093929703085429980814127835149614277183275038967946009968870203535512256352201271898244626862047231,
        lam=8444461749428370424248824938781546531284005582649182570233710176290576793600,
        decomp=[(True, 91893752504881257701523279626832445441), (True, 1), (False, 1),
                (True, 91893752504881257701523279626832445440)],
    )


def bw6_761_g1_glv() -> GLVSpec:
    from zkarray_torch.curves import bw6_761 as b

    return GLVSpec(
        b.G1,
        endo_coeff=4922464560225523242118178942575080391082002530232324381063048548642823052024664478336818169867474395270858391911405337707247735739826664939444490469542109391530482826728203582549674992333383150446779312029624171857054392282775648,
        lam=258664426012969093929703085429980814127835149614277183275038967946009968870203535512256352201271898244626862047231,
        decomp=[(True, 293634935485640680722085584138834120324914961969255022593),
                (False, 293634935485640680722085584138834120315328839056164388863),
                (True, 293634935485640680722085584138834120315328839056164388863),
                (True, 587269870971281361444171168277668240640243801025419411456)],
    )


def pallas_glv() -> GLVSpec:
    from zkarray_torch.curves import zoo

    return GLVSpec(
        zoo.PALLAS,
        endo_coeff=20444556541222657078399132219657928148671392403212669005631716460534733845831,
        lam=26005156700822196841419187675678338661165322343552424574062261873906994770353,
        decomp=[(False, 98231058071100081932162823354453065728),
                (True, 98231058071186745657228807397848383489),
                (False, 196462116142286827589391630752301449217),
                (False, 98231058071100081932162823354453065728)],
    )


def vesta_glv() -> GLVSpec:
    from zkarray_torch.curves import zoo

    return GLVSpec(
        zoo.VESTA,
        endo_coeff=26005156700822196841419187675678338661165322343552424574062261873906994770353,
        lam=20444556541222657078399132219657928148671392403212669005631716460534733845831,
        decomp=[(False, 98231058071100081932162823354453065729),
                (True, 98231058071186745657228807397848383488),
                (False, 196462116142286827589391630752301449217),
                (False, 98231058071100081932162823354453065729)],
    )


def bls12_381_g2_glv() -> GLVSpecExt:
    from zkarray_torch.curves import bls12_381 as b

    return GLVSpecExt(
        b.G2,
        endo_host=(793479390729215512621379701633421447060886740281060493010456487427281649075476305620758731620350, 0),
        lam=228988810152649578064853576960394133503,
        decomp=[(False, 228988810152649578064853576960394133503), (True, 1), (False, 1),
                (False, 228988810152649578064853576960394133504)],
    )
