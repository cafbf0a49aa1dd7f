"""CP6-782 pairing engine (Zexe's outer curve over BLS12-377), batched over
the pairs axis.

Counterpart of zkarray/ec/pairing/cp6.py: an ate Miller loop whose G2 ladder
runs in affine coordinates (one inversion per step), and a two-chunk final
exponentiation (the easy part by the third Frobenius power, then the
Frobenius to the W1 and the (inverse) element to the |W0| by cyclotomic
ladders). Every quantity of the ladder depends on Q alone, so the whole
affine ladder runs once on the host over Python ints, as in the JAX
package's design (``g2_prepare_host``); what goes to the device is a dense
stack of line coefficients. The Miller loop is an Fq6 square and line
products per step, batched over the pairs, each tower product one mont_mul
launch on a CUDA device and each linear op one fp_add or fp_sub launch.

Where the JAX package inverts in Fq3 by Fermat on the host (tower_host.py
there: a^(p^3 - 2), ~132 ms for a 782-bit Fq3 element on a CPU, so ~155 s a
G2 point), the port's ``HostExt.inv`` inverts through the norm with one
prime-field inverse; the inverse is unique, so the coefficients are the
same. The JAX package computes the add-step line at every step and
selects; this computes it only at the set bits of the loop count (the
select keeps f elsewhere), so ``CP6G2Prepared.add_gro``/``add_gt`` hold
only those steps' slots, in order (``CP6Spec.add_rows``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.ec.sw import AffinePoints, SWCurveSpec
from zkarray_torch.ec.pairing.mnt import row_chunks
from zkarray_torch.ec.sw_ext import ExtCurveSpec
from zkarray_torch.ff import cyclotomic as cyc
from zkarray_torch.ff.towers import combine_pairs


class CP6Spec:
    def __init__(self, name, fq_spec, fq3, fq6, g1_curve: SWCurveSpec, g2_curve: ExtCurveSpec,
                 twist_host, ate_loop_count: int, w0_abs: int, w0_neg: bool, w1: int):
        self.name = name
        self.fq = fq_spec
        self.fq3 = fq3
        self.fq6 = fq6
        self.g1 = g1_curve
        self.g2 = g2_curve
        self.twist_host = twist_host
        self.ate_loop_count = ate_loop_count
        self.w0_abs = w0_abs
        self.w0_neg = w0_neg
        self.w1 = w1
        self.steps_bits = [int(b) for b in bin(ate_loop_count)[3:]]  # below the leading one
        self.add_rows = [i for i, b in enumerate(self.steps_bits) if b]

    def __hash__(self):
        return hash((self.name, self.ate_loop_count))

    def __eq__(self, o):
        return isinstance(o, CP6Spec) and o.name == self.name

    def __repr__(self):
        return f"CP6Spec({self.name})"


class CP6G2Prepared(NamedTuple):
    """Host-computed line data, each (rows, 3, L, n): ``dbl_gro`` = gamma
    old_rx - old_ry and ``dbl_gt`` = gamma TWIST per doubling step;
    ``add_gro`` = gamma' qx - qy and ``add_gt`` = gamma' TWIST per step at a
    set bit (``CP6Spec.add_rows``); ``inf`` the (n,) infinity mask."""
    dbl_gro: torch.Tensor
    dbl_gt: torch.Tensor
    add_gro: torch.Tensor
    add_gt: torch.Tensor
    inf: torch.Tensor


def host_ladder(spec: CP6Spec, q):
    """The reference's affine ladder (cp6_782/src/curves/mod.rs:68-117) for
    one G2 point (x, y) of host Fq3 elements: per doubling step (gro, gt),
    per set bit (gro2, gt2)."""
    H = spec.fq3.host
    tw = spec.twist_host
    a = spec.g2.a_host
    three = H.embed(3)
    qx, qy = q
    rx, ry = qx, qy
    dbl, add = [], []
    for bit in spec.steps_bits:
        gamma = H.mul(H.add(H.mul(three, H.mul(rx, rx)), a), H.inv(H.add(ry, ry)))
        dbl.append((H.sub(H.mul(gamma, rx), ry), H.mul(gamma, tw)))
        nrx = H.sub(H.mul(gamma, gamma), H.add(rx, rx))
        ry = H.sub(H.mul(gamma, H.sub(rx, nrx)), ry)
        rx = nrx
        if bit:
            gamma2 = H.mul(H.sub(ry, qy), H.inv(H.sub(rx, qx)))
            add.append((H.sub(H.mul(gamma2, qx), qy), H.mul(gamma2, tw)))
            nrx = H.sub(H.sub(H.mul(gamma2, gamma2), rx), qx)
            ry = H.sub(H.mul(gamma2, H.sub(rx, nrx)), ry)
            rx = nrx
    return dbl, add


def _to_tensor(spec: CP6Spec, vals, rows: int, n: int, device) -> torch.Tensor:
    """Canonical Fq ints ordered (point, row, coefficient) -> the (rows, 3,
    L, n) Montgomery limb tensor, converted in one pass."""
    f = spec.fq
    L = f.num_limbs
    raw = b"".join((v * f.r_int % f.modulus).to_bytes(2 * L, "little") for v in vals)
    arr = np.frombuffer(raw, dtype="<u2").reshape(n, rows, 3, L).transpose(1, 2, 3, 0)
    return torch.from_numpy(arr.astype(np.int32)).to(device)


def g2_prepare_host(spec: CP6Spec, q_list, device=DEFAULT_DEVICE) -> CP6G2Prepared:
    """Prepare G2 points given as [(x, y)] of host Fq3 elements (tuples of
    three canonical ints): the affine ladder on the host, then one tensor
    per coefficient array."""
    ladders = [host_ladder(spec, q) for q in q_list]
    n = len(q_list)

    def stack(which, sel):
        vals = [c for lad in ladders for row in lad[which] for c in row[sel]]
        return _to_tensor(spec, vals, len(ladders[0][which]) if n else 0, n, device)

    return CP6G2Prepared(stack(0, 0), stack(0, 1), stack(1, 0), stack(1, 1),
                         torch.zeros((n,), dtype=torch.bool, device=device))


def _line_rows(spec: CP6Spec, P: AffinePoints, gro_rows, gt_rows):
    """Lines ell = (py TWIST^2, gro - gt px) for a block of k ladder rows,
    (k, *Fq6 element): TWIST = (0, 1, 0), so TWIST^2 = (0, 0, 1) and py
    TWIST^2 = (0, 0, py); the products gt px of the block are one call."""
    F3, F6 = spec.fq3, spec.fq6
    k = gro_rows.shape[0]
    L = spec.fq.num_limbs
    gro = gro_rows.movedim(0, 2)  # (3, L, k, *batch)
    gt = gt_rows.movedim(0, 2)
    px = P.x.unsqueeze(1).expand((L, k) + tuple(P.x.shape[1:]))
    py = P.y.unsqueeze(1).expand_as(px)
    z = torch.zeros_like(py)
    ell = F6._stack([torch.stack([z, z, py]), F3.sub(gro, F3.mul_base(gt, px))])
    return ell.movedim(len(F6.shape) + 1, 0).contiguous()


def multi_miller_loop(spec: CP6Spec, P: AffinePoints, Qp: CP6G2Prepared, combine: bool = True):
    """Per-pair Miller values (reference ate_miller_loop, mod.rs:57-119), 1
    where either input is infinity, or their product over the pairs when
    ``combine``. The lines depend on P and Q only, so they are built for
    blocks of ladder rows at once (mnt.row_chunks); each step is then an
    Fq6 square and a line product, and a second line product at a set bit
    (the JAX package's select keeps f at a clear bit)."""
    F6 = spec.fq6
    batch, dev = tuple(P.x.shape[1:]), P.x.device
    lanes = 1
    for s in batch:
        lanes *= s
    active = ~(P.inf | Qp.inf)

    def lines(gro, gt):
        for s, e in row_chunks(gro.shape[0], lanes):
            yield from _line_rows(spec, P, gro[s:e], gt[s:e]).unbind(0)

    dbl_lines = lines(Qp.dbl_gro, Qp.dbl_gt)
    add_lines = lines(Qp.add_gro, Qp.add_gt)
    f = F6.one(batch, dev)
    for bit in spec.steps_bits:
        f = F6.sqr(f)
        f = F6.select(active, F6.mul(f, next(dbl_lines)), f)
        if bit:
            f = F6.select(active, F6.mul(f, next(add_lines)), f)
    if not combine:
        return f
    return combine_pairs(F6, f.reshape(tuple(f.shape[: f.dim() - len(batch)]) + (lanes,)))


def _first_chunk(F6, elt, elt_inv):
    over = F6.mul(F6.frobenius(elt, 3), elt_inv)
    return F6.mul(F6.frobenius(over, 1), over)


def final_exponentiation(spec: CP6Spec, f):
    """Reference final_exponentiation (mod.rs:121-155): the first chunk
    f^((q^3 - 1)(q + 1)) of f and of its inverse, then Frob(vt)^W1 times vt
    or its inverse to the |W0|, both by cyclotomic ladders."""
    F6 = spec.fq6
    f_inv = F6.inv(f)
    vt = _first_chunk(F6, f, f_inv)
    vit = _first_chunk(F6, f_inv, f)
    w1_part = cyc.cyclotomic_exp_binary(F6, F6.frobenius(vt, 1), spec.w1)
    w0_part = cyc.cyclotomic_exp_binary(F6, vit if spec.w0_neg else vt, spec.w0_abs)
    return F6.mul(w1_part, w0_part)


def pairing_each(spec: CP6Spec, P: AffinePoints, q_list):
    """Per-pair pairings; ``q_list`` are host G2 points (preparation is a
    host step for this family)."""
    Qp = g2_prepare_host(spec, q_list, P.x.device)
    return final_exponentiation(spec, multi_miller_loop(spec, P, Qp, False))
