"""Carrying arrays and constants across between the JAX package and the port.

The JAX package's field arrays are ``uint32[L, *batch]`` (``np.asarray`` of a
jax array); the port's are ``int32[L, *batch]`` torch tensors with the same
bit patterns (16-bit limbs, or packed 32-bit words shown as int32). These
functions take and give numpy arrays, so the port never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ec.double_odd import DOCurveSpec, DOProjective
from zkarray_torch.ec.pairing import bw6, cp6, mnt
from zkarray_torch.ec.pairing.bls12 import G2Prepared
from zkarray_torch.ec.pairing.bn import BnG2Prepared, BnSpec
from zkarray_torch.ec.sw import AffinePoints, JacobianPoints, SWCurveSpec, XYZZPoints
from zkarray_torch.ec.sw_ext import ExtAffine, ExtJacobian
from zkarray_torch.ec.te import TECurveSpec, TEExtended


def limbs_from_numpy(arr, device=DEFAULT_DEVICE) -> torch.Tensor:
    """uint32 (or any 32-bit) numpy limb array -> int32 tensor, bit for bit."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.itemsize != 4 or a.dtype.kind not in "iu":
        raise TypeError(f"expected a 32-bit integer array, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array, bit for bit."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def affine_from_numpy(x, y, inf, device=DEFAULT_DEVICE) -> AffinePoints:
    return AffinePoints(limbs_from_numpy(x, device), limbs_from_numpy(y, device),
                        torch.from_numpy(np.asarray(inf, dtype=bool).copy()).to(device))


def affine_to_numpy(A: AffinePoints):
    return limbs_to_numpy(A.x), limbs_to_numpy(A.y), A.inf.detach().cpu().numpy()


def jacobian_from_numpy(coords, device=DEFAULT_DEVICE) -> JacobianPoints:
    """Three (L, *batch) uint32 arrays (x, y, z) -> JacobianPoints."""
    return JacobianPoints(*(limbs_from_numpy(v, device) for v in coords))


def jacobian_to_numpy(P: JacobianPoints):
    return tuple(limbs_to_numpy(v) for v in P)


def xyzz_from_numpy(coords, device=DEFAULT_DEVICE) -> XYZZPoints:
    """Four (L, *batch) uint32 arrays (x, y, zz, zzz) -> XYZZPoints."""
    return XYZZPoints(*(limbs_from_numpy(v, device) for v in coords))


def xyzz_to_numpy(P: XYZZPoints):
    return tuple(limbs_to_numpy(v) for v in P)


def te_extended_from_numpy(coords, device=DEFAULT_DEVICE) -> TEExtended:
    """Four (L, *batch) uint32 arrays (x, y, t, z) -> TEExtended."""
    return TEExtended(*(limbs_from_numpy(v, device) for v in coords))


def te_extended_to_numpy(P: TEExtended):
    return tuple(limbs_to_numpy(v) for v in P)


def do_projective_from_numpy(coords, device=DEFAULT_DEVICE) -> DOProjective:
    """Four (L, *batch) uint32 arrays (e, z, u, t) -> DOProjective."""
    return DOProjective(*(limbs_from_numpy(v, device) for v in coords))


def do_projective_to_numpy(P: DOProjective):
    return tuple(limbs_to_numpy(v) for v in P)


def ext_affine_from_numpy(x, y, inf, device=DEFAULT_DEVICE) -> ExtAffine:
    """Tower-element coordinates ((deg,) + base.shape + (L, *batch) uint32)
    and the infinity mask -> ExtAffine."""
    return ExtAffine(limbs_from_numpy(x, device), limbs_from_numpy(y, device),
                     torch.from_numpy(np.asarray(inf, dtype=bool).copy()).to(device))


def ext_affine_to_numpy(A: ExtAffine):
    return limbs_to_numpy(A.x), limbs_to_numpy(A.y), A.inf.detach().cpu().numpy()


def ext_jacobian_from_numpy(coords, device=DEFAULT_DEVICE) -> ExtJacobian:
    """Three tower-element arrays (x, y, z) -> ExtJacobian."""
    return ExtJacobian(*(limbs_from_numpy(v, device) for v in coords))


def ext_jacobian_to_numpy(P: ExtJacobian):
    return tuple(limbs_to_numpy(v) for v in P)


def g2_prepared_from_numpy(dbl, add, inf, add_rows=None, device=DEFAULT_DEVICE) -> G2Prepared:
    """Line coefficients (nbits, 3, 2, L, *batch) and the mask -> G2Prepared.
    The JAX package keeps an add-step slot for every bit; pass the set bits
    (``Bls12Spec.add_bits``) as ``add_rows`` to keep those rows only."""
    add = np.asarray(add)
    if add_rows is not None:
        add = add[list(add_rows)]
    return G2Prepared(limbs_from_numpy(dbl, device), limbs_from_numpy(add, device),
                      torch.from_numpy(np.asarray(inf, dtype=bool).copy()).to(device))


def g2_prepared_to_numpy(Qp: G2Prepared):
    return limbs_to_numpy(Qp.dbl_coeffs), limbs_to_numpy(Qp.add_coeffs), Qp.inf.detach().cpu().numpy()


def _mask(inf, device):
    return torch.from_numpy(np.asarray(inf, dtype=bool).copy()).to(device)


def bn_g2_prepared_from_numpy(bspec: BnSpec, dbl, add, q1, q2, inf,
                              device=DEFAULT_DEVICE) -> BnG2Prepared:
    """The JAX package's BnG2Prepared arrays -> the port's: its add-step
    coefficients hold one slot per digit of 6X + 2 (64, 3, 2, L, *batch),
    of which the port keeps the nonzero digits' (``BnSpec.add_digits``)."""
    add = np.asarray(add)
    if add.shape[0] != len(bspec.digits):
        raise ValueError(f"expected {len(bspec.digits)} add-step slots, got {add.shape[0]}")
    return BnG2Prepared(limbs_from_numpy(dbl, device), limbs_from_numpy(add[bspec.add_digits], device),
                        limbs_from_numpy(q1, device), limbs_from_numpy(q2, device), _mask(inf, device))


def bw6_g2_prepared_from_numpy(bspec, dbl_1, add_1, extra, dbl_2, add_2, inf,
                               device=DEFAULT_DEVICE) -> "bw6.G2Prepared":
    """The JAX package's BW6 G2Prepared arrays -> the port's: its add steps
    hold one slot per bit of u (add_1) and per digit of loop 2 (add_2), of
    which the port keeps the set bits' and the nonzero digits'
    (``BW6Spec.add_rows_1``/``add_rows_2``)."""
    add_1, add_2 = np.asarray(add_1), np.asarray(add_2)
    if (add_1.shape[0], add_2.shape[0]) != (len(bspec.loop_1_bits), len(bspec.digits_2)):
        raise ValueError(f"expected {len(bspec.loop_1_bits)} and {len(bspec.digits_2)} add-step "
                         f"slots, got {add_1.shape[0]} and {add_2.shape[0]}")
    return bw6.G2Prepared(limbs_from_numpy(dbl_1, device),
                          limbs_from_numpy(add_1[bspec.add_rows_1], device),
                          limbs_from_numpy(extra, device), limbs_from_numpy(dbl_2, device),
                          limbs_from_numpy(add_2[bspec.add_rows_2], device), _mask(inf, device))


def _add_slots(add, steps: int, rows, what: str) -> np.ndarray:
    """The add-step rows the port keeps: the JAX package's arrays hold one
    slot per ladder step (``steps``), of which the rows ``rows`` are read."""
    add = np.asarray(add)
    if add.shape[0] != steps:
        raise ValueError(f"{what}: expected {steps} add-step slots, got {add.shape[0]}")
    return add[list(rows)]


def mnt_g1_prepared_from_numpy(x, y, x_twist, y_twist, inf, device=DEFAULT_DEVICE) -> "mnt.G1Prepared":
    """The JAX package's MNT G1Prepared arrays -> the port's."""
    return mnt.G1Prepared(*(limbs_from_numpy(v, device) for v in (x, y, x_twist, y_twist)),
                          _mask(inf, device))


def mnt_g2_prepared_from_numpy(mspec, x_over_twist, y_over_twist, dbl, add, final_add, inf,
                               device=DEFAULT_DEVICE) -> "mnt.G2Prepared":
    """The JAX package's MNT G2Prepared arrays -> the port's: its add-step
    coefficients hold a slot per digit of the loop count, of which the port
    keeps the nonzero digits' (``MNTSpec.add_rows``)."""
    add = _add_slots(add, len(mspec.digits), mspec.add_rows, "mnt_g2_prepared_from_numpy")
    return mnt.G2Prepared(limbs_from_numpy(x_over_twist, device), limbs_from_numpy(y_over_twist, device),
                          limbs_from_numpy(dbl, device), limbs_from_numpy(add, device),
                          limbs_from_numpy(final_add, device), _mask(inf, device))


def mnt_g2_prepared_to_numpy(Qp: "mnt.G2Prepared"):
    """-> (x_over_twist, y_over_twist, dbl_coeffs, add_coeffs at the nonzero
    digits, final_add, inf) as numpy arrays."""
    return tuple(limbs_to_numpy(v) for v in Qp[:5]) + (Qp.inf.detach().cpu().numpy(),)


def cp6_g2_prepared_from_numpy(spec, dbl_gro, dbl_gt, add_gro, add_gt, inf,
                               device=DEFAULT_DEVICE) -> "cp6.CP6G2Prepared":
    """The JAX package's CP6G2Prepared arrays -> the port's: its add-step
    lines hold a slot per ladder step (zeros at a clear bit), of which the
    port keeps the set bits' (``CP6Spec.add_rows``); the JAX package's
    ``bits`` mask is the spec's own (``CP6Spec.steps_bits``)."""
    steps = len(spec.steps_bits)
    add_gro = _add_slots(add_gro, steps, spec.add_rows, "cp6_g2_prepared_from_numpy")
    add_gt = _add_slots(add_gt, steps, spec.add_rows, "cp6_g2_prepared_from_numpy")
    return cp6.CP6G2Prepared(*(limbs_from_numpy(v, device) for v in (dbl_gro, dbl_gt, add_gro, add_gt)),
                             _mask(inf, device))


def cp6_g2_prepared_to_numpy(Qp: "cp6.CP6G2Prepared"):
    """-> (dbl_gro, dbl_gt, add_gro, add_gt at the set bits, inf) as numpy
    arrays."""
    return tuple(limbs_to_numpy(v) for v in Qp[:4]) + (Qp.inf.detach().cpu().numpy(),)


def gt_from_numpy(ext, arr, device=DEFAULT_DEVICE) -> torch.Tensor:
    """A JAX package GT stack (a target-field element array, ext.shape +
    (L, *batch)) -> the port's tensor, its shape checked."""
    a = np.asarray(arr)
    lead = tuple(ext.shape) + (ext.spec.num_limbs,)
    if a.shape[:len(lead)] != lead:
        raise ValueError(f"expected a {ext.name} stack {lead} + batch, got {a.shape}")
    return limbs_from_numpy(a, device)


def _index_tensor(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr).astype(np.int64)).to(device)


def sparse_uv_from_numpy(degrees, coeffs, device=DEFAULT_DEVICE):
    """A JAX package sparse univariate polynomial (uint32 degrees (k,),
    coefficient limbs (L, k)) -> the port's (int64 degrees, int32 limbs)."""
    return _index_tensor(degrees, device), limbs_from_numpy(coeffs, device)


def sparse_mv_from_numpy(powers, coeffs, device=DEFAULT_DEVICE):
    """A JAX package sparse multivariate polynomial (uint32 powers
    (k, num_vars), coefficient limbs (L, k)) -> the port's."""
    return _index_tensor(powers, device), limbs_from_numpy(coeffs, device)


def fixed_base_table_from_numpy(curve: SWCurveSpec, tx, ty, tinf, window: int,
                                device=DEFAULT_DEVICE):
    """A JAX package FixedBaseTable's arrays (tx, ty (L, outerc, 2^window)
    Montgomery limbs, tinf (outerc, 2^window) bool) -> the port's table,
    with no host construction."""
    from zkarray_torch.ec.fixed_base import FixedBaseTable

    t = FixedBaseTable.__new__(FixedBaseTable)
    t.curve, t.window = curve, window
    t.tx, t.ty = limbs_from_numpy(tx, device), limbs_from_numpy(ty, device)
    t.tinf = torch.from_numpy(np.asarray(tinf, dtype=bool).copy()).to(device)
    t.outerc = t.tx.shape[1]
    if t.outerc != -(-curve.scalar.bits // window) or t.tx.shape[2] != 1 << window:
        raise ValueError(f"table {tuple(t.tx.shape)} does not fit window {window} of {curve.name}")
    return t


def wnaf_context_from_numpy(curve: SWCurveSpec, tx, ty, device=DEFAULT_DEVICE):
    """A JAX package WnafContext's table (tx, ty (L, 2^(w-1)) Montgomery
    limbs of the odd multiples) -> the port's context."""
    from zkarray_torch.ec.wnaf import WnafContext

    ctx = WnafContext.__new__(WnafContext)
    ctx.curve = curve
    ctx.tx, ctx.ty = limbs_from_numpy(tx, device), limbs_from_numpy(ty, device)
    ctx.window = ctx.tx.shape[1].bit_length()
    if 1 << (ctx.window - 1) != ctx.tx.shape[1]:
        raise ValueError(f"{ctx.tx.shape[1]} table entries is not 2^(w-1)")
    return ctx


def same_field(spec: FieldSpec, modulus: int, generator: int, r_int: int, r2_int: int,
               inv16: int) -> bool:
    """True when the port's field constants equal the given ints."""
    return (spec.modulus, spec.generator_int, spec.r_int, spec.r2_int, spec.inv16) == (
        modulus, generator % modulus, r_int, r2_int, inv16)


def same_curve(curve: SWCurveSpec, a: int, b: int, gen_x: int, gen_y: int,
               cofactor: int) -> bool:
    """True when the port's curve constants equal the given ints."""
    return (curve.a_int, curve.b_int, curve.gen_x, curve.gen_y, curve.cofactor) == (
        a % curve.base.modulus, b % curve.base.modulus, gen_x, gen_y, cofactor)


def same_te_curve(curve: TECurveSpec, a: int, d: int, gen_x: int, gen_y: int, cofactor: int,
                  mont_coeff_a, mont_coeff_b) -> bool:
    """True when the port's twisted Edwards constants equal the given ints."""
    return (curve.a_int, curve.d_int, curve.gen_x, curve.gen_y, curve.cofactor,
            curve.mont_coeff_a, curve.mont_coeff_b) == (
        a % curve.base.modulus, d % curve.base.modulus, gen_x, gen_y, cofactor, mont_coeff_a,
        mont_coeff_b)


def same_do_curve(curve: DOCurveSpec, a: int, b: int, gen_e: int, gen_u: int,
                  cofactor: int) -> bool:
    """True when the port's double-odd constants equal the given ints."""
    p = curve.base.modulus
    return (curve.a_int, curve.b_int, curve.gen_e, curve.gen_u, curve.cofactor) == (
        a % p, b % p, gen_e % p, gen_u % p, cofactor)
