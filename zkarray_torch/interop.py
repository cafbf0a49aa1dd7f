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
from zkarray_torch.ec.sw import AffinePoints, JacobianPoints, SWCurveSpec, XYZZPoints


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
