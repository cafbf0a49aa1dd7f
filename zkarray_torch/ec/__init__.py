"""Elliptic-curve group law and MSM."""

from zkarray_torch.ec import sw
from zkarray_torch.ec.sw import AffinePoints, JacobianPoints, SWCurveSpec, XYZZPoints

__all__ = ["sw", "AffinePoints", "JacobianPoints", "SWCurveSpec", "XYZZPoints"]
