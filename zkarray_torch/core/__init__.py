"""Field constants and planar limb primitives."""

from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.core import limbs

__all__ = ["FieldSpec", "limbs"]
