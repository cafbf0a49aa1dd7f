"""ToConstraintField analog: flatten values to base-field element vectors
(R1CS public-input packing).

Counterpart of zkarray/ff/to_field_vec.py: field elements map to their
base-prime-field decomposition; bytes pack into field elements of
(bits - 1) // 8 bytes each; curve points map to their (x, y) coordinates.
"""

from __future__ import annotations

from typing import List

import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ff import fp


def field_to_field_vec(spec: FieldSpec, a: torch.Tensor) -> List[torch.Tensor]:
    """Prime-field elements: identity decomposition [a]."""
    return [a]


def bytes_to_field_vec(spec: FieldSpec, data: bytes, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Pack bytes into field elements, (MODULUS_BITS - 1) // 8 little-endian
    bytes each, the last chunk short; Montgomery form (L, chunks)."""
    per = (spec.bits - 1) // 8
    vals = [int.from_bytes(data[i:i + per], "little") for i in range(0, len(data), per)]
    return fp.from_ints(spec, vals, device=device)


def affine_to_field_vec(curve, pts) -> List[torch.Tensor]:
    """SW affine points -> [x, y] coordinate tensors."""
    return [pts.x, pts.y]
