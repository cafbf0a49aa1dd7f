"""Canonical serialization of field elements, bit-exact with arkworks.

Counterpart of zkarray/serialize/canonical.py. A field element serializes as
the little-endian bytes of its canonical (non-Montgomery) value, truncated
to ceil((MODULUS_BITS + FLAG_BITS) / 8) bytes, with the flag bitmask OR'd
into the top bits of the last byte. Flags: SWFlags (2 bits: infinity
1 << 6, y negative 1 << 7), TEFlags (1 bit: x negative 1 << 7), none.

Bytes are host numpy; a field tensor crosses to or from the host in one
copy per call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ff import fp

EMPTY_FLAGS = 0
SW_FLAG_INFINITY = 1 << 6
SW_FLAG_NEGATIVE = 1 << 7
TE_FLAG_NEGATIVE = 1 << 7


def field_byte_size(spec: FieldSpec, flag_bits: int = 0) -> int:
    """buffer_byte_size(MODULUS_BIT_SIZE + flag bits)."""
    return (spec.bits + flag_bits + 7) // 8


def limbs_to_bytes(canon: torch.Tensor, nbytes: int) -> np.ndarray:
    """(L, *batch) canonical 16-bit limbs -> (n, nbytes) little-endian uint8
    (one copy to the host)."""
    L = canon.shape[0]
    host = canon.detach().reshape(L, -1).T.contiguous().cpu().numpy()
    return np.ascontiguousarray(host.astype("<u2").view(np.uint8)[:, :nbytes])


def bytes_to_limbs(spec: FieldSpec, data: np.ndarray) -> np.ndarray:
    """(n, k) little-endian uint8 -> (L, n) int32 canonical limbs, zero-padded."""
    n, k = data.shape
    buf = np.zeros((n, 2 * spec.num_limbs), dtype=np.uint8)
    buf[:, :k] = data
    return np.ascontiguousarray(buf.view("<u2").T.astype(np.int32))


def below_modulus(spec: FieldSpec, limbs: np.ndarray) -> np.ndarray:
    """(L, n) canonical limbs -> (n,) bool: value < p, compared limb by limb
    from the top."""
    lt = np.zeros(limbs.shape[1], dtype=bool)
    decided = np.zeros(limbs.shape[1], dtype=bool)
    for li, pi in zip(limbs[::-1], spec.modulus_limbs[::-1]):
        lt |= ~decided & (li < pi)
        decided |= li != pi
    return lt


def serialize_fp(spec: FieldSpec, a: torch.Tensor, flag_bits: int = 0,
                 flags: Optional[np.ndarray] = None, mont: bool = True) -> np.ndarray:
    """Field tensor -> (n, nbytes) little-endian canonical bytes, with
    ``flags`` (per-element uint8 masks, already shifted) OR'd into the top
    ``flag_bits`` bits of the last byte."""
    if flag_bits > 8:
        raise ValueError("flags must fit one byte (Flags::BIT_SIZE <= 8)")
    out = limbs_to_bytes(fp.from_mont(spec, a) if mont else a, field_byte_size(spec, flag_bits))
    if flags is not None:
        out[:, -1] |= np.asarray(flags, dtype=np.uint8).reshape(-1)
    return out


def deserialize_fp(spec: FieldSpec, data: np.ndarray, flag_bits: int = 0, mont: bool = True,
                   validate: bool = True, device=DEFAULT_DEVICE
                   ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """(n, nbytes) little-endian bytes -> (field tensor (L, n) on ``device``,
    flags uint8 (n,), valid (n,)). A value >= p is marked invalid under
    ``validate``, where the reference would raise."""
    data = np.asarray(data, dtype=np.uint8)
    if data.ndim == 1:
        data = data[None]
    nbytes = field_byte_size(spec, flag_bits)
    if data.shape[1] != nbytes:
        raise ValueError(f"expected {nbytes} bytes per element, got {data.shape[1]}")
    data = data.copy()
    flags_mask = (0xFF << (8 - flag_bits)) & 0xFF if flag_bits else 0
    flags = (data[:, -1] & flags_mask).astype(np.uint8)
    data[:, -1] &= 0xFF ^ flags_mask
    limbs = bytes_to_limbs(spec, data)
    valid = below_modulus(spec, limbs) if validate else np.ones(data.shape[0], dtype=bool)
    arr = torch.from_numpy(limbs).to(device)
    return (fp.to_mont(spec, arr) if mont else arr), flags, valid
