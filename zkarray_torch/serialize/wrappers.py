"""Serde-style mode wrappers and the hash extension.

Counterpart of zkarray/serialize/wrappers.py: the Compress x Validate
modes and hash = H(canonical bytes) (CanonicalSerializeHashExt).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class Mode:
    compress: bool
    validate: bool


COMPRESSED_CHECKED = Mode(True, True)
COMPRESSED_UNCHECKED = Mode(True, False)
UNCOMPRESSED_CHECKED = Mode(False, True)
UNCOMPRESSED_UNCHECKED = Mode(False, False)


def hash_canonical(serialize_fn: Callable[[], "bytes"], hash_name: str = "sha256") -> bytes:
    """H(canonical bytes) of what ``serialize_fn`` returns (bytes or a uint8
    array)."""
    data = serialize_fn()
    if not isinstance(data, (bytes, bytearray)):
        data = bytes(bytearray(data.reshape(-1)))
    return hashlib.new(hash_name, data).digest()
