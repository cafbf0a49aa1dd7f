"""Canonical (arkworks) serialization of field elements and mode wrappers."""

from zkarray_torch.serialize.canonical import (
    EMPTY_FLAGS,
    SW_FLAG_INFINITY,
    SW_FLAG_NEGATIVE,
    TE_FLAG_NEGATIVE,
    deserialize_fp,
    field_byte_size,
    serialize_fp,
)
# The struct-derive decorator serialize.derive.canonical is not re-exported,
# as in the JAX package: the name would shadow the ``canonical`` submodule.
from zkarray_torch.serialize.derive import Codec
from zkarray_torch.serialize.wrappers import (
    COMPRESSED_CHECKED,
    COMPRESSED_UNCHECKED,
    UNCOMPRESSED_CHECKED,
    UNCOMPRESSED_UNCHECKED,
    Mode,
)

__all__ = [
    "EMPTY_FLAGS",
    "SW_FLAG_INFINITY",
    "SW_FLAG_NEGATIVE",
    "TE_FLAG_NEGATIVE",
    "COMPRESSED_CHECKED",
    "COMPRESSED_UNCHECKED",
    "UNCOMPRESSED_CHECKED",
    "UNCOMPRESSED_UNCHECKED",
    "Codec",
    "Mode",
    "deserialize_fp",
    "field_byte_size",
    "serialize_fp",
]
