"""Hash to field: RFC 9380 expand_message_xmd and the default field hasher.

Counterpart of zkarray/ff/hash_to_field.py. Hashing is host byte work
(``hashlib``); elements reach the device through ff/fp.py:from_ints, as
from_be_bytes_mod_order values (len_per_elem = ceil((log2(p) + k) / 8)
bytes each).
"""

from __future__ import annotations

import hashlib
import struct
from typing import List

import torch

from zkarray_torch import DEFAULT_DEVICE
from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ff import fp


def expand_message_xmd(
    msg: bytes, dst: bytes, len_in_bytes: int, hash_name: str = "sha256"
) -> bytes:
    """RFC 9380 §5.3.1 expand_message_xmd."""
    H = lambda data: hashlib.new(hash_name, data).digest()
    b_in_bytes = hashlib.new(hash_name).digest_size
    s_in_bytes = hashlib.new(hash_name).block_size
    ell = -(-len_in_bytes // b_in_bytes)
    if ell > 255 or len_in_bytes > 65535 or len(dst) > 255:
        raise ValueError("expand_message_xmd parameter overflow")
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(s_in_bytes)
    l_i_b_str = struct.pack(">H", len_in_bytes)
    b0 = H(z_pad + msg + l_i_b_str + b"\x00" + dst_prime)
    b1 = H(b0 + b"\x01" + dst_prime)
    bs = [b1]
    for i in range(2, ell + 1):
        prev = bs[-1]
        bs.append(H(bytes(x ^ y for x, y in zip(b0, prev)) + bytes([i]) + dst_prime))
    return b"".join(bs)[:len_in_bytes]


def len_per_base_elem(spec: FieldSpec, sec_param: int = 128) -> int:
    """ceil((log2(p) + k)/8)."""
    return -(-(spec.bits + sec_param) // 8)


def hash_to_field_ints(
    spec: FieldSpec,
    msg: bytes,
    dst: bytes,
    count: int,
    ext_degree: int = 1,
    sec_param: int = 128,
    hash_name: str = "sha256",
) -> List[List[int]]:
    """RFC 9380 hash_to_field: count elements of F_{p^m} as canonical int
    lists (m = ext_degree)."""
    L = len_per_base_elem(spec, sec_param)
    total = count * ext_degree * L
    uniform = expand_message_xmd(msg, dst, total, hash_name)
    out = []
    for i in range(count):
        elem = []
        for j in range(ext_degree):
            off = (i * ext_degree + j) * L
            chunk = uniform[off : off + L]
            elem.append(int.from_bytes(chunk, "big") % spec.modulus)
        out.append(elem)
    return out


def hash_to_field(
    spec: FieldSpec, msg: bytes, dst: bytes, count: int, device=DEFAULT_DEVICE, **kw
) -> torch.Tensor:
    """count base-field elements as an (L, count) Montgomery tensor on ``device``."""
    vals = hash_to_field_ints(spec, msg, dst, count, 1, **kw)
    return fp.from_ints(spec, [v[0] for v in vals], device=device)


def from_be_bytes_mod_order(spec: FieldSpec, data: bytes) -> int:
    """The big-endian integer of ``data`` reduced mod p."""
    return int.from_bytes(data, "big") % spec.modulus


def from_le_bytes_mod_order(spec: FieldSpec, data: bytes) -> int:
    return int.from_bytes(data, "little") % spec.modulus
