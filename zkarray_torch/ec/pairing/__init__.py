"""Pairing engines."""

from zkarray_torch.ec.pairing import bls12, bn

__all__ = ["bls12", "bn"]
