"""Polynomials over evaluation domains: the radix-2 NTT and Evaluations."""

from zkarray_torch.poly.domain import Radix2Domain

__all__ = ["Radix2Domain"]
