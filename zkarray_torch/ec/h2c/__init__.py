"""Hashing to curves: the simplified SWU map (RFC 9380 §6.6.2) over a prime
field and over Fq2, the Wahby–Boneh maps for BLS12-381 G1 and G2, and
Elligator2 for twisted Edwards curves."""

from zkarray_torch.ec.h2c.swu import swu_map
from zkarray_torch.ec.h2c.wb import bls12_381_g1_wb_map, hash_to_curve_bls12_381_g1

__all__ = ["swu_map", "bls12_381_g1_wb_map", "hash_to_curve_bls12_381_g1"]
