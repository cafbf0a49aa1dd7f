"""Elliptic-curve group law and MSM."""
