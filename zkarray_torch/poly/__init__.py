"""Polynomials over evaluation domains: the radix-2 NTT and Evaluations."""
