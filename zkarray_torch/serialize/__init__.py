"""Canonical (arkworks) serialization of field elements and mode wrappers."""
