"""Pairing engines."""
