"""Curve and field parameter sets."""
