"""Field constants and planar limb primitives."""
