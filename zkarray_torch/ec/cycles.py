"""Curve cycles: two curves where each one's scalar field is the other's
base field (proof recursion). Host data and a consistency check.

Counterpart of zkarray/ec/cycles.py.
"""

from __future__ import annotations


class CurveCycle:
    def __init__(self, e1, e2):
        """e1.base == e2.scalar and e1.scalar == e2.base (field moduli)."""
        if e1.base.modulus != e2.scalar.modulus or e1.scalar.modulus != e2.base.modulus:
            raise ValueError(f"not a cycle: {e1.name} / {e2.name}")
        self.e1 = e1
        self.e2 = e2

    def __repr__(self):
        return f"CurveCycle({self.e1.name}, {self.e2.name})"


class PairingFriendlyCycle(CurveCycle):
    def __init__(self, e1, e2, engine1=None, engine2=None):
        super().__init__(e1, e2)
        self.engine1 = engine1
        self.engine2 = engine2


def pasta_cycle() -> CurveCycle:
    """Pallas / Vesta."""
    from zkarray_torch.curves import zoo

    return CurveCycle(zoo.PALLAS, zoo.VESTA)


def bn254_grumpkin_cycle() -> CurveCycle:
    from zkarray_torch.curves import bn254, zoo

    return CurveCycle(bn254.G1, zoo.GRUMPKIN)
