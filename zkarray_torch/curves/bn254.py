"""BN254 fields and G1 (standard public constants).

Counterpart of zkarray/curves/bn254.py:FR/FQ/G1; the towers, G2 and the
pairing are not ported yet.
"""

from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ec.sw import SWCurveSpec

# Fr: 254 bits, 2-adicity 28
FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617
FR = FieldSpec(FR_MODULUS, generator=5, name="bn254.Fr")

# Fq: 254 bits, q = 3 mod 4
FQ_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583
FQ = FieldSpec(FQ_MODULUS, generator=3, name="bn254.Fq")

# G1: y^2 = x^3 + 3, generator (1, 2), cofactor 1
G1 = SWCurveSpec(name="bn254.G1", base=FQ, scalar=FR, a=0, b=3, gen_x=1, gen_y=2, cofactor=1)
