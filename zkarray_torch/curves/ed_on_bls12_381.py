"""ed_on_bls12_381 (Jubjub): the twisted Edwards curve over BLS12-381's
scalar field (standard public constants).

Counterpart of zkarray/curves/ed_on_bls12_381.py.
"""

from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.curves.bls12_381 import FR as _BLS_FR
from zkarray_torch.ec.te import TECurveSpec

# Base field = BLS12-381 Fr
FQ = _BLS_FR

# Subgroup order
FR = FieldSpec(
    6554484396890773809930967563523245729705921265872317281365359162392183254199,
    generator=6,
    name="ed_on_bls12_381.Fr",
)

EDWARDS = TECurveSpec(
    name="ed_on_bls12_381",
    base=FQ,
    scalar=FR,
    a=-1,
    d=19257038036680949359750312669786877991949435402254120286184196891950884077233,
    gen_x=8076246640662884909881801758704306714034609987455869804520522091855516602923,
    gen_y=13262374693698910701929044844600465831413122818447359594527400194675274060458,
    cofactor=8,
    # birational Montgomery form (reference MontCurveConfig): y² = x³ + A x² + B x
    mont_coeff_a=40962,
    mont_coeff_b=-40964,
)
