"""BLS12-381 fields, towers, G1, G2 and the pairing (standard public
constants).

Counterpart of zkarray/curves/bls12_381.py. Towers: Fq2 = Fq[u]/(u^2 + 1),
Fq6 = Fq2[v]/(v^3 - (u + 1)), Fq12 = Fq6[w]/(w^2 - v). G2 is the M-twist
y^2 = x^3 + 4(u + 1) over Fq2.
"""

import torch

from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ec.sw import SWCurveSpec

FR_MODULUS = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
FR = FieldSpec(FR_MODULUS, generator=7, name="bls12_381.Fr")

FQ_MODULUS = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
FQ = FieldSpec(FQ_MODULUS, generator=2, name="bls12_381.Fq")

# G1: y^2 = x^3 + 4
G1 = SWCurveSpec(
    name="bls12_381.G1",
    base=FQ,
    scalar=FR,
    a=0,
    b=4,
    gen_x=0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    gen_y=0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    cofactor=0x396C8C005555E1568C00AAAB0000AAAB,
)

# BLS parameter X (the ate loop count)
X = -0xD201000000010000

# ---- towers
from zkarray_torch.ff.towers import ExtOps, PrimeOps, mul_by_cubic_generator  # noqa: E402

FQ_OPS = PrimeOps(FQ)
FQ2 = ExtOps("bls12_381.Fq2", FQ_OPS, 2, FQ_MODULUS - 1)  # beta = -1


def _nr6_hook(fq2, x):
    """x (u + 1) = (c0 - c1) + (c0 + c1) u for x in Fq2."""
    return torch.stack([fq2.base.sub(x[0], x[1]), fq2.base.add(x[0], x[1])])


FQ6 = ExtOps("bls12_381.Fq6", FQ2, 3, (1, 1), mul_nonresidue_hook=_nr6_hook)
FQ12 = ExtOps("bls12_381.Fq12", FQ6, 2, ((0, 0), (1, 0), (0, 0)),  # beta = v
              mul_nonresidue_hook=mul_by_cubic_generator)

# ---- G2: y^2 = x^3 + 4(u + 1) over Fq2, M-twist
from zkarray_torch.ec.sw_ext import ExtCurveSpec  # noqa: E402

G2 = ExtCurveSpec(
    name="bls12_381.G2",
    ops=FQ2,
    scalar_spec=FR,
    a_host=(0, 0),
    b_host=(4, 4),
    gen_x_host=(
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    gen_y_host=(
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
    cofactor=0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5,
)

# ---- the pairing engine
from zkarray_torch.ec.pairing.bls12 import Bls12Spec  # noqa: E402

PAIRING = Bls12Spec(name="bls12_381", x=X, twist_type="M", fq_spec=FQ, fq2=FQ2, fq6=FQ6,
                    fq12=FQ12, g1_curve=G1, g2_curve=G2)
