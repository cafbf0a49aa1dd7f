"""BN254 fields, towers, G1, G2 and the pairing (standard public constants).

Counterpart of zkarray/curves/bn254.py. Towers: Fq2 = Fq[u]/(u^2 + 1),
Fq6 = Fq2[v]/(v^3 - (9 + u)), Fq12 = Fq6[w]/(w^2 - v). G2 is the D-twist
y^2 = x^3 + 3/(9 + u) over Fq2, so the Miller loop takes the mul_by_034
lines.
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

# ---- towers
from zkarray_torch.ff.towers import ExtOps, PrimeOps, mul_by_cubic_generator  # noqa: E402

FQ_OPS = PrimeOps(FQ)
FQ2 = ExtOps("bn254.Fq2", FQ_OPS, 2, FQ_MODULUS - 1)  # beta = -1


def _nr6_hook(fq2, x):
    """x (9 + u) = (9 c0 - c1) + (c0 + 9 c1) u for x = c0 + c1 u in Fq2: 9 x
    as three doublings and an add, each one call over the whole Fq2
    element, then one sub and one add (the JAX package's ten Fq ops as six
    launches)."""
    fq = fq2.base
    x9 = fq2.add(fq2.double(fq2.double(fq2.double(x))), x)
    return fq2._stack([fq.sub(x9[0], x[1]), fq.add(x[0], x9[1])])


FQ6 = ExtOps("bn254.Fq6", FQ2, 3, (9, 1), mul_nonresidue_hook=_nr6_hook)
FQ12 = ExtOps("bn254.Fq12", FQ6, 2, ((0, 0), (1, 0), (0, 0)),  # beta = v
              mul_nonresidue_hook=mul_by_cubic_generator)

# ---- G2: y^2 = x^3 + 3/(9 + u) over Fq2, D-twist
from zkarray_torch.ec.sw_ext import ExtCurveSpec  # noqa: E402

G2 = ExtCurveSpec(
    name="bn254.G2",
    ops=FQ2,
    scalar_spec=FR,
    a_host=(0, 0),
    b_host=(
        19485874751759354771024239261021720505790618469301721065564631296452457478373,
        266929791119991161246907387137283842545076965332900288569378510910307636690,
    ),
    gen_x_host=(
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    gen_y_host=(
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
    cofactor=0x30644E72E131A029B85045B68181585E06CEECDA572A2489345F2299C0F9FA8D,
)

# ---- the pairing engine (BN family, X = 4965661367192848881, D-twist)
from zkarray_torch.ec.pairing.bn import BnSpec  # noqa: E402

# signed digits of 6X + 2, low first (arkworks' ATE_LOOP_COUNT)
ATE_LOOP_COUNT = [
    0, 0, 0, 1, 0, 1, 0, -1, 0, 0, -1, 0, 0, 0, 1, 0, 0, -1, 0, -1, 0, 0, 0,
    1, 0, -1, 0, 0, 0, 0, -1, 0, 0, 1, 0, -1, 0, 0, 1, 0, 0, 0, 0, 0, -1, 0,
    0, -1, 0, 1, 0, -1, 0, 0, 0, -1, 0, -1, 0, 0, 0, 1, 0, 1, 1,
]

PAIRING = BnSpec(
    name="bn254",
    x=4965661367192848881,
    ate_loop_count=ATE_LOOP_COUNT,
    twist_type="D",
    fq_spec=FQ,
    fq2=FQ2,
    fq6=FQ6,
    fq12=FQ12,
    g1_curve=G1,
    g2_curve=G2,
    twist_mul_by_q_x=(
        21575463638280843010398324269430826099269044274347216827212613867836435027261,
        10307601595873709700152284273816112264069230130616436755625194854815875713954,
    ),
    twist_mul_by_q_y=(
        2821565182194536844548159561693502659359617185244120367078079554186484126554,
        3505843767911556378687030309984248845540243509899259641013678093033130930403,
    ),
)
