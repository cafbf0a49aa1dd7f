"""BLS12-377 fields, towers, G1, G2 and the pairing (standard public
constants).

Counterpart of zkarray/curves/bls12_377.py. Towers: Fq2 = Fq[u]/(u^2 + 5),
Fq6 = Fq2[v]/(v^3 - u), Fq12 = Fq6[w]/(w^2 - v). G2 is the D-twist
y^2 = x^3 + b/u over Fq2, so the Miller loop takes the mul_by_034 lines.
"""

from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ec.sw import SWCurveSpec

# Fr: 253 bits, 2-adicity 47
FR_MODULUS = 8444461749428370424248824938781546531375899335154063827935233455917409239041
FR = FieldSpec(FR_MODULUS, generator=22, name="bls12_377.Fr")

# Fq: 377 bits, 2-adicity 46 (square roots by Tonelli-Shanks)
FQ_MODULUS = 258664426012969094010652733694893533536393512754914660539884262666720468348340822774968888139573360124440321458177
FQ = FieldSpec(FQ_MODULUS, generator=15, name="bls12_377.Fq")

# BLS parameter X (positive)
X = 0x8508C00000000001

# G1: y^2 = x^3 + 1
G1 = SWCurveSpec(
    name="bls12_377.G1",
    base=FQ,
    scalar=FR,
    a=0,
    b=1,
    gen_x=81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695,
    gen_y=241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030,
    cofactor=30631250834960419227450344600217059328,
)

# ---- towers
from zkarray_torch.ff.towers import ExtOps, PrimeOps, mul_by_cubic_generator  # noqa: E402

FQ_OPS = PrimeOps(FQ)
FQ2 = ExtOps("bls12_377.Fq2", FQ_OPS, 2, FQ_MODULUS - 5)  # beta = -5


def _nr6_hook(fq2, x):
    """x u = -5 c1 + c0 u for x = c0 + c1 u in Fq2."""
    fq = fq2.base
    return fq2._stack([fq.neg(fq.add(fq.double(fq.double(x[1])), x[1])), x[0]])


FQ6 = ExtOps("bls12_377.Fq6", FQ2, 3, (0, 1), mul_nonresidue_hook=_nr6_hook)
FQ12 = ExtOps("bls12_377.Fq12", FQ6, 2, ((0, 0), (1, 0), (0, 0)),  # beta = v
              mul_nonresidue_hook=mul_by_cubic_generator)

# ---- G2: y^2 = x^3 + b/u over Fq2, D-twist
from zkarray_torch.ec.sw_ext import ExtCurveSpec  # noqa: E402

G2 = ExtCurveSpec(
    name="bls12_377.G2",
    ops=FQ2,
    scalar_spec=FR,
    a_host=(0, 0),
    b_host=(
        0,
        155198655607781456406391640216936120121836107652948796323930557600032281009004493664981332883744016074664192874906,
    ),
    gen_x_host=(
        233578398248691099356572568220835526895379068987715365179118596935057653620464273615301663571204657964920925606294,
        140913150380207355837477652521042157274541796891053068589147167627541651775299824604154852141315666357241556069118,
    ),
    gen_y_host=(
        63160294768292073209381361943935198908131692476676907196754037919244929611450776219210369229519898517858833747423,
        149157405641012693445398062341192467754805999074082136895788947234480009303640899064710353187729182149407503257491,
    ),
    cofactor=7923214915284317143930293550643874566881017850177945424769256759165301436616933228209277966774092486467289478618404761412630691835764674559376407658497,
)

# ---- the pairing engine (D-twist: mul_by_034 lines)
from zkarray_torch.ec.pairing.bls12 import Bls12Spec  # noqa: E402

PAIRING = Bls12Spec(name="bls12_377", x=X, twist_type="D", fq_spec=FQ, fq2=FQ2, fq6=FQ6,
                    fq12=FQ12, g1_curve=G1, g2_curve=G2)
