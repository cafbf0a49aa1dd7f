"""MNT4-298 fields, towers, G1, G2 and the pairing (standard public
constants): with MNT6-298 the 298-bit amicable cycle (Fq here is Fr there
and the other way round).

Counterpart of zkarray/curves/mnt4_298.py. Fq has L = 20 sixteen-bit limbs
(R = 2^320), NW = 10 words in the CUDA kernels. Towers: Fq2 = Fq[u]/(u^2 -
17), Fq4 = Fq2[v]/(v^2 - u). G1: y^2 = x^3 + 2x + b over Fq; G2 over Fq2
with a = (34, 0).
"""

from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ec.sw import SWCurveSpec
from zkarray_torch.ec.sw_ext import ExtCurveSpec
from zkarray_torch.ff.towers import ExtOps, PrimeOps, mul_by_quadratic_generator

FQ_MODULUS = 475922286169261325753349249653048451545124879242694725395555128576210262817955800483758081
FR_MODULUS = 475922286169261325753349249653048451545124878552823515553267735739164647307408490559963137

FQ = FieldSpec(FQ_MODULUS, generator=17, name="mnt4_298.Fq",
               small_subgroup_base=7, small_subgroup_base_adicity=2)
FR = FieldSpec(FR_MODULUS, generator=10, name="mnt4_298.Fr")

FQ_OPS = PrimeOps(FQ)
FQ2 = ExtOps("mnt4_298.Fq2", FQ_OPS, 2, 17)  # u^2 = 17
FQ4 = ExtOps("mnt4_298.Fq4", FQ2, 2, (0, 1),  # v^2 = u
             mul_nonresidue_hook=mul_by_quadratic_generator)

# G1: y^2 = x^3 + 2x + b
G1 = SWCurveSpec(
    name="mnt4_298.G1", base=FQ, scalar=FR, a=2,
    b=423894536526684178289416011533888240029318103673896002803341544124054745019340795360841685,
    gen_x=60760244141852568949126569781626075788424196370144486719385562369396875346601926534016838,
    gen_y=363732850702582978263902770815145784459747722357071843971107674179038674942891694705904306,
    cofactor=1,
)

# G2 over FQ2
G2 = ExtCurveSpec(
    name="mnt4_298.G2", ops=FQ2, scalar_spec=FR,
    a_host=(34, 0),
    b_host=(
        0,
        67372828414711144619833451280373307321534573815811166723479321465776723059456513877937430,
    ),
    gen_x_host=(
        438374926219350099854919100077809681842783509163790991847867546339851681564223481322252708,
        37620953615500480110935514360923278605464476459712393277679280819942849043649216370485641,
    ),
    gen_y_host=(
        37437409008528968268352521034936931842973546441370663118543015118291998305624025037512482,
        424621479598893882672393190337420680597584695892317197646113820787463109735345923009077489,
    ),
    cofactor=475922286169261325753349249653048451545124879932565935237842521413255878328503110407553025,
)

from zkarray_torch.ec.pairing.mnt import MNTSpec  # noqa: E402

# signed ate digits, high first, the leading 1 included
ATE_LOOP_COUNT = [
    1, 0, 0, 0, 0, -1, 0, 0, 0, -1, 0, 0, 0, -1, 0, 1, 0, 1, 0, 1, 0, 1, 0,
    1, 0, 0, 1, 0, -1, 0, 1, 0, -1, 0, 0, 0, 0, 0, 1, 0, 1, 0, -1, 0, 0, 0,
    -1, 0, -1, 0, -1, 0, 0, -1, 0, -1, 0, 0, 0, 0, 0, -1, 0, -1, 0, 0, 0, 0, 1,
    0, 1, 0, 1, 0, 0, 1, 0, -1, 0, 1, 0, 0, 0, 0, 0, -1, 0, 0, 0, 1, 0, 0,
    -1, 0, 0, -1, 0, 0, 1, 0, 1, 0, -1, 0, 1, 0, 0, 0, 1, 0, 0, -1, 0, 0, -1,
    0, -1, 0, 1, 0, 0, -1, 0, 0, 1, 0, -1, 0, -1, 0, 1, 0, -1, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
]

PAIRING = MNTSpec(
    name="mnt4_298",
    fq_spec=FQ,
    fq_tw=FQ2,
    fq_target=FQ4,
    g1_curve=G1,
    g2_curve=G2,
    twist_host=(0, 1),
    twist_coeff_a_host=(34, 0),
    ate_loop_count=ATE_LOOP_COUNT,
    ate_is_loop_count_neg=False,
    final_exp_last_chunk_1=1,
    final_exp_w0_abs=689871209842287392837045615510547309923794945,
    final_exp_w0_neg=False,
)
