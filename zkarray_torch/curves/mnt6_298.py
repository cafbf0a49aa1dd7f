"""MNT6-298 fields, towers, G1, G2 and the pairing (standard public
constants): Fq and Fr are MNT4-298's swapped.

Counterpart of zkarray/curves/mnt6_298.py. Fq has L = 20 sixteen-bit limbs
(R = 2^320), NW = 10 words in the CUDA kernels. Towers: Fq3 = Fq[u]/(u^3 -
5), Fq6 = Fq3[v]/(v^2 - u). G1: y^2 = x^3 + 11x + b over Fq; G2 over Fq3
with a = (0, 0, 11). Its ate loop count is negative.
"""

from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.ec.sw import SWCurveSpec
from zkarray_torch.ec.sw_ext import ExtCurveSpec
from zkarray_torch.ff.towers import ExtOps, PrimeOps, mul_by_cubic_generator

FQ_MODULUS = 475922286169261325753349249653048451545124878552823515553267735739164647307408490559963137
FR_MODULUS = 475922286169261325753349249653048451545124879242694725395555128576210262817955800483758081

FQ = FieldSpec(FQ_MODULUS, generator=10, name="mnt6_298.Fq")
FR = FieldSpec(FR_MODULUS, generator=17, name="mnt6_298.Fr",
               small_subgroup_base=7, small_subgroup_base_adicity=2)

FQ_OPS = PrimeOps(FQ)
FQ3 = ExtOps("mnt6_298.Fq3", FQ_OPS, 3, 5)  # u^3 = 5
FQ6 = ExtOps("mnt6_298.Fq6", FQ3, 2, (0, 1, 0),  # v^2 = u
             mul_nonresidue_hook=mul_by_cubic_generator)

# G1: y^2 = x^3 + 11x + b
G1 = SWCurveSpec(
    name="mnt6_298.G1", base=FQ, scalar=FR, a=11,
    b=106700080510851735677967319632585352256454251201367587890185989362936000262606668469523074,
    gen_x=336685752883082228109289846353937104185698209371404178342968838739115829740084426881123453,
    gen_y=402596290139780989709332707716568920777622032073762749862342374583908837063963736098549800,
    cofactor=1,
)

# G2 over FQ3
G2 = ExtCurveSpec(
    name="mnt6_298.G2", ops=FQ3, scalar_spec=FR,
    a_host=(0, 0, 11),
    b_host=(
        57578116384997352636487348509878309737146377454014423897662211075515354005624851787652233,
        0,
        0,
    ),
    gen_x_host=(
        421456435772811846256826561593908322288509115489119907560382401870203318738334702321297427,
        103072927438548502463527009961344915021167584706439945404959058962657261178393635706405114,
        143029172143731852627002926324735183809768363301149009204849580478324784395590388826052558,
    ),
    gen_y_host=(
        464673596668689463130099227575639512541218133445388869383893594087634649237515554342751377,
        100642907501977375184575075967118071807821117960152743335603284583254620685343989304941678,
        123019855502969896026940545715841181300275180157288044663051565390506010149881373807142903,
    ),
    cofactor=226502022472576270196498690498308461791828762732602586162207535351960270082712694977333372361549082214519252261735048131889018501404377856786623430385820659037970876666767495659520,
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
    name="mnt6_298",
    fq_spec=FQ,
    fq_tw=FQ3,
    fq_target=FQ6,
    g1_curve=G1,
    g2_curve=G2,
    twist_host=(0, 1, 0),
    twist_coeff_a_host=(0, 0, 11),
    ate_loop_count=ATE_LOOP_COUNT,
    ate_is_loop_count_neg=True,
    final_exp_last_chunk_1=1,
    final_exp_w0_abs=689871209842287392837045615510547309923794944,
    final_exp_w0_neg=True,
)
