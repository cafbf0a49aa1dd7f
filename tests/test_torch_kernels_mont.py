"""Port parity: the plain versions of the butterfly kernels against the
Pallas kernels of zkarray.kernels.mont in interpret mode, bit for bit, at the
shapes tests/test_kernels.py runs them (BLS12-381 Fr, L = 16); the narrow
DIT stages (H = 1, 2, 4) that the JAX package leaves to XLA against
Python ints; the operand map the mont_mul/mont_sqr kernels read strided
inputs through; and the plain versions of pow_table and twiddle_mul (no
Pallas counterpart) against the JAX package's power_table, twiddle_table
and distribute_powers, which build the same tables by doubling. The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from torch_parity import both, same  # noqa: E402
from zkarray.curves import bls12_381 as jcurves  # noqa: E402
from zkarray.ff import fp as jfp  # noqa: E402
from zkarray.kernels import mont as jkm  # noqa: E402
from zkarray.poly import domain as jdm  # noqa: E402
from zkarray_torch.core.limbs import unpack_pairs  # noqa: E402
from zkarray_torch.curves import bls12_381 as tcurves  # noqa: E402
from zkarray_torch.ff import fp as tfp  # noqa: E402
from zkarray_torch.interop import limbs_to_numpy  # noqa: E402
from zkarray_torch.kernels import mont as tkm  # noqa: E402

JFR, TFR = jcurves.FR, tcurves.FR
L = TFR.num_limbs
P = TFR.modulus


def rand_ints(n, rng):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def test_butterfly_dit_plain_matches_jax_kernel():
    # tests/test_kernels.py:test_butterfly_dit_inplace_matches_xla's shape
    rng = np.random.default_rng(11)
    C, H, R = 2, 8, 128
    jx, tx = both(JFR, rand_ints(C * 2 * H * R, rng))
    jw, tw = both(JFR, rand_ints(H, rng))
    want = jkm.butterfly_dit_inplace(JFR, jx.reshape(L, C, 2, H, R),
                                     jnp.broadcast_to(jw[:, :, None], (L, H, 128)), C, H, R)
    x = tx.reshape(L, C, 2, H, R).clone()
    # the port reads w_h = tw[:, h * stride]: spread the same twiddles at stride 3
    spread = torch.zeros((L, 3 * H - 2), dtype=torch.int32)
    spread[:, ::3] = tw
    for fn in (tkm.butterfly_dit, tkm.butterfly_dit_plain):
        y = x.clone()
        assert fn(TFR, y, spread, 3) is y  # in place
        assert same(want, y)
    with pytest.raises(ValueError):  # in place needs a buffer the caller owns outright
        tkm.butterfly_dit(TFR, x.transpose(3, 4), spread, 3)


@pytest.mark.parametrize("H", [1, 2, 4])
def test_butterfly_dit_narrow_stages_match_ints(H):
    rng = np.random.default_rng(H)
    C, R = 3, 2
    xs = rand_ints(C * 2 * H * R, rng)
    ws = rand_ints(H, rng)
    x = tfp.from_ints(TFR, xs, device="cpu").reshape(L, C, 2, H, R)
    tkm.butterfly_dit(TFR, x, tfp.from_ints(TFR, ws, device="cpu"), 1)
    got = tfp.to_ints(TFR, x)
    want = list(xs)
    for c in range(C):
        for h in range(H):
            for r in range(R):
                lo, hi = (c * 2 * H + h) * R + r, ((c * 2 + 1) * H + h) * R + r
                t = xs[hi] * ws[h] % P
                want[lo], want[hi] = (xs[lo] + t) % P, (xs[lo] - t) % P
    assert got == want


def test_butterfly_stage_plain_matches_jax_kernel():
    # tests/test_kernels.py:test_pallas_butterfly_matches_fp's shape, n = 300
    rng = np.random.default_rng(9)
    los, his, ws = (rand_ints(300, rng) for _ in range(3))
    (jl, tl), (jh, th), (jw, tw) = both(JFR, los), both(JFR, his), both(JFR, ws)
    ja, jb = jkm.butterfly_stage(JFR, jl, jh, jw)
    for fn in (tkm.butterfly_stage, tkm.butterfly_stage_plain):
        a, b = fn(TFR, tl, th, tw)
        assert same(ja, a) and same(jb, b)
    assert tfp.to_ints(TFR, a) == [(x + y) % P for x, y in zip(los, his)]
    assert tfp.to_ints(TFR, b) == [(x - y) * z % P for x, y, z in zip(los, his, ws)]


def read_through_map(t):
    """The (L, n) elements the kernels read for ``t``: _operand's descriptor
    evaluated with csrc/field.cuh:load_operand's index arithmetic."""
    op, ld, inner, outer = tkm._operand(t)
    n = t[0].numel()
    i = torch.arange(n)
    off = torch.where(i < inner, i, (i // inner) * outer + i % inner)
    flat = torch.as_strided(op, (L, int(off.max()) + 1), (ld, 1))
    return op, flat[:, off]


def test_operand_map_reads_slices_and_broadcasts_in_place():
    base = torch.arange(L * 6 * 10, dtype=torch.int32).reshape(L, 6, 10)
    const = torch.arange(L * 10, dtype=torch.int32).reshape(L, 1, 10)
    cases = {
        "contiguous": (base, False),
        "first-axis slice": (base[:, 1:4], False),
        "last-axis slice": (base[:, :, 2:7], False),
        "broadcast row": (const.expand(L, 6, 10), False),
        "broadcast scalar": (base[:, :1, :1].expand(L, 6, 10), False),
        "strided last axis": (base[:, :, ::2], False),
        "transpose": (base.transpose(1, 2), True),
        "broadcast column": (base[:, :, :1].expand(L, 6, 10), True),
    }
    for name, (t, copied) in cases.items():
        op, got = read_through_map(t)
        assert (op.data_ptr() != t.data_ptr()) == copied, name
        assert torch.equal(got, t.reshape(L, -1)), name


@pytest.mark.parametrize("m", [8, 9])
def test_operand_map_reads_tree_halves_in_place(m):
    """ec/msm.py:_tree_sum_last's halves v[..., :h], v[..., h:2h] of a
    (L, q, W, m) level (odd m leaves a tail), and _weighted_sum_bits' per-bit
    rows v[:, i] of a (L, q, W) sum: all read in place."""
    v = torch.arange(L * 4 * 3 * m, dtype=torch.int32).reshape(L, 4, 3, m)
    h = m // 2
    for t in (v[..., :h], v[..., h : 2 * h], v[..., h : 2 * h][:, 1:3], v[:, 2, :, 0]):
        op, got = read_through_map(t)
        assert op.data_ptr() == t.data_ptr()
        assert torch.equal(got, t.reshape(L, -1))
    lo, hi = tkm._operand(v[..., :h]), tkm._operand(v[..., h : 2 * h])
    assert (lo[2], lo[3]) == (hi[2], hi[3]) == (h, m)


@pytest.mark.parametrize("n", [1, 2, 13, 64])
def test_pow_table_plain_matches_jax_power_table(n):
    w = TFR.root_of_unity(64)
    want = jdm.power_table(JFR, w, n)
    for fn in (tkm.pow_table, tkm.pow_table_plain):
        assert same(want, fn(TFR, w, n, "cpu"))
    # n^-1 folded in, packed entry-major as twiddle_mul reads its tables
    s = pow(n, -1, P)
    got = tkm.pow_table_plain(TFR, w, n, "cpu", scale_int=s, packed=True)
    assert got.shape == (n, L // 2)
    assert tfp.to_ints(TFR, unpack_pairs(got.T)) == [s * pow(w, j, P) % P for j in range(n)]


@pytest.mark.parametrize("case", ["whole", "column-block", "coset-row"])
def test_twiddle_mul_plain_matches_jax_twiddle_table(case):
    """x · w^((r0 + r)(c0 + c)): a whole 64 x 64 table (fft_fourstep_core),
    pass 1's column block c = 3 written into a strided block of a wider
    output (fft_fourstep_big), and one row with r0 = 1 for the coset
    offset 7, not a root of unity (distribute_powers)."""
    n1 = n2 = 64
    w = TFR.root_of_unity(n1 * n2)
    rng = np.random.default_rng({"whole": 21, "column-block": 22, "coset-row": 23}[case])
    if case == "coset-row":
        jx, tx = both(JFR, rand_ints(n2, rng))
        want = np.asarray(jdm.distribute_powers(JFR, jx, 7))[:, None, :]
        tw = tkm.twiddle_tables(TFR, 7, n2 - 1, "cpu")
        x, r0, c0, cols = tx[:, None, :], 1, 0, slice(0, n2)
    else:
        jx, tx = both(JFR, rand_ints(n1 * n2, rng))
        jx, x = jx.reshape(L, n1, n2), tx.reshape(L, n1, n2)
        want = np.asarray(jfp.mont_mul(JFR, jx, jdm.twiddle_table(JFR, w, n1, n2)))
        tw = tkm.twiddle_tables(TFR, w, (n1 - 1) * (n2 - 1), "cpu")
        r0, c0, cols = 0, 0, slice(0, n2)
        if case == "column-block":
            m2 = n2 // 8
            c0, cols = 3 * m2, slice(3 * m2, 4 * m2)
            x = x[:, :, cols].contiguous()
    for fn in (tkm.twiddle_mul, tkm.twiddle_mul_plain):
        wide = torch.zeros((L, x.shape[1], n2), dtype=torch.int32)
        out = wide[:, :, cols]
        assert fn(TFR, x, tw, r0, c0, out) is out
        assert np.array_equal(want[:, :, cols], limbs_to_numpy(out))
        rest = torch.ones(n2, dtype=torch.bool)
        rest[cols] = False
        assert not wide[:, :, rest].any()  # nothing outside the block is written
    with pytest.raises(ValueError):  # exponents beyond the tables
        tkm.twiddle_mul(TFR, x, tw, r0, c0 + n2)


def _five_fields():
    from zkarray.curves import bls12_377 as j377, bn254 as jbn, bw6_761 as j761, bw6_767 as j767
    from zkarray_torch.curves import bls12_377 as t377, bn254 as tbn
    from zkarray_torch.curves import bw6_761 as t761, bw6_767 as t767

    return [(jbn.FR, tbn.FR), (jbn.FQ, tbn.FQ), (jcurves.FR, tcurves.FR),
            (jcurves.FQ, tcurves.FQ), (j377.FQ, t377.FQ), (j761.FQ, t761.FQ), (j767.FQ, t767.FQ)]


@pytest.mark.parametrize("k", range(7), ids=["bn254.Fr", "bn254.Fq", "bls12_381.Fr",
                                              "bls12_381.Fq", "bls12_377.Fq", "bw6_761.Fq",
                                              "bw6_767.Fq"])
def test_field_additions_plain_match_jax(k):
    """add_plain and sub_plain (csrc/fadd.cu's plain versions; -a is
    sub_plain(0, a)) on testing.fadd_edge_words, all pairs, against
    zkarray.ff.fp.add/sub/neg bit for bit, inputs >= p included; the wrappers fp_add/fp_sub/fp_neg give
    the same words on CPU tensors, into a new tensor and into a strided
    ``out`` (the tower layout's coefficient axes behind the limb axis).
    The two BW6 fields are the L = 48 (NW = 24) cases: carries across 47
    limb boundaries, 23 word boundaries."""
    from zkarray_torch.core.limbs import ints_to_limbs_np
    from zkarray_torch.testing import fadd_edge_words

    jspec, tspec = _five_fields()[k]
    Lk = tspec.num_limbs
    words = fadd_edge_words(tspec, np.random.default_rng(20 + k))
    m = len(words)
    arr = ints_to_limbs_np(words, Lk)
    ii = np.arange(m * m)
    a_np, b_np = arr[:, ii // m], arr[:, ii % m]
    ja, jb = jnp.asarray(a_np), jnp.asarray(b_np)
    ta = torch.from_numpy(a_np.astype(np.int32))
    tb = torch.from_numpy(b_np.astype(np.int32))
    for jf, plain, wrap, args_j, args_t in (
        (jfp.add, tkm.add_plain, tkm.fp_add, (ja, jb), (ta, tb)),
        (jfp.sub, tkm.sub_plain, tkm.fp_sub, (ja, jb), (ta, tb)),
        (jfp.neg, lambda f, x: tkm.sub_plain(f, torch.zeros_like(x), x), tkm.fp_neg, (ja,), (ta,)),
    ):
        want = np.asarray(jf(jspec, *args_j))
        assert np.array_equal(limbs_to_numpy(plain(tspec, *args_t)), want)
        assert np.array_equal(limbs_to_numpy(wrap(tspec, *args_t)), want)
        # into the (c, L, n) layout through its (L, c, n) view, c = 1
        out = torch.empty((1, Lk, m * m), dtype=torch.int32)
        wrap(tspec, *(t[:, None] for t in args_t), out=out.movedim(1, 0))
        assert np.array_equal(limbs_to_numpy(out[0]), want)
    # broadcasting: a ()-batch constant against the batch, as align pads it
    c = torch.from_numpy(arr[:, 3].astype(np.int32))
    want = np.asarray(jfp.add(jspec, jnp.asarray(arr[:, 3]), ja))
    assert np.array_equal(limbs_to_numpy(tkm.fp_add(tspec, c, ta)), want)
