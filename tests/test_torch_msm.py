"""Port parity: zkarray_torch.ec.msm against zkarray.ec.msm and the host
oracle, on BLS12-381 G1 at n = 64, c = 5 (the shape tests/test_msm.py
compiles), bit for bit:

* the digit and window geometry;
* msm_accumulate's (L, W, half) bucket state, in one window group and in
  two; equal states also show that torch's stable sort and JAX's CPU sort
  order ties alike here;
* msm's XYZZ result, also with points at infinity and with all-equal
  scalars, which overflow both static bands so the residual loop must
  finish the bucket;
* ChunkedMSM against the O(1) host known answer on tiled inputs;
* msm_reduce's weighted bucket sums with the tree route split at a small
  width against the unsplit route, and against the JAX package's with the
  weight bits in one group and in several;
* the bit-Horner's plain version (kernels/sw.py:xyzz_bit_horner_plain, what
  the xyzz_bit_horner kernel computes) against the JAX package's loop of
  xyzz_double and xyzz_add, on partials that take every edge branch.

The port runs its one accumulate path, the grid-structured feed with the
plain kernels, so these tests cover the production feed building."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy
torch.set_num_threads(1)

from torch_parity import (  # noqa: E402
    BITS, JC, TC, C, N, assert_same_points, msm_inputs, xyzz_both, xyzz_coords)
from zkarray.ec import msm as jmsm  # noqa: E402
from zkarray.ec import sw as jsw  # noqa: E402
from zkarray_torch.ec import msm as tmsm  # noqa: E402
from zkarray_torch.ec import sw as tsw  # noqa: E402
from zkarray_torch.interop import affine_from_numpy, limbs_from_numpy, limbs_to_numpy  # noqa: E402
from zkarray_torch.kernels import sw as ksw  # noqa: E402
from zkarray_torch.testing import (  # noqa: E402
    bit_horner_edge_parts, ec_msm_oracle, ec_mul, ec_neg, expected_msm, tiled_inputs)


def test_signed_digits_and_window_geometry_match_jax():
    for c, bits in [(5, 255), (13, 254), (8, 63), (3, 255), (16, 255)]:
        assert tmsm._window_geometry(c, bits) == jmsm._window_geometry(c, bits)
        assert tmsm._accum_bounds(c, 1 << 20, 16) == jmsm._accum_bounds(c, 1 << 20, 16)
        assert tmsm.default_window_size(1 << c) == jmsm.default_window_size(1 << c)
    _, _, _, js, _, ts = msm_inputs(1)
    for c in (5, 13):
        W = tmsm._window_geometry(c, BITS)[0]
        want = np.asarray(jmsm.signed_digits(JC.scalar, js, c, W))
        assert np.array_equal(want, tmsm.signed_digits(TC.scalar, ts, c, W).numpy())


def test_msm_matches_jax_and_oracle():
    pts, ks, jA, js, tA, ts = msm_inputs(3)
    got = tmsm.msm(TC, tA, ts, C)
    assert_same_points(jmsm.msm(JC, jA, js, C), got)
    aff = tsw.xyzz_to_affine(TC, tsw.XYZZPoints(*(v[:, None] for v in got)))
    assert tsw.affine_to_ints(TC, aff)[0] == ec_msm_oracle(pts, ks, 0, JC.base.modulus)


@pytest.mark.parametrize("groups", [1, 2])
def test_msm_accumulate_bucket_state_matches_jax(groups, monkeypatch):
    """One window group, and two (a budget that fits 26 of the 52 windows'
    band-1 feeds)."""
    _, _, jA, js, tA, ts = msm_inputs(2)
    W, half, _, _ = tmsm._window_geometry(C, BITS)
    if groups == 2:
        r1b, _ = tmsm._accum_bounds(C, N, tmsm.ACCUM_T)
        monkeypatch.setattr(tmsm, "GROUP_BYTES", (W // 2) * r1b * half * TC.base.num_limbs * 4)
    want = jmsm.msm_accumulate(JC, jA, js, C, BITS, jsw.xyzz_zero(JC, (W, half)))
    got = tmsm.msm_accumulate(TC, tA, ts, C, BITS, tsw.xyzz_zero(TC, (W, half), "cpu"))
    assert_same_points(want, got)


def test_msm_infinity_points_match_jax_and_oracle():
    pts, ks, jA, js, tA, ts = msm_inputs(4, inf_at=(1, 3, 9, 10, 63))
    got = tmsm.msm(TC, tA, ts, C)
    assert_same_points(jmsm.msm(JC, jA, js, C), got)
    aff = tsw.xyzz_to_affine(TC, tsw.XYZZPoints(*(v[:, None] for v in got)))
    assert tsw.affine_to_ints(TC, aff)[0] == ec_msm_oracle(pts, ks, 0, JC.base.modulus)


def test_msm_reduce_matches_jax_on_edge_buckets():
    """msm_reduce on a seeded (L, W, half) bucket state at c = 5: random XYZZ
    representatives of real points, about a third of the buckets at infinity,
    and in two of every three windows bucket j + 8 holding bucket j's point
    (another representative) or its negation. Buckets j and j + 8 meet at the
    first tree level of every weight bit below 3, so those levels take the
    doubling and the cancel branches. Against zkarray.ec.msm.msm_reduce and
    the host oracle."""
    mod, r = JC.base.modulus, JC.scalar.modulus
    W, half, _, _ = tmsm._window_geometry(C, BITS)
    rng = np.random.default_rng(21)
    gen = (JC.gen_x, JC.gen_y)
    pool = [ec_mul(gen, int(k), 0, mod) for k in rng.integers(1, 1 << 40, size=24)]
    idx = np.where(rng.random((W, half)) < 0.35, -1, rng.integers(0, len(pool), (W, half)))
    neg = np.zeros((W, half), dtype=bool)
    for w in range(W):
        if w % 3:
            idx[w, 8:16] = idx[w, :8]
            neg[w, 8:16] = (w % 3 == 2) & (idx[w, :8] >= 0)
    weights = tmsm._bucket_weights(C, BITS)
    coef = [0] * len(pool)
    coords = []
    for w in range(W):
        for j in range(half):
            k = int(idx[w, j])
            pt = None if k < 0 else (ec_neg(pool[k], mod) if neg[w, j] else pool[k])
            lam = int.from_bytes(rng.bytes(48), "little") % (mod - 1) + 1
            coords.append(xyzz_coords(pt, lam, mod))
            if k >= 0:
                sign = -1 if neg[w, j] else 1
                coef[k] = (coef[k] + sign * int(weights[w, j]) * (1 << (C * w))) % r
    jst, tst = xyzz_both(coords, (W, half))
    got = tmsm.msm_reduce(TC, tst, C, BITS)
    assert_same_points(jmsm.msm_reduce(JC, jst, C, BITS), got)
    aff = tsw.xyzz_to_affine(TC, tsw.XYZZPoints(*(v[:, None] for v in got)))
    assert tsw.affine_to_ints(TC, aff)[0] == ec_msm_oracle(pool, coef, 0, mod)


@pytest.mark.parametrize("tail, quad", [(1, None), (4, 2)])
def test_msm_reduce_split_tree_route_matches_unsplit(tail, quad, monkeypatch):
    """msm_reduce's weighted bucket sums at c = 5 (trees of half = 16
    buckets; the weights of windows 0-2 and of the last two, split, windows)
    with the tree route split at TREE_SUM_MAX = tail: element-wise levels
    down to the tail width, then the tree sum (tail 4, the 5 weight bits in
    groups of 2), or element-wise to the end (tail 1, one group), against the
    unsplit route (one tree sum from 16, one group). The
    buckets hold points at infinity, and bucket j + 8 holds bucket j's point
    (another representative) or its negation, so the first level doubles and
    cancels."""
    mod = JC.base.modulus
    W, half, _, _ = tmsm._window_geometry(C, BITS)
    wins = [0, 1, 2, W - 2, W - 1]
    weights = tmsm._bucket_weights(C, BITS)[wins]
    rng = np.random.default_rng(22 + tail)
    gen = (JC.gen_x, JC.gen_y)
    pool = [ec_mul(gen, int(k), 0, mod) for k in rng.integers(1, 1 << 40, size=6)]
    pts = [[None if rng.random() < 0.3 else pool[rng.integers(len(pool))] for _ in range(half)]
           for _ in wins]
    for w, row in enumerate(pts):
        for j in range(8):
            if row[j] is not None and w % 3:
                row[j + 8] = row[j] if w % 3 == 1 else ec_neg(row[j], mod)
    lams = rng.integers(1, 1 << 62, size=len(wins) * half)
    coords = [xyzz_coords(p, int(lam), mod) for p, lam in zip((p for row in pts for p in row), lams)]
    _, tst = xyzz_both(coords, (len(wins), half))
    want = tmsm._weighted_sum_bits(TC, tst, weights)
    monkeypatch.setattr(ksw, "TREE_SUM_MAX", tail)
    got = tmsm._weighted_sum_bits(TC, tst, weights, quad)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_msm_all_equal_scalars_runs_residual_tiles(monkeypatch):
    """Every scalar equal: one bucket per window holds all 64 points, past
    both static bands."""
    k = 0x1234567890ABCDEF1234567890ABCDEF % JC.scalar.modulus
    _, _, jA, js, tA, ts = msm_inputs(5, scalars=[k] * N)
    calls = []
    tiles = ksw.xyzz_accum_tiles

    def counting_tiles(*args):
        calls.append(1)
        return tiles(*args)

    monkeypatch.setattr(ksw, "xyzz_accum_tiles", counting_tiles)
    got = tmsm.msm(TC, tA, ts, C)
    assert len(calls) == 2  # 64 points - 32 band rounds = 2 tiles of 16
    assert_same_points(jmsm.msm(JC, jA, js, C), got)


def test_chunked_msm_matches_known_answer():
    """Two chunks of 40 and 24 points, the second padded to the chunk size."""
    rng = np.random.default_rng(6)
    n = 64
    px, py, sc, ks, bits = tiled_inputs(TC, n, rng, base_n=16)
    A = affine_from_numpy(px, py, np.zeros(n, dtype=bool), "cpu")
    s = limbs_from_numpy(sc, "cpu")
    cm = tmsm.ChunkedMSM(TC, 40, c=C, max_scalar_bits=bits, device="cpu")
    for lo in (0, 40):
        hi = min(lo + 40, n)
        cm.add_chunk(tsw.AffinePoints(A.x[:, lo:hi], A.y[:, lo:hi], A.inf[lo:hi]), s[:, lo:hi])
    res = cm.result()
    aff = tsw.xyzz_to_affine(TC, tsw.XYZZPoints(*(v[:, None] for v in res)))
    assert tsw.affine_to_ints(TC, aff)[0] == expected_msm(TC, ks, sc)


@pytest.mark.parametrize("nbits", [1, 2, 13])
def test_xyzz_bit_horner_plain_matches_jax_loop(nbits):
    """kernels/sw.py:xyzz_bit_horner_plain (and the wrapper, which takes it on
    the CPU) against zkarray/ec/msm.py:_weighted_sum_bits' bit-Horner (acc =
    parts[nbits - 1]; acc = xyzz_double(acc); acc = xyzz_add(acc, parts[k])
    for k = nbits - 2 .. 0) at W = 3, on testing.bit_horner_edge_parts'
    partials: at 13 bits every lane meets a partial at infinity, acc == part,
    acc == -part and a y = 0 doubling."""
    parts = bit_horner_edge_parts(TC, nbits, 3, np.random.default_rng(30 + nbits))
    jp = [jnp.asarray(limbs_to_numpy(v)) for v in parts]
    acc = jsw.XYZZPoints(*(v[:, nbits - 1] for v in jp))
    for k in range(nbits - 2, -1, -1):
        acc = jsw.xyzz_double(JC, acc)
        acc = jsw.xyzz_add(JC, acc, jsw.XYZZPoints(*(v[:, k] for v in jp)))
    got = ksw.xyzz_bit_horner_plain(TC, parts)
    assert_same_points(acc, got)
    assert all(torch.equal(a, b) for a, b in zip(ksw.xyzz_bit_horner(TC, parts), got))


def test_weighted_sum_bits_matches_jax_one_and_several_groups(monkeypatch):
    """ec/msm.py:_weighted_sum_bits on a seeded (L, 5, 16) bucket state (the
    weights of windows 0-2 and of the last two, split, windows at c = 5;
    points at infinity, and bucket j + 8 holding bucket j's point or its
    negation) with the 5 weight bits in one group and in groups of 2,
    against zkarray.ec.msm._weighted_sum_bits; each run makes one
    xyzz_bit_horner call and no xyzz_double or per-bit xyzz_add call."""
    mod = JC.base.modulus
    W, half, _, _ = tmsm._window_geometry(C, BITS)
    wins = [0, 1, 2, W - 2, W - 1]
    weights = tmsm._bucket_weights(C, BITS)[wins]
    rng = np.random.default_rng(40)
    gen = (JC.gen_x, JC.gen_y)
    pool = [ec_mul(gen, int(k), 0, mod) for k in rng.integers(1, 1 << 40, size=6)]
    pts = [[None if rng.random() < 0.3 else pool[rng.integers(len(pool))] for _ in range(half)]
           for _ in wins]
    for w, row in enumerate(pts):
        for j in range(8):
            if row[j] is not None and w % 3:
                row[j + 8] = row[j] if w % 3 == 1 else ec_neg(row[j], mod)
    lams = rng.integers(1, 1 << 62, size=len(wins) * half)
    coords = [xyzz_coords(p, int(lam), mod) for p, lam in zip((p for row in pts for p in row), lams)]
    jst, tst = xyzz_both(coords, (len(wins), half))
    want = jax.jit(lambda st: jmsm._weighted_sum_bits(JC, st, weights))(jst)
    calls = []
    horner = ksw.xyzz_bit_horner

    def counting_horner(curve, parts):
        calls.append(tuple(parts[0].shape))
        return horner(curve, parts)

    def no_call(*args):
        raise AssertionError("the bit-Horner runs in xyzz_bit_horner only")

    monkeypatch.setattr(ksw, "xyzz_bit_horner", counting_horner)
    monkeypatch.setattr(ksw, "xyzz_double", no_call)
    monkeypatch.setattr(ksw, "xyzz_add", no_call)  # half = 16: no element-wise tree level
    for quad in (None, 2):
        assert_same_points(want, tmsm._weighted_sum_bits(TC, tst, weights, quad))
    assert calls == [(TC.base.num_limbs, 5, len(wins))] * 2
