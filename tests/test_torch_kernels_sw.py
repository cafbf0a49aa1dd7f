"""Port parity: the plain versions of the xyzz_accum and horner_windows
kernels against the JAX package, bit for bit.

* xyzz_accum_grid / xyzz_accum_tiles (plain) against sequential
  zkarray.ec.sw.xyzz_add_affine, built as tests/test_kernels.py's tile case
  builds it, on BLS12-381 G1: 1024 slots, 2 rounds, digit signs and skipped
  slots, and in round 0 the doubling, cancel and infinity edges.
* horner_windows (plain) against zkarray.ec.msm.msm_reduce, whose CPU path
  runs the window Horner with sw.xyzz_double / sw.xyzz_add, on the window
  points of a bucket state (n = 64, c = 5 geometry, as test_msm.py): its
  words stored in tests/vectors/horner_reduce.npz, rebuilt by a test
  marked slow.
* both again on the edge-class inputs of zkarray_torch/testing.py
  (accum_edge_rounds, horner_edge_windows), which chip_smoke.py also feeds
  the CUDA kernels.

The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from torch_parity import JC, TC  # noqa: E402
from zkarray.ec import sw as jsw  # noqa: E402
from zkarray.ff import fp as jfp  # noqa: E402
from zkarray_torch.core.limbs import pack_pairs, unpack_pairs  # noqa: E402
from zkarray_torch.ec import msm as tmsm  # noqa: E402
from zkarray_torch.ec import sw as tsw  # noqa: E402
from zkarray_torch.interop import limbs_from_numpy, limbs_to_numpy  # noqa: E402
from zkarray_torch.kernels import sw as ksw  # noqa: E402
from zkarray_torch.testing import accum_edge_rounds, accum_feed, ec_mul, horner_edge_windows  # noqa: E402

L = JC.base.num_limbs
MOD = JC.base.modulus


def point_pool(rng, size=64):
    gen = (JC.gen_x, JC.gen_y)
    return [ec_mul(gen, int(k), 0, MOD) for k in rng.integers(1, 1 << 30, size=size)]


def test_accum_plain_matches_sequential_jax_mixed_adds():
    rng = np.random.default_rng(21)
    pool = point_pool(rng)
    n = 1024
    cls = np.arange(n) % 6
    P0 = [pool[i] for i in rng.integers(0, len(pool), size=n)]
    P0 = [None if c in (3, 5) else p for c, p in zip(cls, P0)]
    rounds = []
    # round 0: 0 generic, 1 A == P, 2 A == -P (sign bit), 3 P at infinity,
    # 4 A skipped (infinity), 5 both at infinity
    A0 = [pool[i] for i in rng.integers(0, len(pool), size=n)]
    A0 = [P0[i] if cls[i] in (1, 2) else A0[i] for i in range(n)]
    sign0 = cls == 2
    skip0 = np.isin(cls, (4, 5))
    rounds.append((A0, sign0, skip0))
    # round 1: random signs and skips
    A1 = [pool[i] for i in rng.integers(0, len(pool), size=n)]
    rounds.append((A1, rng.integers(0, 2, size=n).astype(bool), rng.integers(0, 4, size=n) == 0))

    jP = jsw.xyzz_from_affine(JC, JC.affine_from_ints(P0))
    want = jP
    coords, vwords = [], []
    for pts, sign, skip in rounds:
        A = JC.affine_from_ints([p if p is not None else (0, 0) for p in pts])
        y = jfp.select(jnp.asarray(sign), jfp.neg(JC.base, A.y), A.y)
        want = jsw.xyzz_add_affine(JC, want, jsw.AffinePoints(A.x, y, jnp.asarray(skip)))
        xy = limbs_from_numpy(np.concatenate([np.asarray(A.x), np.asarray(A.y)]), "cpu")
        coords.append(pack_pairs(xy))
        vwords.append((~skip).astype(np.int32) | (sign.astype(np.int32) << 1))

    state = torch.cat([pack_pairs(limbs_from_numpy(np.asarray(v), "cpu")) for v in jP])
    coords = torch.stack(coords, dim=1).contiguous()  # (L, R, S)
    valid = torch.from_numpy(np.stack(vwords))  # (R, S)
    Lp = L // 2
    for fn in (ksw.xyzz_accum_grid, ksw.xyzz_accum_tiles, ksw.xyzz_accum_plain):
        got = fn(TC, state, coords, valid)
        for i, w in enumerate(want):
            assert np.array_equal(np.asarray(w), limbs_to_numpy(unpack_pairs(got[i * Lp : (i + 1) * Lp])))


def _words_script():
    from torch_parity import words_script

    return words_script()


def test_horner_plain_matches_jax_msm_reduce():
    """tests/test_msm.py's n = 64, c = 5 geometry (W = 52, half = 16): a
    bucket state with ZZ != 1, the XYZZ sum of two seeded affine points a
    bucket, reduced by the port's bit-Horner and horner_windows_plain,
    against zkarray.ec.msm.msm_reduce's words (and the state) stored in
    tests/vectors/horner_reduce.npz by scripts/pairing_bundle_words.py."""
    import os

    c = 5
    W, half, P, Q = _words_script().horner_reduce_inputs()
    ref = np.load(os.path.join(os.path.dirname(__file__), "vectors", "horner_reduce.npz"))
    tP = tsw.xyzz_from_affine(TC, tsw.affine_from_ints(TC, P, device="cpu"))
    tQ = tsw.xyzz_from_affine(TC, tsw.affine_from_ints(TC, Q, device="cpu"))
    state = tsw.XYZZPoints(*(v.reshape(L, W, half) for v in tsw.xyzz_add(TC, tP, tQ)))
    assert np.array_equal(np.stack([limbs_to_numpy(v) for v in state]), ref["state"].astype(np.uint32))
    win = tmsm._weighted_sum_bits(TC, state, tmsm._bucket_weights(c, 255))
    got = ksw.horner_windows_plain(TC, torch.cat(list(win)).T.contiguous(), c)
    want = ref["want"].astype(np.uint32)
    for i in range(4):
        assert np.array_equal(want[i], limbs_to_numpy(got[i * L : (i + 1) * L]))


@pytest.mark.slow
def test_stored_horner_reduce_words_match_jax():
    """The stored msm_reduce words equal what the JAX package computes now."""
    mod = _words_script()
    want = mod.words_horner_reduce()
    ref = np.load(mod.OUT["horner_reduce"])
    assert sorted(ref.files) == sorted(want)
    for k, v in want.items():
        assert ref[k].dtype == v.dtype and np.array_equal(ref[k], v), k


def test_accum_plain_matches_sequential_jax_on_edge_rounds():
    """45 slots (not a multiple of 32 or of the kernel's block) x 3 rounds
    from testing.accum_edge_rounds: doubling and cancel in round 0 and, with
    ZZ != 1, in round 1; buckets at infinity; skipped rounds; slots whose
    last rounds are all skipped."""
    S, R = 45, 3
    P0, rounds = accum_edge_rounds(TC, S, R, np.random.default_rng(23))
    want = jsw.xyzz_from_affine(JC, JC.affine_from_ints(P0))
    for pts, sign, skip in rounds:
        A = JC.affine_from_ints([p if p is not None else (0, 0) for p in pts])
        y = jfp.select(jnp.asarray(sign), jfp.neg(JC.base, A.y), A.y)
        want = jsw.xyzz_add_affine(JC, want, jsw.AffinePoints(A.x, y, jnp.asarray(skip)))
    state, coords, valid = accum_feed(TC, P0, rounds)
    got = ksw.xyzz_accum_plain(TC, state, coords, valid)
    Lp = L // 2
    for i, w in enumerate(want):
        assert np.array_equal(np.asarray(w), limbs_to_numpy(unpack_pairs(got[i * Lp : (i + 1) * Lp])))


def test_horner_plain_matches_jax_window_chain_on_edge_windows():
    """horner_windows_plain against zkarray/ec/msm.py's window Horner order
    (c sw.xyzz_double, then sw.xyzz_add, high window to low) on windows from
    testing.horner_edge_windows: the top window at infinity, one at infinity
    mid-chain, one equal to the running sum in another Z, one equal to its
    negation; the total also equals the host oracle's."""
    W, c = 7, 2
    win, total = horner_edge_windows(TC, W, c, np.random.default_rng(24))
    rows = limbs_to_numpy(win.T.contiguous())  # (4L, W)
    pt = lambda w: jsw.XYZZPoints(*(jnp.asarray(rows[i * L : (i + 1) * L, w]) for i in range(4)))  # noqa: E731
    want = pt(W - 1)
    for wi in range(W - 2, -1, -1):
        for _ in range(c):
            want = jsw.xyzz_double(JC, want)
        want = jsw.xyzz_add(JC, want, pt(wi))
    got = ksw.horner_windows_plain(TC, win, c)
    for i, w in enumerate(want):
        assert np.array_equal(np.asarray(w), limbs_to_numpy(got[i * L : (i + 1) * L]))
    res = tsw.XYZZPoints(*(got[i * L : (i + 1) * L, None] for i in range(4)))
    assert tsw.affine_to_ints(TC, tsw.xyzz_to_affine(TC, res)) == [total]
