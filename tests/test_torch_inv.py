"""The field inverse's and the to-affine's batched binary GCD
(csrc/mont.cu:gcd_div_pair and gcd_div_one, behind mont_inv_kernel and
mont_div_kernel) on the CPU, where the CUDA kernels cannot run.

Their word model (zkarray_torch/testing.py:gcd_div_model, with its carries,
its 62-bit stand-ins, its batches of 30 steps and the pending negations of
the coefficients) is held against Python's pow on testing.mont_inv_edge_words
and random words, one field at each width the library builds: BN254 Fr,
BLS12-381 Fr and secp256k1's field (NW = 8; the last with p's top bit set),
MNT4-298 Fq (10), BLS12-381 Fq (12), MNT4-753 Fq (24) and CP6-782 Fq (26),
with its steps until a = 0 under their stated bound and within the
kernel's fixed GCD_STEPS x gcd_batches steps. The division form
(num / den, den = 0 included) is held against Python ints; mont_div's plain
version (the batch-inverse route, the wrapper's on the CPU) against Python
ints and against the model; and ec.sw.xyzz_to_affine on the CPU against
zkarray.ec.sw.xyzz_to_affine on points at infinity and others with random
ZZ representatives, at the width 8 that tests/test_sw.py compiles. No other
JAX function runs here."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import JC, TC, xyzz_both  # noqa: E402
from zkarray.ec import sw as jsw  # noqa: E402
from zkarray_torch.core.limbs import ints_to_limbs_np, limbs_to_ints  # noqa: E402
from zkarray_torch.curves import bls12_381, bn254, cp6_782, mnt4_298, mnt4_753, zoo  # noqa: E402
from zkarray_torch.ec import sw as tsw  # noqa: E402
from zkarray_torch.interop import limbs_to_numpy  # noqa: E402
from zkarray_torch.kernels import mont as km  # noqa: E402
from zkarray_torch.testing import (gcd_div_model, mont_div_model, mont_inv_edge_words,  # noqa: E402
                                   mont_inv_iteration_bound, mont_inv_model)

SPECS = [bn254.FR, bls12_381.FR, zoo.SECP256K1.base, mnt4_298.FQ, bls12_381.FQ, mnt4_753.FQ,
         cp6_782.FQ]
IDS = ["bn254-Fr", "bls12_381-Fr", "secp256k1-Fq", "mnt4_298-Fq", "bls12_381-Fq", "mnt4_753-Fq",
       "cp6_782-Fq"]


def test_widths_and_batches():
    """One field of each width, and the batch counts the kernels run
    (ceil((2 bits(p) - 1) / 30)); secp256k1's p has its top bit set."""
    assert sorted({f.num_limbs // 2 for f in SPECS}) == [8, 10, 12, 24, 26]
    assert zoo.SECP256K1.base.modulus >> (32 * 8 - 1) == 1
    assert [km.gcd_batches(f) for f in SPECS] == [17, 17, 18, 20, 26, 51, 53]
    for f in SPECS:
        assert km.GCD_STEPS * km.gcd_batches(f) >= 2 * f.modulus.bit_length() - 1


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_gcd_model_inverse_matches_pow(spec):
    """The model from u0 = R^2 (mont_inv) on the edge words (0, 1, R mod p,
    p - 1, powers of two and the elements 2^k) and four random words: x^-1's
    Montgomery word, 0 for 0; the steps until a = 0 below the bound, which the
    kernel's steps reach; the words 2^k with k near bits(p) come within two
    steps of 2 bits(p) - 1, so the batches cannot be fewer."""
    p, R = spec.modulus, spec.r_int
    words = mont_inv_edge_words(spec, np.random.default_rng(21), n_random=4)
    steps = []
    for w in words:
        inv_w, st = mont_inv_model(spec, w)
        assert inv_w == (pow(w * pow(R, -1, p), -1, p) * R % p if w else 0), w
        assert st < mont_inv_iteration_bound(spec, w) <= km.GCD_STEPS * km.gcd_batches(spec) + 1, w
        steps.append(st)
    assert max(steps) >= 2 * p.bit_length() - 3


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_gcd_model_division_matches_python_ints(spec):
    """The division form (mont_div: u0 = num R) on the edge words as
    denominators (0 among them) with random numerators: (num / den)'s
    Montgomery word, 0 where den = 0; and u0 = 0 gives 0."""
    p, R = spec.modulus, spec.r_int
    rng = np.random.default_rng(22)
    dens = mont_inv_edge_words(spec, rng, n_random=2)
    nums = [int.from_bytes(rng.bytes(2 * spec.num_limbs), "little") % p for _ in dens]
    assert 0 in dens
    for num, den in zip(nums, dens):
        q, _ = mont_div_model(spec, num, den)
        assert q == (num * pow(den, -1, p) * R % p if den else 0), (num, den)
    assert gcd_div_model(spec, dens[-1], 0)[0] == 0


@pytest.mark.parametrize("spec", [bn254.FR, bls12_381.FQ, zoo.SECP256K1.base],
                         ids=["bn254-Fr", "bls12_381-Fq", "secp256k1-Fq"])
def test_mont_div_plain_matches_python_ints(spec):
    """mont_div's plain version, and the wrapper on CPU tensors, on a
    (L, 2, 5) batch: both quotients against Python ints (zero denominators
    give 0) and against the word model."""
    p, R, L = spec.modulus, spec.r_int, spec.num_limbs
    rng = np.random.default_rng(23)
    dens = mont_inv_edge_words(spec, rng, n_random=0)[:10]
    nums = [int.from_bytes(rng.bytes(2 * L), "little") % p for _ in range(20)]

    def limbs(xs):
        return torch.from_numpy(ints_to_limbs_np(xs, L).astype(np.int32)).reshape(L, 2, 5)

    n0, n1, d0, d1 = limbs(nums[:10]), limbs(nums[10:]), limbs(dens), limbs(dens[::-1])
    got = km.mont_div_plain(spec, n0, d0, n1, d1)
    assert got.shape == (2, L, 2, 5)
    assert torch.equal(km.mont_div(spec, n0, d0, n1, d1), got)
    for k, (ns, ds) in enumerate(((nums[:10], dens), (nums[10:], dens[::-1]))):
        want = [a * pow(d, -1, p) * R % p if d else 0 for a, d in zip(ns, ds)]
        assert limbs_to_ints(got[k].reshape(L, -1)) == want
        assert want == [mont_div_model(spec, a, d)[0] for a, d in zip(ns, ds)]


def test_xyzz_to_affine_matches_jax():
    """ec.sw.xyzz_to_affine on the CPU (mont_div's plain version: each
    numerator times its batch inverse) against zkarray.ec.sw.xyzz_to_affine
    at width 8: points at infinity (ZZ = ZZZ = 0) and points with random
    ZZ = l^2, ZZZ = l^3, word for word, and against the affine points."""
    mod = JC.base.modulus
    rng = np.random.default_rng(24)
    gen = (JC.gen_x, JC.gen_y)
    from zkarray_torch.testing import ec_mul

    pts = [None if i in (2, 5) else ec_mul(gen, int(k), 0, mod)
           for i, k in enumerate(rng.integers(1, 1 << 30, size=8))]
    coords = []
    for pt in pts:
        if pt is None:
            coords.append((int(rng.integers(1, 1 << 30)), 7, 0, 0))
            continue
        lam = int.from_bytes(rng.bytes(48), "little") % (mod - 1) + 1
        l2 = lam * lam % mod
        coords.append((pt[0] * l2 % mod, pt[1] * l2 * lam % mod, l2, l2 * lam % mod))
    jP, tP = xyzz_both(coords, (8,))
    ja, ta = jsw.xyzz_to_affine(JC, jP), tsw.xyzz_to_affine(TC, tP)
    for j, t in ((ja.x, ta.x), (ja.y, ta.y)):
        assert np.array_equal(np.asarray(j), limbs_to_numpy(t))
    assert np.array_equal(np.asarray(ja.inf), ta.inf.numpy())
    assert tsw.affine_to_ints(TC, ta) == pts
