"""Port parity for the small fields (ff/smallfp.py, ff/fp64.py,
ff/smallfp64.py) and ff/to_field_vec.py, bit for bit against the JAX
package and Python ints.

Every public function runs on CPU tensors, so each takes the plain version
of its kernel (kernels/smallfp.py: sf_op, sf_butterfly); the same seeded
words go through the JAX function, at the shapes the JAX package's own
tests compile (tests/test_smallfp.py: 16 lanes, n = 64; test_fp64.py: 64
lanes, n = 16; test_smallfp64.py: 65 lanes), so XLA compiles nothing new.
Edge words: 0, 1, p - 1 and, where the JAX function takes them, words >= p
(up to 2^32 - 1 a word); the plain versions keep the JAX functions' wraps
there. Tolerance: zero."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from zkarray.ff import fp64 as jfp64  # noqa: E402
from zkarray.ff import smallfp as jsf  # noqa: E402
from zkarray.ff import smallfp64 as jsf64  # noqa: E402
from zkarray_torch import interop  # noqa: E402
from zkarray_torch.ff import fp64 as tfp64  # noqa: E402
from zkarray_torch.ff import smallfp as tsf  # noqa: E402
from zkarray_torch.ff import smallfp64 as tsf64  # noqa: E402
from zkarray_torch.kernels import smallfp as ks  # noqa: E402

SMALL = ("m31", "babybear", "koalabear")
# tests/test_smallfp64.py's primes (its 41-bit candidate is not prime and
# drops out there)
U64_PRIMES = [((1 << 61) - 1, 37, "mersenne61"), ((1 << 62) - (1 << 16) + 1, 3, "p62")]


def _spec_pair(name):
    return getattr(jsf, name.upper()), getattr(tsf, name.upper())


def _t(arr):
    return interop.smallfp_from_numpy(np.asarray(arr), "cpu")


def _same(j, t):
    return np.array_equal(np.asarray(j).astype(np.uint32), interop.smallfp_to_numpy(t))


def _u32_words(p, rng, n=16, wide=False):
    """n words: 0, 1, p - 1, p // 2, then random below p (or below 2^32
    with p, p + 1, 2^32 - 1 when ``wide``)."""
    head = [0, 1, p - 1, p // 2] + ([p, p + 1, (1 << 32) - 1, 2 * p - 1 if 2 * p < 1 << 32 else p + 7]
                                   if wide else [])
    top = (1 << 32) if wide else p
    return np.asarray(head + [rng.randrange(top) for _ in range(n - len(head))], dtype=np.uint32)


# ---------------------------------------------------------------------------
# ff/smallfp.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SMALL)
@pytest.mark.parametrize("wide", [False, True], ids=["below_p", "words_ge_p"])
def test_smallfp_elementwise_match_jax(name, wide):
    js, ts = _spec_pair(name)
    rng = random.Random(f"{name}-{wide}")
    a, b = _u32_words(js.modulus, rng, wide=wide), _u32_words(js.modulus, rng, wide=wide)[::-1].copy()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = _t(a), _t(b)
    assert _same(jsf.mont_mul(js, ja, jb), tsf.mont_mul(ts, ta, tb))
    assert _same(jsf.mont_sqr(js, ja), tsf.mont_sqr(ts, ta))
    assert _same(jsf.add(js, ja, jb), tsf.add(ts, ta, tb))
    assert _same(jsf.sub(js, ja, jb), tsf.sub(ts, ta, tb))
    assert _same(jsf.neg(js, ja), tsf.neg(ts, ta))
    assert _same(jsf.inv(js, ja), tsf.inv(ts, ta))


@pytest.mark.parametrize("name", SMALL)
def test_smallfp_against_python_ints(name):
    """The element-wise ops and pow_const at several exponents against
    Python ints on canonical words (tests/test_smallfp.py's inputs)."""
    _, ts = _spec_pair(name)
    p = ts.modulus
    rng = random.Random(0)
    xs = [0, 1, p - 1, p // 2] + [rng.randrange(p) for _ in range(12)]
    ys = [1, p - 1, 2, p // 3] + [rng.randrange(p) for _ in range(12)]
    a, b = tsf.from_ints(ts, xs, device="cpu"), tsf.from_ints(ts, ys, device="cpu")
    assert a.dtype == torch.uint32 and tuple(a.shape) == (16,)
    assert tsf.to_ints(ts, tsf.mont_mul(ts, a, b)) == [x * y % p for x, y in zip(xs, ys)]
    assert tsf.to_ints(ts, tsf.add(ts, a, b)) == [(x + y) % p for x, y in zip(xs, ys)]
    assert tsf.to_ints(ts, tsf.sub(ts, a, b)) == [(x - y) % p for x, y in zip(xs, ys)]
    assert tsf.to_ints(ts, tsf.neg(ts, a)) == [-x % p for x in xs]
    assert tsf.to_ints(ts, tsf.inv(ts, a)) == [pow(x, -1, p) if x else 0 for x in xs]
    for e in (0, 1, 2, 3, 1 << 40, (p - 1) // 2):
        assert tsf.to_ints(ts, tsf.pow_const(ts, a, e)) == [pow(x, e, p) for x in xs], e
    assert tsf.to_ints(ts, tsf.from_ints(ts, xs, mont=False, device="cpu"), mont=False) == xs


def test_smallfp_pow_const_long_exponents():
    """Exponents of one to three 32-bit words (the kernel's exponent
    words) against Python ints."""
    ts = tsf.BABYBEAR
    p = ts.modulus
    rng = random.Random(5)
    xs = [0, 1, p - 1] + [rng.randrange(p) for _ in range(13)]
    a = tsf.from_ints(ts, xs, device="cpu")
    for e in (1 << 31, (1 << 32) + 1, (1 << 64) + 3, (1 << 95) - 1):
        assert tsf.to_ints(ts, tsf.pow_const(ts, a, e)) == [pow(x, e, p) for x in xs], e
    with pytest.raises(ValueError):
        tsf.pow_const(ts, a, -1)


def test_m31_mul_matches_jax_and_ints():
    rng = random.Random(1)
    p = tsf.M31.modulus
    xs = [0, 1, p - 1] + [rng.randrange(p) for _ in range(13)]
    ys = [5, p - 1, 2] + [rng.randrange(p) for _ in range(13)]
    a, b = np.asarray(xs, dtype=np.uint32), np.asarray(ys, dtype=np.uint32)
    got = tsf.m31_mul(_t(a), _t(b))
    assert [int(v) for v in got.numpy()] == [x * y % p for x, y in zip(xs, ys)]
    assert _same(jsf.m31_mul(a, b), got)
    # words up to 2^32 - 1, where the folds wrap as u32 sums
    w = _u32_words(p, rng, wide=True)
    assert _same(jsf.m31_mul(w, w[::-1].copy()), tsf.m31_mul(_t(w), _t(w[::-1].copy())))


@pytest.mark.parametrize("name", ["babybear", "koalabear"])
def test_smallfp_ntt_matches_jax(name):
    """ntt forward and inverse at n = 64 (1-D, as tests/test_smallfp.py),
    word for word against the JAX package; the round trip and the DFT at
    three indices against Python ints."""
    js, ts = _spec_pair(name)
    p, n = js.modulus, 64
    rng = random.Random(2)
    xs = [rng.randrange(p) for _ in range(n)]
    w = js.root_of_unity(n)
    assert ts.root_of_unity(n) == w
    ja, ta = jsf.from_ints(js, xs), tsf.from_ints(ts, xs, device="cpu")
    jf, tf = jsf.ntt(js, ja, w), tsf.ntt(ts, ta, w)
    assert _same(jf, tf)
    assert _same(jsf.ntt(js, jf, w, inverse=True), tsf.ntt(ts, tf, w, inverse=True))
    assert tsf.to_ints(ts, tsf.ntt(ts, tf, w, inverse=True)) == xs
    fwd = tsf.to_ints(ts, tf)
    for k in (0, 1, 7):
        assert fwd[k] == sum(x * pow(w, j * k, p) for j, x in enumerate(xs)) % p


def test_smallfp_ntt_batched_columns():
    """(n, batch) input: each column's transform equals the 1-D transform
    (the JAX function's batch axis)."""
    ts = tsf.BABYBEAR
    p, n = ts.modulus, 64
    rng = random.Random(3)
    cols = [[rng.randrange(p) for _ in range(n)] for _ in range(3)]
    x = torch.stack([tsf.from_ints(ts, c, device="cpu") for c in cols], dim=1)
    w = ts.root_of_unity(n)
    y = tsf.ntt(ts, x, w)
    for j, c in enumerate(cols):
        assert torch.equal(y[:, j], tsf.ntt(ts, tsf.from_ints(ts, c, device="cpu"), w))
    assert torch.equal(tsf.ntt(ts, y, w, inverse=True), x)


@pytest.mark.parametrize("log_size", [0, 1, 5, 9])
def test_device_twiddle_tables_equal_host_loop(log_size):
    """The doubling tables (T[k:2k] = T[0:k] w^k by sf_op) equal the JAX
    package's host loops word for word, at a power of two and one below."""
    ts = tsf.BABYBEAR
    for size in {1 << log_size, max((1 << log_size) - 1, 1)}:
        w = ts.root_of_unity(1 << 10)
        host, cur = [], 1
        for _ in range(size):
            host.append(ts.to_mont_int(cur))
            cur = cur * w % ts.modulus
        assert [int(v) for v in tsf.twiddle_table(ts, w, size, "cpu").numpy()] == host
        g = tfp64.GOLDILOCKS.root_of_unity(1 << 12)
        tw = [1] * size
        for i in range(1, size):
            tw[i] = tw[i - 1] * g % tfp64.GOLDILOCKS.modulus
        assert tfp64.to_ints(tfp64.twiddle_table(g, size, "cpu")) == tw


# ---------------------------------------------------------------------------
# ff/fp64.py (Goldilocks)
# ---------------------------------------------------------------------------

GP = tfp64.GOLDILOCKS.modulus


def _gl_words(rng, n=64, wide=False):
    head = [0, 1, GP - 1, (1 << 63) + 5, 1 << 32, (1 << 32) - 1]
    if wide:
        head += [GP, GP + 1, (1 << 64) - 1, (1 << 64) - (1 << 32)]
    top = (1 << 64) if wide else GP
    vals = head + [rng.randrange(top) for _ in range(n - len(head))]
    return np.stack([np.asarray([v & 0xFFFFFFFF for v in vals], dtype=np.uint32),
                     np.asarray([v >> 32 for v in vals], dtype=np.uint32)]), vals


@pytest.mark.parametrize("wide", [False, True], ids=["below_p", "words_ge_p"])
def test_fp64_elementwise_match_jax(wide):
    rng = random.Random(11 + wide)
    a, _ = _gl_words(rng, wide=wide)
    b, _ = _gl_words(rng, wide=wide)
    b = b[:, ::-1].copy()
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
    assert _same(jfp64.mul(ja, jb), tfp64.mul(ta, tb))
    assert _same(jfp64.sqr(ja), tfp64.sqr(ta))
    assert _same(jfp64.add(ja, jb), tfp64.add(ta, tb))
    assert _same(jfp64.sub(ja, jb), tfp64.sub(ta, tb))
    assert _same(jfp64.neg(ja), tfp64.neg(ta))
    assert _same(jfp64.inv(jfp64.GOLDILOCKS, ja), tfp64.inv(tfp64.GOLDILOCKS, ta))
    assert _same(jfp64.one_like(ja), tfp64.one_like(ta))


def test_fp64_against_python_ints():
    rng = random.Random(1)
    xs = [0, 1, GP - 1, (1 << 63) + 5] + [rng.randrange(GP) for _ in range(60)]
    ys = [1, GP - 1, 0, (1 << 40) + 7] + [rng.randrange(GP) for _ in range(60)]
    a, b = tfp64.from_ints(xs, "cpu"), tfp64.from_ints(ys, "cpu")
    assert a.dtype == torch.uint32 and tuple(a.shape) == (2, 64)
    assert tfp64.to_ints(tfp64.mul(a, b)) == [x * y % GP for x, y in zip(xs, ys)]
    assert tfp64.to_ints(tfp64.add(a, b)) == [(x + y) % GP for x, y in zip(xs, ys)]
    assert tfp64.to_ints(tfp64.sub(a, b)) == [(x - y) % GP for x, y in zip(xs, ys)]
    assert tfp64.to_ints(tfp64.neg(a)) == [-x % GP for x in xs]
    assert tfp64.to_ints(tfp64.inv(tfp64.GOLDILOCKS, a)) == [pow(x, -1, GP) if x else 0 for x in xs]
    for e in (0, 1, 7, (GP - 1) // 2):
        assert tfp64.to_ints(tfp64.pow_const(a, e)) == [pow(x, e, GP) for x in xs], e
    # the two-word helpers smallfp64 shares
    lo, hi = tfp64._mul32(torch.tensor([0xFFFFFFFF, 3]), torch.tensor([0xFFFFFFFF, 5]))
    assert lo.tolist() == [1, 15] and hi.tolist() == [0xFFFFFFFE, 0]
    s_lo, s_hi, c = tfp64._addc(*(torch.tensor([0xFFFFFFFF]),) * 4)
    assert (s_lo.item(), s_hi.item(), c.item()) == (0xFFFFFFFE, 0xFFFFFFFF, 1)
    d_lo, d_hi, br = tfp64._subb(torch.tensor([0]), torch.tensor([0]), torch.tensor([1]),
                                 torch.tensor([0]))
    assert (d_lo.item(), d_hi.item(), br.item()) == (0xFFFFFFFF, 0xFFFFFFFF, 1)


def test_fp64_ntt_matches_jax():
    """ntt at n = 16 (tests/test_fp64.py) word for word against the JAX
    package, and the DFT and round trip against Python ints."""
    rng = random.Random(2)
    n = 16
    w = jfp64.GOLDILOCKS.root_of_unity(n)
    assert tfp64.GOLDILOCKS.root_of_unity(n) == w
    vals = [rng.randrange(GP) for _ in range(n)]
    jx, tx = jfp64.from_ints(vals), tfp64.from_ints(vals, "cpu")
    jy, ty = jfp64.ntt(jx, w), tfp64.ntt(tx, w)
    assert _same(jy, ty)
    assert tfp64.to_ints(ty) == [sum(vals[j] * pow(w, j * k, GP) for j in range(n)) % GP
                                 for k in range(n)]
    assert _same(jfp64.ntt(jy, w, inverse=True), tfp64.ntt(ty, w, inverse=True))
    assert tfp64.to_ints(tfp64.ntt(ty, w, inverse=True)) == vals
    assert tfp64.GOLDILOCKS.two_adicity == 32


# ---------------------------------------------------------------------------
# ff/smallfp64.py
# ---------------------------------------------------------------------------

def _u64_pair(i):
    p, g, name = U64_PRIMES[i]
    return jsf64.SmallFp64Spec(p, g, name), tsf64.SmallFp64Spec(p, g, name)


@pytest.mark.parametrize("i", range(len(U64_PRIMES)), ids=[c[2] for c in U64_PRIMES])
def test_smallfp64_elementwise_match_jax_and_ints(i):
    """tests/test_smallfp64.py's inputs through both packages, word for
    word, and the results against Python ints."""
    js, ts = _u64_pair(i)
    p = ts.modulus
    rng = np.random.default_rng(42)
    xs = [int(v) % p for v in rng.integers(0, 1 << 63, size=65)]
    ys = [int(v) % p for v in rng.integers(0, 1 << 63, size=65)]
    xs[:3] = [0, 1, p - 1]
    ys[:3] = [p - 1, p - 1, p - 1]
    ja, jb = jsf64.from_ints(js, xs), jsf64.from_ints(js, ys)
    ta, tb = tsf64.from_ints(ts, xs, "cpu"), tsf64.from_ints(ts, ys, "cpu")
    assert _same(ja, ta) and _same(jb, tb)
    for jf, tf, want in (
        (jsf64.mont_mul(js, ja, jb), tsf64.mont_mul(ts, ta, tb), [x * y % p for x, y in zip(xs, ys)]),
        (jsf64.add(js, ja, jb), tsf64.add(ts, ta, tb), [(x + y) % p for x, y in zip(xs, ys)]),
        (jsf64.sub(js, ja, jb), tsf64.sub(ts, ta, tb), [(x - y) % p for x, y in zip(xs, ys)]),
        (jsf64.neg(js, ja), tsf64.neg(ts, ta), [-x % p for x in xs]),
        (jsf64.inv(js, ja), tsf64.inv(ts, ta), [pow(x, -1, p) if x else 0 for x in xs]),
    ):
        assert _same(jf, tf)
        assert tsf64.to_ints(ts, tf) == want
    assert _same(jsf64.one(js, (65,)), tsf64.one(ts, (65,), "cpu"))
    assert tsf64.to_ints(ts, tsf64.pow_const(ts, ta, 0)) == [1] * 65
    assert tsf64.to_ints(ts, tsf64.pow_const(ts, ta, 13)) == [pow(x, 13, p) for x in xs]


@pytest.mark.parametrize("i", range(len(U64_PRIMES)), ids=[c[2] for c in U64_PRIMES])
def test_smallfp64_words_ge_p_match_jax(i):
    """Words up to 2^64 - 1 (>= p), where the two-step CIOS's top word and
    the additions wrap: the same words as the JAX functions."""
    js, ts = _u64_pair(i)
    p = ts.modulus
    rng = random.Random(9 + i)
    head = [p, p + 1, (1 << 64) - 1, (1 << 64) - p, 2 * p - 1, 0, 1, p - 1]
    vals = head + [rng.randrange(1 << 64) for _ in range(65 - len(head))]
    arr = np.stack([np.asarray([v & 0xFFFFFFFF for v in vals], dtype=np.uint32),
                    np.asarray([v >> 32 for v in vals], dtype=np.uint32)])
    brr = arr[:, ::-1].copy()
    ja, jb, ta, tb = jnp.asarray(arr), jnp.asarray(brr), _t(arr), _t(brr)
    assert _same(jsf64.mont_mul(js, ja, jb), tsf64.mont_mul(ts, ta, tb))
    assert _same(jsf64.add(js, ja, jb), tsf64.add(ts, ta, tb))
    assert _same(jsf64.sub(js, ja, jb), tsf64.sub(ts, ta, tb))
    assert _same(jsf64.neg(js, ja), tsf64.neg(ts, ta))
    assert _same(jsf64.inv(js, ja), tsf64.inv(ts, ta))


def test_small_field_specs_match_jax():
    for name in SMALL:
        js, ts = _spec_pair(name)
        assert interop.same_small_field(ts, js.modulus, js.generator_int)
        assert (ts.r_int, ts.r2_int, ts.inv32, ts.two_adicity, ts.two_adic_root_int,
                ts.is_mersenne) == (js.r_int, js.r2_int, js.inv32, js.two_adicity,
                                    js.two_adic_root_int, js.is_mersenne)
    g = jfp64.GOLDILOCKS
    assert interop.same_small_field(tfp64.GOLDILOCKS, g.modulus, g.generator_int)
    assert (tfp64.GOLDILOCKS.two_adicity, tfp64.GOLDILOCKS.two_adic_root_int) == (
        g.two_adicity, g.two_adic_root_int)
    for i in range(len(U64_PRIMES)):
        js, ts = _u64_pair(i)
        assert interop.same_small_field(ts, js.modulus, js.generator_int)
        assert (ts.r2_int, ts.two_adic_root_int) == (js.r2_int, js.two_adic_root_int)
    assert not interop.same_small_field(tsf.BABYBEAR, tsf.KOALABEAR.modulus, 3)


# ---------------------------------------------------------------------------
# the kernels' plain versions on edge words, against Python ints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", ["u32", "m31", "gl64", "u64"])
def test_sf_op_plain_edge_words_against_ints(fam):
    """Every op of every family on all pairs of 0, 1, p - 1, p // 2 and a
    random word: the field results by Python ints (Montgomery forms
    converted on the host)."""
    if fam in ("u32", "m31"):
        spec = tsf.BABYBEAR if fam == "u32" else tsf.M31
        p, c = spec.modulus, (spec.consts if fam == "u32" else ks.M31)
        R = (1 << 32) if fam == "u32" else 1
    elif fam == "gl64":
        p, c, R = GP, ks.GL64, 1
    else:
        spec = tsf64.SmallFp64Spec(*U64_PRIMES[1])
        p, c, R = spec.modulus, spec.consts, 1 << 64
    base = [0, 1, p - 1, p // 2, random.Random(fam).randrange(p)]
    xs = [x for x in base for _ in base]
    ys = [y for _ in base for y in base]

    def enc(vals):
        w = [v * R % p for v in vals]
        if fam in ("u32", "m31"):
            return torch.tensor(w, dtype=torch.int64).to(torch.uint32)
        return torch.tensor([[v & 0xFFFFFFFF for v in w], [v >> 32 for v in w]],
                            dtype=torch.int64).to(torch.uint32)

    def dec(t):
        w = t.to(torch.int64)
        w = w.tolist() if w.dim() == 1 else [lo | (hi << 32) for lo, hi in zip(*w.tolist())]
        return [v * pow(R, -1, p) % p for v in w]

    a, b = enc(xs), enc(ys)
    ops = {"mul": [x * y % p for x, y in zip(xs, ys)]}
    if fam != "m31":
        ops.update(sqr=[x * x % p for x in xs], add=[(x + y) % p for x, y in zip(xs, ys)],
                   sub=[(x - y) % p for x, y in zip(xs, ys)], neg=[-x % p for x in xs],
                   pow=[pow(x, p - 2, p) for x in xs])
    for op, want in ops.items():
        args = (a,) if ks.ARITY[op] == 1 else (a, b)
        got = ks.sf_op(fam, c, op, *args, exponent=p - 2 if op == "pow" else None)
        assert dec(got) == want, op


def test_sf_op_broadcast_and_out():
    """A one-element operand broadcasts (the kernel's element stride 0), a
    column operand expands, and out= writes into strided column slices."""
    ts = tsf.KOALABEAR
    rng = random.Random(4)
    a = tsf.from_ints(ts, [rng.randrange(ts.modulus) for _ in range(12)], device="cpu").reshape(3, 4)
    s = tsf.from_ints(ts, [5], device="cpu")
    col = tsf.from_ints(ts, [2, 3, 4], device="cpu").reshape(3, 1)
    assert torch.equal(tsf.mont_mul(ts, a, s), tsf.mont_mul(ts, a, s.expand(3, 4).contiguous()))
    assert torch.equal(tsf.add(ts, a, col), tsf.add(ts, a, col.expand(3, 4).contiguous()))
    T = torch.zeros((2, 8), dtype=torch.uint32)
    x = tfp64.from_ints([3, 4, 5, 6], "cpu")
    ks.sf_op("gl64", ks.GL64, "mul", x, tfp64.from_ints([7], "cpu").reshape(2, 1), out=T[:, 4:])
    assert tfp64.to_ints(T[:, 4:].contiguous()) == [21, 28, 35, 42]
    with pytest.raises(ValueError):
        ks.sf_op("m31", ks.M31, "add", s, s)
    with pytest.raises(TypeError):
        ks.sf_op("u32", ts.consts, "mul", s.to(torch.int64), s)


@pytest.mark.parametrize("fam", ["u32", "gl64"])
def test_sf_butterfly_plain_against_stage_formula(fam):
    """One stage of each size on edge words against the stage by Python
    ints: (lo + hi w_j, lo - hi w_j), w_j = tw[j n/m]."""
    n = 16
    if fam == "u32":
        spec = tsf.BABYBEAR
        p, c, R = spec.modulus, spec.consts, 1 << 32
    else:
        p, c, R = GP, ks.GL64, 1
    rng = random.Random(fam)
    vals = [0, 1, p - 1, p // 2] + [rng.randrange(p) for _ in range(n - 4)]
    tw_vals = [rng.randrange(p) for _ in range(n // 2)]

    def enc(v, rows):
        w = [x * R % p for x in v]
        if fam == "u32":
            return torch.tensor(w, dtype=torch.int64).to(torch.uint32).reshape(rows)
        return torch.tensor([[x & 0xFFFFFFFF for x in w], [x >> 32 for x in w]],
                            dtype=torch.int64).to(torch.uint32)

    def dec(t):
        w = t.to(torch.int64)
        w = w.reshape(-1).tolist() if fam == "u32" else [lo | (hi << 32) for lo, hi in zip(*w.tolist())]
        return [x * pow(R, -1, p) % p for x in w]

    tw = enc(tw_vals, (n // 2,))
    for m in (2, 4, 8, 16):
        y = enc(vals, (n, 1))
        ks.sf_butterfly(fam, c, y, tw, m)
        want = list(vals)
        for k in range(n // m):
            for j in range(m // 2):
                i0, i1 = k * m + j, k * m + j + m // 2
                t = vals[i1] * tw_vals[j * (n // m)] % p
                want[i0], want[i1] = (vals[i0] + t) % p, (vals[i0] - t) % p
        assert dec(y) == want, m


# ---------------------------------------------------------------------------
# ff/to_field_vec.py
# ---------------------------------------------------------------------------

def test_to_field_vec_matches_jax():
    from zkarray.curves import bn254 as jbn
    from zkarray.ff import to_field_vec as jtv
    from zkarray_torch.curves import bn254 as tbn
    from zkarray_torch.ec import sw as tsw
    from zkarray_torch.ff import to_field_vec as ttv

    data = bytes(range(7, 7 + 95))
    got = ttv.bytes_to_field_vec(tbn.FR, data, device="cpu")
    want = jtv.bytes_to_field_vec(jbn.FR, data)
    assert np.array_equal(np.asarray(want), interop.limbs_to_numpy(got))
    per = (tbn.FR.bits - 1) // 8
    from zkarray_torch.ff import fp as tfp
    assert tfp.to_ints(tbn.FR, got) == [int.from_bytes(data[i:i + per], "little")
                                       for i in range(0, len(data), per)]
    a = tfp.from_ints(tbn.FR, [3, 4], device="cpu")
    assert ttv.field_to_field_vec(tbn.FR, a)[0] is a
    pts = tsw.affine_from_ints(tbn.G1, [(tbn.G1.gen_x, tbn.G1.gen_y)], "cpu")
    x, y = ttv.affine_to_field_vec(tbn.G1, pts)
    assert x is pts.x and y is pts.y
