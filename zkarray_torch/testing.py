"""Host oracles and known-answer inputs for the port's tests and chip_smoke.py.

The port's own copies of tests/ec_oracle.py (textbook affine arithmetic on
Python ints) and of bench.py's tiled MSM inputs with their O(1)-host-work
known answer; edge-class inputs for the bucket accumulation and the
window Horner, built with the oracle; and for the group path, seeded points
and scalars with known answers at sampled indices, Jacobian edge-class
pairs, and curve points outside the prime-order subgroup, that the CPU
tests and chip_smoke.py share; for the pairing path, host G2 arithmetic
over Fp2 (and over any tower with a curve coefficient a, for MNT4/6 and
CP6), the known answers E = e(G1, G2) of BLS12-381, BLS12-377, BN254,
BW6-761, BW6-767, MNT4/6-298, MNT4/6-753 and CP6-782 and their powers
(HostExt), tiled pairing and GT inputs, and edge words for the field
additions and for fp_lin with maps at its coefficient bound; for the other
curve models and hashing, affine twisted Edwards and double-odd group laws
on Python ints and host models of the BLS12-381 G1 and G2 hash to curve
(SWU, the isogenies, the cofactor multiples).
"""

from __future__ import annotations

import numpy as np
import torch

from zkarray_torch.core.limbs import pack_pairs
from zkarray_torch.ec.sw import AffinePoints, SWCurveSpec, affine_from_ints, xyzz_from_affine
from zkarray_torch.ec.sw_ext import ExtAffine
from zkarray_torch.ff import fp
from zkarray_torch.kernels import mont as km


def ec_neg(p, mod):
    return None if p is None else (p[0], (-p[1]) % mod)


def ec_add(p, q, a, mod):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2 and (y1 + y2) % mod == 0:
        return None
    if p == q:
        lam = (3 * x1 * x1 + a) * pow(2 * y1, -1, mod) % mod
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, mod) % mod
    x3 = (lam * lam - x1 - x2) % mod
    y3 = (lam * (x1 - x3) - y1) % mod
    return (x3, y3)


def ec_mul(p, k, a, mod):
    if k < 0:
        return ec_mul(ec_neg(p, mod), -k, a, mod)
    acc = None
    for bit in bin(k)[2:] if k else "":
        acc = ec_add(acc, acc, a, mod)
        if bit == "1":
            acc = ec_add(acc, p, a, mod)
    return acc


def ec_msm_oracle(pts, scalars, a, mod):
    """Σ k_i·P_i as an affine int pair (or None for the identity)."""
    acc = None
    for p, k in zip(pts, scalars):
        acc = ec_add(acc, ec_mul(p, k, a, mod), a, mod)
    return acc


def sqrt_mod(a: int, p: int):
    """A square root of a mod an odd prime p (Tonelli-Shanks), or None."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
    while q % 2 == 0:
        q, s = q // 2, s + 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2, i = t2 * t2 % p, i + 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


def sqrt_reference(spec, x: int) -> int:
    """The root zkarray/ff/fp.py:sqrt returns for a canonical x (0 for a
    non-square), on Python ints, route by route: x^((p+1)/4); Atkin's
    x^((p+3)/8) times 2^((p-1)/4) where x^((p-1)/4) != 1; Tonelli-Shanks'
    bit-by-bit discrete log with the constants c^(-2^j) of
    c = qnr^trace."""
    p = spec.modulus
    if spec.sqrt_mode == "3mod4":
        r = pow(x, spec.sqrt_exp, p)
    elif spec.sqrt_mode == "5mod8":
        r = pow(x, (p + 3) // 8, p)
        if pow(x, (p - 1) // 4, p) != 1:
            r = r * pow(2, (p - 1) // 4, p) % p
    else:
        s, t = spec.two_adicity, spec.trace
        cs_inv = [pow(pow(spec.sqrt_qnr, t, p), -(1 << j), p) for j in range(s)]
        g, r = pow(x, t, p), pow(x, (t + 1) // 2, p)
        for j in range(s):
            if pow(g, 1 << (s - 1 - j), p) != 1:
                g = g * cs_inv[j] % p
                if j >= 1:
                    r = r * cs_inv[j - 1] % p
    return r if r * r % p == x % p else 0


def off_subgroup_points(curve: SWCurveSpec, n: int, rng: np.random.Generator) -> list:
    """n points on the curve whose order the prime subgroup's r does not
    kill: x drawn at random until x^3 + a x + b is a square, y its root, never
    multiplied by the cofactor (the host checks r P != infinity). Needs a
    cofactor > 1."""
    if curve.cofactor == 1:
        raise ValueError(f"{curve.name} has cofactor 1: every point is in the subgroup")
    mod, a, r = curve.base.modulus, curve.a_int, curve.scalar.modulus
    out = []
    while len(out) < n:
        x = int.from_bytes(rng.bytes(64), "little") % mod
        y = sqrt_mod(x * x * x + a * x + curve.b_int, mod)
        if y is not None and ec_mul((x, y), r, a, mod) is not None:
            out.append((x, y))
    return out


def group_inputs(curve: SWCurveSpec, n: int, rng: np.random.Generator, base_n: int = 64):
    """Seeded inputs of a batched scalar multiplication: ``base_n`` random
    multiples of the generator tiled to n points, and n scalars of
    ``curve.scalar.bits`` random bits as canonical limbs. Returns (base
    points, px, py, sc): the affine int pairs, uint32 limb arrays (L, n),
    (L, n) and (Ls, n); point i is base[i % base_n]."""
    gen = (curve.gen_x, curve.gen_y)
    base = [ec_mul(gen, int(k), curve.a_int, curve.base.modulus)
            for k in rng.integers(1, 1 << 62, size=base_n)]
    A0 = affine_from_ints(curve, base, device="cpu")
    reps = -(-n // base_n)
    px = np.tile(A0.x.numpy().astype(np.uint32), (1, reps))[:, :n]
    py = np.tile(A0.y.numpy().astype(np.uint32), (1, reps))[:, :n]
    Ls, bits = curve.scalar.num_limbs, curve.scalar.bits
    sc = rng.integers(0, 1 << 16, size=(Ls, n), dtype=np.uint32)
    sc[bits // 16 :] = 0
    if bits % 16:
        sc[bits // 16] &= (1 << (bits % 16)) - 1
    return base, np.ascontiguousarray(px), np.ascontiguousarray(py), sc


def scalar_of(sc: np.ndarray, i: int) -> int:
    """Scalar i of a (Ls, n) canonical limb array, as a Python int."""
    return sum(int(sc[l, i]) << (16 * l) for l in range(sc.shape[0]))


def jac_edge_pairs(curve: SWCurveSpec, n: int, rng: np.random.Generator):
    """n point pairs (P, Q), affine int pairs or None, in the edge classes of
    the Jacobian add by i % 6: generic, P == Q, P == -Q, P at infinity, Q at
    infinity, both at infinity."""
    mod, a = curve.base.modulus, curve.a_int
    gen = (curve.gen_x, curve.gen_y)
    ps, qs = [], []
    for i in range(n):
        k1, k2 = (int(k) for k in rng.integers(1, 1 << 62, size=2))
        P, Q = ec_mul(gen, k1, a, mod), ec_mul(gen, k2, a, mod)
        cls = i % 6
        if cls == 1:
            Q = P
        elif cls == 2:
            Q = ec_neg(P, mod)
        elif cls == 3:
            P = None
        elif cls == 4:
            Q = None
        elif cls == 5:
            P = Q = None
        ps.append(P)
        qs.append(Q)
    return ps, qs


def jacobian_coords(pt, lam: int, mod: int):
    """Canonical Jacobian (X, Y, Z) = (x lam^2, y lam^3, lam) of an affine
    int pair; infinity is (1, 1, 0), the JAX package's jac_zero."""
    if pt is None:
        return (1, 1, 0)
    l2 = lam * lam % mod
    return (pt[0] * l2 % mod, pt[1] * l2 * lam % mod, lam % mod)


def tiled_inputs(curve: SWCurveSpec, n: int, rng: np.random.Generator, base_n: int = 64):
    """A valid point batch that tiles ``base_n`` multiples k_j·G, with random
    scalars below 2^(16 Ls - 2). Returns (px, py, scalars, ks, bits): uint32
    limb arrays (L, n), (L, n), (Ls, n), the multipliers and the scalar
    bound. Same draws as bench.py:_tiled_inputs for the same generator."""
    gen = (curve.gen_x, curve.gen_y)
    ks = [int(k) for k in rng.integers(1, 1 << 30, size=base_n)]
    base_pts = [ec_mul(gen, k, curve.a_int, curve.base.modulus) for k in ks]
    A0 = affine_from_ints(curve, base_pts, device="cpu")
    reps = n // base_n
    px = np.tile(A0.x.numpy().astype(np.uint32), (1, reps))
    py = np.tile(A0.y.numpy().astype(np.uint32), (1, reps))
    Ls = curve.scalar.num_limbs
    sc = rng.integers(0, 1 << 16, size=(Ls, n), dtype=np.uint32)
    sc[-1] >>= 2
    return px, py, sc, ks, 16 * Ls - 2


def mixed_scalars(spec, n: int, rng: np.random.Generator) -> np.ndarray:
    """(Ls, n) uint32 limbs of scalars in six magnitude classes, lane i in
    class i % 6: 0; 1; 2..2^8 - 1; 2^8..2^16 - 1; 2^16..2^64 - 1; and full
    width (above 2^(16 (Ls - 1)), below r), the shares of a Groth16
    witness that ec/msm.py:msm_mixed splits them by."""
    Ls = spec.num_limbs
    sc = np.zeros((Ls, n), dtype=np.uint32)
    cls = np.arange(n) % 6
    sc[0, cls == 1] = 1
    m = cls == 2
    sc[0, m] = rng.integers(2, 1 << 8, int(m.sum()), dtype=np.uint32)
    m = cls == 3
    sc[0, m] = rng.integers(1 << 8, 1 << 16, int(m.sum()), dtype=np.uint32)
    m = cls == 4
    sc[:4, m] = rng.integers(0, 1 << 16, (4, int(m.sum())), dtype=np.uint32)
    sc[1, m] |= 1  # at least 17 bits
    m = cls == 5
    top = spec.modulus >> (16 * (Ls - 1))  # the top limb stays below r's: every scalar < r
    sc[:, m] = rng.integers(0, 1 << 16, (Ls, int(m.sum())), dtype=np.uint32)
    sc[Ls - 1, m] = rng.integers(1, top, int(m.sum()), dtype=np.uint32)
    return sc


def expected_msm(curve: SWCurveSpec, ks, sc: np.ndarray):
    """Host known answer for ``tiled_inputs``: with P_i = k_(i mod base_n)·G,
    Σ s_i·P_i = (Σ_j k_j·(Σ_(i ≡ j) s_i) mod r)·G, one host scalar-mul."""
    r = curve.scalar.modulus
    base_n = len(ks)
    Ls = sc.shape[0]
    total = 0
    for j in range(base_n):
        limb_sums = sc[:, j::base_n].astype(np.uint64).sum(axis=1)  # exact below 2^64
        agg = sum(int(limb_sums[l]) << (16 * l) for l in range(Ls)) % r
        total = (total + ks[j] * agg) % r
    return ec_mul((curve.gen_x, curve.gen_y), total, curve.a_int, curve.base.modulus)


def _rand_point(curve: SWCurveSpec, rng: np.random.Generator):
    k = int(rng.integers(1, 1 << 62))
    return ec_mul((curve.gen_x, curve.gen_y), k, curve.a_int, curve.base.modulus)


def accum_edge_rounds(curve: SWCurveSpec, S: int, R: int, rng: np.random.Generator):
    """Bucket slots and rounds for xyzz_accum whose mixed adds take every edge
    branch of _madd_core. Slot class s % 8: 0 generic; 1 round 0 adds P
    itself (doubling); 2 round 0 adds -P (cancel, by the sign bit); 3 the
    bucket at infinity; 4 round 0 skipped; 5 round 1 adds the round-0 sum
    (doubling with ZZ != 1); 6 round 1 adds its negation (cancel); 7 every
    round after round 0 skipped. Other rounds: random points, random signs,
    a quarter skipped. Returns (P0, rounds): S affine points (None =
    infinity) and R tuples (points, sign, skip) of per-slot lists, where a
    point is what the feed holds and sign negates its y."""
    if R < 2:
        raise ValueError("accum_edge_rounds needs R >= 2")
    mod, a = curve.base.modulus, curve.a_int
    pool = [_rand_point(curve, rng) for _ in range(64)]
    pick = lambda: pool[int(rng.integers(0, len(pool)))]  # noqa: E731
    cls = [s % 8 for s in range(S)]
    P0 = [None if c == 3 else pick() for c in cls]
    rounds = []
    for r in range(R):
        pts = [pick() for _ in range(S)]
        sign = [bool(rng.integers(0, 2)) for _ in range(S)]
        skip = [int(rng.integers(0, 4)) == 0 for _ in range(S)]
        rounds.append((pts, sign, skip))
    pts0, sign0, skip0 = rounds[0]
    pts1, sign1, skip1 = rounds[1]
    for s, c in enumerate(cls):
        if c in (1, 2):
            pts0[s], sign0[s], skip0[s] = P0[s], c == 2, False
        elif c == 4:
            skip0[s] = True
        elif c in (5, 6):
            sign0[s] = skip0[s] = False
            pts1[s] = ec_add(P0[s], pts0[s], a, mod)
            sign1[s], skip1[s] = c == 6, False
        elif c == 7:
            for _, _, skip in rounds[1:]:
                skip[s] = True
    return P0, rounds


def accum_feed(curve: SWCurveSpec, P0, rounds, device="cpu"):
    """(state int32[2L, S], coords int32[L, R, S], valid int32[R, S]) in
    kernels/sw.py's layout for accum_edge_rounds' slots and rounds."""
    P = xyzz_from_affine(curve, affine_from_ints(curve, P0, device=device))
    state = torch.cat([pack_pairs(v) for v in P]).contiguous()
    coords, valid = [], []
    for pts, sign, skip in rounds:
        A = affine_from_ints(curve, [p if p is not None else (0, 0) for p in pts], device=device)
        coords.append(pack_pairs(torch.cat([A.x, A.y])))
        v = [(not k) | (int(g) << 1) for g, k in zip(sign, skip)]
        valid.append(torch.tensor(v, dtype=torch.int32, device=device))
    return state, torch.stack(coords, dim=1).contiguous(), torch.stack(valid).contiguous()


def horner_edge_windows(curve: SWCurveSpec, W: int, c: int, rng: np.random.Generator,
                        device="cpu"):
    """Window points for the window Horner (total = sum_w 2^(c w) win_w,
    high to low) that take every edge branch of the chain: the top window at
    infinity (so the first add takes P = inf), window W-3 at infinity while
    the running sum is finite, window W-4 equal to the running sum in another
    Z (P == Q: the doubling branch), window W-5 its negation (the sum cancels
    to infinity), and finite windows below it. Every window is k_w G, so the
    total is one host scalar-mul. Returns (win int32[W, 4L] of 16-bit
    Montgomery limbs, X | Y | ZZ | ZZZ per window; the total as an affine int
    pair, or None)."""
    if W < 6:
        raise ValueError("horner_edge_windows needs W >= 6")
    r, mod, a = curve.scalar.modulus, curve.base.modulus, curve.a_int
    ks = [int(x) for x in rng.integers(1, 1 << 62, size=W)]
    ks[W - 1] = ks[W - 3] = 0

    def running(w):  # the sum when window w is added: sum_{v > w} k_v 2^(c (v - w))
        return sum(ks[v] << (c * (v - w)) for v in range(w + 1, W)) % r

    ks[W - 4] = running(W - 4)
    ks[W - 5] = -running(W - 5) % r
    gen = (curve.gen_x, curve.gen_y)
    coords = []
    for k in ks:
        pt = ec_mul(gen, k, a, mod) if k else None
        if pt is None:
            coords.append((1, 1, 0, 0))
            continue
        lam = int.from_bytes(rng.bytes(48), "little") % (mod - 1) + 1
        l2 = lam * lam % mod
        coords.append((pt[0] * l2 % mod, pt[1] * l2 * lam % mod, l2, l2 * lam % mod))
    win = torch.cat([fp.from_ints(curve.base, [cd[i] for cd in coords], device=device)
                     for i in range(4)])
    total = sum(k << (c * w) for w, k in enumerate(ks)) % r
    return win.T.contiguous(), ec_mul(gen, total, a, mod)


# ---------------------------------------------------------------------------
# the field inverse's and division's loop (csrc/mont.cu:gcd_div_pair), word
# by word
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def _words(x: int, nw: int) -> list:
    return [(x >> (32 * j)) & _M32 for j in range(nw)]


def _value(ws) -> int:
    return sum(w << (32 * j) for j, w in enumerate(ws))


def _sub_words(a, b):
    """a - b over 32-bit words with the borrow chain: (words, borrow)."""
    out, borrow = [], 0
    for x, y in zip(a, b):
        s = x - y - borrow
        out.append(s & _M32)
        borrow = int(s < 0)
    return out, borrow


def _gcd_approx(a, b):
    """csrc/mont.cu:gcd_approx: the 62-bit stand-ins of a and b, their bits
    [0, 30) and the 32 bits below n = max(bits(a), bits(b), 62)."""
    nw = len(a)
    o = [x | y for x, y in zip(a, b)]
    nz = sum(1 << j for j, w in enumerate(o) if w)
    h = nz.bit_length() - 1
    n = max(32 * h + (o[h].bit_length() if h >= 0 else 0), 2 * km.GCD_STEPS + 2)
    qw, qs = (n - 32) >> 5, (n - 32) & 31
    low = (1 << km.GCD_STEPS) - 1

    def stand_in(x):
        lo, hi = x[qw], x[qw + 1] if qw + 1 < nw else 0
        top = ((lo | (hi << 32)) >> qs) & _M32
        return (x[0] & low) | (top << km.GCD_STEPS)

    return stand_in(a), stand_in(b)


def _gcd_steps(at: int, bt: int):
    """csrc/mont.cu:gcd_steps: GCD_STEPS steps on the stand-ins with 64-bit
    words; returns the factors (f0, g0, f1, g1) and at after each step."""
    f0, g0, f1, g1 = 1, 0, 0, 1
    trail = []
    for _ in range(km.GCD_STEPS):
        odd, lt = at & 1, at < bt
        sw = odd and lt
        d = ((bt - at if lt else at - bt) & _M64) if odd else at
        f0, g0, f1, g1 = ((f1 - f0, g1 - g0, f0, g0) if sw else
                          (f0 - f1, g0 - g1, f1, g1) if odd else (f0, g0, f1, g1))
        bt = at if sw else bt
        at = d >> 1
        f1, g1 = 2 * f1, 2 * g1
        trail.append(at)
    return (f0, g0, f1, g1), trail


def _gcd_combine(x0, x1, n0, n1, f, g, coef, p, inv32):
    """csrc/mont.cu:gcd_combine with its words and carries: (f x0 + g x1) /
    2^30, exact and made nonnegative on the integer lane (coef False), mod
    p on the coefficient lane (n0, n1: x0, x1 stand for their negations).
    Returns (words, negative)."""
    nw = len(x0)
    sf, sg = (f < 0) != n0, (g < 0) != n1
    af, ag = abs(f), abs(g)
    K = 0 if coef else (af if sf else 0) + (ag if sg else 0)
    M = p if coef else [_M32] * nw
    y0 = _sub_words(M, x0)[0] if sf else x0
    y1 = _sub_words(M, x1)[0] if sg else x1
    u, c, c2, m = [], K, 0, 0
    for j in range(nw):
        s = af * y0[j] + ag * y1[j] + c
        c, t = s >> 32, s & _M32
        if j == 0:
            m = (t * inv32) & ((1 << km.GCD_STEPS) - 1) if coef else 0
        s2 = m * p[j] + t + c2
        u.append(s2 & _M32)
        c2 = s2 >> 32
    u.append((c + c2 - K) & _M32)
    v = [((u[j] | (u[j + 1] << 32)) >> km.GCD_STEPS) & _M32 for j in range(nw)]
    top = u[nw] - (1 << 32) if (u[nw] >> 31 and not coef) else u[nw]
    vtop = (top >> km.GCD_STEPS) & _M32
    neg = not coef and vtop != 0
    d, below_p = _sub_words(v + [vtop], p + [0])
    if neg:
        return _sub_words([0] * nw, v)[0], True
    return (d[:nw] if coef and not below_p else v), False


def gcd_div_model(spec, y: int, u0: int):
    """csrc/mont.cu:gcd_div_pair on a Montgomery word y < p with starting
    coefficient u0 < p, in its order of work and with its carries: returns
    (u0 / y mod p, 0 for y = 0; the steps until a = 0). The kernel runs
    GCD_STEPS x kernels.mont.gcd_batches(spec) steps; the steps to a = 0 are
    fewer than mont_inv_iteration_bound(spec, y), and they are counted
    exactly where the stand-ins are (a and b below 2^62)."""
    nw = spec.num_limbs // 2
    p = _words(spec.modulus, nw)
    a, b, u, v = _words(y, nw), p, _words(u0, nw), [0] * nw
    nu = nv = False
    steps = 0 if y == 0 else None
    for i in range(km.gcd_batches(spec)):
        at, bt = _gcd_approx(a, b)
        (f0, g0, f1, g1), trail = _gcd_steps(at, bt)
        if steps is None and max(_value(a), _value(b)) < 1 << (2 * km.GCD_STEPS + 2):
            steps = next((i * km.GCD_STEPS + j + 1 for j, t in enumerate(trail) if t == 0), None)
        (a, sa), (b, sb) = (_gcd_combine(a, b, False, False, f, g, False, p, spec.inv32)
                            for f, g in ((f0, g0), (f1, g1)))
        u, v = (_gcd_combine(u, v, nu, nv, f, g, True, p, spec.inv32)[0]
                for f, g in ((f0, g0), (f1, g1)))
        nu, nv = sa, sb
    assert _value(a) == 0 and _value(b) == (1 if y else spec.modulus), "the GCD did not end"
    q = _value(v)
    return (spec.modulus - q if nv and q else q), steps


def mont_inv_model(spec, x: int):
    """csrc/mont.cu:mont_inv_kernel on one Montgomery word x < p: the GCD
    from u0 = R^2 mod p. Returns (x^-1's Montgomery word, the steps until
    a = 0), the steps below mont_inv_iteration_bound(spec, x)."""
    return gcd_div_model(spec, x, spec.r2_int)


def mont_div_model(spec, num: int, den: int):
    """csrc/mont.cu:mont_div_kernel's quotient of Montgomery words num / den
    (0 for den = 0): the GCD on den from u0 = num R mod p (fmul(num, R^2)).
    Returns (the quotient's Montgomery word, the steps until a = 0)."""
    return gcd_div_model(spec, den, num * spec.r_int % spec.modulus)


def mont_inv_iteration_bound(spec, x: int) -> int:
    """The GCD's steps on x until a = 0 are fewer than this: bits(a) +
    bits(b) starts at bits(x) + bits(p) and falls by at least 1 a step, on
    the stand-ins too (Pornin, ePrint 2020/972). At most 2 bits(p) <=
    GCD_STEPS x gcd_batches(spec) + 1."""
    return x.bit_length() + spec.modulus.bit_length()


def mont_inv_chain(spec) -> int:
    """Dependent instructions on the critical path of mont_inv_kernel's
    loop (csrc/mont.cu:gcd_div_pair), per batch: the stand-ins (the
    nonzero-word mask and its OR tree, a count of leading zeros, the top
    word picked by an OR tree, its bit length, the window's words picked,
    a funnel shift and the join: 11 + 3 ceil(log2 NW)), one shuffle, 5 a
    step (a 64-bit subtract, two selects, a shift) and the update (a 64-bit
    carry add a column, 2 NW, then the Montgomery factor, the top word, its
    shift, the reduction's borrow and the select: 7); then the last
    negation, 2 NW + 1. mont_div adds one product before the loop."""
    nw = spec.num_limbs // 2
    log_nw = (nw - 1).bit_length()
    per_batch = 11 + 3 * log_nw + 1 + 5 * km.GCD_STEPS + 2 * nw + 7
    return km.gcd_batches(spec) * per_batch + 2 * nw + 1


def mont_inv_ops(spec) -> int:
    """32-bit operations of one inversion, counted once (the second lane's
    copy of the stand-ins and steps is not counted): per batch the
    stand-ins, ~5 NW; 16 a step (two 64-bit subtracts, a compare, four
    selects, a 64-bit shift, two factor updates); four updates of ~7 NW (the
    negated terms, three multiply-adds a word, the shift, the reduction)."""
    nw = spec.num_limbs // 2
    return km.gcd_batches(spec) * (5 * nw + 16 * km.GCD_STEPS + 4 * 7 * nw)


def mont_inv_edge_words(spec, rng: np.random.Generator, n_random: int = 8) -> list:
    """Montgomery words for the field inverse's edge cases: 0, 1, R mod p
    (the element 1), p - 1, the words 2^k (a long first run of halvings),
    the elements 2^k (2^k R mod p) for k up to 380, then ``n_random``
    random words below p."""
    p, bits = spec.modulus, spec.modulus.bit_length()
    out = [0, 1, spec.r_int % p, p - 1]
    out += [1 << k for k in (1, 31, 32, 33, 64, 200, bits - 2) if k < bits - 1]
    out += [spec.to_mont_int(pow(2, k, p)) for k in (1, 63, 64, 255, 380)]
    width = max(48, 2 * spec.num_limbs)  # bytes: random words span the whole field
    out += [int.from_bytes(rng.bytes(width), "little") % p for _ in range(n_random)]
    return out


def bit_horner_edge_parts(curve: SWCurveSpec, nbits: int, W: int, rng: np.random.Generator,
                          device="cpu"):
    """Per-bit partials (X, Y, ZZ, ZZZ), each int32[L, nbits, W] of random
    field elements (the formulas need no curve membership to be compared),
    for the reduce's bit-Horner (acc = parts[nbits - 1]; acc = 2 acc +
    parts[k], k = nbits - 2 .. 0) that take every edge branch. Window w's
    partial of bit k is of class (w - k) % 6: 0 and 5 generic; 1 at
    infinity; 2 equal to 2 acc in another representative (the add doubles);
    3 its negation (the sum cancels to infinity); 4 with y = 0. Down one
    window the classes follow in that order, so a sum that cancelled (3) is
    infinity when a y = 0 partial (4) is added to it, and the next doubling
    (5) doubles a y = 0 point. The top partial takes classes 1 and 4 too."""
    from zkarray_torch.kernels import sw as ksw

    f = curve.base
    p = f.modulus
    one, zero = fp.one(f, (W,), device), fp.zero(f, (W,), device)

    def rand():
        return fp.from_ints(f, [int.from_bytes(rng.bytes(48), "little") % p for _ in range(W)],
                            device=device)

    def cls(k):
        return torch.tensor([(w - k) % 6 for w in range(W)], device=device)[None]

    def classes(k, part, dbl=None):
        c = cls(k)
        part = tuple(torch.where(c == 1, i, v) for i, v in zip((one, one, zero, zero), part))
        if dbl is not None:
            lam = rand()
            l2 = fp.mont_mul(f, lam, lam)
            l3 = fp.mont_mul(f, l2, lam)
            same = tuple(fp.mont_mul(f, v, s) for v, s in zip(dbl, (l2, l3, l2, l3)))
            neg = (same[0], fp.neg(f, same[1]), same[2], same[3])
            part = tuple(torch.where(c == 2, s, torch.where(c == 3, g, v))
                         for s, g, v in zip(same, neg, part))
        return (part[0], torch.where(c == 4, zero, part[1]), part[2], part[3])

    parts = [None] * nbits
    parts[nbits - 1] = acc = classes(nbits - 1, tuple(rand() for _ in range(4)))
    for k in range(nbits - 2, -1, -1):
        acc2 = ksw._dbl_plain(curve, acc)
        parts[k] = classes(k, tuple(rand() for _ in range(4)), acc2)
        acc = ksw._fadd_plain(curve, acc2, parts[k])
    return tuple(torch.stack([pt[i] for pt in parts], dim=1).contiguous() for i in range(4))


# ---------------------------------------------------------------------------
# the pairing path: host G2 arithmetic, GT known answers, tiled inputs
# ---------------------------------------------------------------------------

# E = e(G1 generator, G2 generator) as 12 canonical ints in coefficient
# order (the JAX package's Fp12 layout flattened), computed once from
# zkarray.ec.pairing.bls12.pairing_each. tests/test_torch_pairing.py holds
# them against the JAX package's words for it, which
# scripts/pairing_bundle_words.py writes to tests/vectors (BLS12-381's in
# the pairing bundle, BLS12-377's in bls12_377_pairing_e.npz), and against
# the port.
E_BLS12_381 = (
    2819105605953691245277803056322684086884703000473961065716485506033588504203831029066448642358042597501014294104502,
    1323968232986996742571315206151405965104242542339680722164220900812303524334628370163366153839984196298685227734799,
    2987335049721312504428602988447616328830341722376962214011674875969052835043875658579425548512925634040144704192135,
    3879723582452552452538684314479081967502111497413076598816163759028842927668327542875108457755966417881797966271311,
    261508182517997003171385743374653339186059518494239543139839025878870012614975302676296704930880982238308326681253,
    231488992246460459663813598342448669854473942105054381511346786719005883340876032043606739070883099647773793170614,
    3993582095516422658773669068931361134188738159766715576187490305611759126554796569868053818105850661142222948198557,
    1074773511698422344502264006159859710502164045911412750831641680783012525555872467108249271286757399121183508900634,
    2727588299083545686739024317998512740561167011046940249988557419323068809019137624943703910267790601287073339193943,
    493643299814437640914745677854369670041080344349607504656543355799077485536288866009245028091988146107059514546594,
    734401332196641441839439105942623141234148957972407782257355060229193854324927417865401895596108124443575283868655,
    2348330098288556420918672502923664952620152483128593484301759394583320358354186482723629999370241674973832318248497,
)
E_BLS12_377 = (
    110083230830723987109655696820214910916273706674572586634856969551308702305356658303775506237961573154771378344140,
    244788780104742846436871668319121047075257290166108409917241404606936524542608766332803537171539190182256533917063,
    70591179866591025581008162845739604858876788014997542519276300506514073583341324769099527146730334236662895865046,
    33215506749015620019257676299396072211755543898124622075825860836511008942214474501211834441808696780044441245539,
    141996005453347263090173180206723577395804269667710911417921159823287638494815269986942278355476391040915850450151,
    49108445638151337603000681250658658472023497933997577640647495353498252268968290335483603123267725037131403671515,
    90176803298438364423747154903552831429250422756541192446894181932259050413142675599091235793803716757083372706375,
    19151991642090052547303373703409991425197256637457462081216740605518326884012063439339008275308332070736636254862,
    107814639769391127316528217157090438027031338224027008312403448100972183752115829716940620193448040349262503431554,
    38714735791791130983722173336432250534993930888432824523201238967962785087648814681113534394878856902006900821087,
    61665802096505683799087817396448925253103935552660966716062941445711365774494544506267962952144550065239368469812,
    5382601735945323996025725556060270047499954807549021966963123697509349722278727211567122542201726580665357585411,
)

# BN254's, BW6-761's and BW6-767's (an Fp6 element: 6 ints), taken from the
# JAX package's words that scripts/pairing_bundle_words.py stores (lane 0 of
# pairing_each on tests/pairing_bundle.py's BN254 pairs; the "e" entry of
# tests/vectors/bw6_761_pairing.npz and bw6_767_pairing.npz), never computed
# by the port; tests/test_torch_pairing_bn.py and test_torch_bw6.py hold the
# port against those words.
E_BN254 = (
    17264119758069723980713015158403419364912226240334615592005620718956030922389,
    1300711225518851207585954685848229181392358478699795190245709208408267917898,
    8894217292938489450175280157304813535227569267786222825147475294561798790624,
    1829859855596098509359522796979920150769875799037311140071969971193843357227,
    4968700049505451466697923764727215585075098085662966862137174841375779106779,
    12814315002058128940449527172080950701976819591738376253772993495204862218736,
    4233474252585134102088637248223601499779641130562251948384759786370563844606,
    9420544134055737381096389798327244442442230840902787283326002357297404128074,
    13457906610892676317612909831857663099224588803620954529514857102808143524905,
    5122435115068592725432309312491733755581898052459744089947319066829791570839,
    8891987925005301465158626530377582234132838601606565363865129986128301774627,
    440796048150724096437130979851431985500142692666486515369083499585648077975,
)
E_BW6_761 = (
    5159030990850041326117965283088584843079003629760788798373329258277172298594960580420554787189781555745658885144937149083050673090380129795824365833570250784729398533452179885877923708666584171616014532677249059780359732135058095,
    2606527826331497047737724406878311180060772366722826297497504344083394604836691419948678311648105967663068616785162535806889748069587814184814320662846672196546690593626281026352092616181204305737828073907393425883962017179024386,
    6610536341239083925055641666656286180676627476924931555060566462232499546295810668611283585169762093387089357689978643879321996388929447650132043507740421477190911354713882949142277921610651470895789765533316715693286933683753310,
    3151602220490305412802092837102648886737792036056486941082674120404189645082467000074839617696193321479548444947759097874316512074697945373382643577563325770844054928871605906705132349873975165206584813173695102001728978517402597,
    2118045193263508177398190527869259717746859395779946641694761170918615260855078154011971952105142585645394058452732287089594835495419096215466005902321812686974992119350659877408213814468219237559290191006706122033070359712912792,
    2333071434125211947034580639796531768144522440243688707306692516411436145978443575587646423335971183089082093679891445147238133357030155197807033014700653472587913986586385046045433277641110470706654469412198904018701566023282618,
)
E_BW6_767 = (
    430486052764118261049269038588834886439498297278447932706145537149745291851213372100495862670704841380610054213026647003524426906200439090825131137558983414750151711836881876355648913165633103032825438493638540166337087481131922713,
    107330758438540445503939251321219568719868870126662410136316598493184510685113402785951939819292120348164786631408564084806204942436291907066335109869180009581641233866814742478541977636509799928893484866837466802599420051151080949,
    374643769216272977244090810032242502349076837351597782199495148084893322265524881699288770882344311613268200811552397428749194988518960013044893569079094913588946029366651421146962459414027598341309442154324972843148349267703910446,
    390682634981901788431615518712557391458674019206699976718739850038713927326941736460670024447484433782082133920493672790087246737965799194109252350043493512652860075887580473807648144360182081170931474731867113213287700092413654641,
    282898801575060770551939138590850478619533182108104295816534646252130602300562377611328736530676778176279288776605574659952928182288457195646028926497457920266497302301703261801367988261416006722617735939931059134429779495329678696,
    145859091666275098653110870522849500219236027981525213420173006309308761443014702325470858844314894335816220022102038265888183182496674440659723401714986375303332285091016503704255805710853822493638095832267390241746426431964995362,
)


# E = e(G1 generator, G2 generator) of MNT4/6-298, MNT4/6-753 (Fq4 / Fq6
# elements: 4 or 6 ints) and CP6-782 (6 ints), taken from the JAX package's
# words that scripts/pairing_bundle_words.py stores (the "e" entry of
# tests/vectors/<curve>_pairing.npz: lane 0 of zkarray.ec.pairing.mnt's or
# .cp6's pairing_each), never computed by the port; tests/test_torch_mnt.py
# and test_torch_cp6.py hold the port against those words.
E_MNT4_298 = (
    432276070167612018525235193084883266084955198762821276611920840843540618094873840446910721,
    101971248517505649173861113942507407870665723725535513527060717654342033150677524001859460,
    295975819140217750701682584987114118955482045628591167970954768365089839196108458538434697,
    387954805480691604875757929762459378009668619107531506056527770792705449652409423336453304,
)
E_MNT6_298 = (
    164491855725158968338495940419097610118705575147238536983484494646000331752452688209570819,
    220086337917742206042722124842323034885640268541919387176659467377361813502783162183773075,
    399671968475311688490138792975767277759339887728978817488708888701369214565341485269277757,
    404833737127542908621860116396086695089483750507098058466979656777527010710794389093696256,
    94994545970144067545117807756424313797023398948279447132803719103900467883169113283666836,
    323393384891955097162027396186621363902393394100316081019725850526951182105132441971039900,
)
E_MNT4_753 = (
    23496587768664530772349392816766338806620754693535260377958672181846956016747302855057683314407236551949280868133945253109140743811831561869168672232565864767038445077563312251158375059616864573220181710278867777029353491434932,
    5662623359507566047373243634299265066768181406315609631786702529254630191511158313689101527576730214868876683060836849370276607544900382543608849255129225591979034823194207798434451805992157420359533985553927895703084623202637,
    32785377843773217122531412317065925594306995035076982182552990628003765983376425820971325746772918982130656443591087045400461757472231252879170670948780912763789559414889407992062121355976892825655036367094785597483517964154958,
    15724666226410637929079983361951570558808397133245812196156753166433358624482531603915820828600076257148411223396184549625990135269333797985089558010856625002218146824168898011205102676414950927940260959828373736601904528410940,
)
E_MNT6_753 = (
    40446824810043828770633412855777433543803228501017571185357108855067148908997363167306397536812929754461394900598830223835119846623465706705577889782385831660090356419521137342636462453182691365316118667415277970148416597926722,
    23094527657316851575762365703955579765638081500560826895392930775952639876571122969893234188986156024381537677557092219710549535120580852074030086135636347416301814993806388926476329317588883304619415202306175357005442787986849,
    19399050773684296280390729213174723298730292342599193309324457181921855509670834016675954239946624517828056984352257191231543562282388688576585304510958742408951971952116670825353571197130670435048843260720161843457403600295007,
    29716648686593234275822093533812131319312803530582982286347990220151810733804574479625104958115818844692742099960571957560388327662894874349344840267782193163411883186612199811966149310289318622293090919035595885603545023628269,
    16065139289833688421225418617087952398248853376886050815518277369974032017076807163282134930441096406413107692133746396773143566881662665537405176284889098914253177661685274229109031435183244508839970147358545455982734511108392,
    20339950550648473500734135467713503653387878922934517395177925153098995376316764418244450946745737233201625127245237567488306638464247613451258411200168658165279751321546060453300094410776681931006125742679579396977412648364721,
)
E_CP6_782 = (
    21513276534743943104596713219355341358586713169859452486127897976599692735060616914556926178706235507317114713031047417109370830075346515923127188102759328733824890991490185326609454475610828618953340885995411028181432145405960888527071,
    3331045930537674940609774936387680192316337121936809450114623293876120286877388404447522199633789741945191865317116369422187070663596622775894893002601805076413995680304431019833374251106695693944386480657543171546768467566748674192911,
    11447758708454340853313015968641938667166651209217552267064442654250258407084793146756921421255595255556019892491543143366685295176148323137283855161937599871310027107080200095589785395929182290749367795317736865548332342310137473351749,
    18305928254593090350663007269621686111157160904682660775442009363678857433703535737285194697123029267744208069423075727037464825973232817539531779064628249581537180351629100080334131870318979946350459432200927722187777135789172908399986,
    13510455650459054066626257897326294736324739865748725149120746804895181966826925043874560288157091482204127755322255295201024511891724356951129961637286053651716706929447854879952641313768535054413995315128456599734218739177820601741005,
    1528013370049677800502710434937465820797994475938748217555709054687026461470730447934146372982198870493604138298507557692798681057320569912053772326445890407748418760317541865916830267009409988714017415552882338015098719034089622248902,
)


def ext_ec_add(Fh, P, Q, a=None):
    """Affine addition on y^2 = x^3 + a x + b over a host tower field ``Fh``
    (G2 over Fp2, Fq3, ...; points (x, y) of host elements, or None); a
    defaults to 0. Inverses by ``HostExt.inv`` (one base-field inverse)."""
    if P is None:
        return Q
    if Q is None:
        return P
    (x1, y1), (x2, y2) = P, Q
    if Fh.eq(x1, x2):
        if Fh.eq(Fh.add(y1, y2), Fh.zero()):
            return None
        num = Fh.mul(Fh.embed(3), Fh.mul(x1, x1))
        if a is not None:
            num = Fh.add(num, a)
        lam = Fh.mul(num, Fh.inv(Fh.add(y1, y1)))
    else:
        lam = Fh.mul(Fh.sub(y2, y1), Fh.inv(Fh.sub(x2, x1)))
    x3 = Fh.sub(Fh.sub(Fh.mul(lam, lam), x1), x2)
    return (x3, Fh.sub(Fh.mul(lam, Fh.sub(x1, x3)), y1))


def ext_ec_mul(Fh, P, k: int, a=None):
    """k P (double-and-add, high bit first; k < 0 negates) with ext_ec_add."""
    if k < 0:
        P, k = (None if P is None else (P[0], Fh.neg(P[1]))), -k
    acc = None
    for bit in bin(k)[2:] if k else "":
        acc = ext_ec_add(Fh, acc, acc, a)
        if bit == "1":
            acc = ext_ec_add(Fh, acc, P, a)
    return acc


def host_fq2_sqrt(F2h, a):
    """A square root of a in a host Fp2 over a prime field (the norm trick,
    with sqrt_mod), or None."""
    p, beta = F2h.p, F2h.nonresidue
    if a[1] % p == 0:
        r = sqrt_mod(a[0], p)
        if r is not None:
            return (r, 0)
        r = sqrt_mod(a[0] * pow(beta, -1, p), p)
        return None if r is None else (0, r)
    d = sqrt_mod(a[0] * a[0] - beta * a[1] * a[1], p)
    if d is None:
        return None
    half = pow(2, -1, p)
    x0 = sqrt_mod((a[0] + d) * half, p)
    if x0 is None:
        x0 = sqrt_mod((a[0] - d) * half, p)
    if not x0:
        return None
    x = (x0, a[1] * pow(2 * x0, -1, p) % p)
    return x if F2h.mul(x, x) == (a[0] % p, a[1] % p) else None


def g2_affine_from_ints(curve, pts, device="cpu"):
    """Host G2 points ((x, y) of host elements of the twist field, e.g.
    ((x0, x1), (y0, y1)) over Fp2, or None) -> ExtAffine (deg, L, n)
    coordinates; infinity as zeros."""
    F = curve.ops
    zero = F.host.zero()
    xy = [(zero, zero) if q is None else q for q in pts]
    x = F.from_ints([[q[0][j] for q in xy] for j in range(F.deg)], device)
    y = F.from_ints([[q[1][j] for q in xy] for j in range(F.deg)], device)
    return ExtAffine(x, y, torch.tensor([q is None for q in pts], dtype=torch.bool, device=device))


def g2_affine_to_ints(curve, A) -> list:
    """ExtAffine over a twist field of a prime field -> host points (None at
    infinity)."""
    F = curve.ops
    x, y = F.to_ints(A.x), F.to_ints(A.y)
    inf = A.inf.reshape(-1).tolist()
    return [None if inf[i] else (tuple(c[i] for c in x), tuple(c[i] for c in y))
            for i in range(len(inf))]


def g2_off_subgroup_points(curve, n: int, rng: np.random.Generator) -> list:
    """n points of the twist outside the prime-order subgroup: x drawn until
    x^3 + b has a root, never multiplied by the cofactor (the host checks
    r P != infinity)."""
    F2h = curve.ops.host
    p, r = F2h.p, curve.scalar.modulus
    out = []
    while len(out) < n:
        x = tuple(int.from_bytes(rng.bytes(64), "little") % p for _ in range(2))
        y = host_fq2_sqrt(F2h, F2h.add(F2h.mul(F2h.mul(x, x), x), curve.b_host))
        if y is not None and ext_ec_mul(F2h, (x, y), r) is not None:
            out.append((x, y))
    return out


def fp12_from_flat(F12h, flat):
    """12 canonical ints in coefficient order -> a host Fp12 element (any
    host tower: 6 ints for a BW6 Fp6 element)."""
    def nest(host, xs):
        if not hasattr(host, "deg"):
            return xs[0]
        k = len(xs) // host.deg
        return tuple(nest(host.base, xs[j * k:(j + 1) * k]) for j in range(host.deg))
    return nest(F12h, list(flat))


def fp12_to_flat(F12, a) -> list:
    """An Fp12 tensor (2, 3, 2, L, *batch) -> per element a tuple of 12
    canonical ints in coefficient order (any tower: an Fp6 one gives 6)."""
    return list(zip(*_flat_cols(F12, a)))


def _flat_cols(ops, a):
    if not hasattr(ops, "deg"):
        return [ops.to_ints(a)]
    out = []
    for j in range(ops.deg):
        out.extend(_flat_cols(ops.base, a[j]))
    return out


def gt_powers(F12h, e_flat, ks) -> list:
    """[E^k for k in ks] on the host (any target tower), the squarings
    E^(2^i) shared; for eight or more exponents a shared table of E^(d
    16^i) for each 4-bit digit d of k instead, one product a nonzero digit
    (about half the host products of the binary route a power)."""
    if len(ks) >= 8:
        x = fp12_from_flat(F12h, e_flat)
        table = []  # table[i][d] = E^(d 16^i)
        for _ in range(0, max(k.bit_length() for k in ks), 4):
            row = [None, x]
            for _ in range(14):
                row.append(F12h.mul(row[-1], x))
            table.append(row)
            x = F12h.mul(row[-1], x)
        out = []
        for k in ks:
            acc = None
            for i, row in enumerate(table):
                d = (k >> (4 * i)) & 15
                if d:
                    acc = row[d] if acc is None else F12h.mul(acc, row[d])
            out.append(tuple(F12h.flatten(F12h.one() if acc is None else acc)))
        return out
    sq = [fp12_from_flat(F12h, e_flat)]
    for _ in range(max(k.bit_length() for k in ks)):
        sq.append(F12h.mul(sq[-1], sq[-1]))
    out = []
    for k in ks:
        acc = F12h.one()
        for i in range(k.bit_length()):
            if (k >> i) & 1:
                acc = F12h.mul(acc, sq[i])
        out.append(tuple(F12h.flatten(acc)))
    return out


def fp12_tensor(F12, rows, device="cpu"):
    """Rows of 12 canonical ints (coefficient order) -> an Fp12 tensor
    (2, 3, 2, L, len(rows)); any tower (rows of 6 for a BW6 Fp6)."""
    def nest(ops, cols):
        if not hasattr(ops, "deg"):
            return list(cols[0])
        k = len(cols) // ops.deg
        return [nest(ops.base, cols[j * k:(j + 1) * k]) for j in range(ops.deg)]
    return F12.from_ints(nest(F12, list(zip(*rows))), device)


def pairing_inputs(bspec, n: int, rng: np.random.Generator, base_n: int = 64, inf_every: int = 1024,
                   device="cpu", scalar_bits=None):
    """Seeded pairs (a_j G1, b_j G2), j < base_n (G2 over an extension with
    its coefficient a, or over the prime field for BW6), tiled to n lanes
    (lane i holds pair i % base_n), with lane i's G1 point at infinity where
    i % inf_every == inf_every - 1 (every inf_every-th lane). a_j and b_j
    are full-size below r, or below 2^scalar_bits: the host's G2 ladder
    inverts in the tower at every step and the known answers E^(a_j b_j)
    take a host product per bit, so on MNT4/6 and CP6 full-size scalars
    would cost seconds a pair at 753 bits; the points are as random either
    way. Returns (P, Q, ab, inf): port points on ``device``, the products
    a_j b_j mod r and the lanes' infinity mask (numpy)."""
    g1, g2 = bspec.g1, bspec.g2
    r = g1.scalar.modulus

    def draw():
        if scalar_bits is None:
            return int.from_bytes(rng.bytes(40), "little") % (r - 1) + 1
        return int.from_bytes(rng.bytes((scalar_bits + 7) // 8), "little") % ((1 << scalar_bits) - 1) + 1

    ks = [(draw(), draw()) for _ in range(base_n)]
    p1 = [ec_mul((g1.gen_x, g1.gen_y), a, g1.a_int, g1.base.modulus) for a, _ in ks]
    A1 = affine_from_ints(g1, p1, device)
    t = torch.arange(n, device=device) % base_n
    inf = np.arange(n) % inf_every == inf_every - 1
    P = AffinePoints(A1.x[:, t], A1.y[:, t], torch.from_numpy(inf).to(device))
    no_inf = torch.zeros(n, dtype=torch.bool, device=device)
    if isinstance(g2, SWCurveSpec):  # BW6: G2 over the prime field
        p2 = [ec_mul((g2.gen_x, g2.gen_y), b, g2.a_int, g2.base.modulus) for _, b in ks]
        A2 = affine_from_ints(g2, p2, device)
        Q = AffinePoints(A2.x[:, t], A2.y[:, t], no_inf)
    else:
        a = None if g2.a_is_zero else g2.a_host
        p2 = [ext_ec_mul(g2.ops.host, (g2.gen_x, g2.gen_y), b, a) for _, b in ks]
        A2 = g2_affine_from_ints(g2, p2, device)
        Q = ExtAffine(A2.x[..., t], A2.y[..., t], no_inf)
    return P, Q, [a * b % r for a, b in ks], inf


def fadd_edge_words(spec, rng: np.random.Generator, n_random: int = 6) -> list:
    """Ints below R = 2^(16 L) (16-bit limbs, not all below p) for the field
    additions' edge cases: 0, 1, p - 1 and its neighbours, values >= p up to
    R - 1, R - p, and 2^(32 k) - 1 and 2^(32 k) at every 32-bit word boundary
    k (a carry or borrow across it), then random words below p and below R."""
    p, R = spec.modulus, 1 << (16 * spec.num_limbs)
    words = [0, 1, 2, p - 2, p - 1, p, p + 1, R - 1, R - p, R - p - 1, (p - 1) // 2, p // 2 + 1]
    if 2 * p < R:
        words += [2 * p - 1, 2 * p]
    for k in range(1, spec.num_limbs // 2):
        words += [(1 << (32 * k)) - 1, 1 << (32 * k)]
    width = max(64, 2 * spec.num_limbs)  # bytes: random words span the whole field
    words += [int.from_bytes(rng.bytes(width), "little") % p for _ in range(n_random)]
    words += [int.from_bytes(rng.bytes(width), "little") % R for _ in range(n_random)]
    return sorted(set(w for w in words if 0 <= w < R))


def gt_inputs(F, e_flat, scalar, n: int, rng: np.random.Generator, base_n: int = 64,
              device="cpu"):
    """GT inputs tiled from base_n seeded pairs (k_j, s_j): lane i holds the
    element E^(k_j) and the scalar s_j, j = i % base_n, with s_j below the
    ``scalar`` field's r (255-bit for BLS12-381's). Returns (elements, scalar limbs (Ls, n),
    ks, ss): the elements as a tower tensor of n lanes on ``device`` (from
    host powers of E), the scalars as canonical 16-bit limbs."""
    from zkarray_torch.core.limbs import ints_to_limbs_np

    r = scalar.modulus
    nbytes = (r.bit_length() + 7) // 8
    ks = [int.from_bytes(rng.bytes(nbytes), "little") % r for _ in range(base_n)]
    ss = [int.from_bytes(rng.bytes(nbytes), "little") % r for _ in range(base_n)]
    table = fp12_tensor(F, gt_powers(F.host, e_flat, ks), device)
    t = torch.arange(n, device=device) % base_n
    sc = torch.from_numpy(ints_to_limbs_np(ss, scalar.num_limbs).astype(np.int32)).to(device)
    return table[..., t], sc[:, t], ks, ss


def lin_edge_words(spec, rng: np.random.Generator, n_random: int = 6) -> list:
    """Ints below p (fp_lin's inputs) for its edge cases: 0, 1, 2, p - 1,
    p - 2, (p - 1)/2, (p + 1)/2, 2^(32 k) - 1 and 2^(32 k) below p at every
    32-bit word boundary, then random words below p."""
    p = spec.modulus
    words = [0, 1, 2, p - 2, p - 1, (p - 1) // 2, (p + 1) // 2]
    for k in range(1, spec.num_limbs // 2):
        words += [(1 << (32 * k)) - 1, 1 << (32 * k)]
    width = max(64, 2 * spec.num_limbs)
    words += [int.from_bytes(rng.bytes(width), "little") % p for _ in range(n_random)]
    return sorted(set(w for w in words if 0 <= w < p))


def lanes_crossover(m: int, max_terms: int) -> int:
    """The last width n at which kernels/lin.py:lanes gives a launch of m
    rows, the longest of ``max_terms`` terms, two lanes or more (the narrow
    body); n + 1 takes one thread a row."""
    from zkarray_torch.kernels.lin import lanes

    lo = 1
    while lanes(2 * lo, m, max_terms) > 1:
        lo *= 2
    hi = 2 * lo  # lanes(lo) > 1 >= lanes(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if lanes(mid, m, max_terms) > 1 else (lo, mid)
    return lo


def lin_edge_rows(sizes, rng: np.random.Generator, n_random: int = 6, long_rows=()) -> list:
    """Rows of a LinMap over sources of ``sizes`` slots for fp_lin's edges:
    a row's sum of |c| at the bound 2^16 - 1 all positive, all negative and
    mixed; a copy, a negation, an empty row (0) and a lone -1; then random
    rows of 1 to 6 terms whose |c| sum near the bound; then, for each count
    in ``long_rows``, a row of that many terms (distinct slots, mixed signs)
    whose |c| sum to the bound exactly, as the narrow body's lanes split
    a row longer than 32 or 64 terms."""
    limit = (1 << 16) - 1
    ref = [(s, k) for s, n in enumerate(sizes) for k in range(n)]
    rows = [[(0, 0, limit)], [(0, 0, -limit)], [(0, 0, 1)], [(0, 0, -1)], [],
            [(*ref[0], 1 << 15), (*ref[-1], -((1 << 15) - 1))],
            [(*ref[-1], 3), (*ref[0], -2), (*ref[len(ref) // 2], limit - 5)]]
    for _ in range(n_random):
        t = int(rng.integers(1, min(6, len(ref)) + 1))
        picks = rng.choice(len(ref), t, replace=False)
        cuts = np.sort(rng.integers(1, limit - t, t - 1)) if t > 1 else np.array([], dtype=int)
        mags = np.diff(np.concatenate([[0], cuts, [limit - int(rng.integers(0, 4))]]))
        rows.append([(*ref[i], int(m) * (1 if rng.random() < 0.5 else -1))
                     for i, m in zip(picks, mags) if m])
    for t in long_rows:
        if not 0 < t <= len(ref):
            raise ValueError(f"lin_edge_rows: a row of {t} terms over {len(ref)} slots")
        picks = rng.choice(len(ref), t, replace=False)
        cuts = np.sort(rng.choice(np.arange(1, limit), t - 1, replace=False))
        mags = np.diff(np.concatenate([[0], cuts, [limit]]))
        rows.append([(*ref[i], int(m) * (1 if j % 2 else -1))
                     for j, (i, m) in enumerate(zip(picks, mags))])
    return rows


# ---------------------------------------------------------------------------
# twisted Edwards and double-odd group laws on Python ints
# ---------------------------------------------------------------------------

def te_add_host(spec, P, Q):
    """Affine a x^2 + y^2 = 1 + d x^2 y^2 addition (complete on these curves)."""
    p, a, d = spec.base.modulus, spec.a_int, spec.d_int
    (x1, y1), (x2, y2) = P, Q
    dxy = d * x1 * x2 * y1 * y2 % p
    return ((x1 * y2 + y1 * x2) * pow(1 + dxy, -1, p) % p,
            (y1 * y2 - a * x1 * x2) * pow(1 - dxy, -1, p) % p)


def te_mul_host(spec, P, k: int):
    """k P by double-and-add in projective (X : Y : Z), x = X/Z, y = Y/Z,
    with the addition te_add_host computes (add-2008-bbjlp: the same
    denominators 1 +- d x1 x2 y1 y2, as Z3 = F G) and one inverse at the
    end."""
    p, a, d = spec.base.modulus, spec.a_int, spec.d_int

    def add(P1, P2):
        (X1, Y1, Z1), (X2, Y2, Z2) = P1, P2
        A = Z1 * Z2 % p
        B = A * A % p
        C = X1 * X2 % p
        D = Y1 * Y2 % p
        E = d * C % p * D % p
        F, G = (B - E) % p, (B + E) % p
        X3 = A * F % p * (((X1 + Y1) * (X2 + Y2) - C - D) % p) % p
        Y3 = A * G % p * ((D - a * C) % p) % p
        return X3, Y3, F * G % p

    Q = (P[0] % p, P[1] % p, 1)
    acc = (0, 1, 1)
    for bit in bin(k)[2:] if k else "":
        acc = add(acc, acc)
        if bit == "1":
            acc = add(acc, Q)
    zi = pow(acc[2], -1, p)
    return acc[0] * zi % p, acc[1] * zi % p


def do_to_xy(spec, eu):
    """Double-odd (e, u) -> a point (x, y) of y^2 = x (x^2 + a x + b) in its
    class {P, P + N}: x = (e + 1 - a u^2) / (2 u^2), y = x / u; the identity
    class (u = 0) -> None."""
    p, a = spec.base.modulus, spec.a_int
    e, u = eu
    if u % p == 0:
        return None
    x = (e + 1 - a * u * u) * pow(2 * u * u, -1, p) % p
    return (x, x * pow(u, -1, p) % p)


def do_from_xy(spec, P):
    """(x, y) -> (e, u) = (u^2 (x - b/x), x/y); None and N = (0, 0) -> (1, 0)."""
    p, b = spec.base.modulus, spec.b_int
    if P is None or P[0] % p == 0:
        return (1, 0)
    x, y = P
    u = x * pow(y, -1, p) % p
    return (u * u * (x - b * pow(x, -1, p)) % p, u)


def do_add_xy(spec, P, Q):
    """Addition on y^2 = x^3 + a x^2 + b x (affine, None = infinity)."""
    p, a, b = spec.base.modulus, spec.a_int, spec.b_int
    if P is None:
        return Q
    if Q is None:
        return P
    (x1, y1), (x2, y2) = P, Q
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1 + 2 * a * x1 + b) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - a - x1 - x2) % p
    return (x3, (lam * (x1 - x3) - y1) % p)


def do_mul_host(spec, eu, k: int):
    """k (e, u) in the double-odd group through the curve's own law; the
    result's (e, u) is defined up to the sign of both (P and P + N)."""
    P, acc = do_to_xy(spec, eu), None
    for bit in bin(k)[2:] if k else "":
        acc = do_add_xy(spec, acc, acc)
        if bit == "1":
            acc = do_add_xy(spec, acc, P)
    return do_from_xy(spec, acc)


def do_same(spec, eu1, eu2) -> bool:
    """Equal as group elements: (e, u) == +-(e', u')."""
    p = spec.base.modulus
    (e1, u1), (e2, u2) = eu1, eu2
    return (e1 - e2) % p == 0 and (u1 - u2) % p == 0 or (
        (e1 + e2) % p == 0 and (u1 + u2) % p == 0)


# ---------------------------------------------------------------------------
# hash to curve on Python ints (RFC 9380 suites for BLS12-381)
# ---------------------------------------------------------------------------

H_EFF_G2 = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551


def host_swu(a, b, z, u, p):
    """Simplified SWU to y^2 = x^3 + a x + b over F_p on ints (RFC 9380
    §6.6.2, straight-line): (x, y) with sgn0(y) = sgn0(u)."""
    tv = (z * z * pow(u, 4, p) + z * u * u) % p
    x1 = b * pow(z * a, -1, p) % p if tv == 0 else (-b) * pow(a, -1, p) * (1 + pow(tv, -1, p)) % p
    gx1 = (x1 ** 3 + a * x1 + b) % p
    y = sqrt_mod(gx1, p)
    x = x1
    if y is None:
        x = z * u * u * x1 % p
        y = sqrt_mod((x ** 3 + a * x + b) % p, p)
    if y % 2 != u % 2:
        y = (-y) % p
    return x, y


def _host_poly(cs, x, p):
    acc = 0
    for c in reversed(cs):
        acc = (acc * x + c) % p
    return acc


def host_hash_to_g1(u0: int, u1: int):
    """to_affine(h_eff (iso(swu(u0)) + iso(swu(u1)))) on BLS12-381 G1 (None
    at infinity)."""
    from zkarray_torch.curves import bls12_381 as b381
    from zkarray_torch.ec.h2c import _bls12_381_g1_iso as iso

    p = b381.FQ.modulus

    def mapped(u):
        x, y = host_swu(iso.ISO_A, iso.ISO_B, iso.ZETA, u, p)
        xn, xd = _host_poly(iso.X_MAP_NUMERATOR, x, p), _host_poly(iso.X_MAP_DENOMINATOR, x, p)
        yn, yd = _host_poly(iso.Y_MAP_NUMERATOR, x, p), _host_poly(iso.Y_MAP_DENOMINATOR, x, p)
        return (xn * pow(xd, -1, p) % p, y * yn * pow(yd, -1, p) % p)

    return ec_mul(ec_add(mapped(u0), mapped(u1), 0, p), 0xD201000000010001, 0, p)


def _host_sgn0_m2(e, p):
    return e[1] % 2 if e[0] % p == 0 else e[0] % 2


def host_hash_to_g2(u0, u1):
    """to_affine(h_eff (iso(swu(u0)) + iso(swu(u1)))) on BLS12-381 G2, u0 and
    u1 host Fq2 pairs, with RFC 9380's h_eff for G2 (which the psi schedule
    computes); None at infinity."""
    from zkarray_torch.curves import bls12_381 as b381
    from zkarray_torch.ec.h2c import _bls12_381_g2_iso as iso

    F = b381.FQ2.host
    p = b381.FQ.modulus

    def poly(cs, x):
        acc = F.zero()
        for c in reversed(cs):
            acc = F.add(F.mul(acc, x), tuple(c))
        return acc

    def g(x):
        return F.add(F.add(F.mul(F.mul(x, x), x), F.mul(iso.ISO_A, x)), iso.ISO_B)

    def mapped(u):
        u = tuple(c % p for c in u)
        zu2 = F.mul(iso.ZETA, F.mul(u, u))
        tv = F.add(F.mul(zu2, zu2), zu2)
        if F.eq(tv, F.zero()):
            x1 = iso.B_OVER_ZA
        else:
            x1 = F.mul(iso.NEG_B_OVER_A, F.add(F.one(), F.inv(tv)))
        x, y = x1, host_fq2_sqrt(F, g(x1))
        if y is None:
            x = F.mul(zu2, x1)
            y = host_fq2_sqrt(F, g(x))
        if _host_sgn0_m2(y, p) != _host_sgn0_m2(u, p):
            y = F.neg(y)
        inv_xd = F.inv(poly(iso.X_MAP_DENOMINATOR, x))
        inv_yd = F.inv(poly(iso.Y_MAP_DENOMINATOR, x))
        return (F.mul(poly(iso.X_MAP_NUMERATOR, x), inv_xd),
                F.mul(y, F.mul(poly(iso.Y_MAP_NUMERATOR, x), inv_yd)))

    return ext_ec_mul(F, ext_ec_add(F, mapped(u0), mapped(u1)), H_EFF_G2)


def host_elligator2(spec, u: int, zeta: int):
    """Elligator2 (RFC 9380 §6.7.1) on ints for a TE curve with Montgomery
    constants (A, B): x1 = -A / (1 + Z u^2) (-A where Z u^2 = -1), the first
    of x1, -x1 - A with (x^3 + A x^2 + x) / B a square, sgn0(y) = sgn0(u),
    then (s x/y, (x - 1)/(x + 1)) with s^2 = ((A + 2)/B)/a; y = 0 or x = -1
    gives the identity (0, 1)."""
    p = spec.base.modulus
    A, B = spec.mont_coeff_a % p, spec.mont_coeff_b % p
    zu2 = zeta * u * u % p
    if (1 + zu2) % p == 0:
        return (0, 1)
    x1 = -A * pow(1 + zu2, -1, p) % p

    def g(x):
        return (x * x * x + A * x * x + x) * pow(B, -1, p) % p

    x, y = x1, sqrt_mod(g(x1), p)
    if y is None:
        x = (-x1 - A) % p
        y = sqrt_mod(g(x), p)
    if y % 2 != u % p % 2:
        y = (-y) % p
    if y == 0 or (x + 1) % p == 0:
        return (0, 1)
    val = (A + 2) * pow(B, -1, p) * pow(spec.a_int, -1, p) % p
    s = sqrt_mod(val, p)
    return (s * x * pow(y, -1, p) % p, (x - 1) * pow(x + 1, -1, p) % p)
