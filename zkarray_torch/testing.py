"""Host oracles and known-answer inputs for the port's tests and chip_smoke.py.

The port's own copies of tests/ec_oracle.py (textbook affine arithmetic on
Python ints) and of bench.py's tiled MSM inputs with their O(1)-host-work
known answer; edge-class inputs for the bucket accumulation and the
window Horner, built with the oracle; and for the group path, seeded points
and scalars with known answers at sampled indices, Jacobian edge-class
pairs, and curve points outside the prime-order subgroup, that the CPU
tests and chip_smoke.py share.
"""

from __future__ import annotations

import numpy as np
import torch

from zkarray_torch.core.limbs import pack_pairs
from zkarray_torch.ec.sw import SWCurveSpec, affine_from_ints, xyzz_from_affine
from zkarray_torch.ff import fp


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
# the field inverse's loop (csrc/mont.cu:mont_inv_kernel), word by word
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _words(x: int, nw: int) -> list:
    return [(x >> (32 * j)) & _M32 for j in range(nw)]


def _sub_words(a, b):
    """a - b over 32-bit words with the borrow chain: (words, borrow)."""
    out, borrow = [], 0
    for x, y in zip(a, b):
        s = x - y - borrow
        out.append(s & _M32)
        borrow = int(s < 0)
    return out, borrow


def _fsub_words(a, b, p):
    """csrc/field.cuh:fsub_cc: a - b, then p added under the borrow's mask,
    the carry out dropped."""
    d, borrow = _sub_words(a, b)
    out, c = [], 0
    for x, y in zip(d, p):
        s = x + (y if borrow else 0) + c
        out.append(s & _M32)
        c = s >> 32
    return out


def _halve_words(u, b, p, inv32):
    """csrc/mont.cu:halve: k = trailing zeros of u's low word (31 when it is
    0); u >>= k; b = (b + m p) >> k with m = b inv32 mod 2^k, over NW + 1
    words."""
    nw = len(u)
    w0 = u[0]
    k = (w0 & -w0).bit_length() - 1 if w0 else 31
    u = [((u[j] >> k) | (u[j + 1] << (32 - k))) & _M32 for j in range(nw - 1)] + [u[-1] >> k]
    m = (b[0] * inv32) & ((1 << k) - 1)
    t, c = [], 0
    for j in range(nw):
        s = m * p[j] + b[j] + c
        t.append(s & _M32)
        c = s >> 32
    t.append(c)
    return u, [((t[j] >> k) | (t[j + 1] << (32 - k))) & _M32 for j in range(nw)]


def mont_inv_model(spec, x: int):
    """csrc/mont.cu:mont_inv_kernel on one Montgomery word x < p, in its
    order of work and with its carries: returns (x^-1's Montgomery word, the
    loop's iterations). u v at least halves each iteration, so the
    iterations stay below mont_inv_iteration_bound(spec, x)."""
    nw = spec.num_limbs // 2
    if x == 0:
        return 0, 0
    p = _words(spec.modulus, nw)
    u, v, b, c = _words(x, nw), p, _words(spec.r2_int, nw), [0] * nw
    one = [1] + [0] * (nw - 1)

    def strip(u, b):
        for _ in range(nw + 1):
            if u[0] & 1:
                break
            u, b = _halve_words(u, b, p, spec.inv32)
        return u, b

    u, b = strip(u, b)
    it = 0
    while it < 64 * nw and u != one:
        d, lt = _sub_words(u, v)
        e, _ = _sub_words(v, u)
        bc, cb = _fsub_words(b, c, p), _fsub_words(c, b, p)
        if lt:
            u, b, v, c = e, cb, u, b
        else:
            u, b = d, bc
        u, b = strip(u, b)
        it += 1
    return sum(w << (32 * j) for j, w in enumerate(b)), it


def mont_inv_iteration_bound(spec, x: int) -> int:
    """Iterations of mont_inv's loop on x are fewer than this: log2(u v)
    starts below bits(x) + bits(p) and falls by at least 1 each time."""
    return x.bit_length() + spec.modulus.bit_length()


def mont_inv_edge_words(spec, rng: np.random.Generator, n_random: int = 8) -> list:
    """Montgomery words for the field inverse's edge cases: 0, 1, R mod p
    (the element 1), p - 1, the words 2^k (a long first run of halvings),
    the elements 2^k (2^k R mod p) for k up to 380, then ``n_random``
    random words below p."""
    p, bits = spec.modulus, spec.modulus.bit_length()
    out = [0, 1, spec.r_int % p, p - 1]
    out += [1 << k for k in (1, 31, 32, 33, 64, 200, bits - 2) if k < bits - 1]
    out += [spec.to_mont_int(pow(2, k, p)) for k in (1, 63, 64, 255, 380)]
    out += [int.from_bytes(rng.bytes(48), "little") % p for _ in range(n_random)]
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
