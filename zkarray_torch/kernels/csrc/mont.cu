// Element-wise Montgomery product, square and power on planar 16-bit limbs.
//
// mont_mul and mont_sqr replace zkarray/kernels/mont.py:mont_mul and
// :mont_sqr (Pallas, _elementwise_call): one thread per element instead of
// one (L, 8, 128) VMEM block per grid step.
//
// Bound on an H100: bytes. An L = 24 product reads 2 x 96 B and writes 96 B
// per element (16-bit limbs held in int32, twice the bytes of the values) and
// does ~4 NW^2 = 576 32-bit multiply-adds; at 3.35 TB/s and ~16.7 T int32
// ops/s the bytes take longer. Design: limb k of consecutive elements sits at
// consecutive addresses, so each of the 2L loads and L stores of a warp is
// one coalesced 128-byte line; limb pairs are packed into NW = L/2 32-bit
// words in registers and the CIOS runs there.
//
// mont_pow has no Pallas counterpart: it replaces the loop of mont_mul and
// mont_sqr launches in ff/fp.py:pow_const (zkarray/ff/fp.py:pow_const, a
// lax.scan that XLA fuses), ~570 launches for a Fermat inverse in Fq. It runs
// the same low-bit-first square-and-multiply with the whole chain in
// registers. Bound: operations for a wide batch (~1.5 products per exponent
// bit); on the MSM path it inverts one element, a serial chain bound by the
// latency of one thread, which the launch count no longer multiplies. The
// exponent is uniform, so no warp diverges.
//
// mont_inv has no Pallas counterpart either: it replaces mont_pow on the
// field inverse (ff/fp.py:inv, whose JAX counterpart zkarray/ff/fp.py:inv
// runs pow_const's Fermat chain, a^(p-2)). Where it inverts one element
// what bounds it is the latency of its dependent instructions; a Fermat
// chain there is 609 dependent CIOS products (mont_pow, ~1.2 us each on the
// H100). Design: a binary GCD in batches of 30 steps on 62-bit stand-ins,
// a fixed number of batches per field, two lanes an element (see
// gcd_div_pair). mont_div runs the same loop with a numerator as the
// starting coefficient, two divisions a point: it replaces the MSM's
// to-affine (ec/sw.py:xyzz_to_affine; zkarray/ec/sw.py:174, two batch
// inverses and two products, 8 launches at one point) with one launch.
//
// Each kernel is built for NW = 8, 10, 12, 24 and 26 (ZK_DISPATCH_NW_FIELD):
// 254- to 384-bit fields, MNT4/6-298's 298-bit fields (NW = 10), the 753- to
// 767-bit fields of MNT4/6-753 and BW6 (NW = 24) and CP6-782's 782-bit field
// (NW = 26), where fmul's CIOS holds a, b and t[NW + 2], ~80 live words, and
// a GCD lane its pair, the pair being made and the combine's NW + 1 words,
// ~110 (ptxas' registers and spills at each width: chip_smoke.py's build
// line).
// The file is compiled once per width group (ZK_FIELD_WIDTHS: 8/10/12, 24,
// 26), the groups in parallel, as the wide groups' unrolled loops take most
// of the build. The products' one-thread-per-element design is kept at
// every width. At NW = 24 a product reads 2 x 192 B and writes 192 B per element
// and does ~4 NW^2 = 2,304 32-bit operations, ~4 a byte against the card's
// ~5 (16.7 T int32 ops/s over 3.35 TB/s): still bound by bytes, nearly
// balanced (NW = 26: ~4.3 a byte), where a 254- to 384-bit product has 1 to
// 2 operations a byte. mont_pow's exponent (MAX_EXP_WORDS words, 2,048
// bits) holds p - 2 at every width.
//
// Operands are read through field.cuh's strided map (Operand); outputs are
// contiguous, ld = n.
#include "field.cuh"

// Exponents of up to MAX_EXP_WORDS 32-bit words ride in the kernel's
// parameters (the wrapper refuses longer ones).
#define MAX_EXP_WORDS 64

struct Exponent {
  uint32_t w[MAX_EXP_WORDS];
  int nbits;
};

template <int NW>
__global__ void __launch_bounds__(256)
mont_mul_kernel(Operand a, Operand b, int32_t* __restrict__ out, long long n, FieldConsts<NW> F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe<NW> x = load_operand<NW>(a, i);
  const Fe<NW> y = load_operand<NW>(b, i);
  store16<NW>(out, (size_t)n, (size_t)i, fmul<NW>(x, y, F));
}

template <int NW>
__global__ void __launch_bounds__(256)
mont_sqr_kernel(Operand a, int32_t* __restrict__ out, long long n, FieldConsts<NW> F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe<NW> x = load_operand<NW>(a, i);
  store16<NW>(out, (size_t)n, (size_t)i, fmul<NW>(x, x, F));
}

// a^e, exponent bits low first: res *= base on a set bit, base squared while
// bits remain (the plain version's order; e = 0 gives one, a = 0 gives 0 for e > 0).
template <int NW>
__global__ void __launch_bounds__(128)
mont_pow_kernel(Operand a, int32_t* __restrict__ out, long long n, Exponent e, FieldConsts<NW> F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<NW> base = load_operand<NW>(a, i);
  Fe<NW> res = fe_one<NW>(F);
  for (int b = 0; b < e.nbits; ++b) {
    if ((e.w[b >> 5] >> (b & 31)) & 1u) res = fmul<NW>(res, base, F);
    if (b + 1 < e.nbits) base = fmul<NW>(base, base, F);
  }
  store16<NW>(out, (size_t)n, (size_t)i, res);
}

// ---- inverse and division by batched binary GCD -----------------------------
//
// Pornin's optimized binary GCD (IACR ePrint 2020/972, Algorithm 2) on
// a = y, b = p with coefficients u = u0, v = 0, which keeps a = u y K and
// b = v y K (mod p) for K = 1/u0. A batch runs GCD_STEPS = 30 steps of the
// classic loop (a odd: swap a, b when a < b, then a = (a - b)/2; a even:
// a = a/2) on 62-bit stand-ins for a and b (their low 30 bits and the top
// 32 of max(bits(a), bits(b), 62) bits), recording them as signed factors
// |f| + |g| <= 2^30: 2^30 a' = f0 a + g0 b, 2^30 b' = f1 a + g1 b. Then the
// full-width values take the batch at once: a, b <- (f a + g b) / 2^30,
// negated if negative (the stand-ins may swap where the exact loop would
// not), and u, v <- (f u + g v) 2^-30 mod p (a Montgomery step of 30 bits
// over NW + 1 words: no spare bit of p is assumed), negated with them. After
// ceil((2 bits(p) - 1) / 30) batches (26 at 381 bits, 53 at 782) a = 0,
// b = 1 and v = u0 / y: the paper's bound of 2 bits(p) - 1 steps holds on
// the stand-ins. A zero y keeps v = 0, so zero maps to zero.
//
// The loop count is fixed by the field, so the lanes of a warp stay in step
// at any width. Below GCD_WIDE elements two lanes work on each division
// (gcd_div_pair): lane 0 of the pair holds the integers (a, b), lane 1 the
// coefficients (u, v). Both compute the stand-ins and run the 30 steps
// (lane 1 takes lane 0's stand-ins by shuffle), then each updates its own
// pair. The two updates are one code path (gcd_combine on GCD_EITHER): the
// coefficient lane's negation of a term is p - x and its result is reduced
// mod p, the integer lane's negation is ~x with a correction of the top
// word, so no lane of the warp waits on another branch. A negative a' or b'
// reaches the coefficient lane as a flag that flips the sign of its factors
// in the next batch (and of v at the end), so no negation of the
// coefficients sits on the batch's critical path. From GCD_WIDE elements on,
// where the card is bound by issue rather than by one lane's latency, one
// lane does all four updates (gcd_div_one), each specialised to its role.
//
// Bound on the MSM path (one element): one warp. A batch is ~1,400 SASS
// instructions at NW = 12 (the 30 steps ~22 each, the two updates ~600),
// and the warp issues them at about one every two cycles: each depends on
// one a few before it, and the integer multiply-adds take two issue cycles.
// zkarray_torch/testing.py:mont_inv_chain counts the loop's dependent
// instructions (the stand-ins, a shuffle, 5 a step, the update's column
// carry chain and reduction), which chip_smoke.py multiplies by one carried
// add's latency: the chain bound; mont_inv_model follows the loop word for
// word.
#define GCD_STEPS 30
#define GCD_LOW ((1u << GCD_STEPS) - 1u)
// From this many elements (points for mont_div) on, one lane a division:
// the card then has the warps to hide each lane's latency, and the pair's
// second copy of the stand-ins and steps would cost issue slots.
#define GCD_WIDE (1 << 14)

struct GcdFactors {
  int32_t f0, g0, f1, g1;
};

// The 62-bit stand-ins of a and b: bits [0, 30) and the 32 bits below
// n = max(bits(a), bits(b), 62), so they are exact when both fit in 62 bits.
// h is the top nonzero word of a | b; the window is the top word of
// (word h : word h - 1) << s, s its leading zeros (a select per word: no
// register array indexed at run time).
template <int NW>
__device__ __forceinline__ void gcd_approx(const Fe<NW>& a, const Fe<NW>& b, uint64_t& at,
                                           uint64_t& bt) {
  int h = 0;
#pragma unroll
  for (int j = 1; j < NW; ++j) h = (a.w[j] | b.w[j]) != 0u ? j : h;
  uint32_t ah = a.w[0], al = 0u, bh = b.w[0], bl = 0u;
#pragma unroll
  for (int j = 1; j < NW; ++j) {
    const bool at_h = j == h;
    ah = at_h ? a.w[j] : ah;
    al = at_h ? a.w[j - 1] : al;
    bh = at_h ? b.w[j] : bh;
    bl = at_h ? b.w[j - 1] : bl;
  }
  const int s = __clz(ah | bh);
  const bool small = 32 * h + 32 - s <= 2 * GCD_STEPS + 2;  // then the window is [30, 62)
  const uint32_t ta = small ? __funnelshift_r(a.w[0], a.w[1], GCD_STEPS) : __funnelshift_l(al, ah, s);
  const uint32_t tb = small ? __funnelshift_r(b.w[0], b.w[1], GCD_STEPS) : __funnelshift_l(bl, bh, s);
  at = (uint64_t)(a.w[0] & GCD_LOW) | ((uint64_t)ta << GCD_STEPS);
  bt = (uint64_t)(b.w[0] & GCD_LOW) | ((uint64_t)tb << GCD_STEPS);
}

// GCD_STEPS steps on the stand-ins, without a branch: the factors of the
// batch. A step swaps the rows (f0, g0) and (f1, g1) where a is odd and
// below b, subtracts row 1 from row 0 where a is odd, and doubles row 1.
__device__ __forceinline__ GcdFactors gcd_steps(uint64_t at, uint64_t bt) {
  int32_t f0 = 1, g0 = 0, f1 = 0, g1 = 1;
#pragma unroll
  for (int j = 0; j < GCD_STEPS; ++j) {
    const uint32_t oddm = 0u - ((uint32_t)at & 1u);
    const uint64_t d1 = at - bt, d2 = bt - at;
    const uint32_t ltm = (uint32_t)((int32_t)(uint32_t)(d1 >> 32) >> 31);  // at < bt: both below 2^62
    const uint32_t swm = oddm & ltm;
    const uint64_t odd64 = ((uint64_t)oddm << 32) | oddm, sw64 = ((uint64_t)swm << 32) | swm;
    const uint64_t e = (d1 & odd64) | (at & ~odd64);
    const uint64_t an = (d2 & sw64) | (e & ~sw64);
    bt = (at & sw64) | (bt & ~sw64);
    at = an >> 1;
    const int32_t sm = (int32_t)swm, om = (int32_t)oddm;
    const int32_t x = (f1 & sm) | (f0 & ~sm), y = (f0 & sm) | (f1 & ~sm);
    const int32_t xg = (g1 & sm) | (g0 & ~sm), yg = (g0 & sm) | (g1 & ~sm);
    f0 = x - (y & om);
    g0 = xg - (yg & om);
    f1 = y + y;
    g1 = yg + yg;
  }
  return GcdFactors{f0, g0, f1, g1};
}

// The roles a GCD lane takes: the integers a, b; the coefficients u, v;
// or either, by a flag known at run time (a lane pair, one code path).
enum { GCD_INT = 0, GCD_COEF = 1, GCD_EITHER = 2 };

// M - x for the negated terms: M = p on a coefficient lane (M - x in
// (0, p]), 2^(32 NW) - 1 on the integer lane (~x).
template <int NW, int ROLE>
__device__ __forceinline__ Fe<NW> gcd_negated(const Fe<NW>& x, bool coef, const FieldConsts<NW>& F) {
  Fe<NW> m;
  if constexpr (ROLE == GCD_INT) {
#pragma unroll
    for (int j = 0; j < NW; ++j) m.w[j] = ~x.w[j];
  } else {
    const bool cf = ROLE == GCD_COEF || coef;
    m.w[0] = ptx::sub_cc(cf ? F.p[0] : 0xFFFFFFFFu, x.w[0]);
#pragma unroll
    for (int j = 1; j < NW; ++j) m.w[j] = ptx::subc_cc(cf ? F.p[j] : 0xFFFFFFFFu, x.w[j]);
  }
  return m;
}

// r = (f x0 + g x1) / 2^30: exactly and made nonnegative on the integer
// lane (returns true where it was negative), mod p on the coefficient lane
// (n0, n1: x0, x1 stand for their negations). m0, m1 are gcd_negated's
// M - x0, M - x1: a term with a negative factor is |f| (M - x); on the
// integer lane that adds |f| at the bottom and takes |f| 2^(32 NW) off the
// top word. The sum is below 2^30 p (or 2^(32 NW + 30)); the coefficient
// lane adds m p, m < 2^30 making it a multiple of 2^30, so after the shift
// it is below 2p.
template <int NW, int ROLE>
__device__ __forceinline__ bool gcd_combine(Fe<NW>& r, const Fe<NW>& x0, const Fe<NW>& x1,
                                            const Fe<NW>& m0, const Fe<NW>& m1, bool n0, bool n1,
                                            int32_t f, int32_t g, bool coef,
                                            const FieldConsts<NW>& F) {
  const bool cf = ROLE == GCD_EITHER ? coef : ROLE == GCD_COEF;
  const bool sf = (f < 0) != n0, sg = (g < 0) != n1;
  const uint32_t af = f < 0 ? 0u - (uint32_t)f : (uint32_t)f;
  const uint32_t ag = g < 0 ? 0u - (uint32_t)g : (uint32_t)g;
  const uint32_t K = cf ? 0u : (sf ? af : 0u) + (sg ? ag : 0u);
  uint32_t u[NW + 1];
  uint64_t c = K, c2 = 0;
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint64_t s = (uint64_t)af * (sf ? m0.w[j] : x0.w[j]) +
                       (uint64_t)ag * (sg ? m1.w[j] : x1.w[j]) + c;
    c = s >> 32;
    const uint32_t t = (uint32_t)s;
    if (j == 0) m = cf ? (t * F.inv) & GCD_LOW : 0u;
    const uint64_t s2 = (uint64_t)m * F.p[j] + t + c2;
    u[j] = (uint32_t)s2;
    c2 = s2 >> 32;
  }
  u[NW] = (uint32_t)c + (uint32_t)c2 - K;
  Fe<NW> v;
#pragma unroll
  for (int j = 0; j < NW; ++j) v.w[j] = __funnelshift_r(u[j], u[j + 1], GCD_STEPS);
  const uint32_t vtop = cf ? u[NW] >> GCD_STEPS : (uint32_t)((int32_t)u[NW] >> GCD_STEPS);
  const bool neg = !cf && vtop != 0u;
  // the coefficient lane takes v - p where that does not borrow, the
  // integer lane 0 - v where v < 0: one subtraction chain A - B
  Fe<NW> d;
  const uint32_t a0 = ROLE == GCD_INT ? 0u : cf ? v.w[0] : 0u;
  const uint32_t b0 = ROLE == GCD_INT ? v.w[0] : cf ? F.p[0] : v.w[0];
  d.w[0] = ptx::sub_cc(a0, b0);
#pragma unroll
  for (int j = 1; j < NW; ++j) {
    const uint32_t aj = ROLE == GCD_INT ? 0u : cf ? v.w[j] : 0u;
    const uint32_t bj = ROLE == GCD_INT ? v.w[j] : cf ? F.p[j] : v.w[j];
    d.w[j] = ptx::subc_cc(aj, bj);
  }
  ptx::subc_cc(cf ? vtop : 0u, 0u);
  const bool take = cf ? ptx::subc(0u, 0u) == 0u : neg;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = take ? d.w[j] : v.w[j];
  return neg;
}

// u0 / y mod p on one lane that holds a = y, b = p and u = u0 < p, v = 0
// (see above): fully reduced, 0 for y = 0. Not inlined: mont_inv and
// mont_div share one copy per width (half the build of the wide groups);
// F must be a __grid_constant__ kernel parameter, its address is passed.
template <int NW>
__device__ __noinline__ Fe<NW> gcd_div_one(Fe<NW> a, Fe<NW> u, int batches,
                                           const FieldConsts<NW>& F) {
  Fe<NW> b, v = fe_zero<NW>();
#pragma unroll
  for (int j = 0; j < NW; ++j) b.w[j] = F.p[j];
  bool nu = false, nv = false;
#pragma unroll 1
  for (int it = 0; it < batches; ++it) {
    uint64_t at, bt;
    gcd_approx<NW>(a, b, at, bt);
    const GcdFactors k = gcd_steps(at, bt);
    const Fe<NW> ma = gcd_negated<NW, GCD_INT>(a, false, F), mb = gcd_negated<NW, GCD_INT>(b, false, F);
    const Fe<NW> mu = gcd_negated<NW, GCD_COEF>(u, true, F), mv = gcd_negated<NW, GCD_COEF>(v, true, F);
    Fe<NW> ra, rb, ru, rv;
    const bool sa = gcd_combine<NW, GCD_INT>(ra, a, b, ma, mb, false, false, k.f0, k.g0, false, F);
    const bool sb = gcd_combine<NW, GCD_INT>(rb, a, b, ma, mb, false, false, k.f1, k.g1, false, F);
    gcd_combine<NW, GCD_COEF>(ru, u, v, mu, mv, nu, nv, k.f0, k.g0, true, F);
    gcd_combine<NW, GCD_COEF>(rv, u, v, mu, mv, nu, nv, k.f1, k.g1, true, F);
    a = ra;
    b = rb;
    u = ru;
    v = rv;
    nu = sa;
    nv = sb;
  }
  return nv ? fsub_cc<NW>(fe_zero<NW>(), v, F) : v;  // p - v, and 0 for v = 0
}

// The same on a pair of lanes: lane 0 of the pair enters with x0 = y,
// x1 = p (coef false), lane 1 with x0 = u0 < p, x1 = 0 (coef true); lane 1's
// result is the quotient. Both lanes of a pair must reach this call together.
template <int NW>
__device__ __noinline__ Fe<NW> gcd_div_pair(Fe<NW> x0, Fe<NW> x1, bool coef, int batches,
                                            const FieldConsts<NW>& Fg) {
  const FieldConsts<NW> F = Fg;  // p and inv in registers: the loop reads them every batch
  const unsigned lane = threadIdx.x & 31u;
  const unsigned mask = 3u << (lane & 30u);
  const int lead = (int)(lane & 30u);
  bool n0 = false, n1 = false;
#pragma unroll 1
  for (int it = 0; it < batches; ++it) {
    uint64_t at, bt;
    gcd_approx<NW>(x0, x1, at, bt);
    at = __shfl_sync(mask, at, lead);
    bt = __shfl_sync(mask, bt, lead);
    const GcdFactors k = gcd_steps(at, bt);
    const Fe<NW> m0 = gcd_negated<NW, GCD_EITHER>(x0, coef, F);
    const Fe<NW> m1 = gcd_negated<NW, GCD_EITHER>(x1, coef, F);
    Fe<NW> r0, r1;
    const bool s0 = gcd_combine<NW, GCD_EITHER>(r0, x0, x1, m0, m1, n0, n1, k.f0, k.g0, coef, F);
    const bool s1 = gcd_combine<NW, GCD_EITHER>(r1, x0, x1, m0, m1, n0, n1, k.f1, k.g1, coef, F);
    const uint32_t s = __shfl_sync(mask, (s0 ? 1u : 0u) | (s1 ? 2u : 0u), lead);
    n0 = coef && (s & 1u);
    n1 = coef && (s & 2u);
    x0 = r0;
    x1 = r1;
  }
  return n1 ? fsub_cc<NW>(fe_zero<NW>(), x1, F) : x1;
}

// a^-1 for Montgomery words a = x R < p (0 -> 0): u0 = R^2 mod p, so the
// quotient R^2 / a = x^-1 R is the inverse's Montgomery word. PAIR: threads
// 2i and 2i + 1 work on element i; else thread i alone.
template <int NW, bool PAIR>
__global__ void __launch_bounds__(128)
mont_inv_kernel(Operand a, int32_t* __restrict__ out, long long n, Fe<NW> r2, int batches,
                const __grid_constant__ FieldConsts<NW> F) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i = PAIR ? t >> 1 : t;
  if (i >= n) return;
  const Fe<NW> y = load_operand<NW>(a, i);
  if constexpr (PAIR) {
    const bool coef = t & 1;
    Fe<NW> x0, x1;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      x0.w[j] = coef ? r2.w[j] : y.w[j];
      x1.w[j] = coef ? 0u : F.p[j];
    }
    const Fe<NW> r = gcd_div_pair<NW>(x0, x1, coef, batches, F);
    if (coef) store16<NW>(out, (size_t)n, (size_t)i, r);
  } else {
    store16<NW>(out, (size_t)n, (size_t)i, gcd_div_one<NW>(y, r2, batches, F));
  }
}

// Two divisions a point, num0 / den0 and num1 / den1 (the to-affine's
// X / ZZ and Y / ZZZ), each 0 where its denominator is 0: u0 = num R (one
// product by R^2), so the quotient num R / den is (num / den)'s Montgomery
// word. PAIR: threads 4i .. 4i + 3 work on point i, a pair of lanes a
// division; else threads 2i, 2i + 1, a lane a division. out is (2, L, n).
template <int NW, bool PAIR>
__global__ void __launch_bounds__(128)
mont_div_kernel(Operand n0, Operand d0, Operand n1, Operand d1, int32_t* __restrict__ out,
                long long n, Fe<NW> r2, int batches, const __grid_constant__ FieldConsts<NW> F) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i = PAIR ? t >> 2 : t >> 1;
  if (i >= n) return;
  const bool second = PAIR ? (t & 2) : (t & 1);
  int32_t* const dst = out + (second ? (size_t)2 * NW * (size_t)n : 0);
  if constexpr (PAIR) {
    const bool coef = t & 1;
    const Operand o = second ? (coef ? n1 : d1) : (coef ? n0 : d0);
    const Fe<NW> y = load_operand<NW>(o, i);
    const Fe<NW> num = fmul<NW>(y, r2, F);
    Fe<NW> x0, x1;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      x0.w[j] = coef ? num.w[j] : y.w[j];
      x1.w[j] = coef ? 0u : F.p[j];
    }
    const Fe<NW> r = gcd_div_pair<NW>(x0, x1, coef, batches, F);
    if (coef) store16<NW>(dst, (size_t)n, (size_t)i, r);
  } else {
    const Operand od = second ? d1 : d0, on = second ? n1 : n0;
    const Fe<NW> den = load_operand<NW>(od, i);
    const Fe<NW> num = fmul<NW>(load_operand<NW>(on, i), r2, F);
    store16<NW>(dst, (size_t)n, (size_t)i, gcd_div_one<NW>(den, num, batches, F));
  }
}

// Batches of GCD_STEPS steps for the host words p[NW]: ceil((2 bits(p) - 1) / 30).
static int gcd_batches(const uint32_t* consts, int nw) {
  int top = nw - 1;
  while (top > 0 && consts[top] == 0) --top;
  int bits = 32 * top;
  for (uint32_t w = consts[top]; w; w >>= 1) ++bits;
  return (2 * bits - 1 + GCD_STEPS - 1) / GCD_STEPS;
}

static inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// ops: host descriptors (pointer, ld, inner, outer) of a then b; out:
// int32[L, n] contiguous; consts: host words (see field.cuh).
extern "C" int zk_mont_mul(const long long* ops, void* out, long long n, int nw,
                           const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  if (!operands_ok(ops, 2)) return (int)cudaErrorInvalidValue;
  const Operand a = operand_from_host(ops), b = operand_from_host(ops + 4);
  ZK_DISPATCH_NW_FIELD(nw, mont_mul_kernel<NW><<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
                          a, b, (int32_t*)out, n, consts_from_host<NW>(consts)));
  return (int)cudaGetLastError();
}

extern "C" int zk_mont_sqr(const long long* ops, void* out, long long n, int nw,
                           const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  if (!operands_ok(ops, 1)) return (int)cudaErrorInvalidValue;
  const Operand a = operand_from_host(ops);
  ZK_DISPATCH_NW_FIELD(nw, mont_sqr_kernel<NW><<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
                          a, (int32_t*)out, n, consts_from_host<NW>(consts)));
  return (int)cudaGetLastError();
}

// exp: nbits exponent bits as 32-bit words, low word first.
extern "C" int zk_mont_pow(const long long* ops, void* out, long long n, const uint32_t* exp,
                           int nbits, int nw, const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  if (!operands_ok(ops, 1) || nbits < 0 || nbits > 32 * MAX_EXP_WORDS)
    return (int)cudaErrorInvalidValue;
  Exponent e;
  e.nbits = nbits;
  for (int j = 0; j < MAX_EXP_WORDS; ++j) e.w[j] = j < (nbits + 31) / 32 ? exp[j] : 0u;
  const Operand a = operand_from_host(ops);
  ZK_DISPATCH_NW_FIELD(nw, mont_pow_kernel<NW><<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
                          a, (int32_t*)out, n, e, consts_from_host<NW>(consts)));
  return (int)cudaGetLastError();
}

// r2: R^2 mod p as NW host words; lanes: 2 (a pair an element), 1 or 0
// (2 below GCD_WIDE elements, else 1).
extern "C" int zk_mont_inv(const long long* ops, void* out, long long n, const uint32_t* r2,
                           int lanes, int nw, const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  if (!operands_ok(ops, 1) || lanes < 0 || lanes > 2) return (int)cudaErrorInvalidValue;
  const bool pair = lanes ? lanes == 2 : n < GCD_WIDE;
  const Operand a = operand_from_host(ops);
  const int batches = gcd_batches(consts, nw);
  ZK_DISPATCH_NW_FIELD(nw, {
    Fe<NW> r;
    for (int j = 0; j < NW; ++j) r.w[j] = r2[j];
    const unsigned blocks = blocks_for(pair ? 2 * n : n, 128);
    if (pair)
      mont_inv_kernel<NW, true><<<blocks, 128, 0, (cudaStream_t)stream>>>(
          a, (int32_t*)out, n, r, batches, consts_from_host<NW>(consts));
    else
      mont_inv_kernel<NW, false><<<blocks, 128, 0, (cudaStream_t)stream>>>(
          a, (int32_t*)out, n, r, batches, consts_from_host<NW>(consts));
  });
  return (int)cudaGetLastError();
}

// ops: host descriptors of num0, den0, num1, den1; out: int32[2, L, n]
// contiguous; r2 and lanes as for zk_mont_inv (n counts points).
extern "C" int zk_mont_div(const long long* ops, void* out, long long n, const uint32_t* r2,
                           int lanes, int nw, const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  if (!operands_ok(ops, 4) || lanes < 0 || lanes > 2) return (int)cudaErrorInvalidValue;
  const bool pair = lanes ? lanes == 2 : n < GCD_WIDE;
  const Operand n0 = operand_from_host(ops), d0 = operand_from_host(ops + 4);
  const Operand n1 = operand_from_host(ops + 8), d1 = operand_from_host(ops + 12);
  const int batches = gcd_batches(consts, nw);
  ZK_DISPATCH_NW_FIELD(nw, {
    Fe<NW> r;
    for (int j = 0; j < NW; ++j) r.w[j] = r2[j];
    const unsigned blocks = blocks_for((pair ? 4 : 2) * n, 128);
    if (pair)
      mont_div_kernel<NW, true><<<blocks, 128, 0, (cudaStream_t)stream>>>(
          n0, d0, n1, d1, (int32_t*)out, n, r, batches, consts_from_host<NW>(consts));
    else
      mont_div_kernel<NW, false><<<blocks, 128, 0, (cudaStream_t)stream>>>(
          n0, d0, n1, d1, (int32_t*)out, n, r, batches, consts_from_host<NW>(consts));
  });
  return (int)cudaGetLastError();
}
