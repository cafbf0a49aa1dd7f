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
// MSM's to-affine (ff/fp.py:inv, whose JAX counterpart zkarray/ff/fp.py:inv
// runs pow_const's Fermat chain, a^(p-2)). On the MSM path it inverts one
// element, so what bounds it is the latency of one thread's dependent
// instructions; a Fermat chain there is 609 dependent CIOS products
// (mont_pow, ~1.2 us each on the H100). Design: the binary extended GCD the
// reference uses (arkworks montgomery_backend.rs:319-378, Guajardo et al.'s
// Algorithm 16), whose loop holds no product: word shifts, compares and
// subtractions on NW words in registers, one thread per element. Its
// iterations and the dependent instructions in each bound it; see
// mont_inv_kernel.
//
// Each kernel is built for NW = 8, 10, 12, 24 and 26 (ZK_DISPATCH_NW_FIELD):
// 254- to 384-bit fields, MNT4/6-298's 298-bit fields (NW = 10), the 753- to
// 767-bit fields of MNT4/6-753 and BW6 (NW = 24) and CP6-782's 782-bit field
// (NW = 26), where fmul's CIOS holds a, b and t[NW + 2], ~80 live words, and
// mont_inv's loop u, v, b, c, d, e and the two fsub_cc results, ~210
// (ptxas' registers and spills at each width: chip_smoke.py's build line).
// The file is compiled once per width group (ZK_FIELD_WIDTHS: 8/10/12, 24,
// 26), the groups in parallel, as the wide groups' unrolled loops take most
// of the build. The simple one-thread-per-element design is kept at every
// width. At NW = 24 a product reads 2 x 192 B and writes 192 B per element
// and does ~4 NW^2 = 2,304 32-bit operations, ~4 a byte against the card's
// ~5 (16.7 T int32 ops/s over 3.35 TB/s): still bound by bytes, nearly
// balanced (NW = 26: ~4.3 a byte), where a 254- to 384-bit product has 1 to
// 2 operations a byte. mont_pow's exponent (MAX_EXP_WORDS words, 2,048
// bits) holds p - 2 at every width, and mont_inv's loop cap of 64 NW
// iterations stays above bits(a) + bits(p) <= 64 NW.
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

// ---- inverse by binary GCD ---------------------------------------------------

// d = a - b over NW words; returns all ones when a < b (the borrow out).
template <int NW>
__device__ __forceinline__ uint32_t sub_words(Fe<NW>& d, const Fe<NW>& a, const Fe<NW>& b) {
  d.w[0] = ptx::sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d.w[j] = ptx::subc_cc(a.w[j], b.w[j]);
  return ptx::subc(0, 0);
}

template <int NW>
__device__ __forceinline__ bool fe_is_one_word(const Fe<NW>& a) {
  uint32_t acc = a.w[0] ^ 1u;
#pragma unroll
  for (int j = 1; j < NW; ++j) acc |= a.w[j];
  return acc == 0;
}

// u = u / 2^k and b = b / 2^k mod p, k the trailing zeros of u's low word
// (31 when that word is 0; the caller loops while u is even). With
// m = -b p^-1 mod 2^k, b + m p is a multiple of 2^k and
// (b + m p) / 2^k < (p + (2^k - 1) p) / 2^k = p, so b stays reduced. The
// sum is held in NW + 1 words: no spare bit of p is assumed.
template <int NW>
__device__ __forceinline__ void halve(Fe<NW>& u, Fe<NW>& b, const FieldConsts<NW>& F) {
  const uint32_t w0 = u.w[0];
  const int k = w0 ? __ffs(w0) - 1 : 31;
#pragma unroll
  for (int j = 0; j < NW - 1; ++j) u.w[j] = __funnelshift_r(u.w[j], u.w[j + 1], k);
  u.w[NW - 1] >>= k;
  const uint32_t m = (b.w[0] * F.inv) & ((1u << k) - 1u);
  uint32_t t[NW + 1];
  uint64_t s = (uint64_t)m * F.p[0] + b.w[0];
  t[0] = (uint32_t)s;
#pragma unroll
  for (int j = 1; j < NW; ++j) {
    s = (uint64_t)m * F.p[j] + b.w[j] + (s >> 32);
    t[j] = (uint32_t)s;
  }
  t[NW] = (uint32_t)(s >> 32);
#pragma unroll
  for (int j = 0; j < NW; ++j) b.w[j] = __funnelshift_r(t[j], t[j + 1], k);
}

// a^-1 for a Montgomery word a = x R < p (0 -> 0): the binary extended GCD
// on u = a, v = p with coefficients b = R^2 mod p, c = 0, which keeps
// u R^2 = b a and v R^2 = c a (mod p). Each iteration subtracts the smaller
// of u and v from the larger (both odd, so the difference is even), the
// coefficients alike mod p, and halves the difference and its coefficient
// until it is odd, many bits a step (halve). It ends at u = 1 with
// b = R^2 / a = x^-1 R, the Montgomery word of the inverse: no product and
// no fix-up. The pair that took the difference becomes (u, b), the smaller
// one (v, c), through selects, so no lane branches on the comparison; u v
// at least halves each iteration, so the loop runs fewer than
// bits(a) + bits(p) times (2 * 32 NW caps it for an input that is not
// reduced). Variable-time, as the reference's inverse is.
//
// Bound on the MSM path (one element): the loop's critical path, through
// the coefficients: fsub_cc (two carry chains of NW and the mask between),
// a select, m (a multiply and a mask), the multiply-add chain of halve (NW)
// and its shift, 3 NW + 5 dependent instructions an iteration; the u, v
// side (a chain of NW, a select, the trailing-zero count, a shift, the test
// for 1) runs beside it. chip_smoke.py counts the iterations with
// zkarray_torch/testing.py's word model of this loop and measures one
// dependent instruction's latency.
template <int NW>
__global__ void __launch_bounds__(128)
mont_inv_kernel(Operand a, int32_t* __restrict__ out, long long n, Fe<NW> r2, FieldConsts<NW> F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<NW> u = load_operand<NW>(a, i);
  if (fe_is_zero<NW>(u)) {
    store16<NW>(out, (size_t)n, (size_t)i, u);
    return;
  }
  Fe<NW> v, b = r2, c = fe_zero<NW>();
#pragma unroll
  for (int j = 0; j < NW; ++j) v.w[j] = F.p[j];
#pragma unroll 1
  for (int s = 0; s <= NW && !(u.w[0] & 1u); ++s) halve<NW>(u, b, F);
#pragma unroll 1
  for (int it = 0; it < 64 * NW && !fe_is_one_word<NW>(u); ++it) {
    Fe<NW> d, e;
    const bool lt = sub_words<NW>(d, u, v) != 0;  // u < v
    sub_words<NW>(e, v, u);
    const Fe<NW> bc = fsub_cc<NW>(b, c, F);  // fsub_cc needs no spare bit
    const Fe<NW> cb = fsub_cc<NW>(c, b, F);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint32_t uj = u.w[j], bj = b.w[j];
      u.w[j] = lt ? e.w[j] : d.w[j];
      b.w[j] = lt ? cb.w[j] : bc.w[j];
      v.w[j] = lt ? uj : v.w[j];
      c.w[j] = lt ? bj : c.w[j];
    }
#pragma unroll 1
    for (int s = 0; s <= NW && !(u.w[0] & 1u); ++s) halve<NW>(u, b, F);
  }
  store16<NW>(out, (size_t)n, (size_t)i, b);
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

// r2: R^2 mod p as NW host words.
extern "C" int zk_mont_inv(const long long* ops, void* out, long long n, const uint32_t* r2,
                           int nw, const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  if (!operands_ok(ops, 1)) return (int)cudaErrorInvalidValue;
  const Operand a = operand_from_host(ops);
  ZK_DISPATCH_NW_FIELD(nw, {
    Fe<NW> r;
    for (int j = 0; j < NW; ++j) r.w[j] = r2[j];
    mont_inv_kernel<NW><<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
        a, (int32_t*)out, n, r, consts_from_host<NW>(consts));
  });
  return (int)cudaGetLastError();
}
