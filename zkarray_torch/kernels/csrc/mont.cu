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
  ZK_DISPATCH_NW(nw, mont_mul_kernel<NW><<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
                          a, b, (int32_t*)out, n, consts_from_host<NW>(consts)));
  return (int)cudaGetLastError();
}

extern "C" int zk_mont_sqr(const long long* ops, void* out, long long n, int nw,
                           const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  if (!operands_ok(ops, 1)) return (int)cudaErrorInvalidValue;
  const Operand a = operand_from_host(ops);
  ZK_DISPATCH_NW(nw, mont_sqr_kernel<NW><<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
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
  ZK_DISPATCH_NW(nw, mont_pow_kernel<NW><<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
                          a, (int32_t*)out, n, e, consts_from_host<NW>(consts)));
  return (int)cudaGetLastError();
}
