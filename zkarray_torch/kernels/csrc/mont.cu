// Element-wise Montgomery product and square on planar 16-bit limbs.
//
// Replaces zkarray/kernels/mont.py:mont_mul and :mont_sqr (Pallas,
// _elementwise_call): one thread per element instead of one (L, 8, 128) VMEM
// block per grid step.
//
// Bound on an H100: bytes. An L = 24 product reads 2 x 96 B and writes 96 B
// per element (16-bit limbs held in int32, twice the bytes of the values) and
// does ~4 NW^2 = 576 32-bit multiply-adds; at 3.35 TB/s and ~16.7 T int32
// ops/s the bytes take longer. Design: limb k of consecutive elements sits at
// consecutive addresses, so each of the 2L loads and L stores of a warp is
// one coalesced 128-byte line; limb pairs are packed into NW = L/2 32-bit
// words in registers and the CIOS runs there.
//
// Operands: input element i, limb k, is read at base[k*ld + i % period]. A
// contiguous tensor has ld = period = n; a slice along the first batch axis
// keeps period = n with a wider ld; a constant broadcast over leading batch
// axes has a smaller period. So neither a slice nor a broadcast constant is
// copied before the launch. The output is contiguous, ld = n.
#include "field.cuh"

struct Operand {
  const int32_t* base;
  long long ld;
  long long period;
};

template <int NW>
__device__ __forceinline__ Fe<NW> load_operand(const Operand& o, long long i) {
  return load16<NW>(o.base, (size_t)o.ld, (size_t)(i < o.period ? i : i % o.period));
}

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

static inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// a, b: int32 limb operands (base, ld, period); out: int32[L, n] contiguous;
// consts: host words (see field.cuh).
extern "C" int zk_mont_mul(const void* a, long long lda, long long pa, const void* b,
                           long long ldb, long long pb, void* out, long long n, int nw,
                           const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  if (pa <= 0 || pb <= 0) return (int)cudaErrorInvalidValue;
  const Operand oa{(const int32_t*)a, lda, pa};
  const Operand ob{(const int32_t*)b, ldb, pb};
  ZK_DISPATCH_NW(nw, mont_mul_kernel<NW><<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
                          oa, ob, (int32_t*)out, n, consts_from_host<NW>(consts)));
  return (int)cudaGetLastError();
}

extern "C" int zk_mont_sqr(const void* a, long long lda, long long pa, void* out, long long n,
                           int nw, const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  if (pa <= 0) return (int)cudaErrorInvalidValue;
  const Operand oa{(const int32_t*)a, lda, pa};
  ZK_DISPATCH_NW(nw, mont_sqr_kernel<NW><<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
                          oa, (int32_t*)out, n, consts_from_host<NW>(consts)));
  return (int)cudaGetLastError();
}
