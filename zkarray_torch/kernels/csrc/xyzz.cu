// Element-wise full XYZZ + XYZZ and XYZZ doubling on planar 16-bit limbs.
//
// No Pallas counterpart: these replace the chains of mont_mul/mont_sqr
// launches (zkarray/kernels/mont.py:mont_mul, :mont_sqr, ported in mont.cu)
// and plain field ops that ec/sw.py:xyzz_add and :xyzz_double ran, ~110 and
// ~70 device operations a call, which the JAX package's jitted
// zkarray/ec/sw.py:xyzz_add and :xyzz_double leave XLA to fuse. The MSM's
// bucket reduction (ec/msm.py:_tree_sum_last, _weighted_sum_bits) calls them
// once per tree level and per bit-Horner step, so each call is now one launch.
//
// xyzz_add follows _fadd_core's select order through field.cuh:xyzz_add:
// Q = inf -> P, P = inf -> Q, P == Q -> xyzz_dbl(P), P == -Q -> inf. The
// doubling runs only on the lanes that take that branch; an infinity lane
// does no arithmetic. xyzz_double is field.cuh:xyzz_dbl (inf or y = 0 -> inf).
//
// Bound on an H100: operations where the lanes are finite. A generic
// BLS12-381 full add is 14 Montgomery products of 4 NW^2 + 3 NW = 612 32-bit
// operations plus 7 additions, ~8,800 operations, against 8 x 96 B read and
// 4 x 96 B written per point: ~7.7 operations per byte, above the card's ~5.
// Lanes at infinity only move bytes. Design: the two points stay in
// registers for the whole formula, so device memory sees each coordinate
// once; limb k of neighbouring threads sits at neighbouring addresses, so
// every load and store coalesces; inputs are read through the strided
// Operand map, so the tree sum's last-axis halves are not copied.
#include "field.cuh"

struct PointOperands {
  Operand c[4];  // X, Y, ZZ, ZZZ
};

static inline PointOperands point_from_host(const long long* d) {
  PointOperands p;
  for (int k = 0; k < 4; ++k) p.c[k] = operand_from_host(d + 4 * k);
  return p;
}

template <int NW>
__device__ __forceinline__ Xyzz<NW> load_point(const PointOperands& p, long long i) {
  return Xyzz<NW>{load_operand<NW>(p.c[0], i), load_operand<NW>(p.c[1], i),
                  load_operand<NW>(p.c[2], i), load_operand<NW>(p.c[3], i)};
}

// out: int32[4, L, n] contiguous, coordinate-major.
template <int NW>
__device__ __forceinline__ void store_point(int32_t* out, long long n, long long i,
                                            const Xyzz<NW>& P) {
  const size_t s = (size_t)n, k = (size_t)i, c = (size_t)(2 * NW) * s;
  store16<NW>(out, s, k, P.x);
  store16<NW>(out + c, s, k, P.y);
  store16<NW>(out + 2 * c, s, k, P.zz);
  store16<NW>(out + 3 * c, s, k, P.zzz);
}

template <int NW>
__global__ void __launch_bounds__(128)
xyzz_add_kernel(PointOperands p, PointOperands q, int32_t* __restrict__ out, long long n,
                FieldConsts<NW> F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point<NW>(out, n, i, xyzz_add<NW>(load_point<NW>(p, i), load_point<NW>(q, i), F));
}

template <int NW>
__global__ void __launch_bounds__(128)
xyzz_double_kernel(PointOperands p, int32_t* __restrict__ out, long long n, FieldConsts<NW> F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point<NW>(out, n, i, xyzz_dbl<NW>(load_point<NW>(p, i), F));
}

static inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// ops: host descriptors (pointer, ld, inner, outer) of P's X, Y, ZZ, ZZZ, then
// Q's; out: int32[4, L, n] contiguous; consts: host words (see field.cuh).
extern "C" int zk_xyzz_add(const long long* ops, void* out, long long n, int nw,
                           const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  if (!operands_ok(ops, 8)) return (int)cudaErrorInvalidValue;
  const PointOperands p = point_from_host(ops), q = point_from_host(ops + 16);
  ZK_DISPATCH_NW(nw, xyzz_add_kernel<NW><<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
                          p, q, (int32_t*)out, n, consts_from_host<NW>(consts)));
  return (int)cudaGetLastError();
}

extern "C" int zk_xyzz_double(const long long* ops, void* out, long long n, int nw,
                              const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  if (!operands_ok(ops, 4)) return (int)cudaErrorInvalidValue;
  const PointOperands p = point_from_host(ops);
  ZK_DISPATCH_NW(nw, xyzz_double_kernel<NW><<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
                          p, (int32_t*)out, n, consts_from_host<NW>(consts)));
  return (int)cudaGetLastError();
}
