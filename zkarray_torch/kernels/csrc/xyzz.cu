// Element-wise full XYZZ + XYZZ and XYZZ doubling on planar 16-bit limbs, and
// the MSM reduce's tree sums in one launch per tree.
//
// No Pallas counterpart: these replace the chains of mont_mul/mont_sqr
// launches (zkarray/kernels/mont.py:mont_mul, :mont_sqr, ported in mont.cu)
// and plain field ops that ec/sw.py:xyzz_add and :xyzz_double ran, ~110 and
// ~70 device operations a call, which the JAX package's jitted
// zkarray/ec/sw.py:xyzz_add and :xyzz_double leave XLA to fuse. The MSM's
// bucket reduction (ec/msm.py:_tree_sum_last, _weighted_sum_bits) calls
// xyzz_add for each tree level wider than TREE_MAX_WIDTH and for each
// bit-Horner step, xyzz_double for each bit-Horner step, and xyzz_tree_sum
// once per tree for the levels from TREE_MAX_WIDTH down.
//
// xyzz_add follows _fadd_core's select order through field.cuh:xyzz_add:
// Q = inf -> P, P = inf -> Q, P == Q -> xyzz_dbl(P), P == -Q -> inf. The
// doubling runs only on the lanes that take that branch; an infinity lane
// does no arithmetic. Its arithmetic is field.cuh's CallOps, the doubling
// branch included: fmul_wide and the carry-chain additions (855 SASS
// instructions a product at NW = 12 against fmul's 959), every product
// through one non-inlined copy, so the code a warp runs stays in the
// instruction cache (inlined, the kernel was ~25,000 instructions and ran
// at less than half the speed on an H100). xyzz_double is
// field.cuh:xyzz_dbl (inf or y = 0 -> inf) on PlainOps.
//
// Bound on an H100: operations where the lanes are finite. A generic
// BLS12-381 full add is 14 Montgomery products of 4 NW^2 + 3 NW = 612 32-bit
// operations plus 7 additions, ~8,800 operations, against 8 x 96 B read and
// 4 x 96 B written per point: ~7.7 operations per byte, above the card's ~5.
// Lanes at infinity only move bytes. Design: each coordinate is read where
// the formula first needs it (ZZ and ZZZ again later, from cache), so fewer
// values are live at once and nothing spills; limb k of neighbouring
// threads sits at neighbouring addresses, so every load and store
// coalesces; inputs are read through the strided Operand map, so the tree
// sum's last-axis halves are not copied. A narrow launch is bound instead
// by one add's dependent chain: 4 products deep. The kernels take the
// operand maps and the field constants as __grid_constant__ parameters,
// whose addresses the point readers and the non-inlined product are given.
//
// xyzz_tree_sum runs _tree_sum_last's levels over rows of width m <=
// TREE_MAX_WIDTH: one block per row (one (bit, window) of the reduce's
// (L, q, W, m) input). Level 0 reads pairs (i, i + m/2) from device memory
// and writes the ceil(m/2) sums, the odd last element carried, into shared
// memory as packed 32-bit words (192 B a BLS12-381 point, 96 KB for a row of
// 1,024); every later level pairs slot i with i + h in place, pair 0's
// thread moving an odd level's last slot to slot h after it has read slot
// h, with one barrier between levels. Pairing, carry and select order are
// _tree_sum_last's and _fadd_core's, so the sum's words are the per-level
// launches'. It is bound by its chain: log2(m) levels of one add each
// (level 0 two adds a thread at m = 1,024), 4 products deep, where the
// per-level launches paid a launch and the wrapper's host time per level.
// Its add needs 255 registers, so one 256-thread block runs on an SM: the
// reduce's 260 rows of 1,024 are two waves on an H100's 132 SMs.
//
// A modulus with its top bit set (p >= R/2: secp256k1, secp256r1, secq256k1,
// secp384r1) takes xyzz_add's and xyzz_tree_sum's PlainCallOps instantiation
// (field.cuh:ZK_LAUNCH_OPS): the carry-chain routines need p < R/2, and the
// non-inlined fmul keeps that code in the instruction cache too.
#include "field.cuh"

struct PointOperands {
  Operand c[4];  // X, Y, ZZ, ZZZ
};

static inline PointOperands point_from_host(const long long* d) {
  PointOperands p;
  for (int k = 0; k < 4; ++k) p.c[k] = operand_from_host(d + 4 * k);
  return p;
}

// Element i of an operand set, each coordinate read from device memory when
// xyzz_add asks for it (the four element offsets computed once).
struct DevicePoint {
  const PointOperands* p;  // a __grid_constant__ kernel parameter
  long long off[4];
  __device__ __forceinline__ DevicePoint(const PointOperands* p_, long long i) : p(p_) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const Operand& o = p->c[c];
      off[c] = i < o.inner ? i : (i / o.inner) * o.outer + i % o.inner;
    }
  }
  template <int NW>
  __device__ __forceinline__ Fe<NW> get(int c) const {
    return load16<NW>(p->c[c].base, (size_t)p->c[c].ld, (size_t)off[c]);
  }
};

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

template <int NW, class Ops>
__global__ void __launch_bounds__(128)
xyzz_add_kernel(const __grid_constant__ PointOperands p, const __grid_constant__ PointOperands q,
                int32_t* __restrict__ out, long long n, const __grid_constant__ FieldConsts<NW> F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point<NW>(out, n, i, xyzz_add<NW, Ops>(DevicePoint{&p, i}, DevicePoint{&q, i}, F));
}

template <int NW>
__global__ void __launch_bounds__(128)
xyzz_double_kernel(const __grid_constant__ PointOperands p, int32_t* __restrict__ out, long long n,
                   FieldConsts<NW> F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const DevicePoint P{&p, i};
  store_point<NW>(out, n, i, xyzz_dbl<NW>(get_point<NW>(P), F));
}

#define TREE_THREADS 256
#define TREE_MAX_WIDTH 1024

// Point k of a shared row: word j of coordinate c at s[(c*NW + j)*cap + k],
// so neighbouring threads touch neighbouring banks.
template <int NW>
__device__ __forceinline__ void smem_put(uint32_t* s, int cap, int k, const Xyzz<NW>& P) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    s[j * cap + k] = P.x.w[j];
    s[(NW + j) * cap + k] = P.y.w[j];
    s[(2 * NW + j) * cap + k] = P.zz.w[j];
    s[(3 * NW + j) * cap + k] = P.zzz.w[j];
  }
}

// Slot k of a shared row, each coordinate read when xyzz_add asks for it.
struct SharedPoint {
  const uint32_t* s;
  int cap, k;
  template <int NW>
  __device__ __forceinline__ Fe<NW> get(int c) const {
    Fe<NW> r;
#pragma unroll
    for (int j = 0; j < NW; ++j) r.w[j] = s[(c * NW + j) * cap + k];
    return r;
  }
};

template <int NW, class Ops>
__global__ void __launch_bounds__(TREE_THREADS, 1)
xyzz_tree_sum_kernel(const __grid_constant__ PointOperands p, int32_t* __restrict__ out,
                     long long rows, int m, const __grid_constant__ FieldConsts<NW> F) {
  extern __shared__ uint32_t row_pts[];
  const long long base = (long long)blockIdx.x * m;
  const int cap = m - m / 2;  // the row's width after level 0
  int h = m / 2;
  for (int k = threadIdx.x; k < h; k += TREE_THREADS)
    smem_put<NW>(row_pts, cap, k,
                 xyzz_add<NW, Ops>(DevicePoint{&p, base + k}, DevicePoint{&p, base + k + h}, F));
  if ((m & 1) && threadIdx.x == 0)
    smem_put<NW>(row_pts, cap, h, get_point<NW>(DevicePoint{&p, base + m - 1}));
  __syncthreads();
  for (int w = cap; w > 1; w -= w / 2) {
    h = w / 2;
    for (int k = threadIdx.x; k < h; k += TREE_THREADS) {
      const Xyzz<NW> r =
          xyzz_add<NW, Ops>(SharedPoint{row_pts, cap, k}, SharedPoint{row_pts, cap, k + h}, F);
      if (k == 0 && (w & 1))  // slot h has been read: the odd last slot moves there
        smem_put<NW>(row_pts, cap, h, get_point<NW>(SharedPoint{row_pts, cap, w - 1}));
      smem_put<NW>(row_pts, cap, k, r);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0)
    store_point<NW>(out, rows, blockIdx.x, get_point<NW>(SharedPoint{row_pts, cap, 0}));
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
  ZK_DISPATCH_NW(nw, ZK_LAUNCH_OPS(xyzz_add_kernel, CallOps, PlainCallOps, blocks_for(n, 128),
                                   128, 0, (cudaStream_t)stream>>>(p, q, (int32_t*)out, n,
                                                                   consts_from_host<NW>(consts))));
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

// One instantiation of the tree sum: its dynamic shared memory raised to
// the largest row's once, then the launch.
template <int NW, class Ops>
static int launch_tree_sum(const PointOperands& p, int32_t* out, long long rows, int m,
                           const FieldConsts<NW>& F, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const int err = (int)cudaFuncSetAttribute(xyzz_tree_sum_kernel<NW, Ops>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              16 * NW * (TREE_MAX_WIDTH - TREE_MAX_WIDTH / 2));
    if (err) return err;
    sized = true;
  }
  const size_t smem = (size_t)16 * NW * (m - m / 2);
  xyzz_tree_sum_kernel<NW, Ops><<<(unsigned)rows, TREE_THREADS, smem, stream>>>(p, out, rows, m, F);
  return 0;
}

// ops: host descriptors of P's X, Y, ZZ, ZZZ, each (L, rows * m) row-major
// with the tree axis last; out: int32[4, L, rows] contiguous, each row's sum.
extern "C" int zk_xyzz_tree_sum(const long long* ops, void* out, long long rows, int m, int nw,
                                const uint32_t* consts, void* stream) {
  if (rows <= 0) return 0;
  if (m < 1 || m > TREE_MAX_WIDTH || rows > 0x7FFFFFFFLL || !operands_ok(ops, 4))
    return (int)cudaErrorInvalidValue;
  const PointOperands p = point_from_host(ops);
  ZK_DISPATCH_NW(nw, {
    const FieldConsts<NW> F = consts_from_host<NW>(consts);
    const int err = p_fits_cc(consts, nw)
                        ? launch_tree_sum<NW, CallOps<NW>>(p, (int32_t*)out, rows, m, F,
                                                           (cudaStream_t)stream)
                        : launch_tree_sum<NW, PlainCallOps<NW>>(p, (int32_t*)out, rows, m, F,
                                                            (cudaStream_t)stream);
    if (err) return err;
  });
  return (int)cudaGetLastError();
}
