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
// TREE_MAX_WIDTH: one block per row (one (bit, window) of the reduce's (L, q,
// W, m) input). Level 0 reads pairs (i, i + m/2) from device memory and writes
// the ceil(m/2) sums, the odd last element carried, into shared memory as
// packed 32-bit words (192 B a BLS12-381 point, 96 KB for a row of 1,024);
// every later level pairs slot i with i + h in place, an odd level's last slot
// moving to slot h once slot h has been read, with barriers between levels.
// Pairing, carry and select order are _tree_sum_last's and _fadd_core's, so
// the sum's words are the per-level launches'. A level's pairs with a point at
// infinity are copies, made first; only the pairs of two finite points go to
// the warps (tree_level). Each add runs on four lanes of one warp (quad_add):
// lane 8 q + i of a warp is role q of the warp's add i, and each level of
// add-2008-s's independent products runs one product a lane (U1 | U2 | S1 |
// S2, then P'^2 | R^2 | ZZ1 ZZ2 | ZZZ1 ZZZ2, then P' PP | U1 PP | ZZ12 PP,
// then R (Q - X3) | S1 PPP | ZZZ12 PPP), the values a lane needs from another
// passed by warp shuffles; lane q returns coordinate q of the sum. So an add
// is 4 products deep for its warp, where one thread per add ran its 14
// products one after another, and a row's narrow levels (1 to 32 adds) each
// cost one such add. A lane holds a few field elements, not a whole add's, so
// the kernel fits 128 registers: two 256-thread blocks per SM (their shared
// memory 197 KiB of the 228 an H100 SM has), and the reduce's 260 rows of
// 1,024 are one wave on 132 SMs, where 255 registers a thread let one block
// run and took two waves. Every product goes through the one non-inlined copy
// of CallOps (PlainCallOps), as in xyzz_add (inlined, the products ran no
// faster on an H100). Bound: on the wide levels the SM's instruction rate,
// four warps on each of its schedulers running ~855-instruction products; on
// the narrow levels the chain, 4 products an add. Shared rows are laid out
// coordinate word by coordinate word with a row stride whose offset between
// coordinates spreads a quad's four lanes over different banks.
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
#define TREE_QUADS (TREE_THREADS / 4)  // adds a block runs at once
#define FULL_WARP 0xFFFFFFFFu

// Shared words between a row's consecutive coordinate words: the row's slots
// rounded up to 32, plus a pad that puts NW such strides 8 or 24 banks apart,
// so the four lanes of a quad reading four coordinates of one slot hit four
// bank groups.
template <int NW>
__host__ __device__ constexpr int tree_pad() {
  int pad = 1;
  while (pad < 32 && (NW * pad) % 16 != 8) ++pad;
  return pad;
}

template <int NW>
__host__ __device__ inline int tree_ld(int cap) {
  return ((cap + 31) & ~31) + tree_pad<NW>();
}

// Coordinate c of slot k of a shared row: word j at s[(c*NW + j)*ld + k].
template <int NW>
__device__ __forceinline__ void smem_put_coord(uint32_t* s, int ld, int k, int c, const Fe<NW>& v) {
#pragma unroll
  for (int j = 0; j < NW; ++j) s[(c * NW + j) * ld + k] = v.w[j];
}

// Slot k of a shared row, each coordinate read when the add asks for it.
struct SharedPoint {
  const uint32_t* s;
  int ld, k;
  template <int NW>
  __device__ __forceinline__ Fe<NW> get(int c) const {
    Fe<NW> r;
#pragma unroll
    for (int j = 0; j < NW; ++j) r.w[j] = s[(c * NW + j) * ld + k];
    return r;
  }
};

template <int NW>
__device__ __forceinline__ Fe<NW> shfl_fe(const Fe<NW>& a, int src) {
  Fe<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = __shfl_sync(FULL_WARP, a.w[j], src);
  return r;
}

template <int NW>
__device__ __forceinline__ Fe<NW> coord(const Xyzz<NW>& P, int c) {
  return c == 0 ? P.x : c == 1 ? P.y : c == 2 ? P.zz : P.zzz;
}

enum QuadKind { QUAD_NONE, QUAD_INF, QUAD_DBL, QUAD_FULL };

// P + Q for two finite points (add-2008-s with _fadd_core's remaining
// edges: P == Q -> 2P, P == -Q -> inf) on the four lanes i, 8 + i, 16 + i,
// 24 + i of a warp, all 32 lanes calling together; lane 8 q + i returns
// coordinate q. Products run one a lane, level by level; the differences
// and sums between them run on every lane of the quad (only the lanes whose
// role needs them keep them). A quad with ``active`` false reads nothing
// and returns nothing meaningful. Levels no quad of the warp needs are
// skipped.
template <int NW, class Ops, class Pt>
__device__ __forceinline__ Fe<NW> quad_add(const Pt& P, const Pt& Q, bool active,
                                           const FieldConsts<NW>& F) {
  const int lane = threadIdx.x & 31, q = lane >> 3, i = lane & 7;
  int kind = active ? QUAD_FULL : QUAD_NONE;
  Fe<NW> full = fe_zero<NW>();
  if (__any_sync(FULL_WARP, active)) {
    // level 1: P.X Q.ZZ = U1 | Q.X P.ZZ = U2 | P.Y Q.ZZZ = S1 | Q.Y P.ZZZ = S2
    const Pt& A = (q & 1) ? Q : P;
    const Pt& B = (q & 1) ? P : Q;
    const Fe<NW> vA = active ? Ops::mul(A.template get<NW>(q >> 1), B.template get<NW>(2 + (q >> 1)), F)
                             : fe_zero<NW>();
    const Fe<NW> oA = shfl_fe<NW>(vA, lane ^ 8);
    // q = 0, 1: P' = U2 - U1; q = 2, 3: R = S2 - S1
    const Fe<NW> d = (q & 1) ? Ops::sub(vA, oA, F) : Ops::sub(oA, vA, F);
    const Fe<NW> x = shfl_fe<NW>(d, lane ^ 16);
    const bool pd_zero = fe_is_zero<NW>(q < 2 ? d : x), r_zero = fe_is_zero<NW>(q < 2 ? x : d);
    if (active && pd_zero) kind = r_zero ? QUAD_DBL : QUAD_INF;
    if (__any_sync(FULL_WARP, kind == QUAD_FULL)) {
      const Fe<NW> e = q == 1 ? x : d;  // P' on q = 0, R on q = 1
      Fe<NW> a2 = e, b2 = e;  // level 2: P'^2 | R^2 | ZZ1 ZZ2 | ZZZ1 ZZZ2
      if (q >= 2 && kind == QUAD_FULL) {
        a2 = P.template get<NW>(q);
        b2 = Q.template get<NW>(q);
      }
      const Fe<NW> v2 = Ops::mul(a2, b2, F);
      const Fe<NW> pp = shfl_fe<NW>(v2, i);
      const Fe<NW> u1 = shfl_fe<NW>(vA, i);
      // level 3: P' PP = PPP | U1 PP = Q | ZZ12 PP = ZZ3 | (unused)
      const Fe<NW> v3 = Ops::mul(q == 0 ? e : q == 1 ? u1 : v2, pp, F);
      const Fe<NW> ppp = shfl_fe<NW>(v3, i);
      // on q = 1: X3 = R^2 - PPP - 2 Q and Q - X3
      const Fe<NW> x3 = Ops::sub(Ops::sub(v2, ppp, F), Ops::add(v3, v3, F), F);
      const Fe<NW> qx = Ops::sub(v3, x3, F);
      // level 4: R (Q - X3) | S1 PPP | ZZZ12 PPP = ZZZ3 (and unused on q = 0)
      const Fe<NW> v4 = Ops::mul(q == 1 ? e : q == 2 ? vA : v2, q == 1 ? qx : ppp, F);
      const Fe<NW> sp = shfl_fe<NW>(v4, 16 + i);
      const Fe<NW> x3_of_1 = shfl_fe<NW>(x3, 8 + i);
      full = q == 0 ? x3_of_1 : q == 1 ? Ops::sub(v4, sp, F) : q == 2 ? v3 : v4;
    }
  }
  switch (kind) {
    case QUAD_INF: return q < 2 ? fe_one<NW>(F) : fe_zero<NW>();
    case QUAD_DBL: return coord<NW>(xyzz_dbl<NW, Ops>(get_point<NW>(P), F), q);
    default: return full;
  }
}

// One level of the tree: slot k = slot k + slot k + h for k < h, the
// slots read through at(slot) (the row in device memory for level 0, the
// shared row after). First every thread sorts its adds: with Q at infinity
// slot k keeps P (copied in from device memory on level 0), with P at
// infinity Q is copied in, and an add of two finite points goes on the
// level's list. Then the warps' quads run the listed adds only, 8 to a
// warp, so a warp computes products for finite pairs alone however the
// row's points at infinity fall (the reduce's masked rows are half
// infinity, in runs). Results are written in place, slot k only by its
// own add, after every lane of the warp has read its slots.
template <int NW, class Ops, class At>
__device__ __forceinline__ void tree_level(const At& at, bool from_device, uint32_t* row_pts, int ld,
                                           int h, int* list, int* n_full, const FieldConsts<NW>& F) {
  const int lane = threadIdx.x & 31, q = lane >> 3, i = lane & 7, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) *n_full = 0;
  __syncthreads();
  for (int k = threadIdx.x; k < h; k += TREE_THREADS) {
    const auto P = at(k), Q = at(k + h);
    if (fe_is_zero<NW>(Q.template get<NW>(2))) {
      if (from_device)
        for (int c = 0; c < 4; ++c) smem_put_coord<NW>(row_pts, ld, k, c, P.template get<NW>(c));
    } else if (fe_is_zero<NW>(P.template get<NW>(2))) {
      for (int c = 0; c < 4; ++c) smem_put_coord<NW>(row_pts, ld, k, c, Q.template get<NW>(c));
    } else {
      list[atomicAdd(n_full, 1)] = k;
    }
  }
  __syncthreads();
  const int n = *n_full;
  for (int g0 = 8 * warp; g0 < n; g0 += TREE_QUADS) {  // the same rounds on a warp's 32 lanes
    const int g = g0 + i;
    const int k = g < n ? list[g] : 0;
    const Fe<NW> r = quad_add<NW, Ops>(at(k), at(k + h), g < n, F);
    __syncwarp();  // every lane of the warp has read its slots
    if (g < n) smem_put_coord<NW>(row_pts, ld, k, q, r);
  }
}

template <int NW, class Ops>
__global__ void __launch_bounds__(TREE_THREADS, 2)
xyzz_tree_sum_kernel(const __grid_constant__ PointOperands p, int32_t* __restrict__ out,
                     long long rows, int m, const __grid_constant__ FieldConsts<NW> F) {
  extern __shared__ uint32_t row_pts[];
  __shared__ int list[TREE_MAX_WIDTH / 2];
  __shared__ int n_full;
  const long long base = (long long)blockIdx.x * m;
  const int cap = m - m / 2;  // the row's width after level 0
  const int ld = tree_ld<NW>(cap);
  tree_level<NW, Ops>([&](int k) { return DevicePoint{&p, base + k}; }, true, row_pts, ld, m / 2,
                      list, &n_full, F);
  if ((m & 1) && threadIdx.x < 4)  // the odd last point moves to slot m / 2
    smem_put_coord<NW>(row_pts, ld, m / 2, threadIdx.x,
                       DevicePoint{&p, base + m - 1}.template get<NW>(threadIdx.x));
  __syncthreads();
  const auto at = [&](int k) { return SharedPoint{row_pts, ld, k}; };
  for (int w = cap; w > 1; w -= w / 2) {
    const int h = w / 2;
    tree_level<NW, Ops>(at, false, row_pts, ld, h, list, &n_full, F);
    __syncthreads();
    if ((w & 1) && threadIdx.x < 4)  // slot h has been read: the odd last slot moves there
      smem_put_coord<NW>(row_pts, ld, h, threadIdx.x, at(w - 1).template get<NW>(threadIdx.x));
  }
  __syncthreads();
  if (threadIdx.x < 4)
    store16<NW>(out + (size_t)threadIdx.x * 2 * NW * rows, (size_t)rows, (size_t)blockIdx.x,
                at(0).template get<NW>(threadIdx.x));
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
// the widest row's and the carveout to the most shared memory, once.
template <int NW, class Ops>
static int size_tree_sum() {
  static int err = -1;
  if (err < 0) {
    err = (int)cudaFuncSetAttribute(xyzz_tree_sum_kernel<NW, Ops>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    16 * NW * tree_ld<NW>(TREE_MAX_WIDTH - TREE_MAX_WIDTH / 2));
    if (!err)
      err = (int)cudaFuncSetAttribute(xyzz_tree_sum_kernel<NW, Ops>,
                                      cudaFuncAttributePreferredSharedMemoryCarveout,
                                      (int)cudaSharedmemCarveoutMaxShared);
  }
  return err;
}

template <int NW>
static size_t tree_smem(int m) {
  return (size_t)16 * NW * tree_ld<NW>(m - m / 2);
}

template <int NW, class Ops>
static int launch_tree_sum(const PointOperands& p, int32_t* out, long long rows, int m,
                           const FieldConsts<NW>& F, cudaStream_t stream) {
  const int err = size_tree_sum<NW, Ops>();
  if (err) return err;
  xyzz_tree_sum_kernel<NW, Ops><<<(unsigned)rows, TREE_THREADS, tree_smem<NW>(m), stream>>>(
      p, out, rows, m, F);
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

// Resident xyzz_tree_sum blocks per SM at word count nw and row width m
// (plain != 0: the PlainCallOps instantiation), and threads per block.
extern "C" int zk_xyzz_tree_sum_occupancy(int nw, int plain, int m, int* blocks_per_sm,
                                          int* threads_per_block) {
  *threads_per_block = TREE_THREADS;
  if (m < 1 || m > TREE_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  ZK_DISPATCH_NW(nw, {
    const int err = plain ? size_tree_sum<NW, PlainCallOps<NW>>() : size_tree_sum<NW, CallOps<NW>>();
    if (err) return err;
    return (int)(plain ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             blocks_per_sm, xyzz_tree_sum_kernel<NW, PlainCallOps<NW>>,
                             TREE_THREADS, tree_smem<NW>(m))
                       : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             blocks_per_sm, xyzz_tree_sum_kernel<NW, CallOps<NW>>, TREE_THREADS,
                             tree_smem<NW>(m)));
  });
  return 0;
}
