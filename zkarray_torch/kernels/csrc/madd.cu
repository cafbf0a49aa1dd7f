// Element-wise XYZZ += affine (mixed add) on planar 16-bit limbs.
//
// Replaces zkarray/kernels/sw.py:xyzz_add_affine (Pallas, _madd_core over
// (L, 8, 128) blocks): one thread per point. Select order as _madd_core's:
// A = inf leaves P unchanged (tested here; xyzz_madd takes a finite A); then,
// inside field.cuh:xyzz_madd, P = inf gives (AX, AY, 1, 1), P == -A gives
// infinity and P == A the doubling (infinity when AY = 0). The doubling is
// computed only by the lanes that take that branch.
//
// Bound on an H100: operations. A generic BLS12-381 mixed add is 10
// Montgomery products of 4 NW^2 + 3 NW = 612 32-bit operations plus 7
// additions, ~6,400 operations, against 6 x 96 B read and 4 x 96 B written
// per point: ~7 operations per byte, above the card's ~5. Design:
// - The arithmetic is field.cuh's CallOps: fmul_wide and the carry-chain
//   additions of sw.cu's bucket accumulation, with every product through one
//   non-inlined copy of fmul_wide. Inlined, the kernel was ~20,000
//   instructions, more than the instruction cache holds, and ran at a
//   quarter of its operation bound on an H100; through the call its code
//   (~3,200 instructions) stays cached.
// - A lane that doubles (P == A) runs the doubling beside its warp's
//   generic lanes. Collecting a block's doubling lanes in shared memory and
//   finishing them after a barrier, compacted onto its first threads, was
//   slower on the edge-class feed (1.70 against 1.10 ms for 2^20 points on
//   an H100), so the rare classes stay in place.
// - The kernel is latency-bound, so it wants the most warps its registers
//   allow: 64-thread blocks, 8 resident per SM (16 warps, at most 128
//   registers a thread, which the product's call needs without a spill).
// - Limb k of neighbouring threads sits at neighbouring addresses, so every
//   load and store coalesces.
// - A modulus with its top bit set (secp256k1, secp256r1, secq256k1,
//   secp384r1) cannot take the carry-chain routines (field.cuh:p_fits_cc):
//   the C entry launches the same kernel on PlainCallOps there
//   (ZK_LAUNCH_OPS), the same words through fmul/fadd/fsub.
#include "field.cuh"

#define MADD_THREADS 64
#define MADD_MIN_BLOCKS 8

template <int NW, class Ops>
__global__ void __launch_bounds__(MADD_THREADS, MADD_MIN_BLOCKS)
xyzz_add_affine_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                       const int32_t* __restrict__ pzz, const int32_t* __restrict__ pzzz,
                       const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                       const uint8_t* __restrict__ a_inf, int32_t* __restrict__ ox,
                       int32_t* __restrict__ oy, int32_t* __restrict__ ozz,
                       int32_t* __restrict__ ozzz, long long n,
                       const __grid_constant__ FieldConsts<NW> F) {
  const long long i = (long long)blockIdx.x * MADD_THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t s = (size_t)n, k = (size_t)i;
  Xyzz<NW> P{load16<NW>(px, s, k), load16<NW>(py, s, k), load16<NW>(pzz, s, k),
             load16<NW>(pzzz, s, k)};
  if (!a_inf[i]) xyzz_madd<NW, Ops>(P, load16<NW>(ax, s, k), load16<NW>(ay, s, k), F);
  store16<NW>(ox, s, k, P.x);
  store16<NW>(oy, s, k, P.y);
  store16<NW>(ozz, s, k, P.zz);
  store16<NW>(ozzz, s, k, P.zzz);
}

// px..ay, ox..ozzz: int32[L, n] contiguous; a_inf: bool/uint8[n].
extern "C" int zk_xyzz_add_affine(const void* px, const void* py, const void* pzz,
                                  const void* pzzz, const void* ax, const void* ay,
                                  const void* a_inf, void* ox, void* oy, void* ozz, void* ozzz,
                                  long long n, int nw, const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + MADD_THREADS - 1) / MADD_THREADS);
  ZK_DISPATCH_NW(nw, ZK_LAUNCH_OPS(xyzz_add_affine_kernel, CallOps, PlainCallOps, blocks,
                                   MADD_THREADS, 0, (cudaStream_t)stream>>>(
                          (const int32_t*)px, (const int32_t*)py, (const int32_t*)pzz,
                          (const int32_t*)pzzz, (const int32_t*)ax, (const int32_t*)ay,
                          (const uint8_t*)a_inf, (int32_t*)ox, (int32_t*)oy, (int32_t*)ozz,
                          (int32_t*)ozzz, n, consts_from_host<NW>(consts))));
  return (int)cudaGetLastError();
}
