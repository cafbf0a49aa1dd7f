// Element-wise XYZZ += affine (mixed add) on planar 16-bit limbs.
//
// Replaces zkarray/kernels/sw.py:xyzz_add_affine (Pallas, _madd_core over
// (L, 8, 128) blocks): one thread per point. Select order as _madd_core's:
// A = inf leaves P unchanged and is tested first (xyzz_madd assumes a finite
// A); then, inside xyzz_madd, P = inf gives (AX, AY, 1, 1), P == -A gives
// infinity and P == A the doubling (infinity when AY = 0). The doubling
// candidate is computed only on that branch, per thread, where the TPU
// kernel computed it for every lane.
//
// Bound on an H100: operations. A BLS12-381 mixed add is 10 Montgomery
// products of 4 NW^2 + 3 NW = 612 32-bit operations plus 7 additions,
// ~6,400 operations, against 6 x 96 B read and 4 x 96 B written per point:
// ~7 operations per byte, above the card's ~5. Design: the point stays in
// registers; limb k of neighbouring threads sits at neighbouring addresses,
// so every load and store coalesces.
#include "field.cuh"

template <int NW>
__global__ void __launch_bounds__(128)
xyzz_add_affine_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                       const int32_t* __restrict__ pzz, const int32_t* __restrict__ pzzz,
                       const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                       const uint8_t* __restrict__ a_inf, int32_t* __restrict__ ox,
                       int32_t* __restrict__ oy, int32_t* __restrict__ ozz,
                       int32_t* __restrict__ ozzz, long long n, FieldConsts<NW> F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t s = (size_t)n, k = (size_t)i;
  Xyzz<NW> P{load16<NW>(px, s, k), load16<NW>(py, s, k), load16<NW>(pzz, s, k),
             load16<NW>(pzzz, s, k)};
  if (!a_inf[i]) xyzz_madd<NW>(P, load16<NW>(ax, s, k), load16<NW>(ay, s, k), F);
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
  const unsigned blocks = (unsigned)((n + 127) / 128);
  ZK_DISPATCH_NW(nw, xyzz_add_affine_kernel<NW><<<blocks, 128, 0, (cudaStream_t)stream>>>(
                          (const int32_t*)px, (const int32_t*)py, (const int32_t*)pzz,
                          (const int32_t*)pzzz, (const int32_t*)ax, (const int32_t*)ay,
                          (const uint8_t*)a_inf, (int32_t*)ox, (int32_t*)oy, (int32_t*)ozz,
                          (int32_t*)ozzz, n, consts_from_host<NW>(consts)));
  return (int)cudaGetLastError();
}
