// MSM bucket accumulation and window Horner, XYZZ coordinates.
//
// xyzz_accum replaces zkarray/kernels/sw.py:xyzz_accum_grid and
// :xyzz_accum_tiles (Pallas): R sequential bucket rounds, round r adding to
// every bucket slot its r-th sorted point with _madd_core's edge selects.
// Bound on an H100: operations. A BLS12-381 mixed add is ~10 Montgomery
// products of ~4 NW^2 = 576 32-bit multiply-adds against 96 B of point feed,
// ~60 operations per byte. Design: one thread per bucket slot; the slot's
// XYZZ state (4 x NW words) stays in registers across all R rounds, which
// takes the place of the TPU kernel's VMEM residency, so device memory sees
// only the streamed feed. Feed word k of round r for slot s sits at
// coords[(k*R + r)*S + s]: neighbouring threads read neighbouring words. The
// doubling candidate sits under a per-thread branch (the TPU kernel's
// block-level lax.cond), and an invalid slot skips its round.
//
// horner_windows replaces zkarray/kernels/sw.py:horner_windows: total =
// sum_w 2^(c w) win_w, c doublings and one full add per window. It is a
// serial chain of ~c W point operations, bound by the latency of one thread,
// not by bytes or throughput; one thread walks it, as the reference does.
#include "field.cuh"

template <int NW>
__global__ void __launch_bounds__(64)
xyzz_accum_kernel(const int32_t* __restrict__ st_in, int32_t* __restrict__ st_out,
                  const int32_t* __restrict__ coords, const int32_t* __restrict__ valid,
                  int R, long long S, FieldConsts<NW> F) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const size_t n = (size_t)S;
  Xyzz<NW> P;
  P.x = load32<NW>(st_in, n, (size_t)s);
  P.y = load32<NW>(st_in + (size_t)NW * n, n, (size_t)s);
  P.zz = load32<NW>(st_in + (size_t)2 * NW * n, n, (size_t)s);
  P.zzz = load32<NW>(st_in + (size_t)3 * NW * n, n, (size_t)s);
  const size_t rs = (size_t)R * n;
  for (int r = 0; r < R; ++r) {
    const int v = valid[(size_t)r * n + s];
    if (!(v & 1)) continue;  // no point this round: bucket unchanged
    const Fe<NW> AX = load32<NW>(coords + (size_t)r * n, rs, (size_t)s);
    Fe<NW> AY = load32<NW>(coords + ((size_t)NW * R + r) * n, rs, (size_t)s);
    if (v & 2) AY = fsub<NW>(fe_zero<NW>(), AY, F);  // negative digit: -y (0 stays 0)
    xyzz_madd<NW>(P, AX, AY, F);
  }
  store32<NW>(st_out, n, (size_t)s, P.x);
  store32<NW>(st_out + (size_t)NW * n, n, (size_t)s, P.y);
  store32<NW>(st_out + (size_t)2 * NW * n, n, (size_t)s, P.zz);
  store32<NW>(st_out + (size_t)3 * NW * n, n, (size_t)s, P.zzz);
}

// win: int32[W, 4L] 16-bit limbs (X | Y | ZZ | ZZZ per window); out: int32[4L].
template <int NW>
__device__ __forceinline__ Xyzz<NW> load_window(const int32_t* win, int w) {
  const int32_t* b = win + (size_t)w * 8 * NW;
  return Xyzz<NW>{load16<NW>(b, 1, 0), load16<NW>(b + 2 * NW, 1, 0),
                  load16<NW>(b + 4 * NW, 1, 0), load16<NW>(b + 6 * NW, 1, 0)};
}

template <int NW>
__global__ void __launch_bounds__(32)
horner_windows_kernel(const int32_t* __restrict__ win, int32_t* __restrict__ out, int W, int c,
                      FieldConsts<NW> F) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  Xyzz<NW> st = load_window<NW>(win, W - 1);
  for (int wi = W - 2; wi >= 0; --wi) {
    for (int k = 0; k < c; ++k) st = xyzz_dbl<NW>(st, F);
    st = xyzz_add<NW>(st, load_window<NW>(win, wi), F);
  }
  store16<NW>(out, 1, 0, st.x);
  store16<NW>(out + 2 * NW, 1, 0, st.y);
  store16<NW>(out + 4 * NW, 1, 0, st.zz);
  store16<NW>(out + 6 * NW, 1, 0, st.zzz);
}

// st_in, st_out: int32[2L, S] packed words; coords: int32[L, R, S]; valid: int32[R, S].
extern "C" int zk_xyzz_accum(const void* st_in, void* st_out, const void* coords,
                             const void* valid, int R, long long S, int nw,
                             const uint32_t* consts, void* stream) {
  if (S <= 0) return 0;
  const unsigned blocks = (unsigned)((S + 63) / 64);
  ZK_DISPATCH_NW(nw, xyzz_accum_kernel<NW><<<blocks, 64, 0, (cudaStream_t)stream>>>(
                         (const int32_t*)st_in, (int32_t*)st_out, (const int32_t*)coords,
                         (const int32_t*)valid, R, S, consts_from_host<NW>(consts)));
  return (int)cudaGetLastError();
}

extern "C" int zk_horner_windows(const void* win, void* out, int W, int c, int nw,
                                 const uint32_t* consts, void* stream) {
  if (W <= 0) return (int)cudaErrorInvalidValue;
  ZK_DISPATCH_NW(nw, horner_windows_kernel<NW><<<1, 32, 0, (cudaStream_t)stream>>>(
                         (const int32_t*)win, (int32_t*)out, W, c,
                         consts_from_host<NW>(consts)));
  return (int)cudaGetLastError();
}
