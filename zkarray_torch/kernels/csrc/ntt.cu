// Radix-2 NTT butterflies on planar 16-bit limbs.
//
// butterfly_dit replaces zkarray/kernels/mont.py:butterfly_dit_inplace
// (Pallas): one in-place DIT stage over x int32[L, C, 2, H, R], pair (c, h, r)
// -> (lo + hi*w_h, lo - hi*w_h) written back to the same two positions. The
// TPU kernel took the stage twiddles broadcast across 128 lanes, (L, H, 128),
// and needed H % 8 == 0 and R % 128 == 0 ((8, 128) tiling); here the stage
// twiddle w_h is column h*stride of the power table tw int32[L, T] (what
// _fft_core slices as tw[:, ::n/m]), read in place, and any C, H, R is taken,
// so every stage of the ladder runs here, the narrow ones (H = 1, 2, 4)
// included.
//
// butterfly_stage replaces zkarray/kernels/mont.py:butterfly_stage: the DIF
// butterfly (lo, hi, w) -> (lo + hi, (lo - hi)*w), element-wise.
//
// Bound on an H100: bytes. A BLS12-381 Fr stage (L = 16) reads and writes
// 2 x 64 B per pair (16-bit limbs held in int32) for one 8-word CIOS product
// and an add and a sub, ~330 32-bit operations: ~2.6 operations per byte,
// far below the card's ~5 int32 operations per byte of memory bandwidth.
// Design: one thread per pair (per element for butterfly_stage); limb k of
// neighbouring threads sits at neighbouring addresses, so loads and stores
// coalesce whenever R or H is at least a warp wide; a stage's H twiddles are
// few and shared by the R threads of a row, so they are served from L1/L2.
// Offsets are 64-bit: one 2^24-element Fr array is 2^28 int32 words.
#include "field.cuh"

template <int NW>
__global__ void __launch_bounds__(256)
butterfly_dit_kernel(int32_t* __restrict__ x, const int32_t* __restrict__ tw, unsigned H,
                     unsigned R, unsigned pairs, long long tw_len, long long stride,
                     FieldConsts<NW> F) {
  const unsigned q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= pairs) return;
  const unsigned r = q % R;
  const unsigned row = q / R;
  const unsigned h = row % H;
  const unsigned c = row / H;
  const size_t n = (size_t)pairs * 2;  // elements per limb
  const size_t lo = ((size_t)c * 2 * H + h) * R + r;
  const size_t hi = lo + (size_t)H * R;
  const Fe<NW> a = load16<NW>(x, n, lo);
  const Fe<NW> b = load16<NW>(x, n, hi);
  const Fe<NW> w = load16<NW>(tw, (size_t)tw_len, (size_t)h * (size_t)stride);
  const Fe<NW> t = fmul<NW>(b, w, F);
  store16<NW>(x, n, lo, fadd<NW>(a, t, F));
  store16<NW>(x, n, hi, fsub<NW>(a, t, F));
}

template <int NW>
__global__ void __launch_bounds__(256)
butterfly_stage_kernel(const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
                       const int32_t* __restrict__ w, int32_t* __restrict__ out_a,
                       int32_t* __restrict__ out_b, long long n, FieldConsts<NW> F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe<NW> a = load16<NW>(lo, (size_t)n, (size_t)i);
  const Fe<NW> b = load16<NW>(hi, (size_t)n, (size_t)i);
  const Fe<NW> t = load16<NW>(w, (size_t)n, (size_t)i);
  store16<NW>(out_a, (size_t)n, (size_t)i, fadd<NW>(a, b, F));
  store16<NW>(out_b, (size_t)n, (size_t)i, fmul<NW>(fsub<NW>(a, b, F), t, F));
}

// x: int32[L, C, 2, H, R] contiguous, updated in place; tw: int32[L, tw_len]
// contiguous, stage twiddle h at column h*stride (the wrapper checks
// (H-1)*stride < tw_len and C*H*R < 2^31).
extern "C" int zk_butterfly_dit(void* x, const void* tw, long long C, long long H, long long R,
                                long long tw_len, long long stride, int nw,
                                const uint32_t* consts, void* stream) {
  const long long pairs = C * H * R;
  if (pairs <= 0) return 0;
  if (pairs >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((pairs + 255) / 256);
  ZK_DISPATCH_NW(nw, butterfly_dit_kernel<NW><<<blocks, 256, 0, (cudaStream_t)stream>>>(
                          (int32_t*)x, (const int32_t*)tw, (unsigned)H, (unsigned)R,
                          (unsigned)pairs, tw_len, stride, consts_from_host<NW>(consts)));
  return (int)cudaGetLastError();
}

// lo, hi, w, out_a, out_b: int32[L, n] contiguous.
extern "C" int zk_butterfly_stage(const void* lo, const void* hi, const void* w, void* out_a,
                                  void* out_b, long long n, int nw, const uint32_t* consts,
                                  void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  ZK_DISPATCH_NW(nw, butterfly_stage_kernel<NW><<<blocks, 256, 0, (cudaStream_t)stream>>>(
                          (const int32_t*)lo, (const int32_t*)hi, (const int32_t*)w,
                          (int32_t*)out_a, (int32_t*)out_b, n, consts_from_host<NW>(consts)));
  return (int)cudaGetLastError();
}
