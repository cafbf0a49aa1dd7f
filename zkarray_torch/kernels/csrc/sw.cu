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
// The arithmetic is field.cuh's WideOps: fmul_wide (64-bit partial products,
// column sums on the carry flag) and additions whose add-back of p is a
// mask, not a branch. Round r + 1's feed words and valid word are copied into
// shared memory (cp.async, two buffers per thread) while round r computes,
// so no round waits on its loads and the copies cost no registers. The
// kernel is latency-bound, so it wants the most warps its registers allow:
// 64-thread blocks, 6 resident per SM (12 warps, 3 on each of an SM's four
// register files of 16,384, so at most 168 registers a thread, a small
// spill). Fewer warps with no spill and more warps with a larger spill were
// both slower on the H100. Band 1 of the 2^20 MSM (81,920 slots) is then
// 1.62 waves of 50,688 threads.
//
// horner_windows replaces zkarray/kernels/sw.py:horner_windows: total =
// sum_w 2^(c w) win_w, c doublings and one full add per window. It is a
// serial chain of c (W - 1) doublings (9 products, 3 deep) and W - 1 full adds
// (14 products, 4 deep), bound by the latency of its critical path, not by
// bytes or throughput: 3 products deep per doubling and 4 per add, 817 at
// W = 20, c = 13. Design: one warp; the chain's values sit in shared memory
// and each level of a doubling or an add runs its independent products on
// separate lanes, the additions between levels on lane 0. Every product
// goes through one non-inlined copy of fmul_wide (chain_mul), so the code
// the chain runs is a few thousand instructions and stays in the
// instruction cache, where a one-thread chain of inlined formulas was tens
// of thousands. (A rolled product loop, tried for the same reason, had a
// longer latency than the unrolled product.) The edge branches (infinity,
// P == Q, P == -Q) read shared values and are uniform across the warp.
//
// xyzz_bit_horner has no Pallas counterpart: it replaces the bit-Horner of
// ec/msm.py:_weighted_sum_bits (zkarray/ec/msm.py:_weighted_sum_bits, the
// loop over xyzz_double and xyzz_add), which the port ran as one
// xyzz_double and one xyzz_add launch per weight bit (24 launches at
// 13 bits), each 20 threads wide and bound by the host's launch time. Per
// window w it computes acc = parts[nbits - 1], then acc = 2 acc + parts[k]
// for k = nbits - 2 .. 0, with _dbl_core's and _fadd_core's edges. Each
// window is a serial chain of (nbits - 1) doublings (3 products deep) and
// full adds (4 deep): 84 products at 13 bits, bound by their latency, as
// horner_windows is. Design: horner_windows' chain, unchanged, one warp
// (one block) per window, so the W chains run side by side on W SMs in
// one launch.
//
// The carry-chain routines (WideOps) need p < R/2. A modulus with its top bit
// set (secp256k1, secp256r1, secq256k1, secp384r1) takes each kernel's
// PlainOps instantiation instead (fmul, fadd, fsub: the same words, every
// result fully reduced); the C entries pick it from p's top word.
#include "field.cuh"

#define ACCUM_THREADS 64
#define ACCUM_MIN_BLOCKS 6

__device__ __forceinline__ void cp_async4(uint32_t* smem, const int32_t* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int NW, class Ops>
__global__ void __launch_bounds__(ACCUM_THREADS, ACCUM_MIN_BLOCKS)
xyzz_accum_kernel(const int32_t* __restrict__ st_in, int32_t* __restrict__ st_out,
                  const int32_t* __restrict__ coords, const int32_t* __restrict__ valid,
                  int R, long long S, FieldConsts<NW> F) {
  // feed[b][k][thread]: word k (x | y | valid) of the round in buffer b
  __shared__ uint32_t feed[2][2 * NW + 1][ACCUM_THREADS];
  const int tid = threadIdx.x;
  const long long s = (long long)blockIdx.x * ACCUM_THREADS + tid;
  if (s >= S) return;
  const size_t n = (size_t)S;
  const size_t rs = (size_t)R * n;
  auto fetch = [&](int r, int b) {
    const int32_t* src = coords + (size_t)r * n + (size_t)s;
#pragma unroll
    for (int k = 0; k < 2 * NW; ++k, src += rs) cp_async4(&feed[b][k][tid], src);
    cp_async4(&feed[b][2 * NW][tid], valid + (size_t)r * n + (size_t)s);
    cp_async_commit();
  };
  fetch(0, 0);
  Xyzz<NW> P;
  P.x = load32<NW>(st_in, n, (size_t)s);
  P.y = load32<NW>(st_in + (size_t)NW * n, n, (size_t)s);
  P.zz = load32<NW>(st_in + (size_t)2 * NW * n, n, (size_t)s);
  P.zzz = load32<NW>(st_in + (size_t)3 * NW * n, n, (size_t)s);
  for (int r = 0; r < R; ++r) {
    const int b = r & 1;
    if (r + 1 < R) {
      fetch(r + 1, b ^ 1);
      cp_async_wait<1>();  // round r's group has landed; r + 1's is in flight
    } else {
      cp_async_wait<0>();
    }
    const uint32_t v = feed[b][2 * NW][tid];
    if (!(v & 1)) continue;  // no point this round: bucket unchanged
    Fe<NW> AX, AY;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      AX.w[j] = feed[b][j][tid];
      AY.w[j] = feed[b][NW + j][tid];
    }
    if (v & 2) AY = Ops::sub(fe_zero<NW>(), AY, F);  // negative digit: -y (0 stays 0)
    xyzz_madd<NW, Ops>(P, AX, AY, F);
  }
  store32<NW>(st_out, n, (size_t)s, P.x);
  store32<NW>(st_out + (size_t)NW * n, n, (size_t)s, P.y);
  store32<NW>(st_out + (size_t)2 * NW * n, n, (size_t)s, P.zz);
  store32<NW>(st_out + (size_t)3 * NW * n, n, (size_t)s, P.zzz);
}

// ---- window Horner as a cooperative chain ------------------------------------

// Shared slots of the chain, NW words each: the running sum P, the window
// point Q, the constants, and each formula's intermediates.
enum ChainSlot {
  PX, PY, PZZ, PZZZ, QX, QY, QZZ, QZZZ, ONE, ZERO, ACOEF,
  // doubling
  DU, DV, DXX, DZSQ, DAZ, DM, DW, DS, DZZ3, DMM, DX3, DSX, DT, DWY, DZZZ3, DY3,
  // full add
  AU1, AU2, AS1, AS2, APD, AR, APP, ARR, AZZ12, AZZZ12, APPP, AQ, AZZ3, AX3, AQX, AT, ASP,
  AZZZ3, AY3,
  NSLOT
};

template <int NW>
struct ChainSmem {
  uint32_t v[NSLOT][NW];
  uint32_t p[NW];
  uint32_t inv;
};

template <int NW>
__device__ __forceinline__ Fe<NW> ld(const ChainSmem<NW>* sh, int k) {
  Fe<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = sh->v[k][j];
  return r;
}

template <int NW>
__device__ __forceinline__ void st(ChainSmem<NW>* sh, int k, const Fe<NW>& x) {
#pragma unroll
  for (int j = 0; j < NW; ++j) sh->v[k][j] = x.w[j];
}

// One product of a level: slot d = slot a * slot b. The chain's only copy of
// the product code (not inlined), so every level runs the same instructions.
template <int NW, class Ops>
__device__ __noinline__ void chain_mul(ChainSmem<NW>* sh, uint32_t code) {
  FieldConsts<NW> F;
#pragma unroll
  for (int j = 0; j < NW; ++j) F.p[j] = sh->p[j];
  F.inv = sh->inv;
  const int d = code & 0xFF, a = (code >> 8) & 0xFF, b = (code >> 16) & 0xFF;
  st<NW>(sh, d, Ops::mul(ld<NW>(sh, a), ld<NW>(sh, b), F));
}

// A product for one lane of a level: d = a * b (nonzero code).
__host__ __device__ constexpr uint32_t mul(int d, int a, int b) {
  return (uint32_t)d | ((uint32_t)a << 8) | ((uint32_t)b << 16) | (1u << 24);
}

// One level of independent products: lane k < 4 runs product k, then the
// warp meets.
template <int NW, class Ops>
__device__ __forceinline__ void products(ChainSmem<NW>* sh, uint32_t o0, uint32_t o1 = 0,
                                         uint32_t o2 = 0, uint32_t o3 = 0) {
  const int lane = threadIdx.x;
  const uint32_t code = lane == 0 ? o0 : lane == 1 ? o1 : lane == 2 ? o2 : lane == 3 ? o3 : 0;
  if (code) chain_mul<NW, Ops>(sh, code);
  __syncwarp();
}

template <int NW>
__device__ __forceinline__ bool slot_is_zero(const ChainSmem<NW>* sh, int k) {
  return fe_is_zero<NW>(ld<NW>(sh, k));
}

// Slots dst..dst+3 = s0, s1, s2, s3 (word-parallel over the warp).
template <int NW>
__device__ __forceinline__ void set_point(ChainSmem<NW>* sh, int dst, int s0, int s1, int s2, int s3) {
  __syncwarp();
  const int lane = threadIdx.x;
  const int src[4] = {s0, s1, s2, s3};
  uint32_t w[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = lane + 32 * i;
    w[i] = k < 4 * NW ? sh->v[src[k / NW]][k % NW] : 0;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = lane + 32 * i;
    if (k < 4 * NW) sh->v[dst + k / NW][k % NW] = w[i];
  }
  __syncwarp();
}

template <int NW>
__device__ __forceinline__ void set_inf(ChainSmem<NW>* sh) {
  set_point<NW>(sh, PX, ONE, ONE, ZERO, ZERO);
}

// P = 2P (dbl-2008-s-1, _dbl_core): inf or y == 0 -> inf. Products run a
// level at a time across lanes; the additions between them run on lane 0.
template <int NW, class Ops>
__device__ __forceinline__ void chain_dbl(ChainSmem<NW>* sh, const FieldConsts<NW>& F) {
  if (slot_is_zero<NW>(sh, PZZ) || slot_is_zero<NW>(sh, PY)) {
    set_inf<NW>(sh);
    return;
  }
  const bool lead = threadIdx.x == 0;
  if (lead) {
    const Fe<NW> y = ld<NW>(sh, PY);
    st<NW>(sh, DU, Ops::add(y, y, F));
  }
  __syncwarp();
  if (F.a_is_zero) {
    products<NW, Ops>(sh, mul(DV, DU, DU), mul(DXX, PX, PX));
    if (lead) {
      const Fe<NW> xx = ld<NW>(sh, DXX);
      st<NW>(sh, DM, Ops::add(Ops::add(xx, xx, F), xx, F));
    }
    __syncwarp();
    products<NW, Ops>(sh, mul(DW, DU, DV), mul(DS, PX, DV), mul(DZZ3, DV, PZZ), mul(DMM, DM, DM));
  } else {  // M = 3 XX + a ZZ^2
    products<NW, Ops>(sh, mul(DV, DU, DU), mul(DXX, PX, PX), mul(DZSQ, PZZ, PZZ));
    products<NW, Ops>(sh, mul(DAZ, ACOEF, DZSQ), mul(DW, DU, DV), mul(DS, PX, DV),
                      mul(DZZ3, DV, PZZ));
    if (lead) {
      const Fe<NW> xx = ld<NW>(sh, DXX);
      st<NW>(sh, DM, Ops::add(Ops::add(Ops::add(xx, xx, F), xx, F), ld<NW>(sh, DAZ), F));
    }
    __syncwarp();
    products<NW, Ops>(sh, mul(DMM, DM, DM));
  }
  if (lead) {
    const Fe<NW> s = ld<NW>(sh, DS);
    const Fe<NW> x3 = Ops::sub(ld<NW>(sh, DMM), Ops::add(s, s, F), F);
    st<NW>(sh, DX3, x3);
    st<NW>(sh, DSX, Ops::sub(s, x3, F));
  }
  __syncwarp();
  products<NW, Ops>(sh, mul(DT, DM, DSX), mul(DWY, DW, PY), mul(DZZZ3, DW, PZZZ));
  if (lead) st<NW>(sh, DY3, Ops::sub(ld<NW>(sh, DT), ld<NW>(sh, DWY), F));
  set_point<NW>(sh, PX, DX3, DY3, DZZ3, DZZZ3);
}

// P = P + Q (add-2008-s, _fadd_core): Q = inf -> P; P = inf -> Q;
// P == Q -> 2P; P == -Q -> inf.
template <int NW, class Ops>
__device__ __forceinline__ void chain_add(ChainSmem<NW>* sh, const FieldConsts<NW>& F) {
  if (slot_is_zero<NW>(sh, QZZ)) return;
  if (slot_is_zero<NW>(sh, PZZ)) {
    set_point<NW>(sh, PX, QX, QY, QZZ, QZZZ);
    return;
  }
  const int lane = threadIdx.x;
  products<NW, Ops>(sh, mul(AU1, PX, QZZ), mul(AU2, QX, PZZ), mul(AS1, PY, QZZZ),
                    mul(AS2, QY, PZZZ));
  if (lane < 2)  // P' = U2 - U1 on lane 0, R = S2 - S1 on lane 1
    st<NW>(sh, lane ? AR : APD,
           Ops::sub(ld<NW>(sh, lane ? AS2 : AU2), ld<NW>(sh, lane ? AS1 : AU1), F));
  __syncwarp();
  if (slot_is_zero<NW>(sh, APD)) {
    if (slot_is_zero<NW>(sh, AR))
      chain_dbl<NW, Ops>(sh, F);
    else
      set_inf<NW>(sh);
    return;
  }
  products<NW, Ops>(sh, mul(APP, APD, APD), mul(ARR, AR, AR), mul(AZZ12, PZZ, QZZ),
                    mul(AZZZ12, PZZZ, QZZZ));
  products<NW, Ops>(sh, mul(APPP, APD, APP), mul(AQ, AU1, APP), mul(AZZ3, AZZ12, APP));
  if (lane == 0) {
    const Fe<NW> q = ld<NW>(sh, AQ);
    const Fe<NW> x3 =
        Ops::sub(Ops::sub(ld<NW>(sh, ARR), ld<NW>(sh, APPP), F), Ops::add(q, q, F), F);
    st<NW>(sh, AX3, x3);
    st<NW>(sh, AQX, Ops::sub(q, x3, F));
  }
  __syncwarp();
  products<NW, Ops>(sh, mul(AT, AR, AQX), mul(ASP, AS1, APPP), mul(AZZZ3, AZZZ12, APPP));
  if (lane == 0) st<NW>(sh, AY3, Ops::sub(ld<NW>(sh, AT), ld<NW>(sh, ASP), F));
  set_point<NW>(sh, PX, AX3, AY3, AZZ3, AZZZ3);
}

// The chain's constants: p and inv for chain_mul, one, zero and the curve's a.
// The load that follows ends with the warp meeting.
template <int NW>
__device__ __forceinline__ void chain_init(ChainSmem<NW>* sh, const FieldConsts<NW>& F) {
  const int lane = threadIdx.x;
  if (lane < NW) {
    sh->p[lane] = F.p[lane];
    sh->v[ONE][lane] = F.one[lane];
    sh->v[ZERO][lane] = 0;
    sh->v[ACOEF][lane] = F.a[lane];
  }
  if (lane == 0) sh->inv = F.inv;
}

// win: int32[W, 4L] 16-bit limbs (X | Y | ZZ | ZZZ per window); slots
// dst..dst+3 = window w (word-parallel over the warp).
template <int NW>
__device__ __forceinline__ void load_window(ChainSmem<NW>* sh, const int32_t* win, int w, int dst) {
  const int32_t* b = win + (size_t)w * 8 * NW;
  for (int k = threadIdx.x; k < 4 * NW; k += 32)
    sh->v[dst + k / NW][k % NW] = ((uint32_t)b[2 * k] & 0xFFFFu) | ((uint32_t)b[2 * k + 1] << 16);
  __syncwarp();
}

template <int NW, class Ops>
__global__ void __launch_bounds__(32)
horner_windows_kernel(const int32_t* __restrict__ win, int32_t* __restrict__ out, int W, int c,
                      FieldConsts<NW> F) {
  __shared__ ChainSmem<NW> sh;
  const int lane = threadIdx.x;
  chain_init<NW>(&sh, F);
  load_window<NW>(&sh, win, W - 1, PX);
  for (int wi = W - 2; wi >= 0; --wi) {
    for (int k = 0; k < c; ++k) chain_dbl<NW, Ops>(&sh, F);
    load_window<NW>(&sh, win, wi, QX);
    chain_add<NW, Ops>(&sh, F);
  }
  for (int k = lane; k < 4 * NW; k += 32) {
    const uint32_t w = sh.v[PX + k / NW][k % NW];
    out[2 * k] = (int32_t)(w & 0xFFFFu);
    out[2 * k + 1] = (int32_t)(w >> 16);
  }
}

// ---- the reduce's bit-Horner, one chain per window ---------------------------

// The four coordinates of the per-bit partials, each int32[L, nbits, W] of
// 16-bit limbs.
struct PartCoords {
  const int32_t* c[4];
};

// Slots dst..dst+3 = window w's partial of weight bit k (word-parallel over
// the warp).
template <int NW>
__device__ __forceinline__ void load_part(ChainSmem<NW>* sh, const PartCoords& P, int k, int nbits,
                                          int W, int w, int dst) {
  const size_t limb = (size_t)nbits * W;
  for (int i = threadIdx.x; i < 4 * NW; i += 32) {
    const int j = i % NW;
    const int32_t* b = P.c[i / NW] + 2 * j * limb + (size_t)k * W + w;
    sh->v[dst + i / NW][j] = ((uint32_t)b[0] & 0xFFFFu) | ((uint32_t)b[limb] << 16);
  }
  __syncwarp();
}

// out: int32[4, L, W], X | Y | ZZ | ZZZ of every window.
template <int NW, class Ops>
__global__ void __launch_bounds__(32)
xyzz_bit_horner_kernel(PartCoords P, int32_t* __restrict__ out, int nbits, int W,
                       FieldConsts<NW> F) {
  __shared__ ChainSmem<NW> sh;
  const int lane = threadIdx.x, w = blockIdx.x;
  chain_init<NW>(&sh, F);
  load_part<NW>(&sh, P, nbits - 1, nbits, W, w, PX);
  for (int k = nbits - 2; k >= 0; --k) {
    chain_dbl<NW, Ops>(&sh, F);
    load_part<NW>(&sh, P, k, nbits, W, w, QX);
    chain_add<NW, Ops>(&sh, F);
  }
  for (int i = lane; i < 4 * NW; i += 32) {
    const uint32_t x = sh.v[PX + i / NW][i % NW];
    int32_t* o = out + ((size_t)(i / NW) * 2 * NW + 2 * (i % NW)) * W + w;
    o[0] = (int32_t)(x & 0xFFFFu);
    o[W] = (int32_t)(x >> 16);
  }
}

// st_in, st_out: int32[2L, S] packed words; coords: int32[L, R, S]; valid: int32[R, S].
extern "C" int zk_xyzz_accum(const void* st_in, void* st_out, const void* coords,
                             const void* valid, int R, long long S, int nw,
                             const uint32_t* consts, void* stream) {
  if (S <= 0) return 0;
  const unsigned blocks = (unsigned)((S + ACCUM_THREADS - 1) / ACCUM_THREADS);
  ZK_DISPATCH_NW(nw, ZK_LAUNCH_OPS(xyzz_accum_kernel, WideOps, PlainOps, blocks, ACCUM_THREADS,
                                   0, (cudaStream_t)stream>>>(
                                       (const int32_t*)st_in, (int32_t*)st_out,
                                       (const int32_t*)coords, (const int32_t*)valid, R, S,
                                       consts_from_host<NW>(consts))));
  return (int)cudaGetLastError();
}

// Resident xyzz_accum blocks per SM (its WideOps instantiation) and threads
// per block at word count nw.
extern "C" int zk_xyzz_accum_occupancy(int nw, int* blocks_per_sm, int* threads_per_block) {
  *threads_per_block = ACCUM_THREADS;
  ZK_DISPATCH_NW(nw, return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         blocks_per_sm, xyzz_accum_kernel<NW, WideOps<NW>>, ACCUM_THREADS, 0));
  return 0;
}

extern "C" int zk_horner_windows(const void* win, void* out, int W, int c, int nw,
                                 const uint32_t* consts, void* stream) {
  if (W <= 0) return (int)cudaErrorInvalidValue;
  ZK_DISPATCH_NW(nw, ZK_LAUNCH_OPS(horner_windows_kernel, WideOps, PlainOps, 1, 32, 0,
                                   (cudaStream_t)stream>>>((const int32_t*)win, (int32_t*)out, W,
                                                           c, consts_from_host<NW>(consts))));
  return (int)cudaGetLastError();
}

// x, y, zz, zzz: int32[L, nbits, W] each; out: int32[4, L, W].
extern "C" int zk_xyzz_bit_horner(const void* x, const void* y, const void* zz, const void* zzz,
                                  void* out, int nbits, int W, int nw, const uint32_t* consts,
                                  void* stream) {
  if (nbits <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const PartCoords P{{(const int32_t*)x, (const int32_t*)y, (const int32_t*)zz,
                      (const int32_t*)zzz}};
  ZK_DISPATCH_NW(nw, ZK_LAUNCH_OPS(xyzz_bit_horner_kernel, WideOps, PlainOps, W, 32, 0,
                                   (cudaStream_t)stream>>>(P, (int32_t*)out, nbits, W,
                                                           consts_from_host<NW>(consts))));
  return (int)cudaGetLastError();
}
