// Power tables and the NTT's twiddle multiply on planar 16-bit limbs.
//
// No Pallas counterpart: these replace the chains of mont_mul/mont_sqr
// launches (zkarray/kernels/mont.py:mont_mul, :mont_sqr, ported in mont.cu)
// that poly/domain.py ran to build its tables, as the JAX package does
// (zkarray/poly/domain.py:power_table, twiddle_table and fft_fourstep_big's
// doubling): log2(n) launches of growing width per power table, and per
// four-step column block a k1-twiddle table T[k1, i2] = w^(k1 i2) built by
// doubling and then multiplied in. Those chains were a TPU choice (an
// index-built table cost ~9 ns per element on its gather engine); here the
// tables are small enough to live in L2 and a product costs far less than a
// launch.
//
// pow_table writes [s w^0, ..., s w^(n-1)] (s = 1 unless the caller folds a
// constant in) in one launch: thread j multiplies s by the host constants
// w^(2^b) for the set bits of j, at most POW_TABLE_BITS products in
// registers. Every product ends fully reduced, so entry j is the one
// canonical word pattern of s w^j in Montgomery form, the same bits as any
// other chain of products (the JAX package's doubling included). It writes
// the port's planar limbs, or packed words, element-major (entry j's NW
// 32-bit words contiguous), for twiddle_mul's tables.
//
// twiddle_mul computes out[r, c] = x[r, c] w^e with e = (r0 + r)(c0 + c),
// forming w^e = HI[e >> h] LO[e & (2^h - 1)] from two packed pow_tables:
// LO = s w^j for j < 2^h, HI = (w^(2^h))^j. The exponent never wraps (the
// caller's largest e is below the tables' reach, which the wrapper checks),
// so no reduction mod n is needed and any base is exact, a coset offset too.
// x is read through the strided Operand map; out may be a column block of a
// wider tensor (limb stride out_ld, row stride out_row), so a four-step
// pass writes its block of the output in place.
//
// Bound on an H100: bytes. A 2^24 four-step pass-1 block is 2^21 Fr
// elements; the kernel reads and writes 64 B of planar limbs (16-bit limbs
// held in int32) per element, 256 MiB in all, 0.080 ms at 3.35 TB/s; its two
// products are 2 x (4 NW^2 + 3 NW) = 560 32-bit operations per element,
// 0.070 ms at ~16.7 T int32 operations/s. Design: one thread per element, a
// block's threads along one row of x, so each limb load and store of a warp
// is one coalesced 128-byte line. The tables are 4,096 entries each at 2^24
// (256 KiB at L = 16) and stay in L2; LO's index jumps by r0 + r from one
// thread to the next, so each entry is one 32-byte sector (two 16-byte
// loads) rather than 16 scattered limb loads, which is why the tables are
// packed. The products are field.cuh's fmul_wide, so the C entries refuse a
// field with p >= R/2, as sw.cu's do (every field of the port has p < R/2).
//
// Widths: the field kernels' (ZK_DISPATCH_NW_FIELD), built once per width
// group (kernels/_build.py: twiddle for NW = 8, 10, 12, twiddle_w24 for
// NW = 24). A packed entry is NW words, 4 NW bytes: at NW = 10 that is 40,
// not a multiple of 16, so entries are moved as 16-byte vectors where NW is
// a multiple of 4 and as 8-byte ones otherwise (Vec<NW>).
#include "field.cuh"

// Set bits a table index may have: n <= 2^POW_TABLE_BITS entries.
#define POW_TABLE_BITS 16

template <int NW>
struct Powers {
  uint32_t first[NW];               // s in Montgomery form
  uint32_t w[POW_TABLE_BITS][NW];   // w^(2^b) in Montgomery form
};

// The widest vector that every packed entry's start is aligned to.
template <int NW, bool WIDE = (NW % 4 == 0)>
struct Vec {
  static constexpr int K = 4;
  __device__ static void load(const int32_t* t, uint32_t* w, int k) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(t) + k);
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
  __device__ static void store(int32_t* t, const uint32_t* w, int k) {
    reinterpret_cast<uint4*>(t)[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
  }
};

template <int NW>
struct Vec<NW, false> {
  static_assert(NW % 2 == 0, "packed entries need an even word count");
  static constexpr int K = 2;
  __device__ static void load(const int32_t* t, uint32_t* w, int k) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(t) + k);
    w[2 * k] = v.x;
    w[2 * k + 1] = v.y;
  }
  __device__ static void store(int32_t* t, const uint32_t* w, int k) {
    reinterpret_cast<uint2*>(t)[k] = make_uint2(w[2 * k], w[2 * k + 1]);
  }
};

template <int NW>
__device__ __forceinline__ Fe<NW> load_words(const int32_t* __restrict__ t, unsigned long long j) {
  Fe<NW> r;
#pragma unroll
  for (int k = 0; k < NW / Vec<NW>::K; ++k) Vec<NW>::load(t + j * NW, r.w, k);
  return r;
}

template <int NW>
__global__ void __launch_bounds__(256)
pow_table_kernel(int32_t* __restrict__ out, int n, int nbits, int packed, Powers<NW> P,
                 FieldConsts<NW> F) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Fe<NW> r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = P.first[k];
#pragma unroll 1
  for (int b = 0; b < nbits; ++b) {
    if ((j >> b) & 1) {
      Fe<NW> wb;
#pragma unroll
      for (int k = 0; k < NW; ++k) wb.w[k] = P.w[b][k];
      r = fmul_wide<NW>(r, wb, F);
    }
  }
  if (packed) {
#pragma unroll
    for (int k = 0; k < NW / Vec<NW>::K; ++k) Vec<NW>::store(out + (size_t)j * NW, r.w, k);
  } else {
    store16<NW>(out, (size_t)n, (size_t)j, r);
  }
}

// Grid: x over columns, y over rows (a block loops over rows gridDim.y
// apart). out may alias x element for element (an in-place multiply): each
// thread reads its element before it writes it.
template <int NW>
__global__ void __launch_bounds__(256)
twiddle_mul_kernel(Operand x, int32_t* out, long long out_ld, long long out_row,
                   const int32_t* __restrict__ lo, const int32_t* __restrict__ hi, int h,
                   long long rows, long long cols, long long r0, long long c0, FieldConsts<NW> F) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const unsigned long long mask = (1ull << h) - 1;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const unsigned long long e = (unsigned long long)(r0 + r) * (unsigned long long)(c0 + c);
    const Fe<NW> w = fmul_wide<NW>(load_words<NW>(hi, e >> h), load_words<NW>(lo, e & mask), F);
    const Fe<NW> a = load_operand<NW>(x, r * cols + c);
    store16<NW>(out, (size_t)out_ld, (size_t)(r * out_row + c), fmul_wide<NW>(a, w, F));
  }
}

template <int NW>
static void launch_pow_table(int32_t* out, int n, int nbits, int packed, const uint32_t* words,
                             const uint32_t* consts, cudaStream_t stream) {
  Powers<NW> P;
  for (int k = 0; k < NW; ++k) P.first[k] = words[k];
  for (int b = 0; b < POW_TABLE_BITS; ++b)
    for (int k = 0; k < NW; ++k) P.w[b][k] = b < nbits ? words[(b + 1) * NW + k] : 0u;
  pow_table_kernel<NW><<<(n + 255) / 256, 256, 0, stream>>>(out, n, nbits, packed, P,
                                                                consts_from_host<NW>(consts));
}

template <int NW>
static void launch_twiddle_mul(Operand x, int32_t* out, long long out_ld, long long out_row,
                               const int32_t* lo, const int32_t* hi, int h, long long rows,
                               long long cols, long long r0, long long c0, const uint32_t* consts,
                               cudaStream_t stream) {
  const unsigned threads = cols >= 256 ? 256u : (unsigned)((cols + 31) / 32 * 32);
  const dim3 grid((unsigned)((cols + threads - 1) / threads),
                  (unsigned)(rows < 65535 ? rows : 65535));
  twiddle_mul_kernel<NW><<<grid, threads, 0, stream>>>(x, out, out_ld, out_row, lo, hi, h,
                                                           rows, cols, r0, c0,
                                                           consts_from_host<NW>(consts));
}

// out: int32[L, n] planar, or int32[n, NW] packed words when packed != 0
// (16-byte aligned); words: host words s[NW], then w^(2^b)[NW] for
// b < nbits, all Montgomery form; entry j needs j < 2^nbits.
extern "C" int zk_pow_table(void* out, long long n, int packed, const uint32_t* words, int nbits,
                            int nw, const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  if (nbits < 0 || nbits > POW_TABLE_BITS || n > (1LL << nbits) ||
      (packed && ((uintptr_t)out & 15)) || !p_fits_cc(consts, nw))
    return (int)cudaErrorInvalidValue;
  ZK_DISPATCH_NW_FIELD(nw, launch_pow_table<NW>((int32_t*)out, (int)n, nbits, packed, words, consts,
                                          (cudaStream_t)stream));
  return (int)cudaGetLastError();
}

// x: one host operand descriptor (pointer, ld, inner, outer) of an
// (L, rows, cols) input; out: limb k of element (r, c) at
// out[k*out_ld + r*out_row + c]; lo, hi: packed tables of lo_len and hi_len
// entries (16-byte aligned) that cover every e = (r0 + r)(c0 + c) of the
// call, r < rows, c < cols.
extern "C" int zk_twiddle_mul(const long long* x, void* out, long long out_ld, long long out_row,
                              const void* lo, long long lo_len, const void* hi, long long hi_len,
                              int h, long long rows, long long cols, long long r0, long long c0,
                              int nw, const uint32_t* consts, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (!operands_ok(x, 1) || h < 0 || h > 31 || r0 < 0 || c0 < 0 ||
      (((uintptr_t)lo | (uintptr_t)hi) & 15) || !p_fits_cc(consts, nw))
    return (int)cudaErrorInvalidValue;
  const unsigned long long e_max = (unsigned long long)(r0 + rows - 1) * (unsigned long long)(c0 + cols - 1);
  const unsigned long long lo_need = e_max < (1ull << h) ? e_max : (1ull << h) - 1;
  if ((long long)(e_max >> h) >= hi_len || (long long)lo_need >= lo_len)
    return (int)cudaErrorInvalidValue;
  ZK_DISPATCH_NW_FIELD(nw, launch_twiddle_mul<NW>(operand_from_host(x), (int32_t*)out, out_ld, out_row,
                                            (const int32_t*)lo, (const int32_t*)hi, h, rows, cols,
                                            r0, c0, consts, (cudaStream_t)stream));
  return (int)cudaGetLastError();
}
