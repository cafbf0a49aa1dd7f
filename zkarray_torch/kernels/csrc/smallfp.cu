// Small fields: element-wise ops (sf_op) and one radix-2 DIT stage of the
// NTT (sf_butterfly), for fields of one 32-bit or one 64-bit word.
//
// Replaces no Pallas kernel. The JAX package's small fields
// (zkarray/ff/smallfp.py, fp64.py, smallfp64.py) are jitted element-wise
// chains that XLA fuses into one pass; here each public call is one launch
// of sf_op, and each stage of smallfp.py:ntt / fp64.py:ntt one launch of
// sf_butterfly.
//
// Families (template parameter F):
//   U32  uint32 Montgomery, R = 2^32 (smallfp.py: M31, BabyBear, KoalaBear, any odd p < 2^32)
//   M31  canonical 2^31 - 1 by shift folds (smallfp.py:m31_mul; mul only)
//   GL   Goldilocks 2^64 - 2^32 + 1, canonical, the eps fold (fp64.py)
//   U64  uint64 Montgomery, R = 2^64 (smallfp64.py: any odd 33-64-bit p)
// A one-word element is a uint32; a two-word element lives in two uint32
// planes (lo, hi), as the JAX arrays hold it, and is one uint64 in
// registers. Every routine computes the JAX function's own sequence: its
// u32 wraps (smallfp.py:mont_mul's t may wrap for inputs >= p), its selects
// and the order of its power ladder, so the words are the JAX function's for
// every input it accepts, not only below p.
//
// Bound on an H100: bytes. An op reads one or two operands and writes one
// (4 or 8 bytes an element each) and does 5 to 60 integer operations: at most
// ~2.5 operations a byte, below the card's ~5. A butterfly stage reads and
// writes every element once and reads half an element's twiddle per pair.
// Design: one thread per element (per pair for the butterfly); neighbouring
// threads read neighbouring words, so every plane access coalesces; the
// butterfly's batch axis (a column block of a trace) is innermost, so a
// warp shares one twiddle. pow runs its whole ladder in registers, one
// launch for pow_const and inv. Several stages a launch in shared memory is
// later work.
#include <cstdint>
#include <cuda_runtime.h>

#define SF_THREADS 256
#define MAX_EXP_WORDS 64

enum Family { U32 = 0, M31F = 1, GL = 2, U64 = 3 };
enum Op { MUL = 0, SQR = 1, ADD = 2, SUB = 3, NEG = 4, POW = 5 };

struct SfConsts {
  uint64_t p;
  uint64_t r;  // R mod p (Montgomery one); 1 for the canonical families
  uint32_t inv32;
};

struct Exponent {
  uint32_t w[MAX_EXP_WORDS];
  int nbits;
};

// ---- u32 Montgomery (zkarray/ff/smallfp.py) ---------------------------------
__device__ __forceinline__ uint32_t u32_mul(uint32_t a, uint32_t b, const SfConsts& c) {
  const uint32_t p = (uint32_t)c.p;
  const uint64_t T = (uint64_t)a * b;
  const uint32_t lo = (uint32_t)T, hi = (uint32_t)(T >> 32);
  const uint32_t m = lo * c.inv32;
  const uint64_t MP = (uint64_t)m * p;
  const uint32_t carry = (uint32_t)(lo + (uint32_t)MP) < lo;
  const uint32_t t = hi + (uint32_t)(MP >> 32) + carry;  // wraps as the JAX u32 sum does
  return t >= p ? t - p : t;
}
__device__ __forceinline__ uint32_t u32_add(uint32_t a, uint32_t b, const SfConsts& c) {
  const uint32_t p = (uint32_t)c.p, s = a + b;
  return (s < a || s >= p) ? s - p : s;
}
__device__ __forceinline__ uint32_t u32_sub(uint32_t a, uint32_t b, const SfConsts& c) {
  const uint32_t d = a - b;
  return a < b ? d + (uint32_t)c.p : d;
}
__device__ __forceinline__ uint32_t u32_neg(uint32_t a, const SfConsts& c) {
  return a == 0 ? a : (uint32_t)c.p - a;
}

// ---- M31 canonical (smallfp.py:m31_mul) -------------------------------------
__device__ __forceinline__ uint32_t m31_mul(uint32_t a, uint32_t b, const SfConsts&) {
  const uint32_t p = 0x7FFFFFFFu;
  const uint64_t T = (uint64_t)a * b;
  const uint32_t lo = (uint32_t)T, hi = (uint32_t)(T >> 32);
  uint32_t t = (lo & p) + (lo >> 31) + ((hi << 1) & p) + (hi >> 30);
  t = (t & p) + (t >> 31);
  t = (t & p) + (t >> 31);
  return t == p ? 0u : t;
}

// ---- Goldilocks (zkarray/ff/fp64.py) ----------------------------------------
#define GL_P 0xFFFFFFFF00000001ull
#define GL_EPS 0xFFFFFFFFull

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b, const SfConsts&) {
  const uint64_t lo = a * b, hi = __umul64hi(a, b);  // w1:w0 = lo, w3:w2 = hi
  const uint64_t w2 = hi & 0xFFFFFFFFull, w3 = hi >> 32;
  // _reduce128: t = lo - w3, less eps on a borrow; + w2 eps, plus eps on a
  // carry; one conditional subtract of p.
  uint64_t t = lo - w3;
  if (lo < w3) t -= GL_EPS;
  const uint64_t m = w2 * GL_EPS;
  uint64_t r = t + m;
  if (r < t) r += GL_EPS;
  return r >= GL_P ? r - GL_P : r;
}
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b, const SfConsts&) {
  uint64_t s = a + b;
  const bool c = s < a;
  bool c2 = false;
  if (c) {
    const uint64_t s2 = s + GL_EPS;
    c2 = s2 < s;
    s = s2;
  }
  return (s >= GL_P || c2) ? s - GL_P : s;
}
__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b, const SfConsts&) {
  const uint64_t d = a - b;
  return a < b ? d + GL_P : d;
}
__device__ __forceinline__ uint64_t gl_neg(uint64_t a, const SfConsts& c) {
  return a == 0 ? a : gl_sub(0, a, c);
}

// ---- u64 Montgomery (zkarray/ff/smallfp64.py) -------------------------------
// One base-2^32 step on a value of up to four words (hi128:lo128): returns
// (w + m p) >> 32 with m = w0 * inv32, the top word wrapping as the JAX
// u32 sum does. The result has three words: lo64 and top.
__device__ __forceinline__ void u64_step(uint64_t wlo, uint64_t whi, const SfConsts& c,
                                         uint64_t& rlo, uint64_t& rhi) {
  const uint32_t m = (uint32_t)wlo * c.inv32;
  const uint64_t mplo = (uint64_t)m * c.p, mphi = __umul64hi((uint64_t)m, c.p);
  const uint64_t tlo = wlo + mplo;
  const uint64_t thi = whi + mphi + (tlo < wlo ? 1ull : 0ull);
  rlo = (tlo >> 32) | (thi << 32);
  rhi = thi >> 32;
}
__device__ __forceinline__ uint64_t u64_cond_sub(uint64_t v, const SfConsts& c) {
  return v >= c.p ? v - c.p : v;
}
__device__ __forceinline__ uint64_t u64_mul(uint64_t a, uint64_t b, const SfConsts& c) {
  uint64_t u_lo, u_hi, v_lo, v_hi;
  u64_step(a * b, __umul64hi(a, b), c, u_lo, u_hi);
  u64_step(u_lo, u_hi, c, v_lo, v_hi);
  if (v_hi != 0) v_lo += c.r;  // the extra bit: 2^64 = R mod p
  return u64_cond_sub(u64_cond_sub(v_lo, c), c);
}
__device__ __forceinline__ uint64_t u64_add(uint64_t a, uint64_t b, const SfConsts& c) {
  uint64_t s = a + b;
  if (s < a) s += c.r;
  return u64_cond_sub(s, c);
}
__device__ __forceinline__ uint64_t u64_sub(uint64_t a, uint64_t b, const SfConsts& c) {
  const uint64_t d = a - b;
  return a < b ? d + c.p : d;
}
__device__ __forceinline__ uint64_t u64_neg(uint64_t a, const SfConsts& c) {
  return a == 0 ? a : u64_sub(0, a, c);
}

// ---- the families as one interface ------------------------------------------
template <int F>
struct Fam;

template <>
struct Fam<U32> {
  typedef uint32_t T;
  static constexpr int planes = 1;
  static __device__ __forceinline__ T mul(T a, T b, const SfConsts& c) { return u32_mul(a, b, c); }
  static __device__ __forceinline__ T add(T a, T b, const SfConsts& c) { return u32_add(a, b, c); }
  static __device__ __forceinline__ T sub(T a, T b, const SfConsts& c) { return u32_sub(a, b, c); }
  static __device__ __forceinline__ T neg(T a, const SfConsts& c) { return u32_neg(a, c); }
};
template <>
struct Fam<M31F> : Fam<U32> {
  static __device__ __forceinline__ T mul(T a, T b, const SfConsts& c) { return m31_mul(a, b, c); }
};
template <>
struct Fam<GL> {
  typedef uint64_t T;
  static constexpr int planes = 2;
  static __device__ __forceinline__ T mul(T a, T b, const SfConsts& c) { return gl_mul(a, b, c); }
  static __device__ __forceinline__ T add(T a, T b, const SfConsts& c) { return gl_add(a, b, c); }
  static __device__ __forceinline__ T sub(T a, T b, const SfConsts& c) { return gl_sub(a, b, c); }
  static __device__ __forceinline__ T neg(T a, const SfConsts& c) { return gl_neg(a, c); }
};
template <>
struct Fam<U64> {
  typedef uint64_t T;
  static constexpr int planes = 2;
  static __device__ __forceinline__ T mul(T a, T b, const SfConsts& c) { return u64_mul(a, b, c); }
  static __device__ __forceinline__ T add(T a, T b, const SfConsts& c) { return u64_add(a, b, c); }
  static __device__ __forceinline__ T sub(T a, T b, const SfConsts& c) { return u64_sub(a, b, c); }
  static __device__ __forceinline__ T neg(T a, const SfConsts& c) { return u64_neg(a, c); }
};

// An element of an operand: es = 1 reads element i, es = 0 element 0; a
// two-plane element's high word sits ps words after its low word.
template <int F>
__device__ __forceinline__ typename Fam<F>::T load_el(const uint32_t* __restrict__ x, long long i,
                                                      int es, long long ps) {
  const long long k = es ? i : 0;
  if constexpr (Fam<F>::planes == 1) return x[k];
  else return (uint64_t)x[k] | ((uint64_t)x[k + ps] << 32);
}
template <int F>
__device__ __forceinline__ void store_el(uint32_t* __restrict__ x, long long i, long long ps,
                                         typename Fam<F>::T v) {
  x[i] = (uint32_t)v;
  if constexpr (Fam<F>::planes == 2) x[i + ps] = (uint32_t)((uint64_t)v >> 32);
}

template <int F>
__device__ __forceinline__ typename Fam<F>::T pow_el(typename Fam<F>::T a, const Exponent& e,
                                                     const SfConsts& c) {
  typedef typename Fam<F>::T T;
  T r = (T)c.r;
  if constexpr (F == U64) {  // smallfp64.py:pow_const: low bit first, a square per bit
    T base = a;
    for (int i = 0; i < e.nbits; ++i) {
      if ((e.w[i >> 5] >> (i & 31)) & 1u) r = Fam<F>::mul(r, base, c);
      base = Fam<F>::mul(base, base, c);
    }
    return r;
  } else {
    for (int i = e.nbits - 1; i >= 0; --i) {  // smallfp.py / fp64.py: high bit first
      r = Fam<F>::mul(r, r, c);
      if ((e.w[i >> 5] >> (i & 31)) & 1u) r = Fam<F>::mul(r, a, c);
    }
    return r;
  }
}

template <int F, int OP>
__global__ void __launch_bounds__(SF_THREADS)
sf_op_kernel(uint32_t* __restrict__ out, long long out_ps, const uint32_t* __restrict__ a, int a_es,
             long long a_ps, const uint32_t* __restrict__ b, int b_es, long long b_ps, long long n,
             const SfConsts c, const __grid_constant__ Exponent e) {
  const long long i = (long long)blockIdx.x * SF_THREADS + threadIdx.x;
  if (i >= n) return;
  typedef typename Fam<F>::T T;
  const T x = load_el<F>(a, i, a_es, a_ps);
  T r;
  if (OP == MUL) r = Fam<F>::mul(x, load_el<F>(b, i, b_es, b_ps), c);
  else if (OP == SQR) r = Fam<F>::mul(x, x, c);
  else if (OP == ADD) r = Fam<F>::add(x, load_el<F>(b, i, b_es, b_ps), c);
  else if (OP == SUB) r = Fam<F>::sub(x, load_el<F>(b, i, b_es, b_ps), c);
  else if (OP == NEG) r = Fam<F>::neg(x, c);
  else r = pow_el<F>(x, e, c);
  store_el<F>(out, i, out_ps, r);
}

// One DIT stage of size m: pair (k, j), k < n/m, j < m/2, rows i0 = k m + j
// and i1 = i0 + m/2; t = hi * tw[j n/m]; (lo + t, lo - t). One-plane y is
// (n, B) with the batch innermost; two-plane y is (2, n) (B = 1), plane
// stride n, the table's plane stride tw_ps.
template <int F>
__global__ void __launch_bounds__(SF_THREADS)
sf_butterfly_kernel(uint32_t* __restrict__ y, const uint32_t* __restrict__ tw, long long n,
                    long long B, long long m, long long tw_ps, const SfConsts c) {
  const long long g = (long long)blockIdx.x * SF_THREADS + threadIdx.x;
  const long long half = m >> 1;
  if (g >= (n >> 1) * B) return;
  const long long b = g % B, pair = g / B;
  const long long k = pair / half, j = pair - k * half;
  const long long i0 = k * m + j, i1 = i0 + half;
  typedef typename Fam<F>::T T;
  const T w = load_el<F>(tw, j * (n / m), 1, tw_ps);
  const T lo = load_el<F>(y, i0 * B + b, 1, n), hi = load_el<F>(y, i1 * B + b, 1, n);
  const T t = Fam<F>::mul(hi, w, c);
  store_el<F>(y, i0 * B + b, n, Fam<F>::add(lo, t, c));
  store_el<F>(y, i1 * B + b, n, Fam<F>::sub(lo, t, c));
}

static inline unsigned sf_blocks(long long n) { return (unsigned)((n + SF_THREADS - 1) / SF_THREADS); }

#define SF_OP_CASE(FAM, OPC)                                                                  \
  case OPC:                                                                                   \
    sf_op_kernel<FAM, OPC><<<sf_blocks(n), SF_THREADS, 0, (cudaStream_t)stream>>>(            \
        (uint32_t*)out, out_ps, (const uint32_t*)a, a_es, a_ps, (const uint32_t*)b, b_es, b_ps, \
        n, c, e);                                                                             \
    break;

#define SF_OP_ALL(FAM)     \
  switch (op) {            \
    SF_OP_CASE(FAM, MUL)   \
    SF_OP_CASE(FAM, SQR)   \
    SF_OP_CASE(FAM, ADD)   \
    SF_OP_CASE(FAM, SUB)   \
    SF_OP_CASE(FAM, NEG)   \
    SF_OP_CASE(FAM, POW)   \
    default:               \
      return (int)cudaErrorInvalidValue; \
  }

// out, a, b: uint32 planes; *_es element stride (0 or 1), *_ps plane stride
// (two-plane families); exp: nbits exponent bits as 32-bit words, low word
// first (pow only).
extern "C" int zk_sf_op(int family, int op, void* out, long long out_ps, const void* a, int a_es,
                        long long a_ps, const void* b, int b_es, long long b_ps, long long n,
                        unsigned long long p, unsigned long long r, unsigned int inv32,
                        const uint32_t* exp, int nbits, void* stream) {
  if (n <= 0) return 0;
  if (nbits < 0 || nbits > 32 * MAX_EXP_WORDS || (a_es | b_es) & ~1) return (int)cudaErrorInvalidValue;
  const SfConsts c{p, r, inv32};
  Exponent e;
  e.nbits = op == POW ? nbits : 0;
  for (int j = 0; j < MAX_EXP_WORDS; ++j) e.w[j] = j < (e.nbits + 31) / 32 ? exp[j] : 0u;
  switch (family) {
    case U32:
      SF_OP_ALL(U32)
      break;
    case M31F:
      if (op != MUL) return (int)cudaErrorInvalidValue;
      sf_op_kernel<M31F, MUL><<<sf_blocks(n), SF_THREADS, 0, (cudaStream_t)stream>>>(
          (uint32_t*)out, out_ps, (const uint32_t*)a, a_es, a_ps, (const uint32_t*)b, b_es, b_ps, n,
          c, e);
      break;
    case GL:
      SF_OP_ALL(GL)
      break;
    case U64:
      SF_OP_ALL(U64)
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// y: contiguous uint32, (n, B) one-plane or (2, n) two-plane, in place;
// tw: the power table (each plane contiguous, plane stride tw_ps).
extern "C" int zk_sf_butterfly(int family, void* y, const void* tw, long long n, long long B,
                               long long m, long long tw_ps, unsigned long long p,
                               unsigned long long r, unsigned int inv32, void* stream) {
  if (n <= 1 || B <= 0) return 0;
  if (m < 2 || m > n || (m & (m - 1)) || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  const SfConsts c{p, r, inv32};
  const long long work = (n >> 1) * B;
  switch (family) {
    case U32:
      sf_butterfly_kernel<U32><<<sf_blocks(work), SF_THREADS, 0, (cudaStream_t)stream>>>(
          (uint32_t*)y, (const uint32_t*)tw, n, B, m, tw_ps, c);
      break;
    case GL:
      sf_butterfly_kernel<GL><<<sf_blocks(work), SF_THREADS, 0, (cudaStream_t)stream>>>(
          (uint32_t*)y, (const uint32_t*)tw, n, B, m, tw_ps, c);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* zk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
