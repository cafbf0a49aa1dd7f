// Montgomery field and XYZZ point arithmetic on 32-bit words, for sm_90a.
//
// A field element is NW = L/2 little-endian 32-bit words: limb pair
// (2j, 2j+1) of the planar base-2^16 layout is word j. The Montgomery radix
// R = 2^(32 NW) = 2^(16 L) is the JAX package's, and every operation ends
// fully reduced to [0, p), so results are bit-identical to its 16-bit CIOS
// (zkarray/kernels/mont.py:_mul_body/_redc/_cond_sub_p): both compute the
// same (a*b + M*p)/R with the unique M < R, then subtract p at most once.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

template <int NW>
struct FieldConsts {
  uint32_t p[NW];
  uint32_t one[NW];  // 1 in Montgomery form
  uint32_t a[NW];    // curve coefficient a in Montgomery form
  uint32_t inv;      // -p^-1 mod 2^32
  uint32_t a_is_zero;
};

// Host words: p[NW] | one[NW] | a[NW] | inv | a_is_zero.
template <int NW>
static FieldConsts<NW> consts_from_host(const uint32_t* h) {
  FieldConsts<NW> f;
  for (int i = 0; i < NW; ++i) {
    f.p[i] = h[i];
    f.one[i] = h[NW + i];
    f.a[i] = h[2 * NW + i];
  }
  f.inv = h[3 * NW];
  f.a_is_zero = h[3 * NW + 1];
  return f;
}

template <int NW>
struct Fe {
  uint32_t w[NW];
};

template <int NW>
struct Xyzz {
  Fe<NW> x, y, zz, zzz;
};

template <int NW>
__device__ __forceinline__ Fe<NW> fe_zero() {
  Fe<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = 0;
  return r;
}

template <int NW>
__device__ __forceinline__ Fe<NW> fe_one(const FieldConsts<NW>& F) {
  Fe<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = F.one[j];
  return r;
}

template <int NW>
__device__ __forceinline__ bool fe_is_zero(const Fe<NW>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) acc |= a.w[j];
  return acc == 0;
}

// (t[0..NW) + top*2^(32 NW)) - p if that is >= 0, else t: one conditional
// subtract, as _cond_sub_p does on L+1 limbs.
template <int NW>
__device__ __forceinline__ Fe<NW> cond_sub_p(const uint32_t* t, uint32_t top,
                                             const FieldConsts<NW>& F) {
  Fe<NW> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)t[j] - F.p[j] - borrow;
    d.w[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool keep_diff = top >= borrow;
  Fe<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = keep_diff ? d.w[j] : t[j];
  return r;
}

// CIOS Montgomery product a*b*R^-1 mod p.
template <int NW>
__device__ __forceinline__ Fe<NW> fmul(const Fe<NW>& a, const Fe<NW>& b,
                                       const FieldConsts<NW>& F) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F.inv;
    s = (uint64_t)m * F.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)m * F.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  return cond_sub_p<NW>(t, t[NW], F);
}

template <int NW>
__device__ __forceinline__ Fe<NW> fadd(const Fe<NW>& a, const Fe<NW>& b,
                                       const FieldConsts<NW>& F) {
  uint32_t t[NW];
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)a.w[j] + b.w[j] + c;
    t[j] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  return cond_sub_p<NW>(t, c, F);
}

template <int NW>
__device__ __forceinline__ Fe<NW> fsub(const Fe<NW>& a, const Fe<NW>& b,
                                       const FieldConsts<NW>& F) {
  Fe<NW> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)a.w[j] - b.w[j] - borrow;
    d.w[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  if (borrow) {
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)d.w[j] + F.p[j] + c;
      d.w[j] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
  }
  return d;
}

// ---- loads and stores ------------------------------------------------------

// 16-bit limbs, limb k of element i at base[k*stride + i].
template <int NW>
__device__ __forceinline__ Fe<NW> load16(const int32_t* base, size_t stride, size_t i) {
  Fe<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j)
    r.w[j] = ((uint32_t)base[(2 * j) * stride + i] & 0xFFFFu) |
             ((uint32_t)base[(2 * j + 1) * stride + i] << 16);
  return r;
}

template <int NW>
__device__ __forceinline__ void store16(int32_t* base, size_t stride, size_t i, const Fe<NW>& a) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    base[(2 * j) * stride + i] = (int32_t)(a.w[j] & 0xFFFFu);
    base[(2 * j + 1) * stride + i] = (int32_t)(a.w[j] >> 16);
  }
}

// A strided input of 16-bit limbs: batch element i (row-major), limb k, at
// base[k*ld + (i / inner)*outer + i % inner]. A contiguous tensor has
// inner = n; a slice along the first batch axis keeps inner = n with a wider
// ld; a constant broadcast over leading batch axes has outer = 0; the last-axis
// halves v[..., :h] and v[..., h:2h] of a (..., m) tensor have inner = h,
// outer = m. So none of these is copied before a launch.
struct Operand {
  const int32_t* base;
  long long ld;
  long long inner;
  long long outer;
};

// Host descriptor: (pointer, ld, inner, outer) as four 64-bit words.
static inline Operand operand_from_host(const long long* d) {
  return Operand{(const int32_t*)(uintptr_t)d[0], d[1], d[2], d[3]};
}

// True when each of k host descriptors has inner >= 1 and outer >= 0.
static inline bool operands_ok(const long long* d, int k) {
  for (int j = 0; j < k; ++j)
    if (d[4 * j + 2] <= 0 || d[4 * j + 3] < 0) return false;
  return true;
}

template <int NW>
__device__ __forceinline__ Fe<NW> load_operand(const Operand& o, long long i) {
  const long long off = i < o.inner ? i : (i / o.inner) * o.outer + i % o.inner;
  return load16<NW>(o.base, (size_t)o.ld, (size_t)off);
}

// Packed 32-bit words (int32 bit patterns), word j of element i at base[j*stride + i].
template <int NW>
__device__ __forceinline__ Fe<NW> load32(const int32_t* base, size_t stride, size_t i) {
  Fe<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = (uint32_t)base[j * stride + i];
  return r;
}

template <int NW>
__device__ __forceinline__ void store32(int32_t* base, size_t stride, size_t i, const Fe<NW>& a) {
#pragma unroll
  for (int j = 0; j < NW; ++j) base[j * stride + i] = (int32_t)a.w[j];
}

// ---- XYZZ group law (mirrors zkarray/kernels/sw.py, select order included) --

template <int NW>
__device__ __forceinline__ Xyzz<NW> xyzz_inf(const FieldConsts<NW>& F) {
  return Xyzz<NW>{fe_one<NW>(F), fe_one<NW>(F), fe_zero<NW>(), fe_zero<NW>()};
}

// P += (AX, AY) for a finite affine A (_madd_core with a_inf false; the
// A = inf select there returns P unchanged, so the caller skips the call).
// Selects, in _madd_core's order: doubling (P == A), cancel (P == -A),
// P = inf. The doubling candidate is computed only on the doubling branch.
template <int NW>
__device__ __forceinline__ void xyzz_madd(Xyzz<NW>& P, const Fe<NW>& AX, const Fe<NW>& AY,
                                          const FieldConsts<NW>& F) {
  if (fe_is_zero<NW>(P.zz)) {
    P = Xyzz<NW>{AX, AY, fe_one<NW>(F), fe_one<NW>(F)};
    return;
  }
  const Fe<NW> U2 = fmul<NW>(AX, P.zz, F);
  const Fe<NW> S2 = fmul<NW>(AY, P.zzz, F);
  const Fe<NW> Pp = fsub<NW>(U2, P.x, F);
  const Fe<NW> R = fsub<NW>(S2, P.y, F);
  if (fe_is_zero<NW>(Pp)) {
    if (!fe_is_zero<NW>(R) || fe_is_zero<NW>(AY)) {
      P = xyzz_inf<NW>(F);  // cancel, or doubling a 2-torsion point
      return;
    }
    // mdbl-2008-s-1
    const Fe<NW> U = fadd<NW>(AY, AY, F);
    const Fe<NW> V = fmul<NW>(U, U, F);
    const Fe<NW> Wr = fmul<NW>(U, V, F);
    const Fe<NW> S = fmul<NW>(AX, V, F);
    const Fe<NW> XX = fmul<NW>(AX, AX, F);
    Fe<NW> M = fadd<NW>(fadd<NW>(XX, XX, F), XX, F);
    if (!F.a_is_zero) {
      Fe<NW> a;
#pragma unroll
      for (int j = 0; j < NW; ++j) a.w[j] = F.a[j];
      M = fadd<NW>(M, a, F);
    }
    const Fe<NW> X3 = fsub<NW>(fmul<NW>(M, M, F), fadd<NW>(S, S, F), F);
    const Fe<NW> Y3 = fsub<NW>(fmul<NW>(M, fsub<NW>(S, X3, F), F), fmul<NW>(Wr, AY, F), F);
    P = Xyzz<NW>{X3, Y3, V, Wr};
    return;
  }
  // mmadd-xyzz
  const Fe<NW> PP = fmul<NW>(Pp, Pp, F);
  const Fe<NW> PPP = fmul<NW>(Pp, PP, F);
  const Fe<NW> Q = fmul<NW>(P.x, PP, F);
  const Fe<NW> X3 = fsub<NW>(fsub<NW>(fmul<NW>(R, R, F), PPP, F), fadd<NW>(Q, Q, F), F);
  const Fe<NW> Y3 = fsub<NW>(fmul<NW>(R, fsub<NW>(Q, X3, F), F), fmul<NW>(P.y, PPP, F), F);
  P.zz = fmul<NW>(P.zz, PP, F);
  P.zzz = fmul<NW>(P.zzz, PPP, F);
  P.x = X3;
  P.y = Y3;
}

// dbl-2008-s-1, edge-complete: inf or y == 0 -> inf (_dbl_core).
template <int NW>
__device__ __forceinline__ Xyzz<NW> xyzz_dbl(const Xyzz<NW>& P, const FieldConsts<NW>& F) {
  if (fe_is_zero<NW>(P.zz) || fe_is_zero<NW>(P.y)) return xyzz_inf<NW>(F);
  const Fe<NW> U = fadd<NW>(P.y, P.y, F);
  const Fe<NW> V = fmul<NW>(U, U, F);
  const Fe<NW> Wr = fmul<NW>(U, V, F);
  const Fe<NW> S = fmul<NW>(P.x, V, F);
  const Fe<NW> XX = fmul<NW>(P.x, P.x, F);
  Fe<NW> M = fadd<NW>(fadd<NW>(XX, XX, F), XX, F);
  if (!F.a_is_zero) {
    Fe<NW> a;
#pragma unroll
    for (int j = 0; j < NW; ++j) a.w[j] = F.a[j];
    M = fadd<NW>(M, fmul<NW>(a, fmul<NW>(P.zz, P.zz, F), F), F);
  }
  const Fe<NW> X3 = fsub<NW>(fmul<NW>(M, M, F), fadd<NW>(S, S, F), F);
  const Fe<NW> Y3 = fsub<NW>(fmul<NW>(M, fsub<NW>(S, X3, F), F), fmul<NW>(Wr, P.y, F), F);
  return Xyzz<NW>{X3, Y3, fmul<NW>(V, P.zz, F), fmul<NW>(Wr, P.zzz, F)};
}

// add-2008-s, edge-complete (_fadd_core): Q = inf -> P; P = inf -> Q;
// P == Q -> double; P == -Q -> inf.
template <int NW>
__device__ __forceinline__ Xyzz<NW> xyzz_add(const Xyzz<NW>& P, const Xyzz<NW>& Q,
                                             const FieldConsts<NW>& F) {
  if (fe_is_zero<NW>(Q.zz)) return P;
  if (fe_is_zero<NW>(P.zz)) return Q;
  const Fe<NW> U1 = fmul<NW>(P.x, Q.zz, F);
  const Fe<NW> U2 = fmul<NW>(Q.x, P.zz, F);
  const Fe<NW> S1 = fmul<NW>(P.y, Q.zzz, F);
  const Fe<NW> S2 = fmul<NW>(Q.y, P.zzz, F);
  const Fe<NW> Pp = fsub<NW>(U2, U1, F);
  const Fe<NW> R = fsub<NW>(S2, S1, F);
  if (fe_is_zero<NW>(Pp)) {
    if (fe_is_zero<NW>(R)) return xyzz_dbl<NW>(P, F);
    return xyzz_inf<NW>(F);
  }
  const Fe<NW> PP = fmul<NW>(Pp, Pp, F);
  const Fe<NW> PPP = fmul<NW>(Pp, PP, F);
  const Fe<NW> Qv = fmul<NW>(U1, PP, F);
  const Fe<NW> X3 = fsub<NW>(fsub<NW>(fmul<NW>(R, R, F), PPP, F), fadd<NW>(Qv, Qv, F), F);
  const Fe<NW> Y3 = fsub<NW>(fmul<NW>(R, fsub<NW>(Qv, X3, F), F), fmul<NW>(S1, PPP, F), F);
  return Xyzz<NW>{X3, Y3, fmul<NW>(fmul<NW>(P.zz, Q.zz, F), PP, F),
                  fmul<NW>(fmul<NW>(P.zzz, Q.zzz, F), PPP, F)};
}

// Dispatch a templated launcher on the word count; unsupported widths are
// reported as cudaErrorInvalidValue.
#define ZK_DISPATCH_NW(nw, ...)  \
  switch (nw) {                  \
    case 8: {                    \
      constexpr int NW = 8;      \
      __VA_ARGS__;               \
      break;                     \
    }                            \
    case 12: {                   \
      constexpr int NW = 12;     \
      __VA_ARGS__;               \
      break;                     \
    }                            \
    default:                     \
      return (int)cudaErrorInvalidValue; \
  }

extern "C" const char* zk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
