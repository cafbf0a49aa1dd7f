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

// ---- carry-chain arithmetic ------------------------------------------------
//
// The same field operations with the carries on the carry flag (PTX
// add.cc/addc/sub.cc/subc) and no branch: the add-back of p after a borrow
// and the final subtract are masked. They need p < R/2 (p's top bit clear),
// which keeps the CIOS accumulator to NW + 1 words and every sum of two
// reduced values below R; the C entries that use them check it
// (p_fits_cc). Every result is fully reduced to [0, p), so it is the same
// word for word as fmul/fadd/fsub's. The statements are volatile so that the
// compiler keeps each chain in order: the carry flag is invisible to it.
namespace ptx {
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
}  // namespace ptx

// Host words p[NW]: true when p < R/2, as the carry-chain routines need.
static inline bool p_fits_cc(const uint32_t* consts, int nw) { return (consts[nw - 1] >> 31) == 0; }

// t (< 2p) minus p if that does not borrow, else t: the select is a mask.
template <int NW>
__device__ __forceinline__ Fe<NW> cond_sub_p_cc(const uint32_t* t, const FieldConsts<NW>& F) {
  uint32_t d[NW];
  d[0] = ptx::sub_cc(t[0], F.p[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d[j] = ptx::subc_cc(t[j], F.p[j]);
  const uint32_t keep_t = ptx::subc(0, 0);  // all ones when t < p
  Fe<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = (t[j] & keep_t) | (d[j] & ~keep_t);
  return r;
}

// One CIOS row: t = (t + a*bi + m*p) / 2^32 with m = (t + a*bi)[0] * inv.
// Each 32x32-bit product is made whole by one 64-bit multiply-add
// (IMAD.WIDE.U32, which adds t[j] for free), and only the column sums ride
// the carry flag: lo(a_j bi + t_j) + hi(a_{j-1} bi + t_{j-1}). A CIOS written
// as mad.lo.cc/madc.hi.cc chains is longer on sm_90, which has no
// multiply-add with a carry out and splits each of those into a multiply and
// an add (chip_smoke.py's SASS probe counts both). t[NW] is 0 on entry and
// on exit (t < 2p < R); the sums stay below 2^(32 (NW + 1)) because
// a < p < R/2.
template <int NW>
__device__ __forceinline__ void mont_row_wide(uint32_t* t, const Fe<NW>& a, uint32_t bi,
                                              const FieldConsts<NW>& F) {
  uint64_t q = (uint64_t)a.w[0] * bi + t[0];
  t[0] = (uint32_t)q;
  uint32_t c = (uint32_t)(q >> 32);
  q = (uint64_t)a.w[1] * bi + t[1];
  t[1] = ptx::add_cc((uint32_t)q, c);
  c = (uint32_t)(q >> 32);
#pragma unroll
  for (int j = 2; j < NW; ++j) {
    q = (uint64_t)a.w[j] * bi + t[j];
    t[j] = ptx::addc_cc((uint32_t)q, c);
    c = (uint32_t)(q >> 32);
  }
  t[NW] = ptx::addc(c, 0);
  const uint32_t m = t[0] * F.inv;
  q = (uint64_t)F.p[0] * m + t[0];  // low word 0 by the choice of m
  c = (uint32_t)(q >> 32);
  q = (uint64_t)F.p[1] * m + t[1];
  t[0] = ptx::add_cc((uint32_t)q, c);  // shifted down one word
  c = (uint32_t)(q >> 32);
#pragma unroll
  for (int j = 2; j < NW; ++j) {
    q = (uint64_t)F.p[j] * m + t[j];
    t[j - 1] = ptx::addc_cc((uint32_t)q, c);
    c = (uint32_t)(q >> 32);
  }
  t[NW - 1] = ptx::addc(c, t[NW]);
  t[NW] = 0;
}

template <int NW>
__device__ __forceinline__ Fe<NW> fmul_wide(const Fe<NW>& a, const Fe<NW>& b,
                                            const FieldConsts<NW>& F) {
  uint32_t t[NW + 1];
#pragma unroll
  for (int j = 0; j <= NW; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) mont_row_wide<NW>(t, a, b.w[i], F);
  return cond_sub_p_cc<NW>(t, F);
}

template <int NW>
__device__ __forceinline__ Fe<NW> fadd_cc(const Fe<NW>& a, const Fe<NW>& b,
                                          const FieldConsts<NW>& F) {
  uint32_t t[NW];
  t[0] = ptx::add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) t[j] = ptx::addc_cc(a.w[j], b.w[j]);
  return cond_sub_p_cc<NW>(t, F);  // a + b < 2p < R: no carry out
}

template <int NW>
__device__ __forceinline__ Fe<NW> fsub_cc(const Fe<NW>& a, const Fe<NW>& b,
                                          const FieldConsts<NW>& F) {
  Fe<NW> d;
  d.w[0] = ptx::sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d.w[j] = ptx::subc_cc(a.w[j], b.w[j]);
  const uint32_t add_p = ptx::subc(0, 0);  // all ones when a < b
  d.w[0] = ptx::add_cc(d.w[0], F.p[0] & add_p);
#pragma unroll
  for (int j = 1; j < NW; ++j) d.w[j] = ptx::addc_cc(d.w[j], F.p[j] & add_p);
  return d;
}

// The sets of field operations the XYZZ formulas below are written over.
template <int NW>
struct PlainOps {
  static __device__ __forceinline__ Fe<NW> mul(const Fe<NW>& a, const Fe<NW>& b,
                                               const FieldConsts<NW>& F) {
    return fmul<NW>(a, b, F);
  }
  static __device__ __forceinline__ Fe<NW> add(const Fe<NW>& a, const Fe<NW>& b,
                                               const FieldConsts<NW>& F) {
    return fadd<NW>(a, b, F);
  }
  static __device__ __forceinline__ Fe<NW> sub(const Fe<NW>& a, const Fe<NW>& b,
                                               const FieldConsts<NW>& F) {
    return fsub<NW>(a, b, F);
  }
};

template <int NW>
struct WideOps {
  static __device__ __forceinline__ Fe<NW> mul(const Fe<NW>& a, const Fe<NW>& b,
                                               const FieldConsts<NW>& F) {
    return fmul_wide<NW>(a, b, F);
  }
  static __device__ __forceinline__ Fe<NW> add(const Fe<NW>& a, const Fe<NW>& b,
                                               const FieldConsts<NW>& F) {
    return fadd_cc<NW>(a, b, F);
  }
  static __device__ __forceinline__ Fe<NW> sub(const Fe<NW>& a, const Fe<NW>& b,
                                               const FieldConsts<NW>& F) {
    return fsub_cc<NW>(a, b, F);
  }
};

// WideOps with every product through one non-inlined copy of fmul_wide. A
// formula inlined on WideOps is tens of thousands of instructions (an XYZZ
// add ~25,000 at NW = 12), more than the instruction cache holds, so each
// warp fetches its code from L2 as it goes; through the call every product
// runs the same ~900 instructions (sw.cu's horner_windows found the same for
// one warp). On the H100 this more than doubled the element-wise XYZZ
// kernels' throughput (PERF.md). F must be a __grid_constant__ kernel
// parameter, or memory that outlives the call: its address is passed.
template <int NW>
__device__ __noinline__ Fe<NW> fmul_wide_call(const Fe<NW> a, const Fe<NW> b,
                                              const FieldConsts<NW>* F) {
  return fmul_wide<NW>(a, b, *F);
}

template <int NW>
struct CallOps : WideOps<NW> {
  static __device__ __forceinline__ Fe<NW> mul(const Fe<NW>& a, const Fe<NW>& b,
                                               const FieldConsts<NW>& F) {
    return fmul_wide_call<NW>(a, b, &F);
  }
};

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
// Ops: PlainOps (fmul/fadd/fsub), WideOps (fmul_wide, fadd_cc, fsub_cc) or
// CallOps (WideOps, the product not inlined).
template <int NW, class Ops = PlainOps<NW>>
__device__ __forceinline__ void xyzz_madd(Xyzz<NW>& P, const Fe<NW>& AX, const Fe<NW>& AY,
                                          const FieldConsts<NW>& F) {
  if (fe_is_zero<NW>(P.zz)) {
    P = Xyzz<NW>{AX, AY, fe_one<NW>(F), fe_one<NW>(F)};
    return;
  }
  const Fe<NW> U2 = Ops::mul(AX, P.zz, F);
  const Fe<NW> S2 = Ops::mul(AY, P.zzz, F);
  const Fe<NW> Pp = Ops::sub(U2, P.x, F);
  const Fe<NW> R = Ops::sub(S2, P.y, F);
  if (fe_is_zero<NW>(Pp)) {
    if (!fe_is_zero<NW>(R) || fe_is_zero<NW>(AY)) {
      P = xyzz_inf<NW>(F);  // cancel, or doubling a 2-torsion point
      return;
    }
    // mdbl-2008-s-1
    const Fe<NW> U = Ops::add(AY, AY, F);
    const Fe<NW> V = Ops::mul(U, U, F);
    const Fe<NW> Wr = Ops::mul(U, V, F);
    const Fe<NW> S = Ops::mul(AX, V, F);
    const Fe<NW> XX = Ops::mul(AX, AX, F);
    Fe<NW> M = Ops::add(Ops::add(XX, XX, F), XX, F);
    if (!F.a_is_zero) {
      Fe<NW> a;
#pragma unroll
      for (int j = 0; j < NW; ++j) a.w[j] = F.a[j];
      M = Ops::add(M, a, F);
    }
    const Fe<NW> X3 = Ops::sub(Ops::mul(M, M, F), Ops::add(S, S, F), F);
    const Fe<NW> Y3 = Ops::sub(Ops::mul(M, Ops::sub(S, X3, F), F), Ops::mul(Wr, AY, F), F);
    P = Xyzz<NW>{X3, Y3, V, Wr};
    return;
  }
  // mmadd-xyzz
  const Fe<NW> PP = Ops::mul(Pp, Pp, F);
  const Fe<NW> PPP = Ops::mul(Pp, PP, F);
  const Fe<NW> Q = Ops::mul(P.x, PP, F);
  const Fe<NW> X3 = Ops::sub(Ops::sub(Ops::mul(R, R, F), PPP, F), Ops::add(Q, Q, F), F);
  const Fe<NW> Y3 = Ops::sub(Ops::mul(R, Ops::sub(Q, X3, F), F), Ops::mul(P.y, PPP, F), F);
  P.zz = Ops::mul(P.zz, PP, F);
  P.zzz = Ops::mul(P.zzz, PPP, F);
  P.x = X3;
  P.y = Y3;
}

// dbl-2008-s-1, edge-complete: inf or y == 0 -> inf (_dbl_core).
template <int NW, class Ops = PlainOps<NW>>
__device__ __forceinline__ Xyzz<NW> xyzz_dbl(const Xyzz<NW>& P, const FieldConsts<NW>& F) {
  if (fe_is_zero<NW>(P.zz) || fe_is_zero<NW>(P.y)) return xyzz_inf<NW>(F);
  const Fe<NW> U = Ops::add(P.y, P.y, F);
  const Fe<NW> V = Ops::mul(U, U, F);
  const Fe<NW> Wr = Ops::mul(U, V, F);
  const Fe<NW> S = Ops::mul(P.x, V, F);
  const Fe<NW> XX = Ops::mul(P.x, P.x, F);
  Fe<NW> M = Ops::add(Ops::add(XX, XX, F), XX, F);
  if (!F.a_is_zero) {
    Fe<NW> a;
#pragma unroll
    for (int j = 0; j < NW; ++j) a.w[j] = F.a[j];
    M = Ops::add(M, Ops::mul(a, Ops::mul(P.zz, P.zz, F), F), F);
  }
  const Fe<NW> X3 = Ops::sub(Ops::mul(M, M, F), Ops::add(S, S, F), F);
  const Fe<NW> Y3 = Ops::sub(Ops::mul(M, Ops::sub(S, X3, F), F), Ops::mul(Wr, P.y, F), F);
  return Xyzz<NW>{X3, Y3, Ops::mul(V, P.zz, F), Ops::mul(Wr, P.zzz, F)};
}

// A point held in registers, read through the interface xyzz_add takes: a
// point type with get<NW>(c), c = 0..3 for X, Y, ZZ, ZZZ (xyzz.cu adds points
// read from device memory and from shared memory where the formula needs
// each coordinate, so fewer values are live at once).
template <int NW>
struct RegPoint {
  const Xyzz<NW>& P;
  template <int N>
  __device__ __forceinline__ Fe<N> get(int c) const {
    return c == 0 ? P.x : c == 1 ? P.y : c == 2 ? P.zz : P.zzz;
  }
};

template <int NW, class Pt>
__device__ __forceinline__ Xyzz<NW> get_point(const Pt& P) {
  return Xyzz<NW>{P.template get<NW>(0), P.template get<NW>(1), P.template get<NW>(2),
                  P.template get<NW>(3)};
}

// add-2008-s, edge-complete (_fadd_core): Q = inf -> P; P = inf -> Q;
// P == Q -> double; P == -Q -> inf. Each coordinate is read where it is
// first needed (ZZ1, ZZ2, ZZZ1 and ZZZ2 twice).
template <int NW, class Ops = PlainOps<NW>, class PA, class PB>
__device__ __forceinline__ Xyzz<NW> xyzz_add(const PA& P, const PB& Q, const FieldConsts<NW>& F) {
  const Fe<NW> ZZ2 = Q.template get<NW>(2);
  if (fe_is_zero<NW>(ZZ2)) return get_point<NW>(P);
  const Fe<NW> ZZ1 = P.template get<NW>(2);
  if (fe_is_zero<NW>(ZZ1)) return get_point<NW>(Q);
  const Fe<NW> U1 = Ops::mul(P.template get<NW>(0), ZZ2, F);
  const Fe<NW> U2 = Ops::mul(Q.template get<NW>(0), ZZ1, F);
  const Fe<NW> S1 = Ops::mul(P.template get<NW>(1), Q.template get<NW>(3), F);
  const Fe<NW> S2 = Ops::mul(Q.template get<NW>(1), P.template get<NW>(3), F);
  const Fe<NW> Pp = Ops::sub(U2, U1, F);
  const Fe<NW> R = Ops::sub(S2, S1, F);
  if (fe_is_zero<NW>(Pp)) {
    if (fe_is_zero<NW>(R)) return xyzz_dbl<NW, Ops>(get_point<NW>(P), F);
    return xyzz_inf<NW>(F);
  }
  const Fe<NW> PP = Ops::mul(Pp, Pp, F);
  const Fe<NW> PPP = Ops::mul(Pp, PP, F);
  const Fe<NW> ZZ3 = Ops::mul(Ops::mul(ZZ1, ZZ2, F), PP, F);
  const Fe<NW> ZZZ3 =
      Ops::mul(Ops::mul(P.template get<NW>(3), Q.template get<NW>(3), F), PPP, F);
  const Fe<NW> Qv = Ops::mul(U1, PP, F);
  const Fe<NW> X3 = Ops::sub(Ops::sub(Ops::mul(R, R, F), PPP, F), Ops::add(Qv, Qv, F), F);
  const Fe<NW> Y3 = Ops::sub(Ops::mul(R, Ops::sub(Qv, X3, F), F), Ops::mul(S1, PPP, F), F);
  return Xyzz<NW>{X3, Y3, ZZ3, ZZZ3};
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
