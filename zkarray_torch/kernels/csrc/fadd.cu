// Element-wise field addition and subtraction on planar 16-bit limbs.
//
// fp_add and fp_sub have no Pallas counterpart: in the JAX package
// zkarray/ff/fp.py:add and :sub are XLA loops that it fuses with their
// neighbours, while the port's plain versions are ~25 torch kernels each
// (core/limbs.py:add_with_carry, sub_with_borrow). One thread per element; fp.double is
// fp_add(a, a) and fp.neg is fp_sub(0, a).
//
// Bound on an H100: bytes. An L = 24 addition reads 2 x 96 B and writes
// 96 B per element (16-bit limbs held in int32) and does ~3 NW 32-bit
// operations; an L = 48 one (BW6's 761- and 767-bit fields, NW = 24 through
// ZK_DISPATCH_NW_FIELD, which also builds NW = 10 and 26 for the MNT-298 and
// CP6-782 fields) reads 2 x 192 B and writes 192 B for ~72 operations, 0.375
// a byte, so bytes bound it at every width. The file is small enough to
// build all five widths in one unit. The operands and the output go through field.cuh's strided
// map (Operand: base, ld, inner, outer), so a tower element's coefficient
// axes, a stride-0 constant or a coefficient slice of a stacked tensor are
// read and written in place.
//
// The results equal the plain versions' (kernels/mont.py:add_plain,
// :sub_plain) for every input whose limbs are 16-bit, reduced or not, as
// the JAX package's do: add forms s = a + b on NW + 1 words and subtracts p
// once when s >= p, keeping the low NW words; sub adds p once on a borrow,
// modulo 2^(32 NW). So the carry out of a + b is kept and no spare bit of p
// is assumed.
#include "field.cuh"

struct OutOperand {
  int32_t* base;
  long long ld;
  long long inner;
  long long outer;
};

__device__ __forceinline__ long long map_offset(long long i, long long inner, long long outer) {
  return i < inner ? i : (i / inner) * outer + i % inner;
}

template <int NW>
__device__ __forceinline__ Fe<NW> add_once(const Fe<NW>& a, const Fe<NW>& b,
                                           const FieldConsts<NW>& F) {
  uint32_t s[NW];
  s[0] = ptx::add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) s[j] = ptx::addc_cc(a.w[j], b.w[j]);
  const uint32_t top = ptx::addc(0, 0);
  uint32_t d[NW];
  d[0] = ptx::sub_cc(s[0], F.p[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d[j] = ptx::subc_cc(s[j], F.p[j]);
  const uint32_t keep_s = ptx::subc(top, 0) == 0xFFFFFFFFu ? 0xFFFFFFFFu : 0u;  // s < p
  Fe<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = (s[j] & keep_s) | (d[j] & ~keep_s);
  return r;
}

template <int NW>
__device__ __forceinline__ Fe<NW> sub_once(const Fe<NW>& a, const Fe<NW>& b,
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

template <int NW, bool SUB>
__device__ __forceinline__ void addsub_element(const Operand& a, const Operand& b,
                                               const OutOperand& o, long long i,
                                               const FieldConsts<NW>& F) {
  const Fe<NW> x = load_operand<NW>(a, i);
  const Fe<NW> y = load_operand<NW>(b, i);
  const Fe<NW> r = SUB ? sub_once<NW>(x, y, F) : add_once<NW>(x, y, F);
  int32_t* out = o.base + map_offset(i, o.inner, o.outer);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    out[(2 * j) * o.ld] = (int32_t)(r.w[j] & 0xFFFFu);
    out[(2 * j + 1) * o.ld] = (int32_t)(r.w[j] >> 16);
  }
}

// Two kernels, so that a profiler trace tells them apart by name.
template <int NW>
__global__ void __launch_bounds__(256)
fp_add_kernel(Operand a, Operand b, OutOperand o, long long n, FieldConsts<NW> F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) addsub_element<NW, false>(a, b, o, i, F);
}

template <int NW>
__global__ void __launch_bounds__(256)
fp_sub_kernel(Operand a, Operand b, OutOperand o, long long n, FieldConsts<NW> F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) addsub_element<NW, true>(a, b, o, i, F);
}

static inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

static int launch_addsub(bool sub, const long long* ops, long long n, int nw,
                         const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  if (!operands_ok(ops, 3)) return (int)cudaErrorInvalidValue;
  const Operand a = operand_from_host(ops), b = operand_from_host(ops + 4);
  const OutOperand o{(int32_t*)(uintptr_t)ops[8], ops[9], ops[10], ops[11]};
  const unsigned grid = blocks_for(n, 256);
  ZK_DISPATCH_NW_FIELD(nw, {
    const FieldConsts<NW> F = consts_from_host<NW>(consts);
    if (sub)
      fp_sub_kernel<NW><<<grid, 256, 0, (cudaStream_t)stream>>>(a, b, o, n, F);
    else
      fp_add_kernel<NW><<<grid, 256, 0, (cudaStream_t)stream>>>(a, b, o, n, F);
  });
  return (int)cudaGetLastError();
}

// ops: host descriptors (pointer, ld, inner, outer) of a, b, then the
// output; consts: host words (see field.cuh).
extern "C" int zk_fp_add(const long long* ops, long long n, int nw, const uint32_t* consts,
                         void* stream) {
  return launch_addsub(false, ops, n, nw, consts, stream);
}

extern "C" int zk_fp_sub(const long long* ops, long long n, int nw, const uint32_t* consts,
                         void* stream) {
  return launch_addsub(true, ops, n, nw, consts, stream);
}
