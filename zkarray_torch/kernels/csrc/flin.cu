// One linear map over field elements in one launch: out[i] = sum_j c[i][j] src[j] mod p,
// fully reduced, for a small signed integer matrix c.
//
// fp_lin replaces no Pallas kernel. It is the redesign of fadd.cu's fp_add and fp_sub
// for the linear glue of a tower product (ff/linmap.py): in the JAX package XLA fuses
// those additions; the port issued one fp_add or fp_sub launch per addition at every
// tower level (~30 around each Fp12 product's one mont_mul), and the host's ~60-110 us
// per launch, not the device, bounded the pairing paths. Here the additions before the
// products (the operands of the one mont_mul) are one launch and the additions after
// them are another, with every intermediate in registers.
//
// Layout. A source or the output is (slot, limb, batch element) of 16-bit limbs held in
// int32, at base[slot*slot_stride + limb*ld + map(i)], with field.cuh's operand map
// map(i) = (i / inner)*outer + i % inner. So a tower element's coefficient axes, the
// product slab of mont_mul (L, S, *batch), a stride-0 constant and a batch slice are all
// read in place, and the result is written straight into its (c..., L, *batch) tensor.
// The map is a table on the device, uploaded once per map and device (kernels/lin.py): per
// output row (first term, terms, cneg, kbits), then per term (source << 16 | slot, coefficient).
//
// Arithmetic. The wrapper holds each row to sum |c| < 2^16 and the caller gives words
// below p. A thread owns one output row of one element. It accumulates every term on
// 16-bit limbs in 32-bit registers, c x for c > 0 and |c| (2^16 - 1 - x) for c < 0 (the
// complement: the columns stay nonnegative and below sum |c| 2^16 < 2^32). With cneg the
// sum of the negative |c|, the total is T + cneg 2^(16 L) after adding cneg (p + 1), where
// T = P - N + cneg p lies in [0, (sum |c|) p]. One carry pass makes T's NW + 1 words, and
// kbits = bits(sum |c|) conditional subtractions of p 2^b (b = kbits - 1 .. 0) bring it
// below p: the unique reduced result, so it equals the plain version's and the chain of
// fp_add/fp_sub launches it replaces, word for word.
//
// Bound on an H100: bytes. Per element it reads each source slot once (L x 4 B) and
// writes each output row (L x 4 B); each term costs L multiply-adds. A BLS12-381 Fp12
// product's post-map reads 54 slots and writes 12 for ~100 terms: ~2,400 32-bit
// operations against 6.3 KB, 0.4 a byte, where the card does ~5 a byte of HBM.
// Neighbouring threads own neighbouring elements of one row, so every load is coalesced
// and a source slot that several rows read is served from L1/L2 after the first.
#include "field.cuh"

constexpr int LIN_MAX_SRC = 4;

struct LinOperand {
  int32_t* base;
  long long slot;
  long long ld;
  long long inner;
  long long outer;
};

struct LinArgs {
  LinOperand src[LIN_MAX_SRC];
  LinOperand out;
};

__device__ __forceinline__ long long lin_offset(long long i, long long inner, long long outer) {
  return i < inner ? i : (i / inner) * outer + i % inner;
}

template <int NW>
__global__ void __launch_bounds__(256)
fp_lin_kernel(const __grid_constant__ LinArgs A, const int32_t* __restrict__ table, long long n,
              FieldConsts<NW> F) {
  constexpr int L = 2 * NW;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int4 row = __ldg(reinterpret_cast<const int4*>(table) + blockIdx.y);
  const int2* terms = reinterpret_cast<const int2*>(table + row.x);

  uint32_t acc[L];
#pragma unroll
  for (int k = 0; k < L; ++k) acc[k] = 0;
  for (int t = 0; t < row.y; ++t) {  // the row is the block's: every branch is uniform
    const int2 term = __ldg(terms + t);
    const LinOperand& o = A.src[term.x >> 16];
    const int32_t* x =
        o.base + (long long)(term.x & 0xFFFF) * o.slot + lin_offset(i, o.inner, o.outer);
    if (term.y > 0) {
      const uint32_t c = (uint32_t)term.y;
#pragma unroll
      for (int k = 0; k < L; ++k) acc[k] += c * (uint32_t)x[k * o.ld];
    } else {
      const uint32_t c = (uint32_t)(-term.y);
#pragma unroll
      for (int k = 0; k < L; ++k) acc[k] += c * ((uint32_t)x[k * o.ld] ^ 0xFFFFu);
    }
  }

  // T + cneg 2^(16 L) = acc + cneg (p + 1), carried into NW words and a top word
  const uint32_t cneg = (uint32_t)row.z;
  uint32_t w[NW + 1];
  uint64_t carry = cneg;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t v = (uint64_t)acc[2 * j] + (uint64_t)cneg * (F.p[j] & 0xFFFFu) + carry;
    const uint32_t lo = (uint32_t)v & 0xFFFFu;
    carry = v >> 16;
    v = (uint64_t)acc[2 * j + 1] + (uint64_t)cneg * (F.p[j] >> 16) + carry;
    carry = v >> 16;
    w[j] = lo | ((uint32_t)v << 16);
  }
  w[NW] = (uint32_t)carry - cneg;

  // T <= (sum |c|) p < 2^kbits p: subtract p 2^b where it does not borrow
  for (int b = row.w - 1; b >= 0; --b) {
    uint32_t d[NW + 1];
    d[0] = ptx::sub_cc(w[0], __funnelshift_l(0u, F.p[0], b));
#pragma unroll
    for (int j = 1; j < NW; ++j) d[j] = ptx::subc_cc(w[j], __funnelshift_l(F.p[j - 1], F.p[j], b));
    d[NW] = ptx::subc_cc(w[NW], __funnelshift_l(F.p[NW - 1], 0u, b));
    const uint32_t keep = ptx::subc(0, 0);  // all ones on a borrow: T < p 2^b
#pragma unroll
    for (int j = 0; j <= NW; ++j) w[j] = (w[j] & keep) | (d[j] & ~keep);
  }

  int32_t* y = A.out.base + (long long)blockIdx.y * A.out.slot +
               lin_offset(i, A.out.inner, A.out.outer);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    y[(2 * j) * A.out.ld] = (int32_t)(w[j] & 0xFFFFu);
    y[(2 * j + 1) * A.out.ld] = (int32_t)(w[j] >> 16);
  }
}

// One launch as kernels/lin.py:LinLauncher packs it: a block of 64-bit words, built anew
// a call (so no buffer is shared between callers) and read here before the launch; the
// kernel's __grid_constant__ arguments are copied at launch, so nothing reads the block
// after this entry returns.
struct LinCall {
  const int32_t* table;            // the map on the device (m rows)
  const uint32_t* consts;          // the field's constant words (host)
  long long m, n, nw, nsrc;        // rows, batch elements, 32-bit words, sources
  LinOperand op[LIN_MAX_SRC + 1];  // the nsrc sources the table names, then the output
};
static_assert(sizeof(LinOperand) == 40 && sizeof(LinCall) == 8 * (6 + 5 * (LIN_MAX_SRC + 1)),
              "kernels/lin.py packs LinCall as 64-bit words");

extern "C" int zk_fp_lin_v(const LinCall* c, void* stream) {
  if (c->n <= 0 || c->m <= 0) return 0;
  if (c->nsrc < 0 || c->nsrc > LIN_MAX_SRC || c->m > 65535) return (int)cudaErrorInvalidValue;
  LinArgs A{};
  for (int s = 0; s <= c->nsrc; ++s) {
    const LinOperand& o = c->op[s];
    if (o.inner <= 0 || o.outer < 0) return (int)cudaErrorInvalidValue;
    if (s < c->nsrc)
      A.src[s] = o;
    else
      A.out = o;
  }
  const dim3 grid((unsigned)((c->n + 255) / 256), (unsigned)c->m);
  const int32_t* table = c->table;
  const long long n = c->n;
  ZK_DISPATCH_NW_FIELD((int)c->nw, {
    const FieldConsts<NW> F = consts_from_host<NW>(c->consts);
    fp_lin_kernel<NW><<<grid, 256, 0, (cudaStream_t)stream>>>(A, table, n, F);
  });
  return (int)cudaGetLastError();
}
