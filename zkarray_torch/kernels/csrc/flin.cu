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
// below p. A group of G lanes owns one output row of one element (G = 1: one thread). Lane
// t accumulates terms t, t + G, ... on 16-bit limbs in 32-bit registers, c x for c > 0 and
// |c| (2^16 - 1 - x) for c < 0 (the complement: the columns stay nonnegative); a butterfly
// of log2 G warp shuffles then adds the lanes' columns, so every lane holds the row's
// column sums, below sum |c| 2^16 < 2^32 as one thread's were (each partial sum is at most
// the total: nothing wraps). With cneg the sum of the negative |c|, the total is
// T + cneg 2^(16 L) after adding cneg (p + 1), where T = P - N + cneg p lies in
// [0, (sum |c|) p]. One carry pass makes T's NW + 1 words, and kbits = bits(sum |c|)
// conditional subtractions of p 2^b (b = kbits - 1 .. 0) bring it below p: the unique
// reduced result, so it equals the plain version's and the chain of fp_add/fp_sub
// launches it replaces, word for word, whatever G is.
//
// Bound on an H100, wide batches: bytes. Per element it reads each source slot once
// (L x 4 B) and writes each output row (L x 4 B); each term costs L multiply-adds. A
// BLS12-381 Fp12 product's post-map reads 54 slots and writes 12 for ~100 terms: ~2,400
// 32-bit operations against 6.3 KB, 0.4 a byte, where the card does ~5 a byte of HBM.
// Neighbouring threads own neighbouring elements of one row, so every load is coalesced
// and a source slot that several rows read is served from L1/L2 after the first.
//
// Bound on an H100, narrow batches (a few to a few thousand elements, as gt_msm's windows
// and a final exponentiation launch it): a chain of dependent loads, not bytes. One thread
// a row walks the row's terms in series, a table load and then L source loads a term, so
// the Fp12 product's post-map (rows of up to 36 terms) took 36 such rounds however few
// elements there were: 0.0235 ms at 64 lanes against a byte bound of 0.00012 ms. The
// narrow body (G > 1) gives a row's terms to G lanes: the lanes load the row's term words
// side by side (the next round's word in flight while this round's sources load), issue
// one round of source loads each (ceil(terms / G) rounds), and meet in log2 G shuffle
// rounds before the one carry pass; a warp holds 32 / G neighbouring elements and a warp
// wholly past the last element leaves at once. The Fp12 post-map's chain falls from
// 1 + 2 x 36 dependent loads to 1 + 1 + 2 (its pre-map's, 8-term rows: 1 + 1 + 1). Its cost
// is G times the carry pass's instructions (every lane runs it) and the shuffles, which a
// wide batch, where the card is full of threads, pays for nothing: there the one-thread
// body runs.
//
// The rule (kernels/lin.py:lanes, the one place it lives; the host packs G into LinCall):
// G starts at the power of two that covers the map's longest row, at most 32 (36-term
// rows: 32; 8: 8; one term: 1), is halved while the launch's m x n x G lanes exceed
// FILL_THREADS = 2^15, stopping at two, and two lanes give way to one thread a row once
// m x n exceeds PAIR_ELEMENTS = 2^16. Both crossovers were set on the card by timing every G
// on a BLS12-381 Fp12 product's maps and the Granger-Scott square's from 1 to 7 x 2^11
// elements (scripts/probe_lin_narrow.py; PERF.md row K): below 2^15 lanes the card is far
// from full and the shorter chain wins; two lanes keep paying for long rows (36 terms) until
// m x n nears 2^16; past that the one-thread body's fewer instructions win.
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

// The tail both bodies share: T + cneg 2^(16 L) = acc + cneg (p + 1), carried into NW words
// and a top word, then the kbits conditional subtractions, into w.
template <int NW>
__device__ __forceinline__ void lin_reduce(const uint32_t (&acc)[2 * NW], const int4 row,
                                           const FieldConsts<NW>& F, uint32_t (&w)[NW + 1]) {
  const uint32_t cneg = (uint32_t)row.z;
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
}

// The one-thread body (wide batches): a block's 256 threads own 256 elements of its row.
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
  uint32_t w[NW + 1];
  lin_reduce<NW>(acc, row, F, w);

  int32_t* y = A.out.base + (long long)blockIdx.y * A.out.slot +
               lin_offset(i, A.out.inner, A.out.outer);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    y[(2 * j) * A.out.ld] = (int32_t)(w[j] & 0xFFFFu);
    y[(2 * j + 1) * A.out.ld] = (int32_t)(w[j] >> 16);
  }
}

// The narrow body (G = 2 .. 32 lanes a (row, element), 256 / G elements a block). A warp
// holds E = 32 / G neighbouring elements, the element the fastest-moving index of its
// lanes, so the E lanes that hold one term of one row read E neighbouring words of each limb.
template <int NW, int G>
__global__ void __launch_bounds__(256)
fp_lin_kernel(const __grid_constant__ LinArgs A, const int32_t* __restrict__ table, long long n,
              FieldConsts<NW> F) {
  constexpr int L = 2 * NW, E = 32 / G;
  const int lane = (int)(threadIdx.x % 32) / E;  // the group's lane: terms lane, lane + G, ...
  const long long g0 = (long long)blockIdx.x * (256 / G) + (threadIdx.x / 32) * E;
  if (g0 >= n) return;  // a warp wholly past the end leaves at once
  // a group past the end in a warp that holds one before it computes element n - 1 and
  // stores nothing: every lane of the warp reaches the shuffles
  const long long g = g0 + threadIdx.x % E, i = g < n ? g : n - 1;
  const int4 row = __ldg(reinterpret_cast<const int4*>(table) + blockIdx.y);
  const int2* terms = reinterpret_cast<const int2*>(table + row.x);

  uint32_t acc[L];
#pragma unroll
  for (int k = 0; k < L; ++k) acc[k] = 0;
  // the next round's term word is in flight while this round's sources load
  int2 next = lane < row.y ? __ldg(terms + lane) : make_int2(0, 0);
  for (int t = lane; t < row.y; t += G) {  // the row is the block's
    const int2 term = next;
    if (t + G < row.y) next = __ldg(terms + t + G);
    const LinOperand& o = A.src[term.x >> 16];
    const int32_t* x =
        o.base + (long long)(term.x & 0xFFFF) * o.slot + lin_offset(i, o.inner, o.outer);
    const uint32_t c = (uint32_t)abs(term.y);  // lanes hold terms of either sign: no branch
    const uint32_t flip = term.y < 0 ? 0xFFFFu : 0u;
#pragma unroll
    for (int k = 0; k < L; ++k) acc[k] += c * ((uint32_t)x[k * o.ld] ^ flip);
  }
  // the group's column sums, in every lane of it (its lanes lie E apart in the warp)
#pragma unroll
  for (int s = G / 2; s > 0; s >>= 1) {
#pragma unroll
    for (int k = 0; k < L; ++k) acc[k] += __shfl_xor_sync(0xFFFFFFFFu, acc[k], s * E);
  }
  uint32_t w[NW + 1];
  lin_reduce<NW>(acc, row, F, w);

  if (g >= n) return;
  // lane l of a group writes limbs l, l + G, ...
  int32_t* y = A.out.base + (long long)blockIdx.y * A.out.slot +
               lin_offset(i, A.out.inner, A.out.outer);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    if ((2 * j) % G == lane) y[(2 * j) * A.out.ld] = (int32_t)(w[j] & 0xFFFFu);
    if ((2 * j + 1) % G == lane) y[(2 * j + 1) * A.out.ld] = (int32_t)(w[j] >> 16);
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
  long long lanes;                 // G, lanes a (row, element): kernels/lin.py:lanes
  LinOperand op[LIN_MAX_SRC + 1];  // the nsrc sources the table names, then the output
};
static_assert(sizeof(LinOperand) == 40 && sizeof(LinCall) == 8 * (7 + 5 * (LIN_MAX_SRC + 1)),
              "kernels/lin.py packs LinCall as 64-bit words");

template <int NW, int G>
static void launch_lin(const LinArgs& A, const int32_t* table, long long m, long long n,
                       const FieldConsts<NW>& F, cudaStream_t stream) {
  const dim3 grid((unsigned)((n * G + 255) / 256), (unsigned)m);
  if constexpr (G == 1)
    fp_lin_kernel<NW><<<grid, 256, 0, stream>>>(A, table, n, F);
  else
    fp_lin_kernel<NW, G><<<grid, 256, 0, stream>>>(A, table, n, F);
}

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
  const int32_t* table = c->table;
  const long long m = c->m, n = c->n, lanes = c->lanes;
  const cudaStream_t st = (cudaStream_t)stream;
  ZK_DISPATCH_NW_FIELD((int)c->nw, {
    const FieldConsts<NW> F = consts_from_host<NW>(c->consts);
    switch (lanes) {
      case 1: launch_lin<NW, 1>(A, table, m, n, F, st); break;
      case 2: launch_lin<NW, 2>(A, table, m, n, F, st); break;
      case 4: launch_lin<NW, 4>(A, table, m, n, F, st); break;
      case 8: launch_lin<NW, 8>(A, table, m, n, F, st); break;
      case 16: launch_lin<NW, 16>(A, table, m, n, F, st); break;
      case 32: launch_lin<NW, 32>(A, table, m, n, F, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaGetLastError();
}
