// Hopper (sm_90a) streamed attention, forward and backward, head dim 32 or
// 64.
//
// Replaces the TPU kernel
// surface_vision_transformers_tpu/ops/pallas/flash_attention.py::flash_attention
// (_fwd -> _fwd_kernel, _bwd_impl -> _bwd_kernel): softmax(Q K^T / sqrt(dh)) V
// with keys >= valid_len masked and the row log-sum-exp kept, and its
// backward, where query rows >= valid_len contribute nothing.
//
// The TPU kernel holds a (sample, head)'s whole (N, N) fp32 score tile in
// VMEM (N <= 1536). An H100 block has 227 KB of shared memory, so here the
// scores stream through it in tiles (forward 64 x 64 or 64 x 128 per
// warpgroup, backward 64 x 64) and the score matrix never exists, so no sequence
// length is refused.
//
// Forward: one CTA per (64 W queries, head, sample): a producer warpgroup,
// one thread of which issues every load by TMA (the operands' strides
// become 4-D tensor maps, made per call and passed as grid constants), Q
// once and K and V in tiles of BK keys through a two-stage ring with full
// and empty mbarriers, K and V apart; it gives its registers to the W
// consumer warpgroups (setmaxnreg), which own 64 query rows each and run
// the products on wgmma: S = Q K^T with both operands in shared memory,
// then P, rounded to bf16 in registers, as the A operand of O += P V, V
// read MN-major from its swizzled tile. Each consumer overlaps its softmax
// with its tensor-core work (tile j + 1's S is issued before tile j's P.V,
// and the softmax waits for S alone); the warpgroups of a CTA, or the CTAs
// of an SM, overlap each other's softmax and products. Three tilings, by
// shape: past 512 keys, BK = 128 and W = 3 (192 queries, one CTA per SM)
// where that grid still fills the card twice, else W = 1 (two CTAs per SM;
// the CLS block's 8 queries, the long-sequence entry's few (sample,
// head)s); up to 512 keys, BK = 64 and W = 1 (three CTAs per SM, whose
// short loops' prologues and epilogues overlap). PERF.md has the tilings
// measured beside these and lost (two warpgroups taking turns to issue
// their products among them). O leaves through the warpgroup's Q tile in
// 16-byte row pieces; lse = m / 8 + log l when asked for. No CTA depends
// on another.
//
// Backward at head dim 32 up to 320 keys, queries = keys, without dropout
// (every MS-SiT fold; resident_bwd), one launch: flash_bwd_resident_kernel
// keeps a (sample, head)'s whole Q, K, V and dO in shared memory (5 x 320 x
// 32 x 2 B would be 100 KB with O; O is read only for delta, by each thread
// for its own rows). Its tiles are 32 columns wide in the 64-byte swizzle,
// so S, dP (n32 halves of a 64-key block), dV, dK and the dQ share (n32)
// spend no tensor work on zero columns. Warpgroup w owns query tile w and
// its dQ in registers; in round r it takes key block (w + r) % T, so dQ sums
// over the key blocks in a fixed order, and dK and dV sum over the rounds
// in fp32 in shared memory (one warpgroup adds into a block in a round,
// after the round before it: a turn counter per block, so the warpgroups
// drift apart and one's softmax runs under another's products): no
// workspace, no delta or dq pass, no atomics, and the outputs repeat bit
// for bit by construction. Sequences of N <= 32 rows
// go 64 / N to a tile under a block-diagonal mask (stage 2's axial fold: 3
// of 20, 60 rows of 64), one tile a CTA. T = 1 .. 5 tiles, 128 T threads,
// up to 201 KB of shared memory (T = 5: Q, K, V, dO 80 KB, the fp32 key
// block sums 80 KB, a 64 x 64 staging tile a warpgroup for P~ and then dS).
// PERF.md has its times against the streamed kernel's and SDPA's.
//
// Backward elsewhere (dh 64, dropout, past 320 keys), three launches:
//   delta    delta = rowsum(dO . O), eight threads a row, 16-byte loads.
//   main     one CTA per (64 keys, head, sample): a warpgroup that computes
//            and a warp that writes dQ. K and V stay in shared memory; Q and
//            dO stream in 64-row tiles through a two-stage ring filled by
//            TMA (the operands' strides become 4-D tensor maps). Per tile,
//            each score tile is computed once: S = Q K^T and dP = dO V^T
//            (wgmma, operands in shared memory), P = exp(S/8 - lse), P~ and
//            dS = P (dP - delta) / 8 in registers; P~ and dS go to shared
//            memory for dV += P~^T dO and dK += dS^T Q (wgmma, read
//            MN-major), and dS stays in registers as the A operand of the
//            tile's dQ share dS K. Five products where the two-pass mma.sync
//            design this replaces ran seven, and one exp per score where it
//            ran two.
//   dq       adds the fp32 dQ sums and rounds them into dq.
// dQ is summed in a fixed order, so every output repeats bit for bit from
// run to run (no unordered atomics). The warpgroup leaves each tile's dQ
// share in shared memory; the writer adds it into an fp32 sum in the
// workspace with one bulk copy / bulk reduce-add of the copy engine, once a
// turn counter says the add before it has landed. The adds into a tile go
// in increasing key-block order and alternate between two sums (the dq pass
// adds them), so an add waits only for the one two places before it: the
// chain's latency (the reduce, its release, the next block's poll) then
// hides under two steps of work where it did not under one. When there are
// as many key blocks as query tiles, block kb walks tiles kb, kb - 1, ...
// (wrapping), so that its turn at each tile comes as its predecessor's add
// there lands; the blocks past the wrap (kb < tile) then add into two sums
// of their own, in order. Either way a block waits only for blocks of lower
// index in its (sample, head), so the backward needs none of its blocks on
// the card together: it progresses on whatever multiprocessors another
// stream or process leaves it, down to one. That rests on the card starting
// a grid's CTAs in index order, as CUDA does in practice without promising
// it (split-K semaphores rest on the same). Handing each CTA its key block
// from an atomic ticket, start order by construction, made the main pass
// slower at every shape tried (PERF.md).
//
// Forward at head dim 32 (MS-SiT: 96 / 3 ... 768 / 24), without dropout:
// the kernel above on native 32-column tiles (tensor maps of 32-column
// boxes in the 64-byte swizzle, S over two k16 steps, P V as n32 products:
// no zero columns; the outputs are those of the dh-64 design with 32
// columns zero-filled, bit for bit, which this replaced). Where queries =
// keys <= 320 and the sequence is not a whole number of 64-row tiles
// (resident_fwd: MS-SiT's axial folds of 20 and 80 rows),
// flash_fwd_resident_kernel<KS> (below) lays sequences side by side in
// units, so that no query tile is mostly empty. The softmax scale 1 /
// sqrt(32) = 2^-2.5 is not a float: lse takes it rounded once to fp32 (as
// the plain version's fp32 multiply does), the exponent the double product
// 2^-2.5 log2(e) rounded once (SoftmaxScale). The tiling rule is the same
// for both dh.
//
// The streamed backward at dh 32 (past 320 keys, or queries != keys) keeps
// the dh-64 tiles with the head's columns narrower: Q and dO arrive by TMA
// through 32-column maps in 64-column boxes (TMA zero-fills the rest), K
// and V by cp.async with the 16-byte pieces past column 32 zero-filled, so
// every tile, the swizzle, the descriptors and the ring's byte counts stay
// those of dh 64. S and dP
// run dh / 16 = 2 k16 steps; dV, dK and the dQ share run on the padded
// tiles (their columns 32-63 come out zero and are never written), so half
// of those three products' tensor work is on zeros; the kernel is bound by
// latency, not by the tensor cores (below). The dQ shares, the fp32 sums in
// the workspace and the dq pass carry dh columns, so the fixed-order sum
// moves no zeros. P = 2^(s * SoftmaxScale::slog2 - lse log2 e) and dS
// = P (dP - delta) SoftmaxScale::scale use the forward's two roundings of
// the scale, so the backward forms the probabilities the forward's lse
// describes; at dh 64 both are the exact 1/8 and the kernel is unchanged.
//
// Ragged edges, forward: rows past a tensor are zero-filled by TMA; keys in
// [valid_len, nk) are real data and take -inf before the row max; the last
// tile's 16-key P.V steps wholly past valid_len are skipped; query rows
// >= nq are never written.
//
// Ragged edges, backward: a key tile's ragged side is its key dimension,
// the N of S and dP and the K of dQ: keys >= valid_len take P = 0 and dQ skips
// the 16-key steps wholly past them; query rows >= valid_len take lse =
// +inf, so their P is 0 without a test per score, and dV / dK skip the
// 16-query steps wholly past them. Rows past the tensors are zero-filled by
// the loads.
//
// The block chains call the same launchers on their packed activations
// (flash_attention.cuh), and so does flash_attention_qkv on the packed (B,
// N, 3 H 64) qkv, through strides, writing dq, dk and dv into one packed
// gradient.
//
// Dropout (flash_attention_qkv_dropout, replacing _fwd_packed_drop /
// _bwd_packed_drop) is a compile-time flag on the forward and the main
// backward pass. The TPU kernel regenerates its mask from the Mosaic PRNG
// seeded per (batch, head) over the whole (N, N) tile; here the keep bit of
// score (b, h, row, col) is a pure function of its absolute coordinates:
// word col & 3 of Philox4x32-10 at counter {row, col / 4} under key {seed,
// b * heads + h} (common.cuh), kept when >= threshold, so the forward and
// the backward draw the same mask however they tile the scores. The row
// max, the sum l and lse are the undropped softmax's; O = keep(P) V / l / (1
// - rate); dV = P~^T dO with P~ = keep(P) / (1 - rate); dP = keep(dO V^T) /
// (1 - rate); dS = P (dP - delta) / 8. delta = rowsum(dO . O) stays the
// right correction because O is the dropped output the forward returned
// (rowsum(P dP) = dO . (P~ V)). A Philox4x32-10 call is ten rounds of two
// 32-bit multiplies with their high halves, so the draws are integer work
// the no-dropout kernels do not have. The backward's key tile holds its
// keys in a permuted column order (kperm) that gives each thread four
// consecutive keys of a query row: one call per four scores, each word
// drawn once per backward. The forward keeps the keys in order: in the
// wgmma layout threads 2u and 2u + 1 hold keys 4u .. 4u + 3 of rows g and
// g + 8, so the even one draws row g, the odd one row g + 8, and a shuffle
// swaps the halves; also one call per four scores.
//
// Numerics: scores, softmax, sums and accumulators in fp32; P rounded to
// bf16 before P.V and divided by the sum after it; P~ and dS rounded to bf16
// before their products; dQ summed in fp32 and rounded once. The forward's
// P is relative to the running max, so it can differ from the TPU kernel's
// (relative to the final max) in the last bf16 bit. exp(s / 8 - m) is
// formed as 2^(s * log2(e) / 8 - m log2(e)), one fused multiply-add and one
// ex2 per score.
//
// What bounds it on this card: at SiT-base (B 128, 12 heads, N 1281) the
// forward is 4 B H N^2 64 = 0.65 TFLOP against 0.3 GB of q, k, v, o, lse,
// so operations bound it (0.65 ms at the bf16 peak); the backward's five
// products are 2.5x that (1.6 ms). At dh = 64 each score costs about as much
// in the exp unit and the fp32 pipe as in the tensor cores (per SM and
// clock, 16 ex2 against 4096 bf16 operations, 128 per score in the
// forward), so the forward comes near its bound only where the softmax
// hides wholly under the products: hence the overlap within and between
// warpgroups. In the backward a 64 x 64 tile's products are short, so the
// main pass is bound by latency: the
// waits at each step's barriers and TMA, the products, and the dQ adds'
// chain. The dQ sums cost fp32 workspace traffic (up to four sums of B H N
// 64 floats, written once and read once by the dq pass) that the function's
// own bytes do not count. PERF.md has the times beside SDPA's and the bound.

#include <cuda.h>

#include <algorithm>

#include "flash_attention.cuh"

namespace {

using namespace svt;

constexpr float kScale = 0.125f;       // 1 / sqrt(64), exact
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kScaleLog2 = kScale * kLog2e;  // exp(s / 8 - x) = 2^(s * kScaleLog2 - x log2 e)

// The softmax scale 1 / sqrt(DH) (lse, and dS in the backward) and its
// product with log2(e) (the exponent), both directions: exact at dh 64; at
// dh 32, 2^-2.5 rounded once to fp32 and the double product 2^-2.5 log2(e)
// rounded once.
template <int DH>
struct SoftmaxScale;
template <>
struct SoftmaxScale<64> {
  static constexpr float scale = kScale, slog2 = kScaleLog2;
};
template <>
struct SoftmaxScale<32> {
  static constexpr float scale = 0.17677669529663688f;
  static constexpr float slog2 = (float)(0.17677669529663688 * 1.4426950408889634);
};

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// 2^x on the special-function unit; 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One tile of a 4-D tensor map (columns; rows and heads in the map's order;
// samples) into shared memory, counted on `bar`; the map's box sets its rows.
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap& m, uint64_t* bar, int row,
                                         int h, int b, bool heads_first) {
  tma_load_4d(dst, m, bar, 0, heads_first ? h : row, heads_first ? row : h, b);
}

// -- forward -----------------------------------------------------------------
//
// One CTA per (64 NWG queries, head, sample): warpgroup 0 is the producer
// (one thread issues every TMA load), warpgroups 1 .. NWG each own 64 query
// rows. Q lands once; K and V tiles of BK keys stream through a ring of
// FWD_STAGES stages, K and V with their own full / empty barriers, so a
// stage's K is refilled as soon as S has read it.

constexpr int FWD_STAGES = 2;     // K / V ring depth
constexpr int FWD_PRODUCER_REGS = 24;
constexpr int FWD_WG_BAR = 1;     // named barriers 1 .. NWG: one warpgroup's own

// CTAs per SM and the consumers' registers of a (warpgroups, key tile)
// variant: the producer gives back all but 24 of its registers and the
// consumers take the rest of the CTA's share of the SM's 65536.
template <int NWG, int BK>
struct FwdCfg {
  static constexpr int threads = (NWG + 1) * 128;
  static constexpr int ctas = NWG == 1 ? (BK == 64 ? 3 : 2) : 1;
  static constexpr int regs = 65536 / (ctas * threads) / 8 * 8;  // at launch
  static constexpr int consumer_regs =
      (regs * threads - FWD_PRODUCER_REGS * 128) / (NWG * 128) / 8 * 8;
  static_assert(consumer_regs <= 256, "setmaxnreg takes at most 256");
};

// Built with -DSVT_FWD_PROFILE (scripts/flash_fwd_breakdown.py), each
// consumer warpgroup adds the cycles it spends in each part of its loop to
// fwd_profile: the loop's own branch, S issued (K awaited), P.V issued (V awaited), S
// awaited, the softmax, P.V awaited, the rescale and packing, and the whole
// loop. Otherwise the marks compile to nothing.
#ifdef SVT_FWD_PROFILE
__device__ unsigned long long fwd_profile[8];
#define SVT_FWD_MARK(i)            \
  do {                             \
    const long long c_ = clock64(); \
    prof[i] += c_ - prof_t;        \
    prof_t = c_;                   \
  } while (0)
#else
#define SVT_FWD_MARK(i) \
  do {                  \
  } while (0)
#endif

// Tiles of DH columns: [rows][64] in the 128-byte swizzle at dh 64, [rows][32]
// in the 64-byte swizzle at dh 32 (native: no zero columns).
template <int NWG, int BK, int DH>
struct FwdSmem {
  bf16 q[NWG][64 * DH];  // a warpgroup's Q tile; its O on the way out
  bf16 k[FWD_STAGES][BK * DH], v[FWD_STAGES][BK * DH];
  uint64_t q_full, k_full[FWD_STAGES], v_full[FWD_STAGES];
  uint64_t k_empty[FWD_STAGES], v_empty[FWD_STAGES];
};

// Tile scores s (raw Q.K of keys key0 + column) -> P = exp((s - m) / sqrt(DH))
// in place, with the running row max m and sum l (this thread's columns)
// carried over and the old max's rescale factor a returned per row. With
// MASK (the tile that holds valid_len), columns >= kvalid take P = 0. With
// dropout, P is then zeroed where the keep bit is clear (l stays the
// undropped sum). Maxima and sums run in four chains per row.
template <int SA, bool DROP, bool MASK, int DH>
__device__ __forceinline__ void softmax_tile(float (&s)[SA], float (&m)[2], float (&l)[2],
                                             float (&a)[2], int kvalid, int key0, int row,
                                             uint32_t bh, const Dropout& dr, int t) {
  if constexpr (MASK) {
#pragma unroll
    for (int j = 0; j < SA / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t + (e & 1) >= kvalid) s[4 * j + e] = -INFINITY;
  }
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mx[r][c] = fmaxf(s[4 * c + 2 * r], s[4 * c + 2 * r + 1]);
      sum[r][c] = 0.f;
    }
#pragma unroll
  for (int j = 4; j < SA / 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r][j & 3] = fmaxf(mx[r][j & 3], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // every tile holds a key < kend: the new max is finite
    const float mn =
        fmaxf(m[r], quad_max(fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]))));
    a[r] = exp2_approx((m[r] - mn) * SoftmaxScale<DH>::slog2);  // 0 at the first tile
    m[r] = mn;
    ms[r] = mn * SoftmaxScale<DH>::slog2;
  }
#pragma unroll
  for (int j = 0; j < SA / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], SoftmaxScale<DH>::slog2, -ms[e >> 1]));
      sum[e >> 1][j & 3] += s[4 * j + e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * a[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
  if constexpr (DROP) {
    // Keys 4u .. 4u + 3 of a group of 8 share a Philox counter; threads 2u
    // and 2u + 1 hold them for rows g and g + 8. The even thread draws row
    // g, the odd one row g + 8, and one shuffle swaps the halves the other
    // needs: one call per four scores.
    const bool odd = t & 1;
#pragma unroll
    for (int j = 0; j < SA / 4; ++j) {
      const uint4 w = philox4x32((uint32_t)(row + (odd ? 8 : 0)),
                                 (uint32_t)(key0 + 8 * j) / 4 + (t >> 1), dr.seed, bh);
      const uint32_t lo = (w.x >= dr.threshold) | (w.y >= dr.threshold) << 1;
      const uint32_t hi = (w.z >= dr.threshold) | (w.w >= dr.threshold) << 1;
      const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 1);
      const uint32_t k0 = odd ? got : lo, k1 = odd ? hi : got;  // rows g, g + 8
      if (!(k0 & 1)) s[4 * j] = 0.f;
      if (!(k0 & 2)) s[4 * j + 1] = 0.f;
      if (!(k1 & 1)) s[4 * j + 2] = 0.f;
      if (!(k1 & 2)) s[4 * j + 3] = 0.f;
    }
  }
}

// P (fp32 accumulator layout) -> bf16 A fragments, one per 16 keys.
template <int SA>
__device__ __forceinline__ void pack_p(uint32_t (&p)[SA / 8][4], const float (&s)[SA]) {
#pragma unroll
  for (int kk = 0; kk < SA / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

template <int NWG, int BK, bool DROP, int DH>
__global__ void __launch_bounds__(FwdCfg<NWG, BK>::threads, FwdCfg<NWG, BK>::ctas)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, bool hf_q, bool hf_k, bool hf_v,
                     const Strided o, float* __restrict__ lse, int nq, int nk, int valid_len,
                     const Dropout dr) {
  constexpr int SA = BK / 2;  // score accumulators per thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  FwdSmem<NWG, BK, DH>& sm = *reinterpret_cast<FwdSmem<NWG, BK, DH>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int q0 = blockIdx.x * 64 * NWG;
  const int kend = min(valid_len, nk), ntiles = ceil_div(kend, BK);
  const int active = min(NWG, ceil_div(nq - q0, 64));  // warpgroups holding query rows
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int i = 0; i < FWD_STAGES; ++i) {
      mbar_init(&sm.k_full[i], 1);
      mbar_init(&sm.v_full[i], 1);
      mbar_init(&sm.k_empty[i], active);
      mbar_init(&sm.v_empty[i], active);
    }
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    set_max_regs_dec<FWD_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect(&sm.q_full, active * 64 * DH * 2);
      for (int w = 0; w < active; ++w)
        tma_tile(sm.q[w], tm_q, &sm.q_full, q0 + 64 * w, h, b, hf_q);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % FWD_STAGES, use = j / FWD_STAGES;
        if (use > 0) mbar_wait(&sm.k_empty[st], (use - 1) & 1);
        mbar_expect(&sm.k_full[st], BK * DH * 2);
        tma_tile(sm.k[st], tm_k, &sm.k_full[st], j * BK, h, b, hf_k);
        if (use > 0) mbar_wait(&sm.v_empty[st], (use - 1) & 1);
        mbar_expect(&sm.v_full[st], BK * DH * 2);
        tma_tile(sm.v[st], tm_v, &sm.v_full[st], j * BK, h, b, hf_v);
      }
    }
    return;
  }

  // a consumer warpgroup: query rows q0 + 64 w ..
  set_max_regs_inc<FwdCfg<NWG, BK>::consumer_regs>();
  const int w = wg - 1;
  if (w >= active) return;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 64 * w, row = row0 + 16 * warp + g;  // this thread's rows: row, row + 8
  const uint32_t bh = (uint32_t)(b * heads + h);

  float acc[DH / 2], s[SA], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2];
  uint32_t p[SA / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  const bf16* sq = sm.q[w];

  auto issue_s = [&](int j) {  // S = Q K_j^T
    const int st = j % FWD_STAGES;
    mbar_wait(&sm.k_full[st], (j / FWD_STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      if constexpr (DH == 32)
        wgmma_ss<0, 0>(s, sw64_desc(sq + ks * 16), sw64_desc(sm.k[st] + ks * 16), ks);
      else
        wgmma_ss<0, 0>(s, sw128_desc(sq + ks * 16), sw128_desc(sm.k[st] + ks * 16), ks);
    }
    wg_commit();
  };
  auto issue_pv = [&](int j, int ksteps) {  // O += P V_j, V read MN-major
    const int st = j % FWD_STAGES;
    mbar_wait(&sm.v_full[st], (j / FWD_STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (kk >= ksteps) continue;
      if constexpr (DH == 32)
        wgmma_rs<1>(acc, p[kk], sw64_desc(sm.v[st] + kk * 16 * DH), 1);
      else
        wgmma_rs<1>(acc, p[kk], sw128_desc(sm.v[st] + kk * 16 * DH), 1);
    }
    wg_commit();
  };
  auto release = [&](uint64_t* bar) {
    if (tid == 0) mbar_arrive(bar);
  };

  mbar_wait(&sm.q_full, 0);
  issue_s(0);
  wg_wait<0>();
  wg_hold(s);
  release(&sm.k_empty[0]);
  auto softmax = [&](int j) {  // tile j's scores in s -> P
    if (kend - j * BK < BK)
      softmax_tile<SA, DROP, true, DH>(s, m, l, a, kend - j * BK, j * BK, row, bh, dr, t);
    else
      softmax_tile<SA, DROP, false, DH>(s, m, l, a, BK, j * BK, row, bh, dr, t);
  };
  softmax(0);
  pack_p<SA>(p, s);
  // Tile j's P.V runs while tile j + 1's softmax does: S of j + 1 is issued
  // first, then P.V of j, then the softmax waits for S alone.
#ifdef SVT_FWD_PROFILE
  unsigned long long prof[7] = {0, 0, 0, 0, 0, 0, 0};
  const long long prof_t0 = clock64();
  long long prof_t = prof_t0;
#endif
  for (int j = 0; j + 1 < ntiles; ++j) {
    SVT_FWD_MARK(0);
    issue_s(j + 1);
    SVT_FWD_MARK(1);
    issue_pv(j, BK / 16);
    SVT_FWD_MARK(2);
    wg_wait<1>();
    wg_hold(s);
    SVT_FWD_MARK(3);
    release(&sm.k_empty[(j + 1) % FWD_STAGES]);
    softmax(j + 1);
    SVT_FWD_MARK(4);
    wg_wait<0>();
    wg_hold(acc);
    wg_hold(p);
    SVT_FWD_MARK(5);
    release(&sm.v_empty[j % FWD_STAGES]);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] *= a[(i >> 1) & 1];
    pack_p<SA>(p, s);
    SVT_FWD_MARK(6);
  }
#ifdef SVT_FWD_PROFILE
  if (tid == 0) {
    for (int i = 0; i < 7; ++i) atomicAdd(&fwd_profile[i], prof[i]);
    atomicAdd(&fwd_profile[7], (unsigned long long)(clock64() - prof_t0));
  }
#endif
  const int klast = kend - (ntiles - 1) * BK;  // keys of the last tile
  issue_pv(ntiles - 1, ceil_div(klast, 16));   // 16-key steps wholly past them skipped
  wg_wait<0>();
  wg_hold(acc);

  // O = acc / l (x 1 / (1 - rate)), lse = m / sqrt(DH) + log l
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = (DROP ? dr.inv_keep : 1.f) / l[r];
  }
  if (lse != nullptr && t == 0) {
    float* lrow = lse + (long long)bh * nq;
    if (row < nq) lrow[row] = m[0] * SoftmaxScale<DH>::scale + logf(l[0]);
    if (row + 8 < nq) lrow[row + 8] = m[1] * SoftmaxScale<DH>::scale + logf(l[1]);
  }
  // O's DH columns through this warpgroup's Q tile (its last reader, the
  // last S, is done), then out in 16-byte row pieces
  bf16* so = sm.q[w];
  auto at = [](int r, int c) { return DH == 32 ? sw64(r, c) : sw128(r, c); };
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(so + at(16 * warp + g + 8 * r, 8 * j + 2 * t)) =
          pack_bf16(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
  bar_sync(FWD_WG_BAR + w, 128);
  constexpr int PIECES = DH / 8;  // of a row
#pragma unroll
  for (int i = 0; i < 64 * PIECES / 128; ++i) {
    const int r = (128 / PIECES) * i + tid / PIECES, c = (tid % PIECES) * 8;
    if (row0 + r < nq)
      *reinterpret_cast<uint4*>(o.row(b, h, row0 + r) + c) =
          *reinterpret_cast<const uint4*>(so + at(r, c));
  }
}

// -- backward --------------------------------------------------------------
//
// Three launches: delta = rowsum(dO . O) (and the dQ turn counters zeroed);
// the main pass, one CTA (a compute warpgroup and a writer warp) per (64
// keys, head, sample) walking the query tiles; the dq pass, which adds the
// fp32 dQ sums and rounds to bf16. See the header.

constexpr int BWD_BK = 64, BWD_BQ = 64;    // keys per CTA, queries per step
constexpr int BWD_STAGES = 2;              // Q / dO tiles: this step's and the next one's
constexpr int BWD_SLOTS = 2;               // dQ shares between the warpgroup and the writer
constexpr int BWD_THREADS = 128 + 32;      // one compute warpgroup + the writer warp
constexpr int BWD_TILE = BWD_BQ * ATT_DH;  // floats of a dQ share's slot (dh 64)
constexpr int BWD_CHAINS = 4;              // ordered sums per query tile (see add_place)

// Floats of one query tile's dQ share, and of a sum in the workspace, at DH.
template <int DH>
__host__ __device__ constexpr int bwd_tile() {
  return BWD_BQ * DH;
}

// Shared memory of the main pass: 64-row bf16 tiles of 64 columns in the
// 128-byte swizzle, at either dh (at dh 32 columns 32-63 hold zeros).
struct BwdSmem {
  bf16 k[BWD_BK * ATT_DH], v[BWD_BK * ATT_DH];  // key rows in the permuted order kperm()
  bf16 q[BWD_STAGES][BWD_BQ * ATT_DH], d_o[BWD_STAGES][BWD_BQ * ATT_DH];  // ring filled by TMA
  bf16 p[BWD_BQ * BWD_BK], ds[BWD_BQ * BWD_BK];  // P~ and dS of the step, [query][key column]
  float4 dq[BWD_SLOTS][BWD_TILE / 4];           // dQ shares, in the accumulator's order (below)
  uint64_t loaded[BWD_STAGES];                  // a Q / dO stage has landed
  uint64_t full[BWD_SLOTS], empty[BWD_SLOTS];   // a share written / read by the copy engine
};

// A dQ share, and the sums in the workspace, are laid out as the warpgroup
// holds them: float4 m of thread i (d[4m .. 4m + 3]: rows 16 (i / 32) + (i
// % 32) / 4 and 8 below, columns 8m + 2 (i % 4) and the next) at m * 128 +
// i, so the threads' stores are conflict-free and one bulk copy moves a
// tile; flash_bwd_dq_kernel undoes it. At dh 32 the share is the first half
// (m < 4: columns 0-31).

// Key column c of a tile holds key kperm(c): the columns a thread holds
// (2t, 2t + 1, 8 + 2t, 9 + 2t of each 16) are then the four consecutive keys
// 4t .. 4t + 3, one Philox counter.
__device__ __forceinline__ int kperm(int c) {
  return (c & 48) | ((c & 6) << 1) | ((c >> 2) & 2) | (c & 1);
}

// Key rows k0 .. k0 + 63 of (b, h) into a swizzled tile, row r holding key
// k0 + kperm(r); zeros past n and past column DH.
template <int DH>
__device__ __forceinline__ void load_key_tile(bf16* dst, const Strided& t, int b, int h, int k0,
                                              int n, int tid) {
  for (int i = tid; i < 64 * 8; i += 128) {
    const int r = i >> 3, ch = i & 7;
    const int src = k0 + kperm(r);
    const bool ok = src < n && ch < DH / 8;
    cp_async16(dst + sw128(r, ch * 8), ok ? t.row(b, h, src) + ch * 8 : t.p, ok);
  }
}

// The compute warpgroup's own barrier (the writer warp does not take part).
__device__ __forceinline__ void wg_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

// delta = rowsum(dO . O) over (B, heads, nq) rows, DH / 8 threads a row, one
// 16-byte load of each operand per thread; zeroes the nsem turn counters.
template <int DH>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const Strided o, const Strided d_o, float* __restrict__ delta,
                           int* __restrict__ sems, long long nsem, int heads, int nq,
                           long long rows) {
  constexpr int PARTS = DH / 8;  // threads of a row
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid < nsem) sems[gid] = 0;
  const long long r = gid / PARTS;
  const int part = threadIdx.x % PARTS;
  float s = 0.f;
  if (r < rows) {
    const int row = (int)(r % nq), bh = (int)(r / nq);
    const uint4 a = *reinterpret_cast<const uint4*>(o.row(bh / heads, bh % heads, row) + part * 8);
    const uint4 c =
        *reinterpret_cast<const uint4*>(d_o.row(bh / heads, bh % heads, row) + part * 8);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(c2[i]);
      s = fmaf(x.x, y.x, fmaf(x.y, y.y, s));
    }
  }
#pragma unroll
  for (int x = 1; x < PARTS; x *= 2) s += __shfl_xor_sync(0xffffffffu, s, x);
  if (r < rows && part == 0) delta[r] = s;
}

// The query tile key block kb takes at `step`. Rotated (as many key blocks
// as query tiles), block kb walks tiles kb, kb - 1, ..., 0, nqt - 1, ...:
// in step with its neighbours, block kb reaches a tile the step after block
// kb - 1 did (past the wrap, block 0 the step after block nqt - 1).
// Otherwise tiles go in order.
__device__ __forceinline__ int step_tile(int kb, int step, int nqt, bool rotate) {
  return rotate ? (kb - step + nqt) % nqt : step;
}

// Which of the BWD_CHAINS sums of `tile` block kb adds into, and its rank
// there (how many adds into that sum come before it). The adds go in runs
// of increasing block index, each run alternating between two sums, so an
// add waits only for the add two places before it in its run: the chain's
// latency (the copy engine's reduce, its release, the next block's poll)
// overlaps the next step's work. In order, one run: blocks 0, 1, ...
// Rotated, two: blocks tile, tile + 1, ... (sums 0, 1), then the blocks
// past the wrap, 0, 1, ..., tile - 1 (sums 2, 3), so that no block waits
// for one of higher index.
__device__ __forceinline__ int2 add_place(int kb, int tile, bool rotate) {
  const bool wrapped = rotate && kb < tile;
  const int pos = rotate && !wrapped ? kb - tile : kb;  // place in its run
  return make_int2(2 * wrapped + (pos & 1), pos >> 1);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Spin until *p == v. A wait far beyond any kernel's run (seconds) traps, so
// a broken order fails the launch instead of hanging the card.
__device__ __forceinline__ void wait_turn(const int* p, int v) {
  for (long long n = 0; ld_acquire(p) != v; ++n) {
    if (n > (1ll << 26)) __trap();
    __nanosleep(32);
  }
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The writer (one thread): the share of each step into its tile's sum once
// the add before it in that sum is done, with one bulk copy (the first add)
// or bulk reduce-add, then the turn passes on. sums: (BWD_CHAINS, B *
// heads, nqt_all) tiles of bwd_tile<DH>() floats; sems: (BWD_CHAINS, B *
// heads, nqt_all) counters.
template <int DH>
__device__ __forceinline__ void dq_writer(BwdSmem& sm, float* sums, int* sems,
                                          long long chain_tiles, int kb, int nqt,
                                          bool rotate) {
  constexpr int TILE = bwd_tile<DH>();
  for (int step = 0; step < nqt; ++step) {
    const int slot = step % BWD_SLOTS, tile = step_tile(kb, step, nqt, rotate);
    const int2 place = add_place(kb, tile, rotate);
    const int chain = place.x, rank = place.y;
    int* sem = sems + chain * chain_tiles + tile;
    if (rank > 0) {  // wait for the turn first: the slot is held only while it is read
      wait_turn(sem, rank);
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
    }
    mbar_wait(&sm.full[slot], (step / BWD_SLOTS) & 1);
    float* dst = sums + (chain * chain_tiles + tile) * TILE;
    const uint32_t src = smem_u32(sm.dq[slot]);
    if (rank == 0)
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                   "r"(src), "r"(TILE * 4)
                   : "memory");
    else
      asm volatile(
          "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
              dst),
          "r"(src), "r"(TILE * 4)
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    mbar_arrive(&sm.empty[slot]);  // the slot may be refilled
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    st_release(sem, rank + 1);
  }
}

// The main pass, key block blockIdx.x. Per query tile: S = Q K^T and dP =
// dO V^T (wgmma, both operands in shared memory); P = exp(S/8 - lse), the
// keep bits, P~ and dS in registers; P~ and dS to shared memory; dV += P~^T
// dO, dK += dS^T Q (wgmma, P~ and dS read MN-major) and the tile's dQ share
// dS K (wgmma, dS from registers), which goes to shared memory for the
// writer warp.
template <bool DROP, int DH>
__global__ void __launch_bounds__(BWD_THREADS, 2)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do, bool hf_q, bool hf_do,
                     const Strided k, const Strided v, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ sums,
                     int* __restrict__ sems, const Strided dk, const Strided dv, int nq, int nk,
                     int valid_len, bool rotate, const Dropout dr) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = b * heads + h;
  const long long hrow = (long long)bh * nq;
  const int kend = min(valid_len, nk), qend = min(valid_len, nq);
  const int nqt = ceil_div(qend, BWD_BQ), nqt_all = ceil_div(nq, BWD_BQ);
  const int kb = blockIdx.x, k0 = kb * BWD_BK;
  const int steps = k0 < kend ? nqt : 0;  // a block past kend holds no valid key
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's rows of a 64-row accumulator

  if (tid == 0) {
    for (int i = 0; i < BWD_SLOTS; ++i) {
      mbar_init(&sm.full[i], 128);
      mbar_init(&sm.empty[i], 1);
    }
    for (int i = 0; i < BWD_STAGES; ++i) mbar_init(&sm.loaded[i], 1);
  }
  __syncthreads();
  if (warp == 4) {  // the writer
    const long long chain_tiles = (long long)gridDim.z * heads * nqt_all;
    if (lane == 0 && steps > 0)
      dq_writer<DH>(sm, sums + (long long)bh * nqt_all * bwd_tile<DH>(),
                    sems + (long long)bh * nqt_all, chain_tiles, kb, nqt, rotate);
    return;
  }

  // Q and dO rows of step s (one thread issues)
  auto load_step = [&](int s) {
    const int st = s % BWD_STAGES, q0 = step_tile(kb, s, nqt, rotate) * BWD_BQ;
    mbar_expect(&sm.loaded[st], 2 * BWD_BQ * ATT_DH * 2);  // whole boxes, zero fill included
    tma_tile(sm.q[st], tm_q, &sm.loaded[st], q0, h, b, hf_q);
    tma_tile(sm.d_o[st], tm_do, &sm.loaded[st], q0, h, b, hf_do);
  };
  if (tid == 0 && steps > 0) load_step(0);  // each step then fetches the next one's

  float s[32], dp[32], dva[32], dka[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = dva[i] = dka[i] = 0.f;
  if (steps > 0) {
    const int kvalid = min(BWD_BK, kend - k0);
    load_key_tile<DH>(sm.k, k, b, h, k0, nk, tid);
    load_key_tile<DH>(sm.v, v, b, h, k0, nk, tid);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
    wg_sync();  // K and V are in shared memory

    for (int step = 0; step < nqt; ++step) {
      const int st = step % BWD_STAGES, q0 = step_tile(kb, step, nqt, rotate) * BWD_BQ;
      // rows >= qend take lse = +inf, so P = 0
      const float ml0 = q0 + r0 < qend ? lse[hrow + q0 + r0] * kLog2e : INFINITY;
      const float ml1 = q0 + r1 < qend ? lse[hrow + q0 + r1] * kLog2e : INFINITY;
      const float dl0 = q0 + r0 < qend ? delta[hrow + q0 + r0] : 0.f;
      const float dl1 = q0 + r1 < qend ? delta[hrow + q0 + r1] : 0.f;
      if (step > 0) wg_sync();  // every thread is past the last step, whose stage is refilled
      if (tid == 0 && step + 1 < steps) load_step(step + 1);
      mbar_wait(&sm.loaded[st], (step / BWD_STAGES) & 1);  // this step's tile landed

      // S = Q K^T, dP = dO V^T
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        wgmma_ss<0, 0>(s, sw128_desc(sm.q[st] + ks * 16), sw128_desc(sm.k + ks * 16), ks);
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        wgmma_ss<0, 0>(dp, sw128_desc(sm.d_o[st] + ks * 16), sw128_desc(sm.v + ks * 16), ks);
      wg_commit();
      wg_wait<0>();
      wg_hold(s);
      wg_hold(dp);

      // P, keep bits, P~, dS
      uint32_t dsf[4][4];  // dS as the A fragments of dQ, one per 16 key columns
#pragma unroll
      for (int G = 0; G < 4; ++G) {
        // the thread's keys 16G + 4t + e of rows r0 (x[0][e]) and r1 (x[1][e])
        float x[2][4], y[2][4];
        const int i0 = 8 * G, i1 = 8 * G + 4;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          x[rr][0] = s[i0 + 2 * rr];
          x[rr][1] = s[i0 + 2 * rr + 1];
          x[rr][2] = s[i1 + 2 * rr];
          x[rr][3] = s[i1 + 2 * rr + 1];
          y[rr][0] = dp[i0 + 2 * rr];
          y[rr][1] = dp[i0 + 2 * rr + 1];
          y[rr][2] = dp[i1 + 2 * rr];
          y[rr][3] = dp[i1 + 2 * rr + 1];
        }
        const int key = k0 + 16 * G + 4 * t;
        if (kvalid < BWD_BK) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key + e >= kend) x[0][e] = x[1][e] = -INFINITY;
        }
        uint32_t keep[2] = {0xFu, 0xFu};
        if constexpr (DROP) {  // one Philox4x32-10 gives the four keys' words
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const uint4 w = philox4x32((uint32_t)(q0 + (rr ? r1 : r0)), (uint32_t)key >> 2,
                                       dr.seed, (uint32_t)bh);
            keep[rr] = (w.x >= dr.threshold) | (w.y >= dr.threshold) << 1 |
                       (w.z >= dr.threshold) << 2 | (w.w >= dr.threshold) << 3;
          }
        }
        float pt[2][4], dsv[2][4];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float ml = rr ? ml1 : ml0, dl = rr ? dl1 : dl0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pr = exp2_approx(fmaf(x[rr][e], SoftmaxScale<DH>::slog2, -ml));
            if constexpr (DROP) {
              const bool kept = (keep[rr] >> e) & 1;
              pt[rr][e] = kept ? pr * dr.inv_keep : 0.f;
              dsv[rr][e] =
                  pr * ((kept ? y[rr][e] * dr.inv_keep : 0.f) - dl) * SoftmaxScale<DH>::scale;
            } else {
              pt[rr][e] = pr;
              dsv[rr][e] = pr * (y[rr][e] - dl) * SoftmaxScale<DH>::scale;
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = rr ? r1 : r0;
          const uint32_t d01 = pack_bf16(dsv[rr][0], dsv[rr][1]);
          const uint32_t d23 = pack_bf16(dsv[rr][2], dsv[rr][3]);
          *reinterpret_cast<uint32_t*>(sm.p + sw128(row, 16 * G + 2 * t)) =
              pack_bf16(pt[rr][0], pt[rr][1]);
          *reinterpret_cast<uint32_t*>(sm.p + sw128(row, 16 * G + 8 + 2 * t)) =
              pack_bf16(pt[rr][2], pt[rr][3]);
          *reinterpret_cast<uint32_t*>(sm.ds + sw128(row, 16 * G + 2 * t)) = d01;
          *reinterpret_cast<uint32_t*>(sm.ds + sw128(row, 16 * G + 8 + 2 * t)) = d23;
          dsf[G][rr] = d01;
          dsf[G][2 + rr] = d23;
        }
      }
      fence_async_smem();
      wg_sync();  // P~ and dS are in shared memory

      // dV += P~^T dO, dK += dS^T Q over the valid queries; dQ share = dS K
      const int qsteps = min(BWD_BQ, qend - q0 + 15) / 16, ksteps = (kvalid + 15) / 16;
      wg_fence();
#pragma unroll
      for (int kq = 0; kq < BWD_BQ / 16; ++kq) {
        if (kq < qsteps) {
          wgmma_ss<1, 1>(dva, sw128_desc(sm.p + kq * 16 * BWD_BK),
                         sw128_desc(sm.d_o[st] + kq * 16 * ATT_DH), 1);
          wgmma_ss<1, 1>(dka, sw128_desc(sm.ds + kq * 16 * BWD_BK),
                         sw128_desc(sm.q[st] + kq * 16 * ATT_DH), 1);
        }
      }
#pragma unroll
      for (int G = 0; G < 4; ++G)
        if (G < ksteps)  // S is spent: it takes the dQ share
          wgmma_rs<1>(s, dsf[G], sw128_desc(sm.k + G * 16 * ATT_DH), G);
      wg_commit();
      wg_wait<0>();
      wg_hold(dva);
      wg_hold(dka);
      wg_hold(s);

      // the share to a free slot for the writer
      const int slot = step % BWD_SLOTS;
      if (step >= BWD_SLOTS) mbar_wait(&sm.empty[slot], (step / BWD_SLOTS - 1) & 1);
#pragma unroll
      for (int m = 0; m < DH / 8; ++m)
        sm.dq[slot][m * 128 + tid] =
            make_float4(s[4 * m], s[4 * m + 1], s[4 * m + 2], s[4 * m + 3]);
      fence_async_smem();
      mbar_arrive(&sm.full[slot]);
    }
  }

  // dK, dV: accumulator row m is key k0 + kperm(m); keys >= kend are 0
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = k0 + kperm(rr ? r1 : r0);
    if (key >= nk) continue;
    bf16* dkr = dk.row(b, h, key);
    bf16* dvr = dv.row(b, h, key);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int d = 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dkr + d) =
          __floats2bfloat162_rn(dka[4 * j + 2 * rr], dka[4 * j + 2 * rr + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvr + d) =
          __floats2bfloat162_rn(dva[4 * j + 2 * rr], dva[4 * j + 2 * rr + 1]);
    }
  }
}

// -- backward, resident (head dim 32, N <= 320, no dropout) --------------------
//
// One CTA per unit: a (sample, head)'s whole sequence, or, where N <= 32,
// pack = 64 / N of them side by side in one 64-row tile. Its Q, K, V and dO
// (T = ceil(rows / 64) tiles of [rows][32] in the 64-byte swizzle) land once
// by cp.async and stay; warpgroup w owns query tile w and its dQ
// accumulators. In round r it takes key block kb = (w + r) % T: S and dP
// (n32 halves of the 64-key block), P~ and dS in registers, the tile's dQ
// share dS K added into its dQ registers, then dV = P~^T dO and dK = dS^T Q
// through its own staging tile, added into key block kb's fp32 sums in
// shared memory (one warpgroup adds into a block in a round, once the
// block's turn counter says the round before it has). So every sum runs in
// a fixed order (dQ over kb = w, w +
// 1, ..; dK and dV over the rounds), no product spends tensor work on zero
// columns, and nothing but the outputs goes to device memory: no workspace,
// no delta or dq pass (delta comes from O and dO rows read by each thread
// for its own rows).

constexpr int RES_MAX_TILES = 5;  // 320 keys, MS-SiT's longest sequence
// The one-tile kernel's CTAs per SM (its registers: 65536 / (128 x it)).
constexpr int RES_T1_CTAS = 4;

template <int T>
struct ResSums {  // key block sums over the rounds
  float4 dk[T][4 * 128], dv[T][4 * 128];
  int turn[T];  // rounds whose adds into the block are in
};
template <>
struct ResSums<1> {};  // one round: each block is written as it is made

template <int T>
struct ResSmem {
  bf16 q[T * 64 * 32], k[T * 64 * 32], v[T * 64 * 32], d_o[T * 64 * 32];
  bf16 stage[T][64 * 64];  // warpgroup w's P~, then its dS: [query][key], 128-byte swizzle
  ResSums<T> sums;
};

// The unit's rows: tile row i holds row i % n of sequence u * pack + i / n
// of B * heads (none past the pack or the last sequence).
struct ResGeom {
  int n, valid_len, pack, bh_total, heads;
};

// (sequence, row) of tile row i of unit u; x < 0 where the row holds none.
__device__ __forceinline__ int2 res_row(int u, int i, const ResGeom& gm) {
  const int seg = i / gm.n, bh = u * gm.pack + seg;
  return seg < gm.pack && bh < gm.bh_total ? make_int2(bh, i - seg * gm.n) : make_int2(-1, 0);
}

// A 64 x 32 gradient tile (this thread's 16 accumulators, rows r0 and r0 +
// 8) into rows row0 + .. of the unit, as bf16 (rows that hold no sequence
// row skipped).
__device__ __forceinline__ void res_store(const float (&d)[16], const Strided& out, int u, int row0,
                                          int r0, int t, const ResGeom& gm) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int2 br = res_row(u, row0 + r0 + 8 * rr, gm);
    if (br.x < 0) continue;
    bf16* p = out.row(br.x / gm.heads, br.x % gm.heads, br.y);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j + 2 * t) = pack_bf16(d[4 * j + 2 * rr],
                                                                  d[4 * j + 2 * rr + 1]);
  }
}

// Round r's share of key block kb's dK or dV: stored into its sum at round
// 0, added after it; at the last round the sum (+ the share) is rounded and
// written to the block's key rows.
template <int T>
__device__ __forceinline__ void res_key_sum(float4* sum, float (&d)[16], int r, const Strided& out,
                                            int u, int kb, int tid, int r0, int t,
                                            const ResGeom& gm) {
  if constexpr (T > 1) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float4& a = sum[m * 128 + tid];
      if (r == 0) {
        a = make_float4(d[4 * m], d[4 * m + 1], d[4 * m + 2], d[4 * m + 3]);
      } else if (r < T - 1) {
        a.x += d[4 * m];
        a.y += d[4 * m + 1];
        a.z += d[4 * m + 2];
        a.w += d[4 * m + 3];
      } else {
        d[4 * m] += a.x;
        d[4 * m + 1] += a.y;
        d[4 * m + 2] += a.z;
        d[4 * m + 3] += a.w;
      }
    }
    if (r < T - 1) return;
  }
  res_store(d, out, u, 64 * kb, r0, t, gm);
}

__device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared::cta.b32 %0, [%1];\n" : "=r"(v) : "r"(smem_u32(p)) : "memory");
  return v;
}
__device__ __forceinline__ void st_release_cta(int* p, int v) {
  asm volatile("st.release.cta.shared::cta.b32 [%0], %1;\n" ::"r"(smem_u32(p)), "r"(v) : "memory");
}

// Round r's turn at key block kb's sums: the warpgroup goes on once the
// adds of rounds 0 .. r - 1 are in (one thread polls, then the warpgroup's
// barrier). A wait far beyond any kernel's run traps rather than hangs.
template <int T>
__device__ __forceinline__ void res_turn(ResSmem<T>& sm, int kb, int r, int w, int tid) {
  if constexpr (T > 1) {
    if (r == 0) return;
    if (tid == 0)
      for (long long n = 0; ld_acquire_cta(&sm.sums.turn[kb]) != r; ++n) {
        if (n > (1ll << 26)) __trap();
        __nanosleep(20);
      }
    bar_sync(1 + w, 128);
  }
}

// Key block kb's sum of dK (or dV) in shared memory (none at T = 1).
template <int T>
__device__ __forceinline__ float4* res_sum(ResSmem<T>& sm, bool is_dk, int kb) {
  if constexpr (T > 1) return is_dk ? sm.sums.dk[kb] : sm.sums.dv[kb];
  return nullptr;
}

template <int T>
__global__ void __launch_bounds__(128 * T, T == 1 ? RES_T1_CTAS : T == 2 ? 2 : 1)
    flash_bwd_resident_kernel(const Strided q, const Strided k, const Strided v, const Strided o,
                              const Strided d_o, const float* __restrict__ lse, const Strided dq,
                              const Strided dk, const Strided dv, const ResGeom gm) {
  constexpr int ROWS = 64 * T;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  ResSmem<T>& sm = *reinterpret_cast<ResSmem<T>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int u = blockIdx.x;
  // the warpgroup, broadcast so that the compiler sees it uniform (wgmma
  // behind a branch it cannot prove uniform is serialised)
  const int w = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's rows of a 64-row accumulator: r0, r0 + 8
  // tile rows (queries or keys) at which P can be nonzero end here
  const int span = gm.pack == 1 ? min(gm.valid_len, gm.n) : gm.pack * gm.n;

  // Q, K, V, dO of the unit: 16-byte pieces, zeros where a row holds none
  for (int idx = threadIdx.x; idx < 16 * ROWS; idx += 128 * T) {
    const int which = idx / (4 * ROWS), i = (idx >> 2) % ROWS, ch = idx & 3;
    const Strided src = which == 0 ? q : which == 1 ? k : which == 2 ? v : d_o;
    bf16* dst = which == 0 ? sm.q : which == 1 ? sm.k : which == 2 ? sm.v : sm.d_o;
    const int2 br = res_row(u, i, gm);
    cp_async16(dst + sw64(i, ch * 8),
               br.x >= 0 ? src.row(br.x / gm.heads, br.x % gm.heads, br.y) + ch * 8 : src.p,
               br.x >= 0);
  }
  cp_async_commit();

  // this thread's query rows: lse (+inf past valid_len, so P = 0 without a
  // test per score), delta = rowsum(dO . O) over a quad (8 columns a thread)
  float ml[2], dl[2];
  int segr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = 64 * w + r0 + 8 * rr;
    const int2 br = res_row(u, i, gm);
    const bool live = br.x >= 0 && br.y < gm.valid_len;
    segr[rr] = i / gm.n;
    float s = 0.f;
    ml[rr] = INFINITY;
    if (live) {
      const int b = br.x / gm.heads, h = br.x % gm.heads;
      ml[rr] = lse[(long long)br.x * gm.n + br.y] * kLog2e;
      const uint4 a = *reinterpret_cast<const uint4*>(o.row(b, h, br.y) + 8 * t);
      const uint4 c = *reinterpret_cast<const uint4*>(d_o.row(b, h, br.y) + 8 * t);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(c2[e]);
        s = fmaf(x.x, y.x, fmaf(x.y, y.y, s));
      }
    }
    s = quad_sum(s);
    dl[rr] = live ? s : 0.f;
  }
  if constexpr (T > 1)
    if (threadIdx.x < T) sm.sums.turn[threadIdx.x] = 0;
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();  // the unit is in shared memory

  const bf16* qt = sm.q + 64 * w * 32;
  const bf16* dot = sm.d_o + 64 * w * 32;
  bf16* stg = sm.stage[w];
  const int qsteps = max(0, min(4, (span - 64 * w + 15) / 16));  // 16-query steps that can hold P
  float dqa[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dqa[i] = 0.f;

  for (int r = 0; r < T; ++r) {
    const int kb = (w + r) % T;
    const int ksteps = max(0, min(4, (span - 64 * kb + 15) / 16));
    // which of this thread's 16 key columns (bit 8 h + 2 jj + e: column 32 h
    // + 8 jj + 2 t + e of the block) rows r0 and r0 + 8 may see
    uint32_t allow[2] = {0u, 0u};
#pragma unroll
    for (int bit = 0; bit < 16; ++bit) {
      const int kc = 64 * kb + 32 * (bit >> 3) + 8 * ((bit >> 1) & 3) + 2 * t + (bit & 1);
      if (gm.pack == 1) {
        if (kc < span) {
          allow[0] |= 1u << bit;
          allow[1] |= 1u << bit;
        }
      } else {  // packed: a key of the row's own sequence, below valid_len
        const int segk = kc / gm.n;
        if (kc - segk * gm.n < gm.valid_len) {
          allow[0] |= (uint32_t)(segk == segr[0]) << bit;
          allow[1] |= (uint32_t)(segk == segr[1]) << bit;
        }
      }
    }

    uint32_t dsf[4][4];  // dS as the A fragments of dQ, one per 16 keys
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bf16* kh = sm.k + (64 * kb + 32 * h) * 32;
      const bf16* vh = sm.v + (64 * kb + 32 * h) * 32;
      float s[16], dp[16];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        wgmma_ss<0, 0>(s, sw64_desc(qt + ks * 16), sw64_desc(kh + ks * 16), ks);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        wgmma_ss<0, 0>(dp, sw64_desc(dot + ks * 16), sw64_desc(vh + ks * 16), ks);
      wg_commit();
      wg_wait<0>();
      wg_hold(s);
      wg_hold(dp);
      wg_hold(dqa);
      // P, P~ to the staging tile, dS
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float pt[2], dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * jj + 2 * rr + e, bit = 8 * h + 2 * jj + e;
            const float x = (allow[rr] >> bit) & 1 ? s[idx] : -INFINITY;
            pt[e] = exp2_approx(fmaf(x, SoftmaxScale<32>::slog2, -ml[rr]));
            dsv[e] = pt[e] * (dp[idx] - dl[rr]) * SoftmaxScale<32>::scale;
          }
          *reinterpret_cast<uint32_t*>(stg + sw128(r0 + 8 * rr, 32 * h + 8 * jj + 2 * t)) =
              pack_bf16(pt[0], pt[1]);
          dsf[2 * h + (jj >> 1)][2 * (jj & 1) + rr] = pack_bf16(dsv[0], dsv[1]);
        }
      // dQ += dS K over this half's keys (16-key steps past the span skipped)
      wg_fence();
#pragma unroll
      for (int G = 2 * h; G < 2 * h + 2; ++G)
        if (G < ksteps) wgmma_rs<1>(dqa, dsf[G], sw64_desc(sm.k + (64 * kb + 16 * G) * 32), 1);
      wg_commit();
    }
    fence_async_smem();
    bar_sync(1 + w, 128);  // the tile's P~ is in shared memory

    // dV share = P~^T dO over the query steps that can hold P
    float dvs[16], dks[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) dvs[i] = dks[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kq = 0; kq < 4; ++kq)
      if (kq < qsteps)
        wgmma_ss<1, 1>(dvs, sw128_desc(stg + kq * 16 * 64), sw64_desc(dot + kq * 16 * 32), 1);
    wg_commit();
    wg_wait<0>();  // also the dQ products: P~ is read, dsf free
    wg_hold(dvs);
    wg_hold(dqa);
    // dS over P~, then dK share = dS^T Q
#pragma unroll
    for (int G = 0; G < 4; ++G)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        *reinterpret_cast<uint32_t*>(
            stg + sw128(r0 + 8 * (kk & 1), 16 * G + 8 * (kk >> 1) + 2 * t)) = dsf[G][kk];
    fence_async_smem();
    bar_sync(1 + w, 128);
    wg_fence();
#pragma unroll
    for (int kq = 0; kq < 4; ++kq)
      if (kq < qsteps)
        wgmma_ss<1, 1>(dks, sw128_desc(stg + kq * 16 * 64), sw64_desc(qt + kq * 16 * 32), 1);
    wg_commit();
    res_turn(sm, kb, r, w, tid);
    res_key_sum<T>(res_sum(sm, false, kb), dvs, r, dv, u, kb, tid, r0, t, gm);
    wg_wait<0>();
    wg_hold(dks);
    res_key_sum<T>(res_sum(sm, true, kb), dks, r, dk, u, kb, tid, r0, t, gm);
    if constexpr (T > 1) {
      if (r + 1 < T) {  // the block's turn passes to round r + 1
        bar_sync(1 + w, 128);
        if (tid == 0) st_release_cta(&sm.sums.turn[kb], r + 1);
      }
    }
  }
  res_store(dqa, dq, u, 64 * w, r0, t, gm);
}

template <int T>
cudaError_t launch_resident(const Strided& q, const Strided& k, const Strided& v, const Strided& o,
                            const Strided& d_o, const float* lse, const Strided& dq,
                            const Strided& dk, const Strided& dv, const ResGeom& gm, int units,
                            cudaStream_t st) {
  constexpr int smem = sizeof(ResSmem<T>) + 1024;  // + alignment to 1024 bytes
  static bool ready[16];  // the shared-memory limit, set once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16 || !ready[dev]) {
    e = cudaFuncSetAttribute(flash_bwd_resident_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < 16) ready[dev] = true;
  }
  flash_bwd_resident_kernel<T><<<units, 128 * T, smem, st>>>(q, k, v, o, d_o, lse, dq, dk, dv, gm);
  return cudaGetLastError();
}

// -- forward, resident (head dim 32, N <= 320, no dropout) --------------------
//
// One CTA (one warpgroup) per 64-row query tile of a unit: `pack` sequences
// of a fold side by side (ResGeom, res_row: tile row i holds row i % n of
// sequence u * pack + i / n), so that no query tile is mostly empty: 64 / n
// sequences of n <= 32 in one tile (stage 2's axial fold: 3 of 20), else
// 320 / n of them across up to five tiles (stage 1's axial fold: four of
// 80 in five full tiles, where one sequence a CTA ran 64 + 16 query rows
// against 64 + 16 keys). The tile's Q and the keys its rows can see (from
// the first row's sequence start to the last row's sequence end) land once
// by cp.async in [rows][32] tiles of the 64-byte swizzle (a packed sequence
// starts inside a swizzle atom, where no TMA box lands); then per step of
// KS keys S = Q K^T (two k16 products of n = KS), the mask (each row sees
// its own sequence's keys below valid_len: a block-diagonal mask where
// sequences share the tile), the online softmax, P rounded to bf16 as the A
// operand of O += P V (n32, V read MN-major). KS is 64 where the unit is one
// tile, so that a row's max is over all its keys at once (a max found late
// rescales P after its bf16 rounding: the W8A8 block's share gate at N = 20
// saw it), else 32. No product spends tensor work on zero columns, and
// shared memory holds 64 bytes a key where the dh-64 tiles held 128. O
// leaves through the Q tile in 16-byte row pieces; lse = m / sqrt(32) + log
// l, as the streamed kernel writes it. 72 registers, four CTAs an SM.

constexpr int FWD_RES_MAX_ROWS = 320;  // a unit's rows: five 64-row tiles

// Sequences of n rows a unit of the resident forward holds.
__host__ __device__ __forceinline__ int fwd_pack(int n) {
  return n <= 32 ? 64 / n : FWD_RES_MAX_ROWS / n;
}

// The keys (unit rows) query tile qt can see: [k0, k1), k0 on a 32-key half.
__host__ __device__ __forceinline__ int2 fwd_key_range(int qt, const ResGeom& gm) {
  const int rows = gm.pack * gm.n, first = 64 * qt;
  const int last = (first + 64 < rows ? first + 64 : rows) - 1;
  const int k0 = (first / gm.n) * gm.n & ~31;
  return make_int2(k0, (last / gm.n) * gm.n + (gm.valid_len < gm.n ? gm.valid_len : gm.n));
}

// A thread's rows i0, i0 + 32, .. of unit u: each row's (sequence of the
// unit, row in it) and (sample, head), stepped without a division.
struct UnitRows {
  int seg, rem, bh, b, h;
  __device__ __forceinline__ UnitRows(int u, int i0, const ResGeom& gm) {
    seg = i0 / gm.n;
    rem = i0 - seg * gm.n;
    bh = u * gm.pack + seg;
    b = bh / gm.heads;
    h = bh - b * gm.heads;
  }
  __device__ __forceinline__ bool live(const ResGeom& gm) const {
    return seg < gm.pack && bh < gm.bh_total;
  }
  __device__ __forceinline__ void step(const ResGeom& gm) {
    for (rem += 32; rem >= gm.n; rem -= gm.n) {
      ++seg;
      ++bh;
      if (++h == gm.heads) h = 0, ++b;
    }
  }
};

// rows [i0, i0 + rows) of unit u of t into a [rows][32] tile: 16-byte
// pieces (four a row, piece tid % 4 of rows tid / 4 + 32 k), zeros where a
// row holds no sequence row
__device__ __forceinline__ void load_rows(bf16* dst, const Strided t, int u, int i0, int rows,
                                          const ResGeom& gm, int tid) {
  const int ch = tid & 3;
  UnitRows w(u, i0 + (tid >> 2), gm);
  for (int i = tid >> 2; i < rows; i += 32, w.step(gm)) {
    const bool ok = w.live(gm);
    cp_async16(dst + sw64(i, 8 * ch), ok ? t.row(w.b, w.h, w.rem) + 8 * ch : t.p, ok);
  }
}

// KS keys a step: 64 where the unit is one tile (sequences of N <= 32), so
// that each row's softmax takes its max over all its keys at once, as the
// streamed kernel's one 64-key tile did; else 32.
template <int KS>
__global__ void __launch_bounds__(128, 4)
    flash_fwd_resident_kernel(const Strided q, const Strided k, const Strided v, const Strided o,
                              float* __restrict__ lse, const ResGeom gm, int tiles, int kcap) {
  constexpr int SA = KS / 2;  // score accumulators per thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                     ~uintptr_t(1023));
  bf16* sk = sq + 64 * 32;
  bf16* sv = sk + kcap * 32;
  const int u = blockIdx.x / tiles, qt = blockIdx.x - u * tiles;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = 64 * qt;
  const int2 kr = fwd_key_range(qt, gm);
  const int nh = (kr.y - kr.x + KS - 1) / KS;  // the tile's steps of KS keys

  // Q's tile, then the keys' K and V: 16-byte pieces, zeros where a row holds none
  load_rows(sq, q, u, q0, 64, gm, tid);
  load_rows(sk, k, u, kr.x, KS * nh, gm, tid);
  load_rows(sv, v, u, kr.x, KS * nh, gm, tid);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();
  // this thread's rows (r0, r0 + 8 of the tile): the keys each may see
  const int r0 = 16 * warp + g;
  int lo[2], hi[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = q0 + r0 + 8 * rr, seg = i / gm.n;
    const bool live = seg < gm.pack && u * gm.pack + seg < gm.bh_total;
    lo[rr] = live ? seg * gm.n : 0;
    hi[rr] = live ? seg * gm.n + min(gm.valid_len, gm.n) : 0;
  }

  float acc[16], s[SA], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  uint32_t p[KS / 16][4];
  auto issue_s = [&](int h) {  // S = Q K_h^T
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      wgmma_ss<0, 0>(s, sw64_desc(sq + ks * 16),
                     sw64_desc(sk + KS * h * 32 + ks * 16), ks);
    wg_commit();
  };
  auto issue_pv = [&](int h) {  // O += P V_h, V read MN-major
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk)
      wgmma_rs<1>(acc, p[kk], sw64_desc(sv + (KS * h + 16 * kk) * 32), 1);
    wg_commit();
  };
  auto softmax = [&](int h) {  // step h's scores in s -> P, with the rescale a
    const int kh = kr.x + KS * h;  // the step's first key (unit row)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < SA / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kcol = kh + 8 * j + 2 * t + (e & 1), rr = e >> 1;
        if (kcol < lo[rr] || kcol >= hi[rr]) s[4 * j + e] = -INFINITY;
        mx[rr] = fmaxf(mx[rr], s[4 * j + e]);
      }
    float ms[2], sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float mn = fmaxf(m[rr], quad_max(mx[rr]));
      // a row that has seen no key yet keeps l = 0 and O = 0
      a[rr] = mn == -INFINITY ? 1.f : exp2_approx((m[rr] - mn) * SoftmaxScale<32>::slog2);
      ms[rr] = mn == -INFINITY ? 0.f : mn * SoftmaxScale<32>::slog2;
      m[rr] = mn;
    }
#pragma unroll
    for (int j = 0; j < SA / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], SoftmaxScale<32>::slog2, -ms[e >> 1]));
        sum[e >> 1][j & 1] += s[4 * j + e];
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * a[rr] + (sum[rr][0] + sum[rr][1]);
  };
  auto pack = [&] {
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  };

  issue_s(0);
  wg_wait<0>();
  wg_hold(s);
  softmax(0);
  pack();
  // step h's P.V runs while step h + 1's softmax does
  for (int h = 0; h + 1 < nh; ++h) {
    issue_s(h + 1);
    issue_pv(h);
    wg_wait<1>();
    wg_hold(s);
    softmax(h + 1);
    wg_wait<0>();
    wg_hold(acc);
    wg_hold(p);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= a[(i >> 1) & 1];
    pack();
  }
  issue_pv(nh - 1);
  wg_wait<0>();
  wg_hold(acc);
  wg_hold(p);

  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] = quad_sum(l[rr]);
    inv[rr] = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
    const int2 br = res_row(u, q0 + r0 + 8 * rr, gm);
    if (lse != nullptr && t == 0 && br.x >= 0)
      lse[(long long)br.x * gm.n + br.y] = m[rr] * SoftmaxScale<32>::scale + logf(l[rr]);
  }
  __syncthreads();  // every warp's last S has read the Q tile
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      *reinterpret_cast<uint32_t*>(sq + sw64(r0 + 8 * rr, 8 * j + 2 * t)) =
          pack_bf16(acc[4 * j + 2 * rr] * inv[rr], acc[4 * j + 2 * rr + 1] * inv[rr]);
  __syncthreads();
  UnitRows rw(u, q0 + (tid >> 2), gm);
  for (int i = tid >> 2; i < 64; i += 32, rw.step(gm))
    if (rw.live(gm))
      *reinterpret_cast<uint4*>(o.row(rw.b, rw.h, rw.rem) + 8 * (tid & 3)) =
          *reinterpret_cast<const uint4*>(sq + sw64(i, 8 * (tid & 3)));
}

cudaError_t launch_fwd_resident(const Strided& q, const Strided& k, const Strided& v,
                                const Strided& o, float* lse, int B, int heads, int n,
                                int valid_len, cudaStream_t st) {
  const int pack = fwd_pack(n);
  const ResGeom gm{n, valid_len, pack, B * heads, heads};
  const int tiles = ceil_div(pack * n, 64), units = ceil_div(B * heads, pack);
  const int ks = tiles == 1 ? 64 : 32;  // keys a step
  int kcap = 0;  // the most keys a tile loads
  for (int qt = 0; qt < tiles; ++qt) {
    const int2 kr = fwd_key_range(qt, gm);
    kcap = std::max(kcap, ks * ceil_div(kr.y - kr.x, ks));
  }
  const int smem = 1024 + 2 * (64 + 2 * kcap) * 32;  // alignment, Q, K, V
  static bool ready[16];  // the shared-memory limit, set once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16 || !ready[dev]) {
    // keys: at most a unit's rows and the half before its first sequence
    const int most = 1024 + 2 * (64 + 2 * (FWD_RES_MAX_ROWS + 32)) * 32;
    e = cudaFuncSetAttribute(flash_fwd_resident_kernel<32>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_fwd_resident_kernel<64>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    if (dev < 16) ready[dev] = true;
  }
  if (ks == 64)
    flash_fwd_resident_kernel<64><<<units * tiles, 128, smem, st>>>(q, k, v, o, lse, gm, tiles,
                                                                     kcap);
  else
    flash_fwd_resident_kernel<32><<<units * tiles, 128, smem, st>>>(q, k, v, o, lse, gm, tiles,
                                                                     kcap);
  return cudaGetLastError();
}

__device__ __forceinline__ void add4(float4& a, const float4& x) {
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
}

// dq = bf16((sum 0 + sum 1) + (sum 2 + sum 3)) through dq's strides, each
// sum only where its turn counter says it took an add: one thread per
// float4 of a tile (rows r and r + 8, two columns); rows >= qend (never
// summed) are 0.
template <int DH>
__global__ void __launch_bounds__(256)
    flash_bwd_dq_kernel(const float* __restrict__ sums, const int* __restrict__ sems,
                        const Strided dq, int heads, int nq, int qend, long long chunks) {
  constexpr int TILE4 = bwd_tile<DH>() / 4;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chunks) return;
  const int nqt_all = ceil_div(nq, BWD_BQ);
  const long long tile = c / TILE4;
  const int within = (int)(c % TILE4), i = within % 128;
  const int bh = (int)(tile / nqt_all), q0 = (int)(tile % nqt_all) * BWD_BQ;
  const int lane = i & 31, row = q0 + 16 * (i >> 5) + (lane >> 2);
  const int col = 8 * (within / 128) + 2 * (lane & 3);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), w = a;
  if (row < qend) {
    const long long tiles = chunks / TILE4;
    const float4* s4 = reinterpret_cast<const float4*>(sums);
    if (sems[tile]) a = s4[c];
    if (sems[tiles + tile]) add4(a, s4[c + chunks]);
    if (sems[2 * tiles + tile]) {
      w = s4[c + 2 * chunks];
      if (sems[3 * tiles + tile]) add4(w, s4[c + 3 * chunks]);
      add4(a, w);
    }
  }
  const int b = bh / heads, h = bh % heads;
  if (row < nq)
    *reinterpret_cast<uint32_t*>(dq.row(b, h, row) + col) = pack_bf16(a.x, a.y);
  if (row + 8 < nq)
    *reinterpret_cast<uint32_t*>(dq.row(b, h, row + 8) + col) =
        row + 8 < qend ? pack_bf16(a.z, a.w) : 0u;
}

// A TMA map of the (B, heads, n, dh) operand t, boxes of `rows` x 64 in the
// 128-byte swizzle (columns past dh zero-filled); the two middle dimensions
// in increasing stride (heads first for the packed (B, n, heads * dh)
// layouts).
cudaError_t tensor_map(CUtensorMap* m, const Strided& t, int B, int heads, int n,
                       bool heads_first, int rows = 64, int dh = ATT_DH, bool native = false) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)(heads_first ? heads : n),
                              (cuuint64_t)(heads_first ? n : heads), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(heads_first ? t.sh : t.sr) * 2,
                                 (cuuint64_t)(heads_first ? t.sr : t.sh) * 2,
                                 (cuuint64_t)t.sb * 2};
  const cuuint32_t box[4] = {native ? (cuuint32_t)dh : ATT_DH, heads_first ? 1u : (cuuint32_t)rows,
                             heads_first ? (cuuint32_t)rows : 1u, 1};
  return encode_tiled(m, 4, t.p, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      native && dh == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool DROP, int DH>
cudaError_t launch_bwd_main(dim3 grid, cudaStream_t st, const Strided& q, const Strided& k,
                            const Strided& v, const Strided& d_o, const float* lse,
                            const float* delta, float* sums, int* sems, const Strided& dk,
                            const Strided& dv, int B, int heads, int nq, int nk, int valid_len,
                            const Dropout& dr) {
  constexpr int smem = sizeof(BwdSmem) + 1024;  // + alignment to 1024 bytes
  // The shared-memory limit, set once per device (a launch's host work
  // counts where the kernels are short).
  static bool ready[16];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16 || !ready[dev]) {
    e = cudaFuncSetAttribute(flash_bwd_kernel<DROP, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < 16) ready[dev] = true;
  }
  const int qt = ceil_div(std::min(valid_len, nq), BWD_BQ);
  const int kt = ceil_div(std::min(valid_len, nk), BWD_BK);
  const bool rotate = qt == kt;
  const bool hf_q = q.sh < q.sr, hf_do = d_o.sh < d_o.sr;
  CUtensorMap tm_q, tm_do;
  if ((e = tensor_map(&tm_q, q, B, heads, nq, hf_q, BWD_BQ, DH)) != cudaSuccess) return e;
  if ((e = tensor_map(&tm_do, d_o, B, heads, nq, hf_do, BWD_BQ, DH)) != cudaSuccess) return e;
  flash_bwd_kernel<DROP, DH><<<grid, BWD_THREADS, smem, st>>>(
      tm_q, tm_do, hf_q, hf_do, k, v, lse, delta, sums, sems, dk, dv, nq, nk, valid_len, rotate,
      dr);
  return cudaGetLastError();
}

// TMA reads an operand, and the forward writes O in 16-byte pieces: the
// base and every stride on 16 bytes.
bool aligned16(const Strided& t) {
  return (reinterpret_cast<uintptr_t>(t.p) & 15) == 0 && t.sb % 8 == 0 && t.sh % 8 == 0 &&
         t.sr % 8 == 0;
}

template <int NWG, int BK, bool DROP, int DH>
cudaError_t launch_fwd(cudaStream_t st, const Strided& q, const Strided& k, const Strided& v,
                       const Strided& o, float* lse, int B, int heads, int nq, int nk,
                       int valid_len, const Dropout& dr) {
  constexpr int smem = sizeof(FwdSmem<NWG, BK, DH>) + 1024;  // + alignment to 1024 bytes
  static bool ready[16];  // the shared-memory limit, set once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16 || !ready[dev]) {
    e = cudaFuncSetAttribute(flash_fwd_kernel<NWG, BK, DROP, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < 16) ready[dev] = true;
  }
  const bool hf_q = q.sh < q.sr, hf_k = k.sh < k.sr, hf_v = v.sh < v.sr;
  CUtensorMap tm_q, tm_k, tm_v;
  if ((e = tensor_map(&tm_q, q, B, heads, nq, hf_q, 64, DH, true)) != cudaSuccess) return e;
  if ((e = tensor_map(&tm_k, k, B, heads, nk, hf_k, BK, DH, true)) != cudaSuccess) return e;
  if ((e = tensor_map(&tm_v, v, B, heads, nk, hf_v, BK, DH, true)) != cudaSuccess) return e;
  const dim3 grid(ceil_div(nq, 64 * NWG), heads, B);
  flash_fwd_kernel<NWG, BK, DROP, DH><<<grid, FwdCfg<NWG, BK>::threads, smem, st>>>(
      tm_q, tm_k, tm_v, hf_q, hf_k, hf_v, o, lse, nq, nk, valid_len, dr);
  return cudaGetLastError();
}

// Multiprocessors of the current device (read once per device).
int sm_count() {
  static int count[16];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev < 16 && count[dev]) return count[dev];
  int n = 132;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) n = 132;
  if (dev < 16) count[dev] = n;
  return n;
}

// The tiling by shape (flash_fwd): 64-key tiles and one consumer warpgroup
// up to 512 keys; past them 128-key tiles and three warpgroups (wide) or
// one; the same for both head dims.
template <bool DROP, int DH>
cudaError_t launch_rule(bool long_keys, bool wide, cudaStream_t st, const Strided& q,
                        const Strided& k, const Strided& v, const Strided& o, float* lse, int B,
                        int heads, int nq, int nk, int valid_len, const Dropout& dr) {
  if (!long_keys)
    return launch_fwd<1, 64, DROP, DH>(st, q, k, v, o, lse, B, heads, nq, nk, valid_len, dr);
  if (wide)
    return launch_fwd<3, 128, DROP, DH>(st, q, k, v, o, lse, B, heads, nq, nk, valid_len, dr);
  return launch_fwd<1, 128, DROP, DH>(st, q, k, v, o, lse, B, heads, nq, nk, valid_len, dr);
}

// The three launches at head dim DH (see the header).
template <int DH>
cudaError_t bwd_launches(const Strided& q, const Strided& k, const Strided& v, const Strided& o,
                         const Strided& d_o, const float* lse, float* delta, float* ws,
                         const Strided& dq, const Strided& dk, const Strided& dv, int B,
                         int heads, int nq, int nk, int valid_len, cudaStream_t st,
                         const Dropout& dr) {
  const long long rows = (long long)B * heads * nq;
  const long long tiles = (long long)B * heads * ceil_div(nq, BWD_BQ);  // per chain
  float* sums = ws;
  int* sems = reinterpret_cast<int*>(ws + BWD_CHAINS * tiles * bwd_tile<DH>());
  const long long threads = std::max(rows * (DH / 8), BWD_CHAINS * tiles);
  flash_bwd_delta_kernel<DH><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      o, d_o, delta, sems, BWD_CHAINS * tiles, heads, nq, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid(ceil_div(nk, BWD_BK), heads, B);
  e = dr.on ? launch_bwd_main<true, DH>(grid, st, q, k, v, d_o, lse, delta, sums, sems, dk, dv,
                                        B, heads, nq, nk, valid_len, dr)
            : launch_bwd_main<false, DH>(grid, st, q, k, v, d_o, lse, delta, sums, sems, dk, dv,
                                         B, heads, nq, nk, valid_len, dr);
  if (e != cudaSuccess) return e;
  const long long chunks = tiles * (bwd_tile<DH>() / 4);
  flash_bwd_dq_kernel<DH><<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(
      sums, sems, dq, heads, nq, std::min(valid_len, nq), chunks);
  return cudaGetLastError();
}

}  // namespace

namespace svt {

cudaError_t flash_fwd(Strided q, Strided k, Strided v, Strided o, float* lse, int B, int heads,
                      int nq, int nk, int valid_len, int dh, cudaStream_t st, Dropout dr) {
  if (B < 1 || heads < 1 || nq < 1 || nk < 1 || valid_len < 1) return cudaErrorInvalidValue;
  // dh 32 is built without dropout (MS-SiT serves with none)
  if (dh != ATT_DH && (dh != 32 || dr.on)) return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return cudaErrorMisalignedAddress;
  if (resident_fwd(nq, nk, dh, dr.on))  // every MS-SiT fold: the sequences packed, one launch
    return launch_fwd_resident(q, k, v, o, lse, B, heads, nq, valid_len, st);
  // The tiling, from the tilings measured on an H100 (PERF.md): past 512
  // keys, 128-key tiles and three consumer warpgroups (192 queries) where
  // that grid still fills the card twice; else one warpgroup (64 queries,
  // two or three CTAs per SM, whose prologues and epilogues overlap each
  // other's loops), with 64-key tiles up to 512 keys.
  const bool long_keys = std::min(valid_len, nk) > 512;
  const bool wide = long_keys && nq > 64 &&
                    (long long)ceil_div(nq, 192) * heads * B >= 2ll * sm_count();
  if (dh == 32)
    return launch_rule<false, 32>(long_keys, wide, st, q, k, v, o, lse, B, heads, nq, nk,
                                  valid_len, dr);
  return dr.on ? launch_rule<true, ATT_DH>(long_keys, wide, st, q, k, v, o, lse, B, heads, nq,
                                           nk, valid_len, dr)
               : launch_rule<false, ATT_DH>(long_keys, wide, st, q, k, v, o, lse, B, heads, nq,
                                            nk, valid_len, dr);
}

bool resident_fwd(int nq, int nk, int dh, bool dropout) {
  return dh == 32 && !dropout && nq == nk && nq <= FWD_RES_MAX_ROWS && nq % 64 != 0;
}

bool resident_bwd(int nq, int nk, int dh, bool dropout) {
  return dh == 32 && !dropout && nq == nk && nq <= 64 * RES_MAX_TILES;
}

int resident_pack(int n) { return n <= 32 ? 64 / n : 1; }

long long flash_bwd_workspace(int B, int heads, int nq, int nk, int dh) {
  if (resident_bwd(nq, nk, dh, false)) return 0;  // (dh 32 runs without dropout)
  // the sums and a turn counter per sum and tile
  return (long long)BWD_CHAINS * B * heads * ceil_div(nq, BWD_BQ) * ((long long)BWD_BQ * dh + 1);
}

cudaError_t flash_bwd(Strided q, Strided k, Strided v, Strided o, Strided d_o, const float* lse,
                      float* delta, float* ws, Strided dq, Strided dk, Strided dv, int B,
                      int heads, int nq, int nk, int valid_len, int dh, cudaStream_t st,
                      Dropout dr) {
  if (B < 1 || heads < 1 || nq < 1 || nk < 1 || valid_len < 1) return cudaErrorInvalidValue;
  if (resident_bwd(nq, nk, dh, dr.on)) {  // one launch, the sequence in shared memory
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) || !aligned16(d_o))
      return cudaErrorMisalignedAddress;
    const int pack = resident_pack(nq);
    const ResGeom gm{nq, valid_len, pack, B * heads, heads};
    const int units = ceil_div(B * heads, pack);
    switch (ceil_div(nq * pack, 64)) {
      case 1: return launch_resident<1>(q, k, v, o, d_o, lse, dq, dk, dv, gm, units, st);
      case 2: return launch_resident<2>(q, k, v, o, d_o, lse, dq, dk, dv, gm, units, st);
      case 3: return launch_resident<3>(q, k, v, o, d_o, lse, dq, dk, dv, gm, units, st);
      case 4: return launch_resident<4>(q, k, v, o, d_o, lse, dq, dk, dv, gm, units, st);
      default: return launch_resident<5>(q, k, v, o, d_o, lse, dq, dk, dv, gm, units, st);
    }
  }
  if (dh == 32 && !dr.on)  // dh 32 past 320 keys, or nq != nk: the streamed kernels
    return bwd_launches<32>(q, k, v, o, d_o, lse, delta, ws, dq, dk, dv, B, heads, nq, nk,
                            valid_len, st, dr);
  if (dh != ATT_DH) return cudaErrorInvalidValue;
  return bwd_launches<ATT_DH>(q, k, v, o, d_o, lse, delta, ws, dq, dk, dv, B, heads, nq, nk,
                              valid_len, st, dr);
}

Dropout make_dropout(unsigned seed, unsigned threshold, float inv_keep, int on) {
  Dropout dr;
  dr.seed = seed;
  dr.threshold = threshold;
  dr.inv_keep = inv_keep;
  dr.on = on;
  return dr;
}

}  // namespace svt

extern "C" {

// flash_attention forward: q (B, heads, nq, dh), k and v (B, heads, nk,
// dh), o (B, heads, nq, dh), each bf16 at (batch, head, row) strides in
// elements with its last dimension contiguous; lse (B, heads, nq) fp32
// contiguous; dh 32 or 64. Dropout on the probabilities when `drop` (seed,
// threshold on the Philox word, inv_keep = 1 / (1 - rate); dh 64 only).
int svt_flash_attention_fwd(void* q, long long q_sb, long long q_sh, long long q_sr, void* k,
                            long long k_sb, long long k_sh, long long k_sr, void* v,
                            long long v_sb, long long v_sh, long long v_sr, void* o,
                            long long o_sb, long long o_sh, long long o_sr, void* lse, int B,
                            int heads, int nq, int nk, int valid_len, int dh, unsigned seed,
                            unsigned threshold, float inv_keep, int drop, int device,
                            void* stream) {
  SVT_TRY(cudaSetDevice(device));
  return (int)flash_fwd({(bf16*)q, q_sb, q_sh, q_sr}, {(bf16*)k, k_sb, k_sh, k_sr},
                        {(bf16*)v, v_sb, v_sh, v_sr}, {(bf16*)o, o_sb, o_sh, o_sr},
                        (float*)lse, B, heads, nq, nk, valid_len, dh,
                        static_cast<cudaStream_t>(stream),
                        make_dropout(seed, threshold, inv_keep, drop));
}

// flash_attention backward: the forward's operands, o and lse, the output
// cotangent d_o (as o) -> dq (as q), dk, dv (as k); dh 32 or 64; delta (B,
// heads, nq) fp32 scratch; ws svt_flash_attention_bwd_workspace(B, heads,
// nq, nk, dh) floats of scratch (the fp32 dQ sums and their turn counters;
// none for the resident kernel). Dropout as the forward's, which gave o (dh
// 64 only).
int svt_flash_attention_bwd(void* q, long long q_sb, long long q_sh, long long q_sr, void* k,
                            long long k_sb, long long k_sh, long long k_sr, void* v,
                            long long v_sb, long long v_sh, long long v_sr, void* o,
                            long long o_sb, long long o_sh, long long o_sr, void* d_o,
                            long long do_sb, long long do_sh, long long do_sr, void* lse,
                            void* delta, void* ws, void* dq, long long dq_sb, long long dq_sh,
                            long long dq_sr, void* dk, long long dk_sb, long long dk_sh,
                            long long dk_sr, void* dv, long long dv_sb, long long dv_sh,
                            long long dv_sr, int B, int heads, int nq, int nk, int valid_len,
                            int dh, unsigned seed, unsigned threshold, float inv_keep, int drop,
                            int device, void* stream) {
  SVT_TRY(cudaSetDevice(device));
  return (int)flash_bwd({(bf16*)q, q_sb, q_sh, q_sr}, {(bf16*)k, k_sb, k_sh, k_sr},
                        {(bf16*)v, v_sb, v_sh, v_sr}, {(bf16*)o, o_sb, o_sh, o_sr},
                        {(bf16*)d_o, do_sb, do_sh, do_sr}, (const float*)lse, (float*)delta,
                        (float*)ws, {(bf16*)dq, dq_sb, dq_sh, dq_sr},
                        {(bf16*)dk, dk_sb, dk_sh, dk_sr}, {(bf16*)dv, dv_sb, dv_sh, dv_sr}, B,
                        heads, nq, nk, valid_len, dh, static_cast<cudaStream_t>(stream),
                        make_dropout(seed, threshold, inv_keep, drop));
}


#ifdef SVT_FWD_PROFILE
// The profile's eight sums of cycles into out, then zeroed.
int svt_flash_fwd_profile(unsigned long long* out) {
  SVT_TRY(cudaMemcpyFromSymbol(out, fwd_profile, sizeof(fwd_profile)));
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  SVT_TRY(cudaMemcpyToSymbol(fwd_profile, zero, sizeof(zero)));
  return (int)cudaDeviceSynchronize();
}
#endif

// Floats of scratch svt_flash_attention_bwd needs in `ws` at head dim dh (0
// where the resident kernel runs: dh 32, nq == nk <= 320).
long long svt_flash_attention_bwd_workspace(int B, int heads, int nq, int nk, int dh) {
  return flash_bwd_workspace(B, heads, nq, nk, dh);
}

}  // extern "C"
