// Hopper (sm_90a) streamed attention, forward and backward, at every head
// dim laid out in up to 128 columns (flash_attention.cuh head_cols: dh
// rounded up to 8): dh 32 and 64 here, the others built from these kernels
// in flash_attention_widths.cu (its header); wider heads in
// flash_attention_wide.cu.
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
// the long-sequence entry's few (sample, head)s); up to 512 keys, BK = 64
// and W = 1 (three CTAs per SM, whose
// short loops' prologues and epilogues overlap). PERF.md has the tilings
// measured beside these and lost (two warpgroups taking turns to issue
// their products among them). O leaves through the warpgroup's Q tile in
// 16-byte row pieces; lse = m / 8 + log l when asked for. No CTA depends
// on another.
//
// Forward for at most 8 queries against more keys (up to 4,096), without
// dropout (the CLS block's 8 query rows; few_query_fwd),
// one launch: flash_fwd_few_kernel, one CTA a (sample, head), the queries
// on the short side of m64n8 products, every key's scores in shared memory
// for an exact softmax; in the CLS chain it makes its own Q (below, at the
// kernel).
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
// Backward for at most 8 queries against more keys, without dropout (the
// CLS block's 8 query rows; few_query_bwd), one launch: flash_bwd_few_kernel, one CTA a (sample, head), K and V streamed by
// cp.async in 64-key tiles, every product with the queries on its short
// side (m64n8 wgmma for S^T, dP^T and dQ^T; dV and dK from P^T and dS^T in
// registers), dQ summed in registers over the key tiles in order: no
// workspace, no delta or dq pass (below, at the kernel).
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

// The softmax scale of a kernel built for head dim DH (32 or 64), or, where
// DH is 0 (the other widths: flash_attention_widths.cu), of the launch's own
// dh, given at run time as w (the host's 1 / sqrt(dh) and its product with
// log2(e), each rounded once, as SoftmaxScale's).
template <int DH>
__device__ __forceinline__ float att_scale(const Width& w) {
  if constexpr (DH == 0) return w.scale;
  else return SoftmaxScale<DH>::scale;
}
template <int DH>
__device__ __forceinline__ float att_slog2(const Width& w) {
  if constexpr (DH == 0) return w.slog2;
  else return SoftmaxScale<DH>::slog2;
}
// The head's columns: DH, or the launch's dh.
template <int DH>
__device__ __forceinline__ int att_dh(const Width& w) {
  if constexpr (DH == 0) return w.dh;
  else return DH;
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Tiles of TW columns (a head's dh columns in the smallest that holds them,
// zeros past dh): [rows][32] in the 64-byte swizzle (TW 32), [rows][64] in
// the 128-byte swizzle (TW 64), or two such [rows][64] tiles side by side,
// columns 0-63 then 64-127 (TW 128: the 128-byte swizzle spans 64 columns,
// and so does a TMA box in it).
template <int TW>
__device__ __forceinline__ int tile_at(int r, int c, int rows) {
  if constexpr (TW == 32) return sw64(r, c);
  else if constexpr (TW == 64) return sw128(r, c);
  else return (c >> 6) * rows * 64 + sw128(r, c & 63);
}
// The K-major descriptor of k16 step ks (columns 16 ks ..) of a tile of
// `rows` rows at p.
template <int TW>
__device__ __forceinline__ uint64_t tile_kdesc(const bf16* p, int ks, int rows) {
  if constexpr (TW == 32) return sw64_desc(p + ks * 16);
  else if constexpr (TW == 64) return sw128_desc(p + ks * 16);
  else return sw128_desc(p + (ks >> 2) * rows * 64 + (ks & 3) * 16);
}
// The MN-major descriptor of k16 step kk (rows 16 kk ..) of a tile of `rows`
// rows at p, its TW columns the product's N (TW 128: the n128 form, the
// second 64 columns `rows` x 128 bytes on).
template <int TW>
__device__ __forceinline__ uint64_t tile_ndesc(const bf16* p, int kk, int rows) {
  if constexpr (TW == 32) return sw64_desc(p + kk * 16 * 32);
  else if constexpr (TW == 64) return sw128_desc(p + kk * 16 * 64);
  else return sw128_desc(p + kk * 16 * 64, rows * 128);
}

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
                                         int h, int b, bool heads_first, int col = 0) {
  tma_load_4d(dst, m, bar, col, heads_first ? h : row, heads_first ? row : h, b);
}
// A tile of TW columns and `rows` rows: one box, or at TW 128 two boxes of
// 64 columns into its two halves.
template <int TW>
__device__ __forceinline__ void tma_rows(bf16* dst, const CUtensorMap& m, uint64_t* bar, int rows,
                                         int row, int h, int b, bool heads_first) {
  tma_tile(dst, m, bar, row, h, b, heads_first);
  if constexpr (TW == 128) tma_tile(dst + rows * 64, m, bar, row, h, b, heads_first, 64);
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
template <int NWG, int BK, int TW = 64>
struct FwdCfg {
  static constexpr int threads = (NWG + 1) * 128;
  // TW 128 (one tiling: NWG 1, BK 64): 80 KB of shared memory, two CTAs
  static constexpr int ctas = TW == 128 ? 2 : NWG == 1 ? (BK == 64 ? 3 : 2) : 1;
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

// Tiles of TW columns (tile_at): [rows][64] in the 128-byte swizzle at dh 64,
// [rows][32] in the 64-byte swizzle at dh 32 (native: no zero columns); a
// head of another dh in the smallest that holds it, zeros past dh.
template <int NWG, int BK, int TW>
struct FwdSmem {
  bf16 q[NWG][64 * TW];  // a warpgroup's Q tile; its O on the way out
  bf16 k[FWD_STAGES][BK * TW], v[FWD_STAGES][BK * TW];
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
                                             uint32_t bh, const Dropout& dr, int t,
                                             const Width& wd) {
  const float slog2 = att_slog2<DH>(wd);
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
    a[r] = exp2_approx((m[r] - mn) * slog2);  // 0 at the first tile
    m[r] = mn;
    ms[r] = mn * slog2;
  }
#pragma unroll
  for (int j = 0; j < SA / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], slog2, -ms[e >> 1]));
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

// DH: the head dim the kernel is built for (32, 64), or 0: the launch's wd.dh
// (a multiple of 8 up to TW, flash_attention_widths.cu), in tiles of TW
// columns zero past dh; its products skip the k16 steps wholly past dh, the
// softmax takes wd's scale and O's stores stop at dh.
template <int NWG, int BK, bool DROP, int DH, int TW = DH>
__global__ void __launch_bounds__(FwdCfg<NWG, BK, TW>::threads, FwdCfg<NWG, BK, TW>::ctas)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, bool hf_q, bool hf_k, bool hf_v,
                     const Strided o, float* __restrict__ lse, int nq, int nk, int valid_len,
                     const Dropout dr, const Width wd) {
  constexpr int SA = BK / 2;  // score accumulators per thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  FwdSmem<NWG, BK, TW>& sm = *reinterpret_cast<FwdSmem<NWG, BK, TW>*>(
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
      mbar_expect(&sm.q_full, active * 64 * TW * 2);
      for (int w = 0; w < active; ++w)
        tma_rows<TW>(sm.q[w], tm_q, &sm.q_full, 64, q0 + 64 * w, h, b, hf_q);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % FWD_STAGES, use = j / FWD_STAGES;
        if (use > 0) mbar_wait(&sm.k_empty[st], (use - 1) & 1);
        mbar_expect(&sm.k_full[st], BK * TW * 2);
        tma_rows<TW>(sm.k[st], tm_k, &sm.k_full[st], BK, j * BK, h, b, hf_k);
        if (use > 0) mbar_wait(&sm.v_empty[st], (use - 1) & 1);
        mbar_expect(&sm.v_full[st], BK * TW * 2);
        tma_rows<TW>(sm.v[st], tm_v, &sm.v_full[st], BK, j * BK, h, b, hf_v);
      }
    }
    return;
  }

  // a consumer warpgroup: query rows q0 + 64 w ..
  set_max_regs_inc<FwdCfg<NWG, BK, TW>::consumer_regs>();
  const int w = wg - 1;
  if (w >= active) return;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 64 * w, row = row0 + 16 * warp + g;  // this thread's rows: row, row + 8
  const uint32_t bh = (uint32_t)(b * heads + h);
  const int dh = att_dh<DH>(wd), ksteps = (dh + 15) / 16;  // S's k16 steps holding a column

  float acc[TW / 2], s[SA], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2];
  uint32_t p[SA / 8][4];
#pragma unroll
  for (int i = 0; i < TW / 2; ++i) acc[i] = 0.f;
  const bf16* sq = sm.q[w];

  auto issue_s = [&](int j) {  // S = Q K_j^T
    const int st = j % FWD_STAGES;
    mbar_wait(&sm.k_full[st], (j / FWD_STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < TW / 16; ++ks)
      if (ks < ksteps)
        wgmma_ss<0, 0>(s, tile_kdesc<TW>(sq, ks, 64), tile_kdesc<TW>(sm.k[st], ks, BK), ks);
    wg_commit();
  };
  auto issue_pv = [&](int j, int kv_steps) {  // O += P V_j, V read MN-major
    const int st = j % FWD_STAGES;
    mbar_wait(&sm.v_full[st], (j / FWD_STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (kk >= kv_steps) continue;
      wgmma_rs<1>(acc, p[kk], tile_ndesc<TW>(sm.v[st], kk, BK), 1);
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
      softmax_tile<SA, DROP, true, DH>(s, m, l, a, kend - j * BK, j * BK, row, bh, dr, t, wd);
    else
      softmax_tile<SA, DROP, false, DH>(s, m, l, a, BK, j * BK, row, bh, dr, t, wd);
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
    for (int i = 0; i < TW / 2; ++i) acc[i] *= a[(i >> 1) & 1];
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

  // O = acc / l (x 1 / (1 - rate)), lse = m / sqrt(dh) + log l
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = (DROP ? dr.inv_keep : 1.f) / l[r];
  }
  if (lse != nullptr && t == 0) {
    float* lrow = lse + (long long)bh * nq;
    if (row < nq) lrow[row] = m[0] * att_scale<DH>(wd) + logf(l[0]);
    if (row + 8 < nq) lrow[row + 8] = m[1] * att_scale<DH>(wd) + logf(l[1]);
  }
  // O's TW columns through this warpgroup's Q tile (its last reader, the
  // last S, is done), then its dh columns out in 16-byte row pieces
  bf16* so = sm.q[w];
#pragma unroll
  for (int j = 0; j < TW / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(so + tile_at<TW>(16 * warp + g + 8 * r, 8 * j + 2 * t, 64)) =
          pack_bf16(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
  bar_sync(FWD_WG_BAR + w, 128);
  constexpr int PIECES = TW / 8;  // of a row
#pragma unroll
  for (int i = 0; i < 64 * PIECES / 128; ++i) {
    const int r = (128 / PIECES) * i + tid / PIECES, c = (tid % PIECES) * 8;
    if (row0 + r < nq && c < dh)
      *reinterpret_cast<uint4*>(o.row(b, h, row0 + r) + c) =
          *reinterpret_cast<const uint4*>(so + tile_at<TW>(r, c, 64));
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
constexpr int BWD_CHAINS = 4;              // ordered sums per query tile (see add_place)

// Floats of one query tile's dQ share, and of a sum in the workspace, at DH.
template <int DH>
__host__ __device__ constexpr int bwd_tile() {
  return BWD_BQ * DH;
}

// Shared memory of the main pass: 64-row bf16 tiles of TW columns
// (tile_at): 64 in the 128-byte swizzle at dh <= 64 (at dh 32 and the other
// widths below 64 the columns past dh hold zeros), two such halves at dh
// 72-128 (TW 128: 176 KB, one CTA an SM).
template <int TW>
struct BwdSmem {
  bf16 k[BWD_BK * TW], v[BWD_BK * TW];  // key rows in the permuted order kperm()
  bf16 q[BWD_STAGES][BWD_BQ * TW], d_o[BWD_STAGES][BWD_BQ * TW];  // ring filled by TMA
  bf16 p[BWD_BQ * BWD_BK], ds[BWD_BQ * BWD_BK];  // P~ and dS of the step, [query][key column]
  float4 dq[BWD_SLOTS][BWD_BQ * TW / 4];        // dQ shares, in the accumulator's order (below)
  uint64_t loaded[BWD_STAGES];                  // a Q / dO stage has landed
  uint64_t full[BWD_SLOTS], empty[BWD_SLOTS];   // a share written / read by the copy engine
};

// A dQ share, and the sums in the workspace, are laid out as the warpgroup
// holds them: float4 m of thread i (d[4m .. 4m + 3]: rows 16 (i / 32) + (i
// % 32) / 4 and 8 below, columns 8m + 2 (i % 4) and the next) at m * 128 +
// i, so the threads' stores are conflict-free and one bulk copy moves a
// tile; flash_bwd_dq_kernel undoes it. At dh < TW the share is its first
// dh / 8 float4s a thread (m < dh / 8: columns 0 .. dh - 1).

// Key column c of a tile holds key kperm(c): the columns a thread holds
// (2t, 2t + 1, 8 + 2t, 9 + 2t of each 16) are then the four consecutive keys
// 4t .. 4t + 3, one Philox counter.
__device__ __forceinline__ int kperm(int c) {
  return (c & 48) | ((c & 6) << 1) | ((c >> 2) & 2) | (c & 1);
}

// Key rows k0 .. k0 + 63 of (b, h) into a swizzled tile of TW columns, row r
// holding key k0 + kperm(r); zeros past n and past column dh.
template <int TW>
__device__ __forceinline__ void load_key_tile(bf16* dst, const Strided& t, int b, int h, int k0,
                                              int n, int tid, int dh) {
  constexpr int CH = TW / 8;  // 16-byte pieces of a row
  for (int i = tid; i < 64 * CH; i += 128) {
    const int r = i / CH, ch = i % CH;
    const int src = k0 + kperm(r);
    const bool ok = src < n && ch < dh / 8;
    cp_async16(dst + tile_at<TW>(r, ch * 8, 64), ok ? t.row(b, h, src) + ch * 8 : t.p, ok);
  }
}

// The compute warpgroup's own barrier (the writer warp does not take part).
__device__ __forceinline__ void wg_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

// delta = rowsum(dO . O) over (B, heads, nq) rows, DH / 8 threads a row, one
// 16-byte load of each operand per thread (DH 0: eight threads a row, the
// row's dh / 8 pieces in turn); zeroes the nsem turn counters.
template <int DH>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const Strided o, const Strided d_o, float* __restrict__ delta,
                           int* __restrict__ sems, long long nsem, int heads, int nq,
                           long long rows, int dh) {
  constexpr int PARTS = DH ? DH / 8 : 8;  // threads of a row
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid < nsem) sems[gid] = 0;
  const long long r = gid / PARTS;
  const int part = threadIdx.x % PARTS;
  float s = 0.f;
  if (r < rows) {
    const int row = (int)(r % nq), bh = (int)(r / nq);
    auto piece = [&](int pc) {
      const uint4 a =
          *reinterpret_cast<const uint4*>(o.row(bh / heads, bh % heads, row) + pc * 8);
      const uint4 c =
          *reinterpret_cast<const uint4*>(d_o.row(bh / heads, bh % heads, row) + pc * 8);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(c2[i]);
        s = fmaf(x.x, y.x, fmaf(x.y, y.y, s));
      }
    };
    if constexpr (DH != 0)
      piece(part);
    else
      for (int pc = part; pc < dh / 8; pc += PARTS) piece(pc);
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
// heads, nqt_all) tiles of `tile` floats (64 dh); sems: (BWD_CHAINS, B *
// heads, nqt_all) counters.
template <int TW>
__device__ __forceinline__ void dq_writer(BwdSmem<TW>& sm, float* sums, int* sems,
                                          long long chain_tiles, int kb, int nqt, bool rotate,
                                          int tile_floats) {
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
    float* dst = sums + (chain * chain_tiles + tile) * tile_floats;
    const uint32_t src = smem_u32(sm.dq[slot]);
    if (rank == 0)
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                   "r"(src), "r"(tile_floats * 4)
                   : "memory");
    else
      asm volatile(
          "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
              dst),
          "r"(src), "r"(tile_floats * 4)
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
// writer warp. DH 0: the launch's wd.dh (a multiple of 8 up to TW), S and
// dP over its k16 steps, wd's scale, the stores and the share to dh
// columns; at TW 128 dV and dK are n128 products (64 accumulators each) and
// the dQ share two n64 ones into S's and dP's registers.
template <bool DROP, int DH, int TW = 64>
__global__ void __launch_bounds__(BWD_THREADS, TW == 128 ? 1 : 2)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do, bool hf_q, bool hf_do,
                     const Strided k, const Strided v, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ sums,
                     int* __restrict__ sems, const Strided dk, const Strided dv, int nq, int nk,
                     int valid_len, bool rotate, const Dropout dr, const Width wd) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  BwdSmem<TW>& sm = *reinterpret_cast<BwdSmem<TW>*>(
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
  const int dh = att_dh<DH>(wd), dsteps = (dh + 15) / 16;  // S's and dP's k16 steps
  const float slog2 = att_slog2<DH>(wd), scale = att_scale<DH>(wd);

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
      dq_writer<TW>(sm, sums + (long long)bh * nqt_all * BWD_BQ * dh,
                    sems + (long long)bh * nqt_all, chain_tiles, kb, nqt, rotate, BWD_BQ * dh);
    return;
  }

  // Q and dO rows of step s (one thread issues)
  auto load_step = [&](int s) {
    const int st = s % BWD_STAGES, q0 = step_tile(kb, s, nqt, rotate) * BWD_BQ;
    mbar_expect(&sm.loaded[st], 2 * BWD_BQ * TW * 2);  // whole boxes, zero fill included
    tma_rows<TW>(sm.q[st], tm_q, &sm.loaded[st], BWD_BQ, q0, h, b, hf_q);
    tma_rows<TW>(sm.d_o[st], tm_do, &sm.loaded[st], BWD_BQ, q0, h, b, hf_do);
  };
  if (tid == 0 && steps > 0) load_step(0);  // each step then fetches the next one's

  float s[32], dp[32], dva[TW / 2], dka[TW / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < TW / 2; ++i) dva[i] = dka[i] = 0.f;
  if (steps > 0) {
    const int kvalid = min(BWD_BK, kend - k0);
    load_key_tile<TW>(sm.k, k, b, h, k0, nk, tid, dh);
    load_key_tile<TW>(sm.v, v, b, h, k0, nk, tid, dh);
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
      for (int ks = 0; ks < TW / 16; ++ks)
        if (ks < dsteps)
          wgmma_ss<0, 0>(s, tile_kdesc<TW>(sm.q[st], ks, BWD_BQ), tile_kdesc<TW>(sm.k, ks, BWD_BK),
                         ks);
#pragma unroll
      for (int ks = 0; ks < TW / 16; ++ks)
        if (ks < dsteps)
          wgmma_ss<0, 0>(dp, tile_kdesc<TW>(sm.d_o[st], ks, BWD_BQ),
                         tile_kdesc<TW>(sm.v, ks, BWD_BK), ks);
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
            const float pr = exp2_approx(fmaf(x[rr][e], slog2, -ml));
            if constexpr (DROP) {
              const bool kept = (keep[rr] >> e) & 1;
              pt[rr][e] = kept ? pr * dr.inv_keep : 0.f;
              dsv[rr][e] = pr * ((kept ? y[rr][e] * dr.inv_keep : 0.f) - dl) * scale;
            } else {
              pt[rr][e] = pr;
              dsv[rr][e] = pr * (y[rr][e] - dl) * scale;
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
      // (TW 128: its columns 0-63 into s, 64-127 into dp)
      const int qsteps = min(BWD_BQ, qend - q0 + 15) / 16, ksteps = (kvalid + 15) / 16;
      wg_fence();
#pragma unroll
      for (int kq = 0; kq < BWD_BQ / 16; ++kq) {
        if (kq < qsteps) {
          wgmma_ss<1, 1>(dva, sw128_desc(sm.p + kq * 16 * BWD_BK),
                         tile_ndesc<TW>(sm.d_o[st], kq, BWD_BQ), 1);
          wgmma_ss<1, 1>(dka, sw128_desc(sm.ds + kq * 16 * BWD_BK),
                         tile_ndesc<TW>(sm.q[st], kq, BWD_BQ), 1);
        }
      }
#pragma unroll
      for (int G = 0; G < 4; ++G)
        if (G < ksteps) {  // S is spent: it takes the dQ share
          wgmma_rs<1>(s, dsf[G], sw128_desc(sm.k + G * 16 * 64), G);
          if constexpr (TW == 128)
            wgmma_rs<1>(dp, dsf[G], sw128_desc(sm.k + BWD_BK * 64 + G * 16 * 64), G);
        }
      wg_commit();
      wg_wait<0>();
      wg_hold(dva);
      wg_hold(dka);
      wg_hold(s);
      if constexpr (TW == 128) wg_hold(dp);

      // the share to a free slot for the writer
      const int slot = step % BWD_SLOTS;
      if (step >= BWD_SLOTS) mbar_wait(&sm.empty[slot], (step / BWD_SLOTS - 1) & 1);
#pragma unroll
      for (int m = 0; m < TW / 8; ++m)
        if (8 * m < dh) {
          const float* d = m < 8 ? s + 4 * m : dp + 4 * (m - 8);
          sm.dq[slot][m * 128 + tid] = make_float4(d[0], d[1], d[2], d[3]);
        }
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
    for (int j = 0; j < TW / 8; ++j) {
      const int d = 8 * j + 2 * t;
      if (8 * j >= dh) continue;
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

// -- backward, few queries (nq <= 8 < nk, no dropout) ---------------------------
//
// The CLS block's 8 query rows against all N keys (few_query_bwd). One CTA,
// one warpgroup, per (head, sample): its Q and dO rows land once, zero-padded
// to 16 rows; it forms delta = rowsum(dO . O) and lse log2(e) for its rows
// itself; K and V stream in 64-key tiles through a ring (FewCfg) by
// cp.async. The queries are the short side of every product:
//   S^T = K Q^T, dP^T = V dO^T    m64n8 (keys M, queries N)
//   P^T, dS^T                      in the accumulators' registers
//   dV = P^T dO, dK = dS^T Q       m64n64k16, A from those registers (the n8
//                                  accumulator is the m16k8 half of an A
//                                  fragment; queries 8-15 are zero)
//   dQ^T += K^T dS^T               m64n8 (dh M, queries N), K read MN-major,
//                                  dS^T through shared memory as [query][key]
// Each key tile's dK and dV come from its own products alone and leave as
// they are made, through the ring stage that held the tile's K and V, by
// the copy engine in whole 128-byte rows; dQ^T sums over the key tiles in
// registers, in key order, and is rounded once. One launch, no workspace, no turn counters or
// atomics, no CTA waits for another: the outputs repeat bit for bit and the
// kernel progresses on one multiprocessor. Keys >= valid_len take P = 0
// (their dK, dV are 0; K and V load zeros past them), query rows >=
// valid_len take lse = +inf (P = 0, dq 0). Where the streamed kernel ran
// 64-row query tiles holding 8 rows (7/8 of its tensor work on padding)
// and summed dQ across key blocks through the workspace, this one's bytes
// are K and V read and dK and dV written once.

constexpr int FEW_MAX_Q = 8;   // query rows: the n of the m64n8 products
// The K / V ring's depth and CTAs an SM: at TW 64 (dh <= 64, ~70 KB of
// shared memory each) 4 and 3, where 3 stages and 4 CTAs read within 3% at
// the CLS shapes, 2 and 5 up to 7% slower (scripts/few_bwd_variants.py); at
// TW 128 (dh 72-128, 64-key tiles of 32 KB, dV and dK 64 accumulators each)
// 3 and 2.
template <int TW>
struct FewCfg {
  static constexpr int stages = TW == 128 ? 3 : 4, ctas = TW == 128 ? 2 : 3;
};

template <int TW>
struct FewSmem {
  // [key][dh] tiles of TW columns (tile_at)
  bf16 k[FewCfg<TW>::stages][64 * TW], v[FewCfg<TW>::stages][64 * TW];
  bf16 q[16 * TW], d_o[16 * TW];  // [query][dh], rows >= nq zero (dV's and dK's k16 depth)
  bf16 ds[FEW_MAX_Q * 64];        // the tile's dS, [query][key], 128-byte swizzle
  float ml[FEW_MAX_Q], dl[FEW_MAX_Q];  // per query: lse log2(e) (+inf past qend), delta
};

// DH 0: the launch's wd.dh (a multiple of 8 up to TW), zeros past it in the
// tiles, S^T and dP^T over its k16 steps, wd's scale; at TW 128 dV and dK
// are n128 products and dQ^T two m64 halves of dh.
template <int DH, int TW = 64>
__global__ void __launch_bounds__(128, FewCfg<TW>::ctas)
    flash_bwd_few_kernel(const Strided q, const Strided k, const Strided v, const Strided o,
                         const Strided d_o, const float* __restrict__ lse, const Strided dq,
                         const Strided dk, const Strided dv, int nq, int nk, int valid_len,
                         const Width wd) {
  constexpr int ST = FewCfg<TW>::stages, CH = TW / 8, HALVES = TW / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  FewSmem<TW>& sm = *reinterpret_cast<FewSmem<TW>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int h = blockIdx.x, b = blockIdx.y, heads = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's key (or dh) rows: r0, r0 + 8
  const int kend = min(valid_len, nk), qend = min(valid_len, nq);
  const int tiles = ceil_div(kend, 64);  // key tiles holding a valid key
  const int dh = att_dh<DH>(wd), dsteps = (dh + 15) / 16;
  const float slog2 = att_slog2<DH>(wd), scale = att_scale<DH>(wd);

  // K and V of key tile j into its stage: 16-byte pieces, zeros past kend and dh
  auto load_tile = [&](int j) {
    const int st = j % ST, k0 = 64 * j;
    for (int i = tid; i < 64 * CH; i += 128) {
      const int r = i / CH, ch = i % CH;
      const bool ok = k0 + r < kend && ch < dh / 8;
      cp_async16(sm.k[st] + tile_at<TW>(r, ch * 8, 64), ok ? k.row(b, h, k0 + r) + ch * 8 : k.p,
                 ok);
      cp_async16(sm.v[st] + tile_at<TW>(r, ch * 8, 64), ok ? v.row(b, h, k0 + r) + ch * 8 : v.p,
                 ok);
    }
  };
  // Q and dO, 16 rows, with the first key tile
  for (int i = tid; i < 16 * CH; i += 128) {
    const int r = i / CH, ch = i % CH;
    const bool ok = r < nq && ch < dh / 8;
    cp_async16(sm.q + tile_at<TW>(r, ch * 8, 16), ok ? q.row(b, h, r) + ch * 8 : q.p, ok);
    cp_async16(sm.d_o + tile_at<TW>(r, ch * 8, 16), ok ? d_o.row(b, h, r) + ch * 8 : d_o.p, ok);
  }
  load_tile(0);
  cp_async_commit();
#pragma unroll
  for (int j = 1; j < ST - 1; ++j) {
    if (j < tiles) load_tile(j);
    cp_async_commit();
  }
  {  // delta and lse of query row tid / 16: sixteen threads a row, TW / 16 columns each
    const int r = tid >> 4, part = tid & 15;
    float s = 0.f;
    auto add = [&](const __nv_bfloat162* a2, const __nv_bfloat162* c2, int n2) {
      for (int e = 0; e < n2; ++e) {
        const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(c2[e]);
        s = fmaf(x.x, y.x, fmaf(x.y, y.y, s));
      }
    };
    if constexpr (TW == 64) {
      if (r < qend && 4 * part < dh) {
        const uint2 a = *reinterpret_cast<const uint2*>(o.row(b, h, r) + 4 * part);
        const uint2 c = *reinterpret_cast<const uint2*>(d_o.row(b, h, r) + 4 * part);
        add(reinterpret_cast<const __nv_bfloat162*>(&a), reinterpret_cast<const __nv_bfloat162*>(&c),
            2);
      }
    } else {
      if (r < qend && 8 * part < dh) {
        const uint4 a = *reinterpret_cast<const uint4*>(o.row(b, h, r) + 8 * part);
        const uint4 c = *reinterpret_cast<const uint4*>(d_o.row(b, h, r) + 8 * part);
        add(reinterpret_cast<const __nv_bfloat162*>(&a), reinterpret_cast<const __nv_bfloat162*>(&c),
            4);
      }
    }
#pragma unroll
    for (int x = 1; x < 16; x *= 2) s += __shfl_xor_sync(0xffffffffu, s, x);
    if (part == 0) {
      sm.dl[r] = r < qend ? s : 0.f;
      sm.ml[r] = r < qend ? lse[((long long)b * heads + h) * nq + r] * kLog2e : INFINITY;
    }
  }

  float dqa[HALVES][4];  // dQ^T: rows dh 64 half + r0, + 8; columns queries 2t, 2t + 1
  float dva[TW / 2], dka[TW / 2];
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[hh][e] = 0.f;
#pragma unroll
  for (int i = 0; i < TW / 2; ++i) dva[i] = dka[i] = 0.f;
  for (int j = 0; j < tiles; ++j) {
    const int st = j % ST, k0 = 64 * j;
    cp_async_wait<ST - 2>();  // this thread's pieces of tile j have landed
    bulk_wait_read<0>();      // and its row of tile j - 1's dK or dV has left
    fence_async_smem();
    __syncthreads();  // everyone's; and every thread is done with tile j - 1's stage
    if (j + ST - 1 < tiles) load_tile(j + ST - 1);
    cp_async_commit();
    const bf16* kt = sm.k[st];

    // S^T = K Q^T, dP^T = V dO^T
    float s[4], dp[4];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < TW / 16; ++ks)
      if (ks < dsteps)
        wgmma_ss<0, 0>(s, tile_kdesc<TW>(kt, ks, 64), tile_kdesc<TW>(sm.q, ks, 16), ks);
#pragma unroll
    for (int ks = 0; ks < TW / 16; ++ks)
      if (ks < dsteps)
        wgmma_ss<0, 0>(dp, tile_kdesc<TW>(sm.v[st], ks, 64), tile_kdesc<TW>(sm.d_o, ks, 16), ks);
    wg_commit();
    wg_wait<0>();
    wg_hold(s);
    wg_hold(dp);

    // P^T and dS^T (keys r0, r0 + 8; queries 2t, 2t + 1): A fragments of dV
    // and dK (queries 8-15 zero), and dS^T into shared memory for dQ
    float pv[4], dsv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kr = r0 + 8 * (e >> 1), qq = 2 * t + (e & 1);
      const float x = k0 + kr < kend ? s[e] : -INFINITY;
      pv[e] = exp2_approx(fmaf(x, slog2, -sm.ml[qq]));
      dsv[e] = pv[e] * (dp[e] - sm.dl[qq]) * scale;
      sm.ds[sw128(qq, kr)] = __float2bfloat16(dsv[e]);
    }
    const uint32_t pa[4] = {pack_bf16(pv[0], pv[1]), pack_bf16(pv[2], pv[3]), 0u, 0u};
    const uint32_t da[4] = {pack_bf16(dsv[0], dsv[1]), pack_bf16(dsv[2], dsv[3]), 0u, 0u};
    fence_async_smem();
    __syncthreads();  // dS^T is in shared memory

    // dV = P^T dO, dK = dS^T Q (dO and Q read MN-major); dQ^T += K^T dS^T
    wg_fence();
    wgmma_rs<1>(dva, pa, tile_ndesc<TW>(sm.d_o, 0, 16), 0);
    wgmma_rs<1>(dka, da, tile_ndesc<TW>(sm.q, 0, 16), 0);
#pragma unroll
    for (int G = 0; G < 4; ++G)
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh)
        wgmma_ss<1, 0>(dqa[hh], sw128_desc(kt + hh * 64 * 64 + G * 16 * 64),
                       sw128_desc(sm.ds + G * 16), 1);
    wg_commit();
    wg_wait<0>();
    wg_hold(dva);
    wg_hold(dka);
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh) wg_hold(dqa[hh]);

    // the tile's dK, dV rows (keys in [kend, nk) come out 0), through the
    // stage its K and V held (read by now; refilled only after the next
    // step's barrier, once these copies have read it) as [key][TW] rows,
    // then out by the copy engine, a row's dh columns a thread, under the
    // next step's work: stored from the accumulators in 4-byte pieces (8
    // rows' 16 bytes a warp's store) the kernel took 1.5x as long
    // (scripts/few_bwd_variants.py)
    __syncthreads();  // every warp is past the products that read the stage
    bf16* const stg[2] = {sm.k[st], sm.v[st]};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int jj = 0; jj < TW / 8; ++jj) {
        const int at = (r0 + 8 * rr) * TW + 8 * jj + 2 * t;
        *reinterpret_cast<uint32_t*>(stg[0] + at) =
            pack_bf16(dka[4 * jj + 2 * rr], dka[4 * jj + 2 * rr + 1]);
        *reinterpret_cast<uint32_t*>(stg[1] + at) =
            pack_bf16(dva[4 * jj + 2 * rr], dva[4 * jj + 2 * rr + 1]);
      }
    fence_async_smem();
    __syncthreads();
    {
      const int which = tid >> 6, r = tid & 63;
      if (k0 + r < nk)
        bulk_store((which ? dv : dk).row(b, h, k0 + r), stg[which] + r * TW, dh * 2);
      bulk_commit();
    }
  }
  cp_async_wait<0>();  // no copy may land after the CTA exits
  bulk_wait<0>();
  // keys past the last tile holding a valid key: dK = dV = 0
  for (int i = tid; i < (nk - 64 * tiles) * CH; i += 128) {
    const int key = 64 * tiles + i / CH, ch = i % CH;
    if (ch >= dh / 8) continue;
    *reinterpret_cast<uint4*>(dk.row(b, h, key) + ch * 8) = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(dv.row(b, h, key) + ch * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  // dQ, rounded once; query rows >= qend are 0
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qq = 2 * t + (e & 1), d = 64 * hh + r0 + 8 * (e >> 1);
      if (qq < nq && d < dh) dq.row(b, h, qq)[d] = __float2bfloat16(qq < qend ? dqa[hh][e] : 0.f);
    }
}

template <int DH, int TW>
cudaError_t launch_few(const Strided& q, const Strided& k, const Strided& v, const Strided& o,
                       const Strided& d_o, const float* lse, const Strided& dq, const Strided& dk,
                       const Strided& dv, int B, int heads, int nq, int nk, int valid_len,
                       const Width& wd, cudaStream_t st) {
  constexpr int smem = sizeof(FewSmem<TW>) + 1024;  // + alignment to 1024 bytes
  static bool ready[16];  // the shared-memory limit, set once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16 || !ready[dev]) {
    e = cudaFuncSetAttribute(flash_bwd_few_kernel<DH, TW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < 16) ready[dev] = true;
  }
  flash_bwd_few_kernel<DH, TW><<<dim3(heads, B), 128, smem, st>>>(q, k, v, o, d_o, lse, dq, dk,
                                                                  dv, nq, nk, valid_len, wd);
  return cudaGetLastError();
}

// -- forward, few queries (nq <= 8 < nk <= FEW_FWD_MAX_KEYS, no dropout) ------------
//
// The CLS block's 8 query rows against all N keys (few_query_fwd), one
// launch: one CTA, one warpgroup, a (sample, head). Where the streamed
// forward gave them a 64-row query tile (7/8 of every S and P.V product on
// padding) and an online softmax rescaled across the key tiles, this one
// puts the queries on the short side of m64n8 products and keeps the fp32
// scores of every key in shared memory (32 bytes a key), so the softmax is
// exact, in two passes:
//   S^T = K Q^T       m64n8k16 (keys M, queries N), K in 64-key tiles; the
//                     scores to shared memory as [key][query], keys >=
//                     valid_len at -inf, and each query's max
//   P^T               from the stored scores and the max, rounded to bf16 as
//                     [query][key] (the B operand below); the fp32 row sums
//                     of the unrounded P
//   O^T += V^T P^T    m64n8k16 (dh M, queries N), V read MN-major, in 64-key
//                     tiles
// O = O^T / l rounded once, lse = m / 8 + log l (the streamed forward's
// convention, which flash_bwd_few_kernel reads). K and V stream by TMA
// (thread 0 issues, an mbarrier a stage) through a ring of 64 x 64 tiles (K
// tiles first, then V tiles: one pass each); its depth is what three CTAs
// an SM leave beside the scores (few_fwd_stages).
//
// MAKE_Q (the CLS block's chain, FewQ): the CTA makes its own Q from the
// block's input: the LayerNorm of the sample's top rows (one warp a row,
// layer_norm_kernel's sums in its order, so h's bits), then Q^T = W_q,h
// h^T (m64n8k16, the head's 64 rows of W_q streamed through the same ring
// ahead of the keys, 64 columns of dim a stage), rounded to bf16 where the
// chain rounds q; the training form also writes Q to its save. No
// workspace, no atomics, every sum in a fixed order: the outputs repeat bit
// for bit.

constexpr int FEW_FWD_MAX_KEYS = 4096;  // 128 KB of fp32 scores, beside two ring stages at any TW
constexpr int FEW_Q_MAX_DIM = 256;      // MAKE_Q: the LN1 rows' values, 8 a lane of a row
constexpr int FEW_FWD_MAX_STAGES = 8;
constexpr int SM_SMEM = 233472;  // an H100 SM's shared memory; a CTA reserves 1 KB of it

// Shared memory of the few-query forward: the ring of `stages` 64 x tw
// tiles, Q^T's B tile, P^T's, then the scores, whose room holds the
// normalised top rows ([8][64] tiles, MAKE_Q) before the first score.
struct FewFwdLayout {
  int ring, q, p, s, red, bars, bytes;
  __host__ __device__ FewFwdLayout(int tiles, int qchunks, int stages, int tw = 64) {
    ring = 0;
    q = ring + stages * 64 * tw * 2;
    p = q + FEW_MAX_Q * tw * 2;
    s = p + FEW_MAX_Q * 64 * 2;
    const int scores = tiles * 64 * FEW_MAX_Q * 4, rows = qchunks * FEW_MAX_Q * 64 * 2;
    red = s + (scores > rows ? scores : rows);
    bars = red + 2 * 4 * FEW_MAX_Q * 4;
    bytes = bars + stages * 8;
  }
};

// Ring stages at these shapes: as many CTAs an SM as a ring of two stages
// lets fit, then the deepest ring (up to FEW_FWD_MAX_STAGES) that keeps them
// there. scripts/few_fwd_variants.py has the rules measured beside it (TW
// 64). At TW 128 and 4,096 keys: one CTA, six stages.
__host__ __device__ inline int few_fwd_stages(int tiles, int qchunks, int tw = 64) {
  const int stage = 64 * tw * 2 + 8;
  const int fixed = FewFwdLayout(tiles, qchunks, 0, tw).bytes + 2048;  // + alignment, reservation
  int ctas = SM_SMEM / (fixed + 2 * stage);
  ctas = ctas < 1 ? 1 : ctas > 8 ? 8 : ctas;
  const int room = (SM_SMEM / ctas - fixed) / stage;
  return room < 2 ? 2 : room > FEW_FWD_MAX_STAGES ? FEW_FWD_MAX_STAGES : room;
}

// DH 0: the launch's wd.dh (a multiple of 8 up to TW) in tiles of TW
// columns, zeros past dh; S^T over its k16 steps, wd's scale, O^T in TW / 64
// m64 halves of dh and O's stores to dh. MAKE_Q at TW 64 only: the head's
// W_q rows start at h dh, and Q's rows past dh are zeroed.
template <bool MAKE_Q, int DH = 64, int TW = 64>
__global__ void __launch_bounds__(128, 8)
    flash_fwd_few_kernel(const Strided q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_w, bool hf_k, bool hf_v,
                         const Strided o, float* __restrict__ lse, int nq, int nk,
                         int valid_len, const FewQ fq, const Width wd) {
  static_assert(!MAKE_Q || TW == 64, "Q is made in 64-row products");
  constexpr int CH = TW / 8, HALVES = TW / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int h = blockIdx.x, b = blockIdx.y, heads = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's key (or dh) rows: r0, r0 + 8
  const int kend = min(valid_len, nk), tiles = ceil_div(kend, 64);
  const int dh = att_dh<DH>(wd), dsteps = (dh + 15) / 16;
  const float slog2 = att_slog2<DH>(wd);
  const int qc = MAKE_Q ? ceil_div(fq.dim, 64) : 0;  // W_q chunks ahead of the keys
  const int items = qc + 2 * tiles, nst = few_fwd_stages(tiles, qc, TW);
  const FewFwdLayout lay(tiles, qc, nst, TW);
  bf16* ring = reinterpret_cast<bf16*>(base + lay.ring);
  bf16* sq = reinterpret_cast<bf16*>(base + lay.q);  // [query][dh] (tile_at, 8 rows)
  bf16* sp = reinterpret_cast<bf16*>(base + lay.p);  // [query][key] of a tile, 128-byte swizzle
  bf16* sh = reinterpret_cast<bf16*>(base + lay.s);  // MAKE_Q: [chunk][query][64], then
  float* sc = reinterpret_cast<float*>(base + lay.s);  // the scores: [key][query] fp32
  float* red = reinterpret_cast<float*>(base + lay.red);  // [2][warp][query]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.bars);  // a ring stage has landed

  // item i into ring stage i % nst by TMA (thread 0): W_q's chunk i of the
  // head's rows (MAKE_Q), then the K tiles, then the V tiles; zeros past
  // dim and past the tensors' rows and columns
  auto load_item = [&](int i) {
    const int st = i % nst;
    bf16* dst = ring + st * 64 * TW;
    mbar_expect(&full[st], 64 * TW * 2);
    if (MAKE_Q && i < qc) {
      tma_load_3d(dst, tm_w, &full[st], 64 * i, h * dh, 0);
      return;
    }
    const int j = i - qc, isv = j >= tiles, k0 = 64 * (isv ? j - tiles : j);
    tma_rows<TW>(dst, isv ? tm_v : tm_k, &full[st], 64, k0, h, b, isv ? hf_v : hf_k);
  };
  // the top of item i's step: it has landed, and every thread is done with
  // item i - 1's stage, which then takes item i + nst - 1
  auto next_item = [&](int i) {
    const int st = i % nst;
    mbar_wait(&full[st], (i / nst) & 1);
    __syncthreads();
    if (tid == 0 && i + nst - 1 < items) load_item(i + nst - 1);
    return ring + st * 64 * TW;
  };

  if (tid == 0) {
    for (int i = 0; i < nst; ++i) mbar_init(&full[i], 1);
    fence_async_smem();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < nst - 1 && i < items; ++i) load_item(i);

  if (!MAKE_Q) {  // Q's rows, zeros past nq and dh
    for (int i = tid; i < FEW_MAX_Q * CH; i += 128) {
      const int r = i / CH, ch = i % CH;
      const bool ok = r < nq && ch < dh / 8;
      cp_async16(sq + tile_at<TW>(r, ch * 8, FEW_MAX_Q), ok ? q.row(b, h, r) + ch * 8 : q.p, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();  // the first K step's barrier makes the tile everyone's
  }

  if (MAKE_Q) {
    // the LayerNorm of the top rows (warp w: rows w, w + 4) into the [8][64]
    // tiles, rows >= nq and columns >= dim zero; layer_norm_kernel's sums in
    // its order, from the rows' values loaded once into registers
    for (int i = tid; i < qc * FEW_MAX_Q * 8; i += 128)
      *reinterpret_cast<uint4*>(sh + i * 8) = make_uint4(0u, 0u, 0u, 0u);
    const int dim = fq.dim;
    constexpr int M = FEW_Q_MAX_DIM / 32;  // values a lane of a row
    float xv[2][M];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = warp + 4 * rr;
      const bf16* xr = fq.x + ((long long)b * nk + row) * dim;
#pragma unroll
      for (int m = 0; m < M; ++m)
        xv[rr][m] = row < nq && lane + 32 * m < dim ? __bfloat162float(xr[lane + 32 * m]) : 0.f;
    }
    __syncthreads();  // the zeros are down before any row's values
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = warp + 4 * rr;
      if (row >= nq) continue;
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m)
        if (lane + 32 * m < dim) s += xv[rr][m];
      const float mu = warp_sum(s) / dim;
      float var = 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m)
        if (lane + 32 * m < dim) {
          const float d = xv[rr][m] - mu;
          var += d * d;
        }
      const float rstd = rsqrtf(warp_sum(var) / dim + fq.eps);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = lane + 32 * m;
        if (i < dim)
          sh[(i >> 6) * FEW_MAX_Q * 64 + sw128(row, i & 63)] =
              __float2bfloat16((xv[rr][m] - mu) * rstd * fq.gamma[i] + fq.beta[i]);
      }
    }
    fence_async_smem();  // the first W step's barrier makes the rows everyone's
    // Q^T = W_q,h h^T over the dim chunks, then bf16 into the Q tile (the
    // rows' room then takes the scores: the first K tile's barrier is past
    // every product that read it); rows past dh (the next head's) zero
    float qa[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < qc; ++c) {
      const bf16* wt = next_item(c);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss<0, 0>(qa, sw128_desc(wt + ks * 16),
                       sw128_desc(sh + c * FEW_MAX_Q * 64 + ks * 16), c > 0 || ks > 0);
      wg_commit();
      wg_wait<0>();
      wg_hold(qa);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // dh row r0 + 8 (e >> 1), query 2 t + (e & 1)
      const int d = r0 + 8 * (e >> 1);
      sq[sw128(2 * t + (e & 1), d)] = __float2bfloat16(d < dh ? qa[e] : 0.f);
    }
    fence_async_smem();
  }

  // pass 1: S^T = K Q^T per key tile; the scores to shared memory, the max
  float mx[2] = {-INFINITY, -INFINITY};  // queries 2t, 2t + 1 over this thread's keys
  for (int j = 0; j < tiles; ++j) {
    const bf16* kt = next_item(qc + j);
    if (MAKE_Q && j == 0 && fq.q_out != nullptr && tid < nq * 8 && (tid & 7) < dh / 8) {
      const int r = tid >> 3, ch = tid & 7;  // the training save
      *reinterpret_cast<uint4*>(fq.q_out + ((long long)b * nq + r) * heads * dh + h * dh +
                                ch * 8) = *reinterpret_cast<const uint4*>(sq + sw128(r, ch * 8));
    }
    float s[4];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < TW / 16; ++ks)
      if (ks < dsteps)
        wgmma_ss<0, 0>(s, tile_kdesc<TW>(kt, ks, 64), tile_kdesc<TW>(sq, ks, FEW_MAX_Q), ks);
    wg_commit();
    wg_wait<0>();
    wg_hold(s);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int key = 64 * j + r0 + 8 * rr;
      const bool ok = key < kend;
      const float2 val = make_float2(ok ? s[2 * rr] : -INFINITY, ok ? s[2 * rr + 1] : -INFINITY);
      *reinterpret_cast<float2*>(sc + key * FEW_MAX_Q + 2 * t) = val;
      mx[0] = fmaxf(mx[0], val.x);
      mx[1] = fmaxf(mx[1], val.y);
    }
  }
#pragma unroll
  for (int x = 4; x < 32; x *= 2) {
    mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], x));
    mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], x));
  }
  if (g == 0) *reinterpret_cast<float2*>(red + warp * FEW_MAX_Q + 2 * t) = make_float2(mx[0], mx[1]);

  // pass 2: P^T of each key tile from the scores, O^T += V^T P^T; thread
  // tid forms key tid / 2 of the tile for queries qb .. qb + 3
  const int qb = 4 * (tid & 1), kk = tid >> 1;
  float ms[4], lsum[4] = {0.f, 0.f, 0.f, 0.f};
  float oa[HALVES][4];  // O^T: dh rows 64 half + r0, + 8; queries 2t, 2t + 1
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int e = 0; e < 4; ++e) oa[hh][e] = 0.f;
  for (int j = 0; j < tiles; ++j) {
    const bf16* vt = next_item(qc + tiles + j);
    if (j == 0) {  // every warp's max is in `red` (the step's barrier)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float m = fmaxf(fmaxf(red[qb + i], red[FEW_MAX_Q + qb + i]),
                              fmaxf(red[2 * FEW_MAX_Q + qb + i], red[3 * FEW_MAX_Q + qb + i]));
        ms[i] = m * slog2;
      }
    }
    const float4 sv = *reinterpret_cast<const float4*>(sc + (64 * j + kk) * FEW_MAX_Q + qb);
    const float pv[4] = {exp2_approx(fmaf(sv.x, slog2, -ms[0])),
                         exp2_approx(fmaf(sv.y, slog2, -ms[1])),
                         exp2_approx(fmaf(sv.z, slog2, -ms[2])),
                         exp2_approx(fmaf(sv.w, slog2, -ms[3]))};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lsum[i] += pv[i];
      sp[sw128(qb + i, kk)] = __float2bfloat16(pv[i]);
    }
    fence_async_smem();
    __syncthreads();  // P^T of the tile is in shared memory
    wg_fence();
#pragma unroll
    for (int G = 0; G < 4; ++G)
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh)
        wgmma_ss<1, 0>(oa[hh], sw128_desc(vt + hh * 64 * 64 + G * 16 * 64),
                       sw128_desc(sp + G * 16), j > 0 || G > 0);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh) wg_hold(oa[hh]);
  }

  // l per query: over the lanes of this thread's parity, then the warps in order
#pragma unroll
  for (int x = 2; x < 32; x *= 2)
#pragma unroll
    for (int i = 0; i < 4; ++i) lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], x);
  float* lred = red + 4 * FEW_MAX_Q;
  if (lane < 2)
#pragma unroll
    for (int i = 0; i < 4; ++i) lred[warp * FEW_MAX_Q + qb + i] = lsum[i];
  __syncthreads();  // and every thread is past its products: the Q tile takes O
  float inv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qq = 2 * t + e;
    inv[e] = 1.f / (((lred[qq] + lred[FEW_MAX_Q + qq]) + lred[2 * FEW_MAX_Q + qq]) +
                    lred[3 * FEW_MAX_Q + qq]);
  }
  if (lse != nullptr && tid < nq) {
    const float l = ((lred[tid] + lred[FEW_MAX_Q + tid]) + lred[2 * FEW_MAX_Q + tid]) +
                    lred[3 * FEW_MAX_Q + tid];
    const float m = fmaxf(fmaxf(red[tid], red[FEW_MAX_Q + tid]),
                          fmaxf(red[2 * FEW_MAX_Q + tid], red[3 * FEW_MAX_Q + tid]));
    lse[((long long)b * heads + h) * nq + tid] = m * att_scale<DH>(wd) + logf(l);
  }
  // O through the Q tile as [query][TW] rows, then its dh columns out in
  // 16-byte pieces
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sq[(2 * t + (e & 1)) * TW + 64 * hh + r0 + 8 * (e >> 1)] =
          __float2bfloat16(oa[hh][e] * inv[e & 1]);
  __syncthreads();
  for (int i = tid; i < nq * CH; i += 128) {
    const int r = i / CH, ch = i % CH;
    if (ch < dh / 8)
      *reinterpret_cast<uint4*>(o.row(b, h, r) + ch * 8) =
          *reinterpret_cast<const uint4*>(sq + r * TW + ch * 8);
  }
}

cudaError_t tensor_map(CUtensorMap* m, const Strided& t, int B, int heads, int n,
                       bool heads_first, int rows, int dh, int box);

template <bool MAKE_Q, int DH, int TW>
cudaError_t launch_few_fwd(const Strided& q, const Strided& k, const Strided& v,
                           const Strided& o, float* lse, int B, int heads, int nq, int nk,
                           int valid_len, const FewQ& fq, const Width& wd, cudaStream_t st) {
  const int dh = wd.dh;  // the head's layout columns
  static bool ready[16];  // the shared-memory limit, set once per device to the card's
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16 || !ready[dev]) {
    e = cudaFuncSetAttribute(flash_fwd_few_kernel<MAKE_Q, DH, TW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return e;
    if (dev < 16) ready[dev] = true;
  }
  const bool hf_k = k.sh < k.sr, hf_v = v.sh < v.sr;
  CUtensorMap tm_k, tm_v, tm_w;
  if ((e = tensor_map(&tm_k, k, B, heads, nk, hf_k, 64, dh, 64)) != cudaSuccess) return e;
  if ((e = tensor_map(&tm_v, v, B, heads, nk, hf_v, 64, dh, 64)) != cudaSuccess) return e;
  tm_w = tm_k;  // unused unless MAKE_Q
  if (MAKE_Q) {  // W_q (heads * dh, dim): [64 rows][64 columns] boxes
    const cuuint64_t dims[3] = {(cuuint64_t)fq.dim, (cuuint64_t)heads * dh, 1};
    const cuuint64_t strides[2] = {(cuuint64_t)fq.dim * 2, (cuuint64_t)heads * dh * fq.dim * 2};
    const cuuint32_t box[3] = {64, 64, 1};
    if ((e = encode_tiled(&tm_w, 3, fq.wq, dims, strides, box)) != cudaSuccess) return e;
  }
  const int tiles = ceil_div(std::min(valid_len, nk), 64), qc = MAKE_Q ? ceil_div(fq.dim, 64) : 0;
  const FewFwdLayout lay(tiles, qc, few_fwd_stages(tiles, qc, TW), TW);
  flash_fwd_few_kernel<MAKE_Q, DH, TW><<<dim3(heads, B), 128, lay.bytes + 1024, st>>>(
      q, tm_k, tm_v, tm_w, hf_k, hf_v, o, lse, nq, nk, valid_len, fq, wd);
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

#ifndef SVT_ATT_WIDTHS
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
#endif

__device__ __forceinline__ void add4(float4& a, const float4& x) {
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
}

// dq = bf16((sum 0 + sum 1) + (sum 2 + sum 3)) through dq's strides, each
// sum only where its turn counter says it took an add: one thread per
// float4 of a tile (rows r and r + 8, two columns); rows >= qend (never
// summed) are 0. DH 0: tiles of 64 dh floats (the launch's dh).
template <int DH>
__global__ void __launch_bounds__(256)
    flash_bwd_dq_kernel(const float* __restrict__ sums, const int* __restrict__ sems,
                        const Strided dq, int heads, int nq, int qend, long long chunks, int dh) {
  const int TILE4 = DH ? bwd_tile<DH>() / 4 : BWD_BQ * dh / 4;
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

// A TMA map of the (B, heads, n, dh) operand t, boxes of `rows` x `box`
// columns (columns past dh zero-filled), in the 64-byte swizzle for 32-column
// boxes, else the 128-byte one; the two middle dimensions in increasing
// stride (heads first for the packed (B, n, heads * dh) layouts).
cudaError_t tensor_map(CUtensorMap* m, const Strided& t, int B, int heads, int n,
                       bool heads_first, int rows, int dh, int box) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)(heads_first ? heads : n),
                              (cuuint64_t)(heads_first ? n : heads), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(heads_first ? t.sh : t.sr) * 2,
                                 (cuuint64_t)(heads_first ? t.sr : t.sh) * 2,
                                 (cuuint64_t)t.sb * 2};
  const cuuint32_t boxes[4] = {(cuuint32_t)box, heads_first ? 1u : (cuuint32_t)rows,
                               heads_first ? (cuuint32_t)rows : 1u, 1};
  return encode_tiled(m, 4, t.p, dims, strides, boxes, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      box == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool DROP, int DH, int TW>
cudaError_t launch_bwd_main(dim3 grid, cudaStream_t st, const Strided& q, const Strided& k,
                            const Strided& v, const Strided& d_o, const float* lse,
                            const float* delta, float* sums, int* sems, const Strided& dk,
                            const Strided& dv, int B, int heads, int nq, int nk, int valid_len,
                            const Dropout& dr, const Width& wd, int dh) {
  constexpr int smem = sizeof(BwdSmem<TW>) + 1024;  // + alignment to 1024 bytes
  // The shared-memory limit, set once per device (a launch's host work
  // counts where the kernels are short).
  static bool ready[16];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16 || !ready[dev]) {
    e = cudaFuncSetAttribute(flash_bwd_kernel<DROP, DH, TW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < 16) ready[dev] = true;
  }
  const int qt = ceil_div(std::min(valid_len, nq), BWD_BQ);
  const int kt = ceil_div(std::min(valid_len, nk), BWD_BK);
  const bool rotate = qt == kt;
  const bool hf_q = q.sh < q.sr, hf_do = d_o.sh < d_o.sr;
  CUtensorMap tm_q, tm_do;
  if ((e = tensor_map(&tm_q, q, B, heads, nq, hf_q, BWD_BQ, dh, 64)) != cudaSuccess) return e;
  if ((e = tensor_map(&tm_do, d_o, B, heads, nq, hf_do, BWD_BQ, dh, 64)) != cudaSuccess) return e;
  flash_bwd_kernel<DROP, DH, TW><<<grid, BWD_THREADS, smem, st>>>(
      tm_q, tm_do, hf_q, hf_do, k, v, lse, delta, sums, sems, dk, dv, nq, nk, valid_len, rotate,
      dr, wd);
  return cudaGetLastError();
}

// TMA reads an operand, and the forward writes O in 16-byte pieces: the
// base and every stride on 16 bytes.
bool aligned16(const Strided& t) {
  return (reinterpret_cast<uintptr_t>(t.p) & 15) == 0 && t.sb % 8 == 0 && t.sh % 8 == 0 &&
         t.sr % 8 == 0;
}

template <int NWG, int BK, bool DROP, int DH, int TW>
cudaError_t launch_fwd(cudaStream_t st, const Strided& q, const Strided& k, const Strided& v,
                       const Strided& o, float* lse, int B, int heads, int nq, int nk,
                       int valid_len, const Dropout& dr, const Width& wd, int dh) {
  constexpr int smem = sizeof(FwdSmem<NWG, BK, TW>) + 1024;  // + alignment to 1024 bytes
  static bool ready[16];  // the shared-memory limit, set once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16 || !ready[dev]) {
    e = cudaFuncSetAttribute(flash_fwd_kernel<NWG, BK, DROP, DH, TW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < 16) ready[dev] = true;
  }
  const bool hf_q = q.sh < q.sr, hf_k = k.sh < k.sr, hf_v = v.sh < v.sr;
  constexpr int box = TW < 64 ? TW : 64;
  CUtensorMap tm_q, tm_k, tm_v;
  if ((e = tensor_map(&tm_q, q, B, heads, nq, hf_q, 64, dh, box)) != cudaSuccess) return e;
  if ((e = tensor_map(&tm_k, k, B, heads, nk, hf_k, BK, dh, box)) != cudaSuccess) return e;
  if ((e = tensor_map(&tm_v, v, B, heads, nk, hf_v, BK, dh, box)) != cudaSuccess) return e;
  const dim3 grid(ceil_div(nq, 64 * NWG), heads, B);
  flash_fwd_kernel<NWG, BK, DROP, DH, TW><<<grid, FwdCfg<NWG, BK, TW>::threads, smem, st>>>(
      tm_q, tm_k, tm_v, hf_q, hf_k, hf_v, o, lse, nq, nk, valid_len, dr, wd);
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
// one; the same for tiles of 32 and 64 columns. Tiles of 128 columns (dh
// 72-128) take one tiling, 64-key tiles and one warpgroup: its O (64
// accumulators a thread) leaves no room for a 128-key tile's scores, or for
// three warpgroups.
template <bool DROP, int DH, int TW = DH>
cudaError_t launch_rule(bool long_keys, bool wide, cudaStream_t st, const Strided& q,
                        const Strided& k, const Strided& v, const Strided& o, float* lse, int B,
                        int heads, int nq, int nk, int valid_len, const Dropout& dr,
                        const Width& wd = Width{}) {
  const int dh = DH ? DH : wd.dh;
  if constexpr (TW == 128) {
    return launch_fwd<1, 64, DROP, DH, TW>(st, q, k, v, o, lse, B, heads, nq, nk, valid_len, dr,
                                           wd, dh);
  } else {
    if (!long_keys)
      return launch_fwd<1, 64, DROP, DH, TW>(st, q, k, v, o, lse, B, heads, nq, nk, valid_len,
                                             dr, wd, dh);
    if (wide)
      return launch_fwd<3, 128, DROP, DH, TW>(st, q, k, v, o, lse, B, heads, nq, nk, valid_len,
                                              dr, wd, dh);
    return launch_fwd<1, 128, DROP, DH, TW>(st, q, k, v, o, lse, B, heads, nq, nk, valid_len,
                                            dr, wd, dh);
  }
}

// The streamed forward's tiling by shape: past 512 keys, 128-key tiles and
// three consumer warpgroups (192 queries) where that grid still fills the
// card twice; else one warpgroup (64 queries, two or three CTAs per SM,
// whose prologues and epilogues overlap each other's loops), with 64-key
// tiles up to 512 keys (the tilings measured on an H100: PERF.md).
bool fwd_long_keys(int nk, int valid_len) { return std::min(valid_len, nk) > 512; }
bool fwd_wide(int B, int heads, int nq, int nk, int valid_len) {
  return fwd_long_keys(nk, valid_len) && nq > 64 &&
         (long long)ceil_div(nq, 192) * heads * B >= 2ll * sm_count();
}

// The three launches at head dim DH, or at wd.dh where DH is 0 (see the
// header).
template <int DH, int TW = 64>
cudaError_t bwd_launches(const Strided& q, const Strided& k, const Strided& v, const Strided& o,
                         const Strided& d_o, const float* lse, float* delta, float* ws,
                         const Strided& dq, const Strided& dk, const Strided& dv, int B,
                         int heads, int nq, int nk, int valid_len, cudaStream_t st,
                         const Dropout& dr, const Width& wd = Width{}) {
  const int dh = DH ? DH : wd.dh;
  const long long rows = (long long)B * heads * nq;
  const long long tiles = (long long)B * heads * ceil_div(nq, BWD_BQ);  // per chain
  float* sums = ws;
  int* sems = reinterpret_cast<int*>(ws + BWD_CHAINS * tiles * BWD_BQ * dh);
  const long long threads = std::max(rows * (DH ? DH / 8 : 8), BWD_CHAINS * tiles);
  flash_bwd_delta_kernel<DH><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      o, d_o, delta, sems, BWD_CHAINS * tiles, heads, nq, rows, dh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid(ceil_div(nk, BWD_BK), heads, B);
  e = dr.on ? launch_bwd_main<true, DH, TW>(grid, st, q, k, v, d_o, lse, delta, sums, sems, dk,
                                            dv, B, heads, nq, nk, valid_len, dr, wd, dh)
            : launch_bwd_main<false, DH, TW>(grid, st, q, k, v, d_o, lse, delta, sums, sems, dk,
                                             dv, B, heads, nq, nk, valid_len, dr, wd, dh);
  if (e != cudaSuccess) return e;
  const long long chunks = tiles * (BWD_BQ * dh / 4);
  flash_bwd_dq_kernel<DH><<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(
      sums, sems, dq, heads, nq, std::min(valid_len, nq), chunks, dh);
  return cudaGetLastError();
}

}  // namespace

namespace svt {

#ifndef SVT_ATT_WIDTHS

cudaError_t flash_fwd(Strided q, Strided k, Strided v, Strided o, float* lse, int B, int heads,
                      int nq, int nk, int valid_len, int dh, cudaStream_t st, Dropout dr) {
  if (B < 1 || heads < 1 || nq < 1 || nk < 1 || valid_len < 1 || !dim_head_ok(dh))
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return cudaErrorMisalignedAddress;
  if (head_cols(dh) > MAX_TILE_COLS)  // past the widest tile: flash_attention_wide.cu
    return flash_fwd_wide(q, k, v, o, lse, B, heads, nq, nk, valid_len, dh, st, dr);
  if (resident_fwd(nq, nk, dh, dr.on))  // every MS-SiT fold: the sequences packed, one launch
    return launch_fwd_resident(q, k, v, o, lse, B, heads, nq, valid_len, st);
  // dh 64, and dh 32's streamed forward without dropout, here; the other
  // widths (and dh 32 with dropout or few queries) on the kernels built for
  // any dh, flash_attention_widths.cu: the padded heads of dh 25-31 and
  // 57-63 too, laid out in 32 and 64 columns, since the kernels built for 32
  // and 64 take their layout's softmax scale
  const bool few = few_query_fwd(nq, nk, dh, dr.on);
  if (dh != ATT_DH && (dh != 32 || dr.on || few))
    return flash_fwd_widths(q, k, v, o, lse, B, heads, nq, nk, valid_len, dh, st, dr);
  if (few)  // the queries on the short side, one launch
    return launch_few_fwd<false, ATT_DH, ATT_DH>(q, k, v, o, lse, B, heads, nq, nk, valid_len,
                                                 FewQ{}, width_of(dh), st);
  const bool long_keys = fwd_long_keys(nk, valid_len);
  const bool wide = fwd_wide(B, heads, nq, nk, valid_len);
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

bool few_query_bwd(int nq, int nk, int dh, bool dropout) {
  return dim_head_ok(dh) && head_cols(dh) <= MAX_TILE_COLS && !dropout && nq <= FEW_MAX_Q &&
         FEW_MAX_Q < nk;
}

bool few_query_fwd(int nq, int nk, int dh, bool dropout) {
  return dim_head_ok(dh) && head_cols(dh) <= MAX_TILE_COLS && !dropout && nq <= FEW_MAX_Q &&
         FEW_MAX_Q < nk && nk <= FEW_FWD_MAX_KEYS;
}

bool few_query_makes_q(int nq, int nk, int dim, int dh) {
  return few_query_fwd(nq, nk, dh, false) && dh <= ATT_DH && dim % 8 == 0 &&
         dim <= FEW_Q_MAX_DIM;
}

cudaError_t flash_fwd_few_q(const FewQ& fq, Strided k, Strided v, Strided o, float* lse, int B,
                            int heads, int nq, int nk, int valid_len, int dh, cudaStream_t st) {
  if (B < 1 || heads < 1 || nq < 1 || valid_len < 1 || !few_query_makes_q(nq, nk, fq.dim, dh))
    return cudaErrorInvalidValue;
  if (!aligned16(k) || !aligned16(v) || !aligned16(o) ||
      (reinterpret_cast<uintptr_t>(fq.wq) & 15) != 0 ||
      (fq.q_out != nullptr && (reinterpret_cast<uintptr_t>(fq.q_out) & 15) != 0))
    return cudaErrorMisalignedAddress;
  if (dh != ATT_DH)
    return flash_fwd_few_q_widths(fq, k, v, o, lse, B, heads, nq, nk, valid_len, dh, st);
  return launch_few_fwd<true, ATT_DH, ATT_DH>(Strided{}, k, v, o, lse, B, heads, nq, nk,
                                              valid_len, fq, width_of(dh), st);
}

int resident_pack(int n) { return n <= 32 ? 64 / n : 1; }

long long flash_bwd_workspace(int B, int heads, int nq, int nk, int dh) {
  // one launch, no dQ sums (the resident kernel runs without dropout;
  // flash_bwd refuses dropout at the few-query shapes); the wide kernels
  // need none either
  if (resident_bwd(nq, nk, dh, false) || few_query_bwd(nq, nk, dh, false) ||
      head_cols(dh) > MAX_TILE_COLS)
    return 0;
  // the sums (of the head's layout columns) and a turn counter per sum and tile
  return (long long)BWD_CHAINS * B * heads * ceil_div(nq, BWD_BQ) *
         ((long long)BWD_BQ * head_cols(dh) + 1);
}

cudaError_t flash_bwd(Strided q, Strided k, Strided v, Strided o, Strided d_o, const float* lse,
                      float* delta, float* ws, Strided dq, Strided dk, Strided dv, int B,
                      int heads, int nq, int nk, int valid_len, int dh, cudaStream_t st,
                      Dropout dr) {
  if (B < 1 || heads < 1 || nq < 1 || nk < 1 || valid_len < 1 || !dim_head_ok(dh))
    return cudaErrorInvalidValue;
  if (head_cols(dh) > MAX_TILE_COLS) {  // past the widest tile: flash_attention_wide.cu
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) || !aligned16(d_o) ||
        !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
      return cudaErrorMisalignedAddress;
    return flash_bwd_wide(q, k, v, o, d_o, lse, delta, dq, dk, dv, B, heads, nq, nk, valid_len,
                          dh, st, dr);
  }
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
  if (few_query_bwd(nq, nk, dh, false)) {  // one launch, the queries on the short side
    // no entry asks for dropout here (flash_attention_qkv_dropout takes nq ==
    // nk), and the workspace is sized for the few-query kernel: none
    if (dr.on) return cudaErrorInvalidValue;
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) || !aligned16(d_o) ||
        !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
      return cudaErrorMisalignedAddress;
    if (dh == ATT_DH)
      return launch_few<ATT_DH, ATT_DH>(q, k, v, o, d_o, lse, dq, dk, dv, B, heads, nq, nk,
                                        valid_len, Width{}, st);
  } else if (dh == 32 && !dr.on) {  // dh 32 past 320 keys, or nq != nk: the streamed kernels
    return bwd_launches<32>(q, k, v, o, d_o, lse, delta, ws, dq, dk, dv, B, heads, nq, nk,
                            valid_len, st, dr);
  } else if (dh == ATT_DH) {
    return bwd_launches<ATT_DH>(q, k, v, o, d_o, lse, delta, ws, dq, dk, dv, B, heads, nq, nk,
                                valid_len, st, dr);
  }
  // the other widths (and dh 32 with dropout): flash_attention_widths.cu
  return flash_bwd_widths(q, k, v, o, d_o, lse, delta, ws, dq, dk, dv, B, heads, nq, nk,
                          valid_len, dh, st, dr);
}

Dropout make_dropout(unsigned seed, unsigned threshold, float inv_keep, int on) {
  Dropout dr;
  dr.seed = seed;
  dr.threshold = threshold;
  dr.inv_keep = inv_keep;
  dr.on = on;
  return dr;
}

#else  // SVT_ATT_WIDTHS: the kernels built for any dh (flash_attention_widths.cu)

// Tiles of 32, 64 or 128 columns: the smallest that holds the head's
// head_cols(dh) columns.
int tile_width(int dh) { return dh <= 32 ? 32 : dh <= 64 ? 64 : 128; }

cudaError_t flash_fwd_widths(Strided q, Strided k, Strided v, Strided o, float* lse, int B,
                             int heads, int nq, int nk, int valid_len, int dh, cudaStream_t st,
                             Dropout dr) {
  const Width wd = width_of(dh);
  if (few_query_fwd(nq, nk, dh, dr.on))  // the queries on the short side, one launch
    return dh <= 64 ? launch_few_fwd<false, 0, 64>(q, k, v, o, lse, B, heads, nq, nk, valid_len,
                                                   FewQ{}, wd, st)
                    : launch_few_fwd<false, 0, 128>(q, k, v, o, lse, B, heads, nq, nk,
                                                    valid_len, FewQ{}, wd, st);
  const bool long_keys = fwd_long_keys(nk, valid_len);
  const bool wide = fwd_wide(B, heads, nq, nk, valid_len);
  switch (tile_width(dh) * 2 + (dr.on ? 1 : 0)) {
    case 64: return launch_rule<false, 0, 32>(long_keys, wide, st, q, k, v, o, lse, B, heads, nq,
                                              nk, valid_len, dr, wd);
    case 65: return launch_rule<true, 0, 32>(long_keys, wide, st, q, k, v, o, lse, B, heads, nq,
                                             nk, valid_len, dr, wd);
    case 128: return launch_rule<false, 0, 64>(long_keys, wide, st, q, k, v, o, lse, B, heads,
                                               nq, nk, valid_len, dr, wd);
    case 129: return launch_rule<true, 0, 64>(long_keys, wide, st, q, k, v, o, lse, B, heads, nq,
                                              nk, valid_len, dr, wd);
    case 256: return launch_rule<false, 0, 128>(long_keys, wide, st, q, k, v, o, lse, B, heads,
                                                nq, nk, valid_len, dr, wd);
    default: return launch_rule<true, 0, 128>(long_keys, wide, st, q, k, v, o, lse, B, heads, nq,
                                              nk, valid_len, dr, wd);
  }
}

cudaError_t flash_fwd_few_q_widths(const FewQ& fq, Strided k, Strided v, Strided o, float* lse,
                                   int B, int heads, int nq, int nk, int valid_len, int dh,
                                   cudaStream_t st) {
  return launch_few_fwd<true, 0, 64>(Strided{}, k, v, o, lse, B, heads, nq, nk, valid_len, fq,
                                     width_of(dh), st);
}

cudaError_t flash_bwd_widths(Strided q, Strided k, Strided v, Strided o, Strided d_o,
                             const float* lse, float* delta, float* ws, Strided dq, Strided dk,
                             Strided dv, int B, int heads, int nq, int nk, int valid_len, int dh,
                             cudaStream_t st, Dropout dr) {
  const Width wd = width_of(dh);
  if (few_query_bwd(nq, nk, dh, false))  // flash_bwd checked dropout and the operands
    return dh <= 64 ? launch_few<0, 64>(q, k, v, o, d_o, lse, dq, dk, dv, B, heads, nq, nk,
                                        valid_len, wd, st)
                    : launch_few<0, 128>(q, k, v, o, d_o, lse, dq, dk, dv, B, heads, nq, nk,
                                         valid_len, wd, st);
  if (dh <= 64)
    return bwd_launches<0, 64>(q, k, v, o, d_o, lse, delta, ws, dq, dk, dv, B, heads, nq, nk,
                               valid_len, st, dr, wd);
  return bwd_launches<0, 128>(q, k, v, o, d_o, lse, delta, ws, dq, dk, dv, B, heads, nq, nk,
                              valid_len, st, dr, wd);
}

#endif  // SVT_ATT_WIDTHS

}  // namespace svt

#ifndef SVT_ATT_WIDTHS

extern "C" {

// flash_attention forward: q (B, heads, nq, dh), k and v (B, heads, nk,
// dh), o (B, heads, nq, dh), each bf16 at (batch, head, row) strides in
// elements with its last dimension contiguous; lse (B, heads, nq) fp32
// contiguous; any dh >= 1, each head laid out in (dh + 7) / 8 * 8 columns
// (the last dimension of every operand), those past dh zero. Dropout on the
// probabilities when `drop` (seed, threshold on the Philox word, inv_keep =
// 1 / (1 - rate)).
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
// cotangent d_o (as o) -> dq (as q), dk, dv (as k); dh as the forward's;
// delta (B, heads, nq) fp32 scratch; ws
// svt_flash_attention_bwd_workspace(B, heads, nq, nk, dh) floats of scratch
// (the fp32 dQ sums and their turn counters; none for the resident and
// few-query kernels). Dropout as the forward's, which gave o (not at nq <= 8
// < nk).
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
// where the resident kernel runs: dh 32, nq == nk <= 320; and the few-query
// kernel: nq <= 8 < nk).
long long svt_flash_attention_bwd_workspace(int B, int heads, int nq, int nk, int dh) {
  return flash_bwd_workspace(B, heads, nq, nk, dh);
}

}  // extern "C"

#endif  // SVT_ATT_WIDTHS
