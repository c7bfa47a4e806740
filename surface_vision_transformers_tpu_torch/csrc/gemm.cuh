// The block GEMM engine (Hopper, sm_90a): one warp-specialised, persistent
// wgmma + TMA kernel behind every GEMM of the block chains -- the forward's
// four products (fused_block.cu: qkv, out-projection, fc1, fc2, and the CLS
// block's K/V and Q), the backward's dX products and its split-K weight
// gradients (fused_block_bwd.cu), and the W8A8 block's four int8 products
// (fused_block_int8.cu: qkv, out-projection, fc1 in two passes, fc2).
//
// One kernel, templated on the operands' element type: bf16 (m64n192k16
// wgmma, fp32 accumulators) or int8 (m64n192k32 s8 wgmma, int32
// accumulators). A stage is 128 bytes deep per row either way (BK = 64 bf16
// or 128 int8), so the tiles, the swizzle, the descriptors, the ring and
// the walk are the same bytes; an int8 stage runs four k32 products where
// a bf16 one runs four k16.
//
// A CTA is three warpgroups on one SM (one CTA per SM, a persistent grid of
// min(tiles, SMs) CTAs walking the output tiles in order, N-tiles fastest,
// so the CTAs working at once share their A rows in L2; F_LNA walks whole
// M-tiles, walk_tile):
//   producer   one thread starts every load by TMA: the A and B tiles of
//              each 128-byte-deep k-step into a ring of STAGES stages with full
//              and empty mbarriers, running ahead across tile boundaries, so
//              the next tile's operands land while the consumers finish the
//              last one's epilogue; it gives its registers to the consumers
//              (setmaxnreg).
//   consumers  two warpgroups of 64 output rows each: per k-step four
//              m64n192k16 wgmma (bf16 in, fp32 accumulators in registers;
//              int8: m64n192k32, int32 accumulators; one group kept in
//              flight), then the epilogue. A bf16 output
//              goes through shared memory (sm.c) and out by TMA, so the
//              warpgroup starts its next tile while the copy engine writes
//              this one; a residual, or df1's fp32 pre-activation (in
//              32-column chunks through the ring's last stage, which its
//              epilogue takes over), comes in by TMA from the tile's start,
//              under its products. Stores and loads made by the threads
//              themselves (4- or 8-byte pieces of 8 rows a warp) ran the
//              epilogue at a fraction of HBM's rate: the SM's outstanding
//              requests, not the bytes, set their pace.
// Tiles: BM = 128 rows (two warpgroups) x BN = 192 columns x 128 bytes
// deep per stage; 40 KB a stage, four stages (three where an fp32 tile is
// read in chunks: df1, the int8 fc2) beside the 48 KB through which an
// output leaves (sm.c). The rule is fixed, not searched: N = 192 covers a
// whole dim-192 output in one wgmma (n <= 256, a multiple of 8), and every
// SiT width is a multiple of 192 (dim 192, 384, 768; qkv 576 .. 2304; mlp
// 768 .. 3072), so no SiT N-tile is ragged. MS-SiT's first stage is: at dim
// 96 the qkv output is 288 columns (one and a half tiles), out-projection
// and fc2 96 (half a tile), and qkv and fc1 read K = 96 (one and a half
// k-steps); chip_smoke.py phase 26 holds these four against their plain
// products. At SiT-tiny K is
// 192 (three k-steps; int8: one and a half, the rest zero-filled by TMA):
// a tile's products are short beside its epilogue, and
// the persistent walk with the ring running ahead is what keeps the loads
// of the next tile going under it. A warpgroup whose 64 rows lie wholly
// past M skips its epilogue (not its products: a branch around wgmma that
// the compiler cannot prove uniform serialises them, ptxas C7518).
//
// Operands stay in their global layout; nothing is transposed in device
// memory. Each sits in shared memory as 128-byte-swizzled [rows][64] bf16
// (or [rows][128] int8) tiles written by TMA (common.cuh); int8 operands
// are K-major only, the one layout s8 wgmma takes:
//   K-major (TA / TB = 0): rows = M or N, 64 columns of K; the forward's A
//              (activations) and W (torch Linear layout), the dX products' A.
//   MN-major (TA / TB = 1): rows = 64 of K, columns 64 of M or N; the dX
//              products' W read as (K = out, N = in), and both operands of
//              the weight gradients, read along the token rows. An MN-major
//              B spans three such tiles, 8 KB apart (the descriptor's LBO).
// Each operand's rows can go through a row map (logical row r at physical
// row (r / rpg) * gstride + r % rpg, gemm::Operand): the
// CLS block's Q GEMM reads the first `rows` rows of each N-row sample, its
// out-projection that many rows of x as the residual, and its dW_q the same
// rows of h1. The tensor map is then 3-D (64 columns, rows of a group,
// groups), which needs `rows` to divide the box (the host checks; the CLS
// block's 8 rows do). The ragged edges of M, N and K are zero-filled by TMA
// and skipped by the epilogue and the TMA stores.
//
// Epilogues (fp32 math on the accumulators, then one rounding; the rounding
// points of the chains they serve):
//   F_NONE       bf16 C                          (qkv, K/V, Q)
//   F_GELU       bf16 gelu(C + bias); with `pre`, the fp32 C + bias kept
//                for the backward                (fc1)
//   F_RES        bf16 C + bias + R, R through its row map (out-proj, fc2)
//   B_PART       fp32 partial of split s at part[s][M][N] (dW, split-K)
//   B_F32        fp32 C                          (dh; with `top`, the CLS
//                block's dkv W_kv plus the top rows' dq W_q share, as
//                B_LN1_TOP adds it)
//   B_BF16       bf16 C                          (da)
//   B_GELU_GRAD  bf16 C * gelu'(pre), and the fp32 column sums of each
//                128-row tile at colpart[tile][N] (df1 and d_bfc1)
//   B_LN2        C is dh (N = dim <= BN: a tile holds whole rows); the
//                LayerNorm backward of x's rows plus the bf16 residual g:
//                dx1 fp32 into Cf and bf16 by TMA, and the column sums of
//                dh n, dh, g and dx1 per CTA into colpart (ln_epilogue)
//   B_LN1        the same with the fp32 residual dx1: bf16 dx, and the
//                sums of dh n and dh
//   B_LN1_TOP    B_LN1 for the CLS block, whose dh is dkv W_kv over every
//                row plus the top rows' dq W_q: on row r of an N-row sample
//                with r % N < rows, the fp32 share `top` and the residual
//                dx1 (each (B * rows, N)), read by the threads from their
//                rows, join dh and dx; other rows have neither. Of a
//                thread's two rows, 8 apart, at most one may be a top row:
//                rows <= 8 and N >= rows + 8 (run() refuses other shapes)
//   F_LNA        bf16 C, A's rows first normalised in place in the ring by
//                the LayerNorm (K = dim 96 or 192: the tile's K-steps hold
//                whole rows); the training form keeps them and their
//                statistics (qkv with LN1 in its prologue, fused_block.cu)
// and on int8 operands, each dequantized as (float(acc) * sa[row]) *
// sw[col], then + bias, then the residual, every rounding written out
// (__fmul_rn, __fadd_rn) so that no contraction moves a value from the
// plain version's (ops/quant.py::int8_mm_reference):
//   Q_S32        the int32 accumulators            (svt_int8_gemm_s32)
//   Q_BF16       bf16 dequantized                  (qkv)
//   Q_RES_F32    fp32 R + (dequantized + bias), R bf16 (x1)
//   Q_GELU_MAX   f = erf-GELU(dequantized + bias); writes only each row's
//                max |f| over the tile's columns, part[N-tile][M] (fc1,
//                pass 1; GELU once per thread and row where GELU_NEG_MAX
//                allows, common.cuh)
//   Q_GELU_Q8    the same f, quantized by the row scale max(part) / 127
//                (quant_code_r: no division per value): int8 codes and
//                the row scales (fc1, pass 2: the codes of quant_rows(f),
//                with no fp32 f in device memory)
//   Q_RES_BF16   bf16 R + (dequantized + bias), R fp32 (fc2)
// fp32 and int32 outputs leave through sm.c by TMA as bf16 ones do, in two
// halves of 96 columns (sm.c holds half a tile of 4-byte values), int8
// codes in [64][64] boxes in the 64-byte swizzle.
// No atomics anywhere: the split-K partials and the column sums are summed
// in a fixed order (fused_block_bwd.cu's reduce), so every result repeats
// bit for bit from run to run.
//
// Split-K (weight gradients only): a dW is at most 3072 x 768, reduced over
// the B * N token rows, so the K range splits into chunks (multiples of
// 64) until the tiles fill whole waves of 132 SMs (split_k). The rule
// depends on the shape alone, so the sums' order, and the results, are the
// same on any card.
//
// What bounds it: at SiT-tiny widths (K or N = 192) a product does 60-150
// operations per byte of its own input and output, below the card's 295, so
// HBM bounds it; at SiT-base widths (K = 768, 3072) the operations bound
// qkv and fc2 (in int8 too: 1,979 TOP/s, 590 operations a byte of HBM).
// scripts/block_gemm_breakdown.py (built with -DSVT_GEMM_PROFILE) reads the
// cycles of each part of the walk.
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace svt {
namespace gemm {
namespace {  // each including source gets its own copy: no symbol of the engine is shared

constexpr int BM = 128, BN = 192;
constexpr int ROW_BYTES = 128;        // a stage's depth: BK<bf16> = 64, BK<int8_t> = 128
template <typename T>
constexpr int BK = ROW_BYTES / (int)sizeof(T);
constexpr int NWG = BM / 64;          // consumer warpgroups
constexpr int STAGES = 4;
constexpr int THREADS = (NWG + 1) * 128;
constexpr int PRODUCER_REGS = 40;
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;  // one CTA per SM
constexpr int CONSUMER_REGS = (LAUNCH_REGS * THREADS - PRODUCER_REGS * 128) / (NWG * 128) / 8 * 8;
static_assert(CONSUMER_REGS <= 256, "setmaxnreg takes at most 256");
constexpr int TARGET_TILES = 132;     // split-K aims at one wave of an H100's SMs
constexpr int COL_BAR = 1;            // named barrier of the consumer warpgroups
constexpr int WG_BAR = 2;             // named barriers 2, 3: one consumer warpgroup's own
constexpr int IDENTITY = 1 << 30;     // a row map's group size when there is none
constexpr int STAGE_BYTES = (BM + BN) * ROW_BYTES;

enum Epi { F_NONE, F_GELU, F_RES, B_PART, B_F32, B_BF16, B_GELU_GRAD, B_LN2, B_LN1, B_LN1_TOP,
           F_LNA, Q_S32, Q_BF16, Q_RES_F32, Q_GELU_MAX, Q_GELU_Q8, Q_RES_BF16 };

// An operand in device memory (bf16 or int8, the engine's element type):
// `rows` rows of `cols` contiguous values, `ld` values apart; logical row r
// lives at physical row (r / rpg) * gstride + r % rpg (rpg 0: r itself).
struct Operand {
  const void* p;
  int rows, cols, ld;
  int rpg = 0, gstride = 0;
};

// What the epilogue reads and writes (unused fields stay null / 0).
struct Epilogue {
  const float* bias = nullptr;
  const bf16* res = nullptr;  // F_RES, Q_RES_F32: residual (ldr), through (r_rpg, r_gstride)
  int ldr = 0, r_rpg = 1, r_gstride = 1;
  bf16* cb = nullptr;         // bf16 C (ldc)
  float* cf = nullptr;        // fp32 C (ldc; B_PART: the partials; Q_S32: the int32 C)
  int ldc = 0;
  float* pre = nullptr;       // F_GELU: fp32 C + bias out; B_GELU_GRAD: the forward's, in
  float* colpart = nullptr;   // B_GELU_GRAD: column sums per 128-row tile
  const float* resf = nullptr;  // Q_RES_BF16: the fp32 residual (ldr)
  const float* sa = nullptr;  // Q_*: A's row scales (M,)
  const float* sw = nullptr;  // Q_*: W's column scales (N,)
  float* part = nullptr;      // Q_GELU_MAX out, Q_GELU_Q8 in: max |f| per row and N-tile
  int8_t* cq = nullptr;       // Q_GELU_Q8: the int8 codes (ldc)
  float* sq = nullptr;        // Q_GELU_Q8: their row scales (M,)
  // B_LN2 / B_LN1: the LayerNorm's input rows x (bf16, ldx), its (mean,
  // rstd) per row, gamma in `bias`, the residual cotangent (ldr: bf16 for
  // B_LN2, fp32 for B_LN1); column sums per CTA into colpart
  const bf16* x = nullptr;
  int ldx = 0;
  const float* stats = nullptr;
  const void* lres = nullptr;
  int ln_n = 0;  // the columns the LayerNorm counts (0: all N); out is 0 past them
  // B_LN1_TOP, B_F32: the top rows' fp32 dh share (B_LN1_TOP: and lres
  // their dx1), (B * top_rows, N): output row r with r % top_seg < top_rows
  // takes row (r / top_seg) * top_rows + r % top_seg of it
  const float* top = nullptr;
  int top_rows = 0, top_seg = 1;
  // F_LNA: the LayerNorm of A's rows (gamma, beta fp32, eps) applied in the
  // prologue; the training form keeps the normalised rows (ln_out, bf16 (M,
  // K)) and each row's (mean, rstd) (ln_stats)
  const float* ln_gamma = nullptr;
  const float* ln_beta = nullptr;
  float ln_eps = 0.f;
  float* ln_stats = nullptr;
  bf16* ln_out = nullptr;
};

// The tile walk, as the device sees it.
struct Walk {
  int M, N, K, k_chunk, splits;
  int a_rpg, b_rpg, r_rpg;  // the tensor maps' rows per group (IDENTITY: none)
};

struct Smem {
  unsigned char a[STAGES][BM * ROW_BYTES];  // [128][64] bf16 or [128][128] int8
  unsigned char b[STAGES][BN * ROW_BYTES];
  bf16 c[BN / 64][BM * 64];  // a tile's output on its way out, [128][64] bf16 blocks
  float col[NWG * 4][BN];    // B_GELU_GRAD: each warp's column sums
  float bias[NWG][BN];       // F_GELU, F_RES, Q_*: each warpgroup's copy of the tile's bias
  float cs[NWG][BN];         // Q_*: the same of the column scales
  float rs[NWG][4][64];      // Q_*: A's row scales; Q_GELU_Q8: the codes' QuantRecip
  uint64_t full[STAGES], empty[STAGES];
  uint64_t res_full[NWG];    // res_tile(): a warpgroup's residual block has landed in sm.c
  uint64_t pre_full[NWG][2];  // chunked(): an fp32 chunk has landed
};

// The LayerNorm backwards folded into the product that makes dh.
__host__ __device__ constexpr bool ln_epi(int epi) {
  return epi == B_LN2 || epi == B_LN1 || epi == B_LN1_TOP;
}
// Whether an epilogue writes a bf16 C (through shared memory and TMA).
__host__ __device__ constexpr bool bf16_out(int epi) {
  return epi == F_NONE || epi == F_GELU || epi == F_RES || epi == B_BF16 ||
         epi == B_GELU_GRAD || epi == Q_BF16 || epi == Q_RES_BF16 || ln_epi(epi) ||
         epi == F_LNA;
}
// ... a 4-byte C (fp32 or int32), in two halves of the tile.
__host__ __device__ constexpr bool w32_out(int epi) { return epi == Q_S32 || epi == Q_RES_F32; }
// ... any C through shared memory and TMA.
__host__ __device__ constexpr bool smem_out(int epi) {
  return bf16_out(epi) || w32_out(epi) || epi == Q_GELU_Q8;
}
// The int8 epilogues, and those of them that dequantize (all but Q_S32).
__host__ __device__ constexpr bool int8_epi(int epi) { return epi >= Q_S32; }
__host__ __device__ constexpr bool dequant(int epi) { return epi > Q_S32; }
// A bf16 residual block (the LayerNorm epilogues: x) comes by TMA into sm.c
// at the tile's start.
__host__ __device__ constexpr bool res_tile(int epi) {
  return epi == F_RES || epi == Q_RES_F32 || ln_epi(epi);
}

// B_GELU_GRAD reads an fp32 pre-activation as large as its output twice
// over, Q_RES_BF16 an fp32 residual: it comes by TMA in 32-column chunks,
// two in flight a warpgroup, in the ring's last stage (a[3] for warpgroup
// 0, b[3] for warpgroup 1), so that epilogue's ring has one stage fewer.
// The LayerNorm epilogues read their residual cotangent the same way, in
// chunks of 128-byte rows: 32 fp32 columns (B_LN1) or 64 bf16 (B_LN2);
// B_LN1_TOP's few residual rows come from the threads' own loads.
__host__ __device__ constexpr bool chunked(int epi) {
  return epi == B_GELU_GRAD || epi == Q_RES_BF16 || epi == B_LN2 || epi == B_LN1;
}
__host__ __device__ constexpr int stages(int epi) { return chunked(epi) ? STAGES - 1 : STAGES; }
constexpr int PRE_COLS = 32, PRE_CHUNK = 64 * PRE_COLS;  // a chunk: 64 rows x 32 fp32
__host__ __device__ constexpr int chunk_cols(int epi) { return epi == B_LN2 ? 64 : PRE_COLS; }
__device__ __forceinline__ float* pre_buf(Smem& sm, int wg, int b) {
  return reinterpret_cast<float*>(wg == 0 ? sm.a[STAGES - 1] : sm.b[STAGES - 1]) + b * PRE_CHUNK;
}

__host__ __device__ __forceinline__ int cdiv(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

struct Tile {
  int m0, n0, split, mt, k0, ksteps;
};

// Built with -DSVT_GEMM_PROFILE (scripts/block_gemm_breakdown.py), the
// consumer warpgroups add the cycles of each part of their walk to
// gemm_profile: waiting for a stage to land, starting a k-step's wgmma,
// waiting for the k-step before it (and releasing its stage), waiting for a
// tile's last k-step, the epilogue, and the whole walk; the producer adds
// its waits for a free stage and its whole walk. Otherwise the marks
// compile to nothing.
#ifdef SVT_GEMM_PROFILE
__device__ unsigned long long gemm_profile[8];
#define SVT_GEMM_MARK(i)            \
  do {                              \
    const long long c_ = clock64(); \
    prof[i] += c_ - prof_t;         \
    prof_t = c_;                    \
  } while (0)
#else
#define SVT_GEMM_MARK(i) \
  do {                   \
  } while (0)
#endif

// The j-th tile a CTA walks, or -1 past its last: tiles blockIdx.x +
// j gridDim.x (N-tiles fastest, so the CTAs at work at once share A rows in
// L2); for F_LNA an M-tile's N-tiles one after the other on one CTA, M-tiles
// blockIdx.x + k gridDim.x (the LayerNorm's statistics are found once an
// M-tile).
template <int EPI>
__device__ __forceinline__ int walk_tile(int j, int nt_n, int mt_n, int tiles) {
  if constexpr (EPI == F_LNA) {
    const int m = blockIdx.x + (j / nt_n) * gridDim.x;
    return m < mt_n ? m * nt_n + j % nt_n : -1;
  }
  const int t = blockIdx.x + j * gridDim.x;
  return t < tiles ? t : -1;
}

template <typename T>
__device__ __forceinline__ Tile tile_at(int tile, const Walk& w) {
  const int nt_n = cdiv(w.N, BN), mt_n = cdiv(w.M, BM);
  Tile t;
  const int nt = tile % nt_n, rest = tile / nt_n;
  t.mt = rest % mt_n;
  t.split = rest / mt_n;
  t.m0 = t.mt * BM;
  t.n0 = nt * BN;
  t.k0 = t.split * w.k_chunk;
  t.ksteps = cdiv(min(w.K, t.k0 + w.k_chunk) - t.k0, BK<T>);
  return t;
}

// The producer's loads of one k-step: A then B, by row coordinate through
// the maps' groups (k0 in elements).
template <int TA, int TB>
__device__ __forceinline__ void load_stage(Smem& sm, int st, const CUtensorMap& tm_a,
                                           const CUtensorMap& tm_b, const Walk& w, int m0,
                                           int n0, int k0) {
  uint64_t* bar = &sm.full[st];
  if (TA == 0) {
    tma_load_3d(sm.a[st], tm_a, bar, k0, m0 % w.a_rpg, m0 / w.a_rpg);
  } else {
#pragma unroll
    for (int i = 0; i < NWG; ++i)
      tma_load_3d(sm.a[st] + i * 64 * ROW_BYTES, tm_a, bar, m0 + 64 * i, k0 % w.a_rpg,
                  k0 / w.a_rpg);
  }
  if (TB == 0) {
    tma_load_3d(sm.b[st], tm_b, bar, k0, n0 % w.b_rpg, n0 / w.b_rpg);
  } else {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_load_3d(sm.b[st] + j * 64 * ROW_BYTES, tm_b, bar, n0 + 64 * j, k0 % w.b_rpg,
                  k0 / w.b_rpg);
  }
}

// One pre-activation chunk (64 rows from row0, 32 fp32 columns from col0)
// into warpgroup wg's buffer b.
__device__ __forceinline__ void load_pre(Smem& sm, const CUtensorMap& tm, int wg, int b, int col0,
                                         int row0) {
  mbar_expect(&sm.pre_full[wg][b], PRE_CHUNK * 4);
  tma_load_3d(pre_buf(sm, wg, b), tm, &sm.pre_full[wg][b], col0, row0, 0);
}

__device__ __forceinline__ float4 load4(const float* p, int c, int n) {
  return c < n ? *reinterpret_cast<const float4*>(p + c) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Before a tile's last products are awaited: sm.c is made free (the last
// tile's copy out has read it), and F_GELU, F_RES and the dequantizing
// epilogues stage the tile's 192 bias values into sm.bias[wg] (thread i <
// 48: values 4 i .. 4 i + 3), so that no load waits in the epilogue behind
// a store the compiler cannot prove apart. (F_RES's and Q_RES_F32's
// residual block comes by TMA into sm.c at the tile's start, where the
// output then replaces it.) The dequantizing epilogues also stage the
// column scales (threads 64-111) and the row scales of A (threads < 64);
// Q_GELU_Q8 reduces each row's partial maxima to its scale, kept as
// quant_recip's (threads 64-127, one row each), and writes the scales from
// the tile at column 0.
template <int EPI>
__device__ __forceinline__ void stage(const Epilogue& ep, const Walk& w, const Tile& tl, int wg,
                                      int tid, Smem& sm) {
  if (smem_out(EPI)) {
    if (tid == 0) bulk_wait_read<0>();
    bar_sync(WG_BAR + wg, 128);
  }
  if ((EPI == F_GELU || EPI == F_RES || ln_epi(EPI) || (dequant(EPI) && EPI != Q_BF16)) &&
      tid < BN / 4)
    *reinterpret_cast<float4*>(&sm.bias[wg][4 * tid]) = load4(ep.bias, tl.n0 + 4 * tid, w.N);
  if (ln_epi(EPI) && tid >= 64) {  // each row's (mean, rstd); rows past M: 0
    const int i = tid - 64, r = tl.m0 + 64 * wg + i;
    const float2 st = r < w.M ? *reinterpret_cast<const float2*>(ep.stats + 2LL * r)
                              : make_float2(0.f, 0.f);
    sm.rs[wg][0][i] = st.x;
    sm.rs[wg][1][i] = st.y;
  }
  if (dequant(EPI)) {
    const int i = tid & 63, r = tl.m0 + 64 * wg + i;
    if (tid < 64) {
      sm.rs[wg][0][i] = r < w.M ? ep.sa[r] : 0.f;
    } else {
      if (i < BN / 4)
        *reinterpret_cast<float4*>(&sm.cs[wg][4 * i]) = load4(ep.sw, tl.n0 + 4 * i, w.N);
      if (EPI == Q_GELU_Q8 && r < w.M) {
        float a = 0.f;
        for (int p = 0; p < cdiv(w.N, BN); ++p) a = fmaxf(a, ep.part[(long long)p * w.M + r]);
        const float sc = quant_scale(a);
        const QuantRecip qr = quant_recip(sc);
        sm.rs[wg][1][i] = qr.k;
        sm.rs[wg][2][i] = qr.s;
        sm.rs[wg][3][i] = qr.r;
        if (tl.n0 == 0) ep.sq[r] = sc;
      }
    }
  }
}

// The column sums over a warp's 16 rows of 48 values a thread (val(k): the
// thread's two rows at column 8 (k >> 1) + 2 t + (k & 1)), reduce-scattered
// over the eight lanes that hold a column: lane g keeps k = 6 g .. 6 g + 5,
// each the sum over its 16 rows. 42 shuffles where a full reduction of each
// value takes 144; the roles of the lanes fix the order of every addition.
template <typename F>
__device__ __forceinline__ void col_reduce(F val, int g, float (&out)[6]) {
  const bool b2 = g & 4, b1 = g & 2, b0 = g & 1;
  float w1[24], w2[12];
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    const float a = val(i), b = val(24 + i);
    w1[i] = (b2 ? b : a) + __shfl_xor_sync(0xffffffffu, b2 ? a : b, 16);
  }
#pragma unroll
  for (int i = 0; i < 12; ++i)
    w2[i] = (b1 ? w1[12 + i] : w1[i]) + __shfl_xor_sync(0xffffffffu, b1 ? w1[i] : w1[12 + i], 8);
#pragma unroll
  for (int i = 0; i < 6; ++i)
    out[i] = (b0 ? w2[6 + i] : w2[i]) + __shfl_xor_sync(0xffffffffu, b0 ? w2[i] : w2[6 + i], 4);
}
// The column of the i-th value col_reduce leaves lane (g, t).
__device__ __forceinline__ int col_of(int g, int t, int i) {
  return 8 * (3 * g + (i >> 1)) + 2 * t + (i & 1);
}

// The LayerNorm backward in the epilogue of the product that makes dh (dim
// = N <= BN, so a tile holds whole rows): acc is dh. With n = (x - mean)
// rstd and d = dh gamma,
//   out = (d - mean(d) - n mean(d n)) rstd + res
// (B_LN2: res = g bf16, out fp32 into cf and bf16; B_LN1: res = dx1 fp32,
// out bf16), as fused_block_bwd.cu's ln_bwd_kernel: the means over a row's
// first ep.ln_n columns, out 0 past them (a padded layout, fused_block.cu;
// gamma and dh are 0 there). x came into sm.c at the
// tile's start, res comes in chunks through the ring's last stage; the row
// sums are quad shuffles over the accumulator fragment. The column sums
// (sum dh n, sum dh; B_LN2 also sum res, sum out) add into colacc across
// the CTA's tiles (col_reduce), written once at the end of its walk. bf16
// out replaces x in sm.c and leaves by TMA.
template <int EPI>
__device__ __forceinline__ void ln_epilogue(float (&acc)[96], const Epilogue& ep,
                                            const CUtensorMap& tm_f, const Walk& w,
                                            const Tile& tl, int n, int wg, int warp, int g,
                                            int t, int tid, Smem& sm, float (&colacc)[4][6]) {
  bar_sync(WG_BAR + wg, 128);  // what stage() wrote
  const int rl[2] = {16 * warp + g, 16 * warp + g + 8};  // rows in the warpgroup's 64
  const float mu[2] = {sm.rs[wg][0][rl[0]], sm.rs[wg][0][rl[1]]};
  const float rs[2] = {sm.rs[wg][1][rl[0]], sm.rs[wg][1][rl[1]]};
  // B_LN1_TOP: a top row's dh share joins acc before any sum, and its dx1
  // row is the residual below. Of a thread's two rows (8 apart) at most one
  // is a top row (htop; -1: none): top_rows <= 8 and top_seg >= top_rows +
  // 8, which run() checks. Each row's 24 pairs are loaded together,
  // predicated: one by one behind a branch, they took a memory latency each.
  int htop = -1;
  long long toff = 0;
  float2 rtop[24];
  if constexpr (EPI == B_LN1_TOP) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tl.m0 + 64 * wg + rl[h], i = r % ep.top_seg;
      if (r < w.M && i < ep.top_rows) {
        htop = h;
        toff = ((long long)(r / ep.top_seg) * ep.top_rows + i) * w.N + 2 * t;
      }
    }
    if (htop >= 0) {
      const float* res = static_cast<const float*>(ep.lres) + toff;
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        const bool in = 8 * j < w.N;
        rtop[j] = in ? *reinterpret_cast<const float2*>(ep.top + toff + 8 * j)
                     : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        if (htop == 0) {
          acc[4 * j] += rtop[j].x;
          acc[4 * j + 1] += rtop[j].y;
        } else {
          acc[4 * j + 2] += rtop[j].x;
          acc[4 * j + 3] += rtop[j].y;
        }
      }
#pragma unroll
      for (int j = 0; j < 24; ++j)  // then the residual, into the same registers
        rtop[j] = 8 * j < w.N ? *reinterpret_cast<const float2*>(res + 8 * j)
                              : make_float2(0.f, 0.f);
    }
  }
  auto x_at = [&](int h, int j) {  // x of row rl[h], columns 8 j + 2 t, + 1
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        sm.c[j >> 3] + sw128(64 * wg + rl[h], 8 * (j & 7) + 2 * t)));
  };
  auto gam = [&](int j) { return *reinterpret_cast<const float2*>(&sm.bias[wg][8 * j + 2 * t]); };
  // row sums of d and d n; column groups wholly past N (half the tile at
  // dim 96) are skipped here and below
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    if (8 * j >= w.N) break;
    const float2 gm = gam(j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 xv = x_at(h, j);
      const float d0 = acc[4 * j + 2 * h] * gm.x, d1 = acc[4 * j + 2 * h + 1] * gm.y;
      s1[h] += d0 + d1;
      s2[h] += d0 * ((xv.x - mu[h]) * rs[h]) + d1 * ((xv.y - mu[h]) * rs[h]);
    }
  }
  const int ln_n = ep.ln_n ? ep.ln_n : w.N;  // a padded layout's true width
  const float inv_dim = 1.f / (float)ln_n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s1[h] = (s1[h] + __shfl_xor_sync(0xffffffffu, s1[h], 1));
    s1[h] = (s1[h] + __shfl_xor_sync(0xffffffffu, s1[h], 2)) * inv_dim;
    s2[h] = (s2[h] + __shfl_xor_sync(0xffffffffu, s2[h], 1));
    s2[h] = (s2[h] + __shfl_xor_sync(0xffffffffu, s2[h], 2)) * inv_dim;
  }
  // column sums of dh n and dh, before out replaces x
  float part[6];
  col_reduce([&](int k) {
    const int j = k >> 1, e = k & 1;
    float v = 0.f;
    if (8 * j >= w.N) return v;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 xv = x_at(h, j);
      v += acc[4 * j + 2 * h + e] * (((e ? xv.y : xv.x) - mu[h]) * rs[h]);
    }
    return v;
  }, g, part);
#pragma unroll
  for (int i = 0; i < 6; ++i) colacc[0][i] += part[i];
  col_reduce([&](int k) {
    const int j = k >> 1, e = k & 1;
    return 8 * j >= w.N ? 0.f : acc[4 * j + e] + acc[4 * j + 2 + e];
  }, g, part);
#pragma unroll
  for (int i = 0; i < 6; ++i) colacc[1][i] += part[i];

  // out, by residual chunk: CC columns, both row halves
  constexpr int CC = chunk_cols(EPI), NCH = BN / CC;
  const int nch = cdiv(w.N, CC);            // chunks holding columns < N
#pragma unroll
  for (int q = 0; q < NCH; ++q) {
    if (q >= nch) break;
    const int b = q & 1, uses = (nch + 1 - b) >> 1;  // uses of buffer b a tile
    if constexpr (chunked(EPI)) mbar_wait(&sm.pre_full[wg][b], (n * uses + (q >> 1)) & 1);
    const float* pb = pre_buf(sm, wg, b);
#pragma unroll
    for (int jj = 0; jj < CC / 8; ++jj) {
      const int j = (CC / 8) * q + jj, cl = 8 * jj + 2 * t, c = tl.n0 + 8 * j + 2 * t;
      if (8 * j >= w.N) break;
      const float2 gm = gam(j);
      float2 rv[2], o[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (EPI == B_LN2)  // bf16 [64][64] in the 128-byte swizzle
          rv[h] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              reinterpret_cast<const bf16*>(pb) + sw128(rl[h], cl)));
        else if (EPI == B_LN1_TOP)  // the top row's dx1, else none
          rv[h] = htop == h ? rtop[j] : make_float2(0.f, 0.f);
        else  // fp32 [64][32] in the 128-byte swizzle
          rv[h] = *reinterpret_cast<const float2*>(
              pb + rl[h] * PRE_COLS + ((((cl >> 2) ^ (rl[h] & 7)) << 2) | (cl & 3)));
        const float2 xv = x_at(h, j);
        const float n0 = (xv.x - mu[h]) * rs[h], n1 = (xv.y - mu[h]) * rs[h];
        o[h].x = (acc[4 * j + 2 * h] * gm.x - s1[h] - n0 * s2[h]) * rs[h] + rv[h].x;
        o[h].y = (acc[4 * j + 2 * h + 1] * gm.y - s1[h] - n1 * s2[h]) * rs[h] + rv[h].y;
        if (c >= ln_n) o[h].x = 0.f;  // padded columns: 0, as ln_bwd_kernel writes
        if (c + 1 >= ln_n) o[h].y = 0.f;
        const int r = tl.m0 + 64 * wg + rl[h];
        if (EPI == B_LN2 && r < w.M && c < w.N)
          *reinterpret_cast<float2*>(ep.cf + (long long)r * ep.ldc + c) = o[h];
        *reinterpret_cast<uint32_t*>(sm.c[j >> 3] + sw128(64 * wg + rl[h], 8 * (j & 7) + 2 * t)) =
            pack_bf16(o[h].x, o[h].y);
      }
      if (EPI == B_LN2) {  // acc, spent, takes the two rows' sums of res and of out
        acc[4 * j] = rv[0].x + rv[1].x;
        acc[4 * j + 1] = rv[0].y + rv[1].y;
        acc[4 * j + 2] = o[0].x + o[1].x;
        acc[4 * j + 3] = o[0].y + o[1].y;
      }
    }
    if constexpr (chunked(EPI)) {
      bar_sync(WG_BAR + wg, 128);  // buffer b read: the chunk two on may land in it
      if (tid == 0 && q + 2 < nch)
        load_pre(sm, tm_f, wg, b, tl.n0 + CC * (q + 2), tl.m0 + 64 * wg);
    }
  }
  if (EPI == B_LN2) {  // column sums of res (d_bfc2) and out (d_bout)
#pragma unroll
    for (int s_ = 0; s_ < 2; ++s_) {
      col_reduce([&](int k) {
        return 8 * (k >> 1) >= w.N ? 0.f : acc[4 * (k >> 1) + 2 * s_ + (k & 1)];
      }, g, part);
#pragma unroll
      for (int i = 0; i < 6; ++i) colacc[2 + s_][i] += part[i];
    }
  }
}

// F_LNA's prologue: the LayerNorm of the warpgroup's 64 rows of A (K = dim
// 96 or 192, so the tile's K-steps, all landed, hold whole rows) in place in
// the ring's stages, before any product reads them: two threads a row,
// layer_norm_kernel's sums in their order (common.cuh ln_row_pair), gamma
// and beta from the warpgroup's copies in sm.bias and sm.cs (by column
// parity: the even columns' first). A CTA walks an M-tile's N-tiles one
// after the other (f_lna_tile), so the first finds each row's (mean, rstd)
// and keeps them in sm.rs; the others only normalise. The training form
// keeps the statistics and the normalised rows (by TMA from the stages,
// tm_h) from the first N-tile.
template <int NCH>
__device__ __forceinline__ void ln_prologue(Smem& sm, int it, int nst, const Epilogue& ep,
                                            const CUtensorMap& tm_h, const Walk& w,
                                            const Tile& tl, int c, int tid) {
  const int rr = tid >> 1, r = 64 * c + rr, p = tid & 1, row = tl.m0 + r;
  auto chunk = [&](int j) {
    return reinterpret_cast<bf16*>(sm.a[(it + (j >> 3)) % nst]) + sw128(r, 8 * (j & 7));
  };
  float2 st;
  if (tl.n0 == 0) {
    st = ln_stats_pair<NCH>(chunk, p, ep.ln_eps);
    if (p == 0) {
      sm.rs[c][0][rr] = st.x;
      sm.rs[c][1][rr] = st.y;
    }
  } else {  // sm.rs holds them since the M-tile's first N-tile (a barrier ago)
    st = make_float2(sm.rs[c][0][rr], sm.rs[c][1][rr]);
  }
  ln_apply_pair<NCH>(chunk, p, sm.bias[c] + p * (4 * NCH), sm.cs[c] + p * (4 * NCH), st.x,
                     st.y);
  const bool keep = ep.ln_out != nullptr && tl.n0 == 0;
  if (keep && p == 0 && row < w.M) *reinterpret_cast<float2*>(ep.ln_stats + 2LL * row) = st;
  fence_async_smem();
  bar_sync(WG_BAR + c, 128);
  if (keep && tid == 0) {  // the rows out, then the stages may be released
    for (int kt = 0; kt < tl.ksteps; ++kt)
      tma_store_3d(tm_h, sm.a[(it + kt) % nst] + 64 * c * ROW_BYTES, 64 * kt, tl.m0 + 64 * c, 0);
    bulk_commit();
    bulk_wait_read<0>();
  }
}

// The epilogue of one warpgroup's 64 x 192 accumulators (thread: rows
// r0 + g and r0 + g + 8, columns 8 j + 2 t, + 1), after stage(). A bf16 C
// goes through sm.c (128-byte swizzled [rows][64] blocks, conflict-free
// writes) and out by TMA, which skips rows and columns past the tensor's
// edges: the warpgroup moves on to its next tile while the copy engine
// writes this one. fp32 outputs are stored from the registers, 32 bytes a
// row a quad.
template <int EPI>
__device__ __forceinline__ void epilogue(float (&acc)[96], const Epilogue& ep,
                                         const CUtensorMap& tm_c, const CUtensorMap& tm_e,
                                         const CUtensorMap& tm_f, const Walk& w, const Tile& tl,
                                         int n, bool live, int wg, int warp, int g, int t,
                                         int tid, Smem& sm, float (&colacc)[4][6]) {
  if (EPI == F_GELU || EPI == F_RES) bar_sync(WG_BAR + wg, 128);  // what stage() wrote
  if constexpr (ln_epi(EPI))
    ln_epilogue<EPI>(acc, ep, tm_f, w, tl, n, wg, warp, g, t, tid, sm, colacc);
  if (EPI == B_GELU_GRAD) {  // by pre-activation chunk: 32 columns, both row halves
#pragma unroll
    for (int q = 0; q < BN / PRE_COLS; ++q) {
      const int b = q & 1;
      mbar_wait(&sm.pre_full[wg][b], (3 * n + (q >> 1)) & 1);  // each buffer: 3 chunks a tile
      const float* pb = pre_buf(sm, wg, b);
      float s[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = 16 * warp + g + 8 * half;  // row in the warpgroup's 64
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * q + jj, cl = 8 * jj + 2 * t;  // cl: column in the chunk
          // the chunk's 128-byte rows in the 128-byte swizzle: 16-byte piece cl / 4
          // of row rl at piece (cl / 4) ^ (rl % 8)
          const float2 pv = *reinterpret_cast<const float2*>(
              pb + rl * PRE_COLS + ((((cl >> 2) ^ (rl & 7)) << 2) | (cl & 3)));
          // rows past M and columns past N hold zeros in acc (TMA filled A and B)
          const float v0 = acc[4 * j + 2 * half] * gelu_erf_grad(pv.x);
          const float v1 = acc[4 * j + 2 * half + 1] * gelu_erf_grad(pv.y);
          s[jj][0] += v0;
          s[jj][1] += v1;
          *reinterpret_cast<uint32_t*>(sm.c[j >> 3] +
                                       sw128(64 * wg + rl, 8 * (j & 7) + 2 * t)) =
              pack_bf16(v0, v1);
        }
      }
      // the chunk's column sums over the warp's 16 rows, in a fixed order
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = s[jj][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) sm.col[4 * wg + warp][8 * (4 * q + jj) + 2 * t + e] = v;
        }
      bar_sync(WG_BAR + wg, 128);  // buffer b read: the chunk two on may land in it
      if (tid == 0 && q + 2 < BN / PRE_COLS)
        load_pre(sm, tm_e, wg, b, tl.n0 + PRE_COLS * (q + 2), tl.m0 + 64 * wg);
    }
  }
  if (EPI != B_GELU_GRAD && !ln_epi(EPI) && live) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = 64 * wg + 16 * warp + g + 8 * half;  // row in the tile
      const int r = tl.m0 + rl;
      const bool row_ok = r < w.M;
      // B_F32 with `top`: a top row's share of the tile's columns, its 24
      // pairs loaded together (predicated) before any is used
      float2 share[24];
      bool is_top = false;
      if constexpr (EPI == B_F32) {
        const int i = r % ep.top_seg;
        is_top = ep.top != nullptr && row_ok && i < ep.top_rows;
        if (is_top) {
          const float* tp =
              ep.top + ((long long)(r / ep.top_seg) * ep.top_rows + i) * w.N + tl.n0 + 2 * t;
#pragma unroll
          for (int j = 0; j < 24; ++j)
            share[j] = tl.n0 + 8 * j < w.N ? *reinterpret_cast<const float2*>(tp + 8 * j)
                                           : make_float2(0.f, 0.f);
        }
      }
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        const int c = tl.n0 + 8 * j + 2 * t;
        const bool ok = row_ok && c < w.N;
        float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
        const long long o = (long long)r * ep.ldc + c;
        float2 bz = make_float2(0.f, 0.f);
        if (EPI == F_GELU || EPI == F_RES)
          bz = *reinterpret_cast<const float2*>(&sm.bias[wg][8 * j + 2 * t]);
        if (EPI == F_GELU) {
          v0 += bz.x;
          v1 += bz.y;
          if (ep.pre != nullptr && ok)  // training: the fp32 pre-activation, for GELU'
            *reinterpret_cast<float2*>(ep.pre + o) = make_float2(v0, v1);
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        } else if (EPI == F_RES) {
          const __nv_bfloat162 rb = *reinterpret_cast<const __nv_bfloat162*>(
              sm.c[j >> 3] + sw128(rl, 8 * (j & 7) + 2 * t));
          v0 = v0 + bz.x + __low2float(rb);
          v1 = v1 + bz.y + __high2float(rb);
        } else if (EPI == B_PART) {
          if (ok)
            *reinterpret_cast<float2*>(ep.cf + ((long long)tl.split * w.M + r) * w.N + c) =
                make_float2(v0, v1);
        } else if (EPI == B_F32) {
          if (is_top) {
            v0 += share[j].x;
            v1 += share[j].y;
          }
          if (ok) *reinterpret_cast<float2*>(ep.cf + o) = make_float2(v0, v1);
        }
        if (bf16_out(EPI))
          *reinterpret_cast<uint32_t*>(sm.c[j >> 3] + sw128(rl, 8 * (j & 7) + 2 * t)) =
              pack_bf16(v0, v1);
      }
    }
  }
  if (bf16_out(EPI)) {  // this warpgroup's 64 rows out by TMA, one box per 64 columns
    fence_async_smem();
    bar_sync(WG_BAR + wg, 128);
    if (live && tid == 0) {
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
        if (tl.n0 + 64 * b < w.N)
          tma_store_3d(tm_c, sm.c[b] + 64 * wg * 64, tl.n0 + 64 * b, tl.m0 + 64 * wg, 0);
      bulk_commit();
    }
  }
  if (EPI == B_GELU_GRAD) {  // fp32 column sums of the 128-row tile, fixed order
    bar_sync(COL_BAR, NWG * 128);
    for (int c = (threadIdx.x - 128); c < BN; c += NWG * 128) {
      if (tl.n0 + c >= w.N) continue;
      float s = sm.col[0][c];
#pragma unroll
      for (int i = 1; i < NWG * 4; ++i) s += sm.col[i][c];
      ep.colpart[(long long)tl.mt * w.N + tl.n0 + c] = s;
    }
    bar_sync(COL_BAR, NWG * 128);  // sm.col free for the next tile
  }
}

// An int8 accumulator dequantized: (float(acc) * s_row) * s_col, each
// product rounded (no contraction), as int8_mm_reference.
__device__ __forceinline__ float deq(int acc, float s_row, float s_col) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s_row), s_col);
}
// fc1's f from its accumulator: erf-GELU(dequantized + bias). Both passes
// compute it with this one function, so pass 2 quantizes the values whose
// maxima pass 1 took.
__device__ __forceinline__ float fc1_value(int acc, float s_row, float s_col, float bias) {
  return gelu_erf(__fadd_rn(deq(acc, s_row, s_col), bias));
}

// The epilogue of one warpgroup's 64 x 192 int32 accumulators (the layout
// of epilogue()), after stage(). Rows past M and columns past N hold zeros
// (TMA filled A and B); nothing is written for them.
template <int EPI>
__device__ __forceinline__ void epilogue_q(int (&acc)[96], const Epilogue& ep,
                                           const CUtensorMap& tm_c, const CUtensorMap& tm_e,
                                           const Walk& w, const Tile& tl, int n, bool live,
                                           int wg, int warp, int g, int t, int tid, Smem& sm) {
  if (dequant(EPI)) bar_sync(WG_BAR + wg, 128);  // what stage() wrote
  // by column pair (j, 2 t) outermost: its two scales and biases (float2)
  // serve both of the thread's rows, rl[0] and rl[1] in the warpgroup's 64
  const int rl[2] = {16 * warp + g, 16 * warp + g + 8};
  const float sr[2] = {sm.rs[wg][0][rl[0]], sm.rs[wg][0][rl[1]]};
  auto col2 = [&](const float* p, int c) { return *reinterpret_cast<const float2*>(p + c); };
  if (EPI == Q_RES_BF16) {  // by residual chunk: 32 columns, both row halves
#pragma unroll
    for (int q = 0; q < BN / PRE_COLS; ++q) {
      const int b = q & 1;
      mbar_wait(&sm.pre_full[wg][b], (3 * n + (q >> 1)) & 1);  // each buffer: 3 chunks a tile
      const float* pb = pre_buf(sm, wg, b);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * q + jj, cl = 8 * jj + 2 * t, c = 8 * j + 2 * t;
        const float2 s2 = col2(sm.cs[wg], c), b2 = col2(sm.bias[wg], c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 rv = *reinterpret_cast<const float2*>(
              pb + rl[h] * PRE_COLS + ((((cl >> 2) ^ (rl[h] & 7)) << 2) | (cl & 3)));
          const float v0 = __fadd_rn(rv.x, __fadd_rn(deq(acc[4 * j + 2 * h], sr[h], s2.x), b2.x));
          const float v1 =
              __fadd_rn(rv.y, __fadd_rn(deq(acc[4 * j + 2 * h + 1], sr[h], s2.y), b2.y));
          *reinterpret_cast<uint32_t*>(sm.c[j >> 3] +
                                       sw128(64 * wg + rl[h], 8 * (j & 7) + 2 * t)) =
              pack_bf16(v0, v1);
        }
      }
      bar_sync(WG_BAR + wg, 128);  // buffer b read: the chunk two on may land in it
      if (tid == 0 && q + 2 < BN / PRE_COLS)
        load_pre(sm, tm_e, wg, b, tl.n0 + PRE_COLS * (q + 2), tl.m0 + 64 * wg);
    }
  } else if (EPI == Q_GELU_MAX) {
    // each row's max |f| over the tile's columns. f = gelu_erf(v) is
    // non-decreasing over v >= 0 and below GELU_NEG_MAX in magnitude over
    // v < 0 (common.cuh), so a thread's max |f| over its 48 values of a row
    // is gelu_erf of their largest v when that reaches GELU_NEG_MAX; else
    // (every v below ~0.29) it takes each |f|.
    float vmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 s2 = col2(sm.cs[wg], c), b2 = col2(sm.bias[wg], c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (tl.n0 + c < w.N)
          vmax[h] = fmaxf(vmax[h], __fadd_rn(deq(acc[4 * j + 2 * h], sr[h], s2.x), b2.x));
        if (tl.n0 + c + 1 < w.N)
          vmax[h] = fmaxf(vmax[h], __fadd_rn(deq(acc[4 * j + 2 * h + 1], sr[h], s2.y), b2.y));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = vmax[h] > 0.f ? gelu_erf(vmax[h]) : 0.f;
      if (m < GELU_NEG_MAX) {
        m = 0.f;
#pragma unroll
        for (int j = 0; j < 24; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * t + e;
            if (tl.n0 + c < w.N)
              m = fmaxf(m, fabsf(fc1_value(acc[4 * j + 2 * h + e], sr[h], sm.cs[wg][c],
                                           sm.bias[wg][c])));
          }
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const int r = tl.m0 + 64 * wg + rl[h];
      if (t == 0 && r < w.M) ep.part[(long long)(tl.n0 / BN) * w.M + r] = m;
    }
  } else if (EPI == Q_GELU_Q8) {  // codes into sm.c: [64][64] int8 boxes, 64-byte swizzle
    const QuantRecip qr[2] = {{sm.rs[wg][1][rl[0]], sm.rs[wg][2][rl[0]], sm.rs[wg][3][rl[0]]},
                              {sm.rs[wg][1][rl[1]], sm.rs[wg][2][rl[1]], sm.rs[wg][3][rl[1]]}};
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int c = 8 * j + 2 * t, cb = c & 63;
      const float2 s2 = col2(sm.cs[wg], c), b2 = col2(sm.bias[wg], c);
      unsigned char* box = reinterpret_cast<unsigned char*>(sm.c[j >> 3] + 64 * wg * 64);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q0 = quant_code_r(fc1_value(acc[4 * j + 2 * h], sr[h], s2.x, b2.x), qr[h]);
        const int q1 = quant_code_r(fc1_value(acc[4 * j + 2 * h + 1], sr[h], s2.y, b2.y), qr[h]);
        *reinterpret_cast<uint16_t*>(
            box + rl[h] * 64 + ((((cb >> 4) ^ ((rl[h] >> 1) & 3)) << 4) | (cb & 15))) =
            (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
      }
    }
  } else if (EPI == Q_BF16) {
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const float2 s2 = col2(sm.cs[wg], 8 * j + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(sm.c[j >> 3] + sw128(64 * wg + rl[h], 8 * (j & 7) + 2 * t)) =
            pack_bf16(deq(acc[4 * j + 2 * h], sr[h], s2.x),
                      deq(acc[4 * j + 2 * h + 1], sr[h], s2.y));
    }
  } else if (EPI == Q_RES_F32) {  // the fp32 values into acc (as bits), reading the residual
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 s2 = col2(sm.cs[wg], c), b2 = col2(sm.bias[wg], c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 rb = *reinterpret_cast<const __nv_bfloat162*>(
            sm.c[j >> 3] + sw128(64 * wg + rl[h], 8 * (j & 7) + 2 * t));
        int& a0 = acc[4 * j + 2 * h];
        int& a1 = acc[4 * j + 2 * h + 1];
        a0 = __float_as_int(__fadd_rn(__low2float(rb), __fadd_rn(deq(a0, sr[h], s2.x), b2.x)));
        a1 = __float_as_int(__fadd_rn(__high2float(rb), __fadd_rn(deq(a1, sr[h], s2.y), b2.y)));
      }
    }
  }
  if (w32_out(EPI)) {  // 4-byte values out by TMA, columns 0-95 then 96-191
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && tid == 0) bulk_wait_read<0>();  // the first half's copy out has read sm.c
      bar_sync(WG_BAR + wg, 128);  // (h = 0: Q_RES_F32's residual is read)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = 16 * warp + g + 8 * half;
#pragma unroll
        for (int jj = 0; jj < 12; ++jj) {
          const int j = 12 * h + jj, cc = 8 * jj + 2 * t, c32 = cc & 31;
          // [64][32] 4-byte boxes, 128-byte swizzle: 16-byte piece c32 / 4 of row
          // rl at piece (c32 / 4) ^ (rl % 8)
          int* box = reinterpret_cast<int*>(sm.c[cc >> 5] + 64 * wg * 64);
          *reinterpret_cast<int2*>(box + rl * 32 + ((((c32 >> 2) ^ (rl & 7)) << 2) | (c32 & 3))) =
              make_int2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        }
      }
      fence_async_smem();
      bar_sync(WG_BAR + wg, 128);
      if (live && tid == 0) {
#pragma unroll
        for (int b = 0; b < 3; ++b)
          if (tl.n0 + 96 * h + 32 * b < w.N)
            tma_store_3d(tm_c, sm.c[b] + 64 * wg * 64, tl.n0 + 96 * h + 32 * b, tl.m0 + 64 * wg,
                         0);
        bulk_commit();
      }
    }
  }
  if (bf16_out(EPI) || EPI == Q_GELU_Q8) {  // this warpgroup's 64 rows out, one box per 64 columns
    fence_async_smem();
    bar_sync(WG_BAR + wg, 128);
    if (live && tid == 0) {
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
        if (tl.n0 + 64 * b < w.N)
          tma_store_3d(tm_c, sm.c[b] + 64 * wg * 64, tl.n0 + 64 * b, tl.m0 + 64 * wg, 0);
      bulk_commit();
    }
  }
}

template <typename T, int TA, int TB, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_c, const __grid_constant__ CUtensorMap tm_e,
                const __grid_constant__ CUtensorMap tm_f, const Walk w, const Epilogue ep) {
  constexpr bool I8 = sizeof(T) == 1;
  static_assert(I8 == int8_epi(EPI) && (!I8 || (TA == 0 && TB == 0)),
                "int8 epilogues take K-major int8 operands, the others bf16");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                      ~uintptr_t(1023));
  const int nt_n = cdiv(w.N, BN), mt_n = cdiv(w.M, BM), tiles = nt_n * mt_n * w.splits;
  // the warpgroup, broadcast from lane 0 so that the compiler sees it
  // uniform: a branch it cannot prove uniform around wgmma serialises them
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages(EPI); ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], NWG);
    }
    for (int i = 0; i < NWG; ++i) {
      mbar_init(&sm.res_full[i], 1);
      mbar_init(&sm.pre_full[i][0], 1);
      mbar_init(&sm.pre_full[i][1], 1);
    }
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    set_max_regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
#ifdef SVT_GEMM_PROFILE
      unsigned long long prof[2] = {0, 0};
      const long long prof_t0 = clock64();
      long long prof_t = prof_t0;
#endif
      int it = 0;
      for (int j = 0, tile; (tile = walk_tile<EPI>(j, nt_n, mt_n, tiles)) >= 0; ++j) {
        const Tile tl = tile_at<T>(tile, w);
        for (int kt = 0; kt < tl.ksteps; ++kt, ++it) {
          const int st = it % stages(EPI), use = it / stages(EPI);
          SVT_GEMM_MARK(1);
          if (use > 0) mbar_wait(&sm.empty[st], (use - 1) & 1);
          SVT_GEMM_MARK(0);
          mbar_expect(&sm.full[st], STAGE_BYTES);
          load_stage<TA, TB>(sm, st, tm_a, tm_b, w, tl.m0, tl.n0, tl.k0 + kt * BK<T>);
        }
      }
#ifdef SVT_GEMM_PROFILE
      atomicAdd(&gemm_profile[6], prof[0]);
      atomicAdd(&gemm_profile[7], (unsigned long long)(clock64() - prof_t0));
#endif
    }
    return;
  }

  // a consumer warpgroup: rows 64 c .. 64 c + 63 of each tile
  set_max_regs_inc<CONSUMER_REGS>();
  const int c = wg - 1, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  typename std::conditional<I8, int, float>::type acc[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0;
  float colacc[4][6];  // the LayerNorm epilogues' column sums over the walk
#pragma unroll
  for (int i = 0; i < 24; ++i) colacc[i / 6][i % 6] = 0.f;
  if constexpr (EPI == F_LNA) {  // the LayerNorm's gamma and beta, once a warpgroup
    for (int i = tid; i < w.K; i += 128) {
      sm.bias[c][(i & 1) * (w.K / 2) + (i >> 1)] = ep.ln_gamma[i];
      sm.cs[c][(i & 1) * (w.K / 2) + (i >> 1)] = ep.ln_beta[i];
    }
    bar_sync(WG_BAR + c, 128);
  }
  // the chunked epilogues' tensor map, chunk width and chunks a tile
  const CUtensorMap& tm_ch = ln_epi(EPI) ? tm_f : tm_e;
  const int nch = ln_epi(EPI) ? cdiv(w.N, chunk_cols(EPI)) : BN / PRE_COLS;
#ifdef SVT_GEMM_PROFILE
  unsigned long long prof[6] = {0, 0, 0, 0, 0, 0};
  const long long prof_t0 = clock64();
  long long prof_t = prof_t0;
#endif
  int it = 0;
  for (int n = 0, tile; (tile = walk_tile<EPI>(n, nt_n, mt_n, tiles)) >= 0; ++n) {
    const Tile tl = tile_at<T>(tile, w);
    const bool live = tl.m0 + 64 * c < w.M;
    if (res_tile(EPI) && tid == 0) {  // this tile's residual block into sm.c, under its products
      bulk_wait_read<0>();          // once the last tile's copy out has read sm.c
      mbar_expect(&sm.res_full[c], BN * 64 * 2);
      const int r0 = tl.m0 + 64 * c;
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
        tma_load_3d(sm.c[b] + 64 * c * 64, tm_e, &sm.res_full[c], tl.n0 + 64 * b,
                    r0 % w.r_rpg, r0 / w.r_rpg);
    }
    if (chunked(EPI) && tid == 0)  // the first two chunks, likewise
      for (int b = 0; b < 2 && b < nch; ++b)
        load_pre(sm, tm_ch, c, b, tl.n0 + chunk_cols(EPI) * b, tl.m0 + 64 * c);
    if constexpr (EPI == F_LNA) {  // LN of the tile's A rows, once all its K-steps landed
      for (int kt = 0; kt < tl.ksteps; ++kt)
        mbar_wait(&sm.full[(it + kt) % stages(EPI)], ((it + kt) / stages(EPI)) & 1);
      if (w.K == 96)
        ln_prologue<12>(sm, it, stages(EPI), ep, tm_e, w, tl, c, tid);
      else
        ln_prologue<24>(sm, it, stages(EPI), ep, tm_e, w, tl, c, tid);
#pragma unroll
      for (int i = 0; i < 96; ++i) acc[i] = 0;  // dead under the LayerNorm: its registers
    }
    int prev = 0;
    for (int kt = 0; kt < tl.ksteps; ++kt, ++it) {
      const int st = it % stages(EPI);
      SVT_GEMM_MARK(5);
      mbar_wait(&sm.full[st], (it / stages(EPI)) & 1);
      SVT_GEMM_MARK(0);
      // every warpgroup runs its products, rows past M included (TMA
      // zero-filled them; the epilogue skips them): no branch around wgmma
      // (a k16 bf16 / k32 int8 step: 32 bytes along a K-major row, 16 rows
      // of an MN-major tile)
      const unsigned char* a = sm.a[st] + c * 64 * ROW_BYTES;
      wg_hold(acc);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < ROW_BYTES / 32; ++ks) {
        const uint64_t da = sw128_desc(a + (TA ? ks * 16 * ROW_BYTES : ks * 32));
        const uint64_t db = sw128_desc(sm.b[st] + (TB ? ks * 16 * ROW_BYTES : ks * 32),
                                       TB ? 64 * ROW_BYTES : 16);
        if constexpr (I8)
          wgmma_s8(acc, da, db, kt > 0 || ks > 0);
        else
          wgmma_ss<TA, TB>(acc, da, db, kt > 0 || ks > 0);
      }
      wg_commit();
      wg_hold(acc);
      SVT_GEMM_MARK(1);
      if (kt > 0) wg_wait<1>();  // the k-step before this one is done with its stage
      if (kt > 0 && tid == 0) mbar_arrive(&sm.empty[prev]);
      prev = st;
      SVT_GEMM_MARK(2);
    }
    stage<EPI>(ep, w, tl, c, tid, sm);
    wg_wait<0>();
    wg_hold(acc);
    if (tid == 0) mbar_arrive(&sm.empty[prev]);
    SVT_GEMM_MARK(3);
    if (res_tile(EPI)) mbar_wait(&sm.res_full[c], n & 1);
    if constexpr (I8)
      epilogue_q<EPI>(acc, ep, tm_c, tm_e, w, tl, n, live, c, warp, g, t, tid, sm);
    else
      epilogue<EPI>(acc, ep, tm_c, tm_e, tm_f, w, tl, n, live, c, warp, g, t, tid, sm, colacc);
    SVT_GEMM_MARK(4);
  }
  if constexpr (ln_epi(EPI)) {
    // the walk's column sums: each warp's by column into sm.col, then the
    // eight warps' added in order into colpart[CTA][sum][N]
    constexpr int NSUM = EPI == B_LN2 ? 4 : 2;
#pragma unroll
    for (int q = 0; q < NSUM; ++q) {
#pragma unroll
      for (int i = 0; i < 6; ++i) sm.col[4 * c + warp][col_of(g, t, i)] = colacc[q][i];
      bar_sync(COL_BAR, NWG * 128);
      for (int col = threadIdx.x - 128; col < w.N; col += NWG * 128) {
        float v = sm.col[0][col];
#pragma unroll
        for (int i = 1; i < NWG * 4; ++i) v += sm.col[i][col];
        ep.colpart[((long long)blockIdx.x * NSUM + q) * w.N + col] = v;
      }
      bar_sync(COL_BAR, NWG * 128);
    }
  }
  if (smem_out(EPI) && tid == 0) bulk_wait<0>();  // the last copy out done
#ifdef SVT_GEMM_PROFILE
  if (tid == 0) {
    for (int i = 0; i < 5; ++i) atomicAdd(&gemm_profile[i], prof[i]);
    atomicAdd(&gemm_profile[5], (unsigned long long)(clock64() - prof_t0));
  }
#endif
}

// -- host side -----------------------------------------------------------------

// CTAs of a LayerNorm epilogue's walk over M rows, each leaving one row of
// column sums: at most TARGET_TILES whatever the card, so that the sums'
// order, and the results, are the same on any card.
inline int ln_ctas(int M) { return std::min(cdiv(M, BM), TARGET_TILES); }

// Splits of a weight gradient's K (the token rows), in chunks of whole
// k-steps: the fewest that fill the waves of TARGET_TILES tiles to 95%
// (e.g. 8 tiles -> 16 splits, 72 -> 11), each chunk at least 8 k-steps.
inline void split_k(int M, int N, int K, int* splits, int* chunk) {
  const int tiles = cdiv(M, BM) * cdiv(N, BN);
  const int most = std::max(1, cdiv(K, BK<bf16>) / 8);
  int s = 1;
  while (s < most &&
         (double)tiles * s < 0.95 * TARGET_TILES * cdiv((long long)tiles * s, TARGET_TILES))
    ++s;
  *chunk = cdiv(cdiv(K, s), BK<bf16>) * BK<bf16>;
  *splits = cdiv(K, *chunk);
}

// The 3-D TMA map of a bf16 or int8 operand (128 bytes of columns x
// box_rows rows a box; with a row map, groups of rpg rows `gstride` rows
// apart, box_rows / rpg groups a box). -> the rows per group the device
// indexes with.
template <typename T>
cudaError_t operand_map(CUtensorMap* m, const Operand& o, int box_rows, int* rpg_dev) {
  constexpr int E = sizeof(T);
  const bool grouped = o.rpg > 0 && o.rpg < o.rows;
  if (reinterpret_cast<uintptr_t>(o.p) % 16 || (o.ld * E) % 16 ||
      (grouped && ((long long)o.gstride * o.ld * E) % 16))
    return cudaErrorMisalignedAddress;
  if (grouped && box_rows % o.rpg) return cudaErrorInvalidValue;
  const int rpg = grouped ? o.rpg : o.rows;
  const cuuint64_t dims[3] = {(cuuint64_t)o.cols, (cuuint64_t)rpg,
                              (cuuint64_t)(grouped ? cdiv(o.rows, o.rpg) : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)o.ld * E,
                                 (cuuint64_t)(grouped ? o.gstride : o.rows) * o.ld * E};
  const cuuint32_t box[3] = {(cuuint32_t)BK<T>, (cuuint32_t)(grouped ? o.rpg : box_rows),
                             (cuuint32_t)(grouped ? box_rows / o.rpg : 1)};
  *rpg_dev = grouped ? o.rpg : IDENTITY;
  return encode_tiled(m, 3, o.p, dims, strides, box,
                      E == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

// The 3-D TMA map of an (M, N) tensor of 4-byte values, `ld` apart, read or
// written in [64][32] boxes (128-byte swizzle), or of int8 codes in [64][64]
// boxes (64-byte swizzle).
inline cudaError_t plain_map(CUtensorMap* m, const void* p, int M, int N, int ld, int esize) {
  if (reinterpret_cast<uintptr_t>(p) % 16 || ((long long)ld * esize) % 16)
    return cudaErrorMisalignedAddress;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)M, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * esize, (cuuint64_t)M * ld * esize};
  const cuuint32_t box[3] = {esize == 4 ? (cuuint32_t)PRE_COLS : 64u, 64, 1};
  return esize == 4 ? encode_tiled(m, 3, p, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32)
                    : encode_tiled(m, 3, p, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                   CU_TENSOR_MAP_SWIZZLE_64B);
}

// C (M, N) = A B over K, A (TA: 0 = (M, K) rows, 1 = (K, M) rows) and B
// (TB: 0 = (N, K) rows, 1 = (K, N) rows) of element type T, split over K
// when `split`.
template <typename T, int TA, int TB, int EPI>
cudaError_t run(const Operand& a, const Operand& b, int M, int N, int K, bool split,
                const Epilogue& ep, cudaStream_t st) {
  constexpr int smem = sizeof(Smem) + 1024;  // + alignment to 1024 bytes
  // per device, once: the shared-memory limit and the SM count
  static bool ready[16];
  static int sms[16];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(gemm_kernel<T, TA, TB, EPI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  if (EPI == F_LNA && K != 96 && K != 192) return cudaErrorInvalidValue;  // whole rows a tile
  Walk w{M, N, K, cdiv(K, BK<T>) * BK<T>, 1, IDENTITY, IDENTITY, IDENTITY};
  if (split) split_k(M, N, K, &w.splits, &w.k_chunk);
  CUtensorMap tm_a, tm_b, tm_c, tm_e, tm_f;
  if ((e = operand_map<T>(&tm_a, a, TA ? 64 : BM, &w.a_rpg)) != cudaSuccess) return e;
  if ((e = operand_map<T>(&tm_b, b, TB ? 64 : BN, &w.b_rpg)) != cudaSuccess) return e;
  int unused;
  tm_c = tm_e = tm_f = tm_a;  // unused unless the epilogue writes C / reads a tile by TMA
  if (bf16_out(EPI)) {  // the bf16 C, written in [64][64] boxes
    if ((e = operand_map<bf16>(&tm_c, Operand{ep.cb, M, N, ep.ldc}, 64, &unused)) != cudaSuccess)
      return e;
  }
  if (w32_out(EPI) && (e = plain_map(&tm_c, ep.cf, M, N, ep.ldc, 4)) != cudaSuccess) return e;
  if (EPI == Q_GELU_Q8 && (e = plain_map(&tm_c, ep.cq, M, N, ep.ldc, 1)) != cudaSuccess) return e;
  if (ln_epi(EPI)) {  // x in [64][64] boxes; the residual in chunks (bf16 [64][64], fp32 [64][32])
    if (N > BN) return cudaErrorInvalidValue;  // a tile holds whole rows
    // B_LN1_TOP: at most one top row of a thread's two, 8 apart (ln_epilogue)
    if (EPI == B_LN1_TOP && (ep.top_rows < 1 || ep.top_rows > 8 || ep.top_seg < ep.top_rows + 8))
      return cudaErrorInvalidValue;
    if ((e = operand_map<bf16>(&tm_e, Operand{ep.x, M, N, ep.ldx}, 64, &w.r_rpg)) != cudaSuccess)
      return e;
    if (chunked(EPI))
      e = EPI == B_LN2 ? operand_map<bf16>(&tm_f, Operand{ep.lres, M, N, ep.ldr}, 64, &unused)
                       : plain_map(&tm_f, ep.lres, M, N, ep.ldr, 4);
    if (e != cudaSuccess) return e;
  }
  if (EPI == F_LNA && ep.ln_out != nullptr &&  // the training form's normalised rows
      (e = operand_map<bf16>(&tm_e, Operand{ep.ln_out, M, K, K}, 64, &unused)) != cudaSuccess)
    return e;
  if (res_tile(EPI) && !ln_epi(EPI)) {  // the residual, read in [64][64] boxes through its row map
    const bool grouped = ep.r_gstride != ep.r_rpg && ep.r_rpg < M;
    const Operand r{ep.res, M, N, ep.ldr, grouped ? ep.r_rpg : 0, ep.r_gstride};
    if ((e = operand_map<bf16>(&tm_e, r, 64, &w.r_rpg)) != cudaSuccess) return e;
  }
  // the fp32 pre-activation / residual, read in [64][32] boxes
  if (EPI == B_GELU_GRAD && (e = plain_map(&tm_e, ep.pre, M, N, ep.ldc, 4)) != cudaSuccess)
    return e;
  if (EPI == Q_RES_BF16 && (e = plain_map(&tm_e, ep.resf, M, N, ep.ldr, 4)) != cudaSuccess)
    return e;
  const int tiles = cdiv(M, BM) * cdiv(N, BN) * w.splits;
  const int ctas = ln_epi(EPI) ? ln_ctas(M)
                   : std::min(EPI == F_LNA ? cdiv(M, BM) : tiles, sms[dev]);  // walk_tile
  gemm_kernel<T, TA, TB, EPI><<<ctas, THREADS, smem, st>>>(tm_a, tm_b, tm_c, tm_e, tm_f, w, ep);
  return cudaGetLastError();
}

// The forward's products: C (M, N) = epi(A W^T), A (M, K) through its row
// map, W (N, K) in the torch Linear layout; bf16 or int8 operands (T).
template <int EPI, typename T>
cudaError_t linear(const Operand& a, const T* w, int N, const Epilogue& ep, cudaStream_t st) {
  return run<T, 0, 0, EPI>(a, Operand{w, N, a.cols, a.cols}, a.rows, N, a.cols, false, ep, st);
}

// The backward's dX products: C (M, N) = epi(A W), A (M, K), W the torch
// (out = K, in = N) weight read N-major.
template <int EPI>
cudaError_t linear_dx(const Operand& a, const bf16* w, int N, const Epilogue& ep,
                      cudaStream_t st) {
  return run<bf16, 0, 1, EPI>(a, Operand{w, a.cols, N, N}, a.rows, N, a.cols, false, ep, st);
}

// The weight gradients' split-K partials: part[s] (Mout, Nout) = the s-th
// K chunk of A^T B, A (K rows, Mout columns), B (K rows through its row
// map, Nout columns). -> the number of splits (split_k) in *splits.
inline cudaError_t weight_grad_partials(const Operand& a, const Operand& b, float* part,
                                        int* splits, cudaStream_t st) {
  int chunk;
  split_k(a.cols, b.cols, a.rows, splits, &chunk);
  Epilogue ep;
  ep.cf = part;
  return run<bf16, 1, 1, B_PART>(a, b, a.cols, b.cols, a.rows, true, ep, st);
}

#ifdef SVT_GEMM_PROFILE
// Copy gemm_profile to the host and zero it (after a synchronisation).
inline int profile_read(unsigned long long* out) {
  SVT_TRY(cudaMemcpyFromSymbol(out, gemm_profile, sizeof(gemm_profile)));
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  SVT_TRY(cudaMemcpyToSymbol(gemm_profile, zero, sizeof(zero)));
  return 0;
}
#endif

}  // namespace
}  // namespace gemm
}  // namespace svt
