// Streamed attention (flash_attention.cu): the launchers the block chains
// (fused_block.cu, fused_block_int8.cu, fused_block_bwd.cu) share with the
// public flash_attention entries. Both directions read their operands by
// TMA and run their products on wgmma up to heads laid out in 128 columns;
// wider heads run the wide kernels (flash_attention_wide.cu). Both take
// every head dim >= 1, with or without dropout (head_cols below).
#pragma once

#include <cmath>

#include "common.cuh"

namespace svt {

// One attention operand: element (b, h, r, d) of a (batch, head, row, dh)
// bf16 tensor lives at p[b * sb + h * sh + r * sr + d]. The base and the
// strides are on 16 bytes (the callers see to it; the forward refuses
// others with cudaErrorMisalignedAddress, as TMA must), so one kernel reads
// both a (B, H, N, dh) tensor and a head's dh columns of the chain's packed
// (B, N, heads * dh) rows.
struct Strided {
  bf16* p;
  long long sb, sh, sr;
  __host__ __device__ bf16* row(int b, int h, int r) const { return p + b * sb + h * sh + r * sr; }
};

// (B, rows, ld) packed activations whose head h starts at column h * dh of p.
inline Strided packed(const bf16* p, int rows, int ld, int dh = ATT_DH) {
  return Strided{const_cast<bf16*>(p), (long long)rows * ld, dh, ld};
}

// Dropout on the softmax probabilities (flash_attention_qkv_dropout): score
// (b, h, row, col) is kept when word (col & 3) of
// Philox4x32-10(counter {row, col / 4, 0, 0}, key {seed, b * heads + h})
// is >= threshold; kept probabilities are scaled by inv_keep. Off unless
// `on`.
struct Dropout {
  uint32_t seed = 0, threshold = 0;
  float inv_keep = 1.f;
  int on = 0;
};

// The columns a head of dh columns is laid out in: dh rounded up to 8, so
// that every head's first column starts on 16 bytes, as TMA and the 16-byte
// row pieces need. The columns past dh are zero in every operand (the
// callers see to it: zero rows of W_qkv and zero columns of W_out in the
// block chains, a zero-padded copy in the public entries), so they add
// nothing to a score, and O, dQ, dK and dV come out zero there.
inline int head_cols(int dh) { return (dh + 7) / 8 * 8; }

// The widest tile the wgmma kernels are built for; heads laid out wider run
// the wide kernels (flash_attention_wide.cu).
constexpr int MAX_TILE_COLS = 128;

// A head width at run time: the kernels built for any dh (the widths other
// than 32 and 64, flash_attention_widths.cu, and the wide kernels) take the
// head's layout, head_cols(dh) columns, in tiles of 32, 64 or 128 (wide:
// steps of 64, passes of up to 128), and the softmax scale 1 / sqrt(dh) of
// the true width from here, rounded once to fp32 as the plain version's
// fp32 multiply rounds it, and its product with log2(e) (the exponent)
// rounded once from double, as SoftmaxScale's at dh 32. A padded head is
// never run on the kernels built for 32 or 64, whose scale is the layout's.
struct Width {
  int dh = 0;
  float scale = 0.f, slog2 = 0.f;
};
inline Width width_of(int dh) {
  const double s = std::pow((double)dh, -0.5);
  return Width{head_cols(dh), (float)s, (float)(s * 1.4426950408889634)};
}

// The head widths the attention kernels take: every dh >= 1 (laid out in
// head_cols(dh) columns).
inline bool dim_head_ok(int dh) { return dh >= 1; }

// The block chains' row widths (fused_block.cu, fused_block_bwd.cu,
// fused_block_int8.cu): a row of ln_dim values laid out in dim >= ln_dim
// columns, zeros past ln_dim (a width off the tensor maps' 16 bytes is laid
// out padded); every LayerNorm counts the first ln_dim.
inline bool ln_dim_ok(int dim, int ln_dim) { return ln_dim >= 1 && ln_dim <= dim; }

// What the few-query forward needs to make its own Q (the CLS block's
// chain, fused_block.cu): the block input x (B, nk, dim) bf16, LN1's gamma
// and beta (fp32) and eps, W_q (heads * dh, dim) bf16 in the torch Linear
// layout; with q_out set (training), Q (B * nq, heads * dh) bf16 is kept.
struct FewQ {
  const bf16* x = nullptr;
  const float* gamma = nullptr;
  const float* beta = nullptr;
  const bf16* wq = nullptr;
  int dim = 0;
  float eps = 0.f;
  bf16* q_out = nullptr;
};

// O = softmax(Q K^T / sqrt(dh)) V over keys < valid_len, lse = the row
// log-sum-exp (B, heads, nq) fp32 (skipped when nullptr); any dh >= 1, the
// operands laid out in head_cols(dh) columns a head, with or without
// dropout. With dropout, the max, the sum and lse are the undropped
// softmax's and O = keep(P) V / l * inv_keep. One kernel: a
// producer warpgroup (one thread issues the TMA loads), one or three
// consumer warpgroups of 64 query rows on wgmma; the tiling by shape is in
// flash_attention.cu. A base or stride off 16 bytes returns
// cudaErrorMisalignedAddress; dh < 1 cudaErrorInvalidValue. dh 32 (without
// dropout) and 64 run kernels built for that width; the others up to
// head_cols 128 kernels built for any dh in tiles of 32, 64 or 128 columns
// (flash_fwd_widths, flash_attention_widths.cu); wider heads the wide
// kernels (flash_fwd_wide).
cudaError_t flash_fwd(Strided q, Strided k, Strided v, Strided o, float* lse, int B, int heads,
                      int nq, int nk, int valid_len, int dh, cudaStream_t st,
                      Dropout dr = Dropout{});

// The backward from the forward's O and lse -> dQ, dK, dV, dh as
// flash_fwd's; delta = rowsum(dO . O) (B, heads, nq) fp32 and ws
// (flash_bwd_workspace floats: the fp32 dQ sums and their turn counters)
// are scratch. Sums in a fixed order, so the outputs repeat bit for bit.
// With dropout, O must be the dropped output the forward returned. dh < 1
// returns cudaErrorInvalidValue.
cudaError_t flash_bwd(Strided q, Strided k, Strided v, Strided o, Strided d_o, const float* lse,
                      float* delta, float* ws, Strided dq, Strided dk, Strided dv, int B,
                      int heads, int nq, int nk, int valid_len, int dh, cudaStream_t st,
                      Dropout dr = Dropout{});

// Floats of scratch flash_bwd needs in ws for (B, heads, nq) query rows
// against nk keys at head dim dh: 0 where the resident kernel runs (dh 32,
// no dropout, nq == nk <= 320: the whole sequence in one CTA's shared
// memory, delta and dQ summed there, one launch) and where the few-query
// kernel does (no dropout, nq <= 8 < nk: the CLS block's 8 query rows
// against every key, one CTA a (sample, head), one launch).
long long flash_bwd_workspace(int B, int heads, int nq, int nk, int dh);

// Whether the backward at these shapes takes the resident kernel, and how
// many sequences it packs into one 64-row tile (N <= 32).
bool resident_bwd(int nq, int nk, int dh, bool dropout);

// Whether the backward at these shapes takes the few-query kernel (no
// dropout, nq <= 8 < nk); flash_bwd refuses dropout at such shapes.
bool few_query_bwd(int nq, int nk, int dh, bool dropout);

// Whether the forward at these shapes takes the few-query kernel (no
// dropout, nq <= 8 < nk <= 4096: one CTA a (sample, head), the scores of
// every key in shared memory, an exact two-pass softmax); and whether that
// kernel makes its own Q at this width (dh <= 64, dim a multiple of 8 up to
// 256: the CLS block's chain at dims 96 / 192).
bool few_query_fwd(int nq, int nk, int dh, bool dropout);
bool few_query_makes_q(int nq, int nk, int dim, int dh);

// The few-query forward with Q made in the CTA from fq: Q = bf16(LN1(x's
// first nq rows of each sample) W_q^T), then attention as flash_fwd's
// against k and v (head dim dh) -> o, lse. Shapes outside few_query_makes_q
// return cudaErrorInvalidValue, operands off 16 bytes
// cudaErrorMisalignedAddress.
cudaError_t flash_fwd_few_q(const FewQ& fq, Strided k, Strided v, Strided o, float* lse, int B,
                            int heads, int nq, int nk, int valid_len, int dh, cudaStream_t st);

// The entries above at the head widths other than 32 (without dropout) and
// 64, on the kernels built for any dh (flash_attention_widths.cu, a
// translation unit of its own so that the build compiles both at once);
// the entries call them after their checks.
cudaError_t flash_fwd_widths(Strided q, Strided k, Strided v, Strided o, float* lse, int B,
                             int heads, int nq, int nk, int valid_len, int dh, cudaStream_t st,
                             Dropout dr);
cudaError_t flash_bwd_widths(Strided q, Strided k, Strided v, Strided o, Strided d_o,
                             const float* lse, float* delta, float* ws, Strided dq, Strided dk,
                             Strided dv, int B, int heads, int nq, int nk, int valid_len, int dh,
                             cudaStream_t st, Dropout dr);
cudaError_t flash_fwd_few_q_widths(const FewQ& fq, Strided k, Strided v, Strided o, float* lse,
                                   int B, int heads, int nq, int nk, int valid_len, int dh,
                                   cudaStream_t st);

// The attention at heads laid out past MAX_TILE_COLS columns (any dh >= 1
// whose head_cols exceeds 128; flash_attention_wide.cu): the same functions
// as flash_fwd and flash_bwd, with the same operands, lse and delta, on
// mma.sync kernels that step the scores' sums over the head 64 columns at a
// time and make O and dQ (dK, dV) in passes of at most 128 (64) columns over
// the same keys; no workspace. flash_fwd and flash_bwd call them after their
// checks.
cudaError_t flash_fwd_wide(Strided q, Strided k, Strided v, Strided o, float* lse, int B,
                           int heads, int nq, int nk, int valid_len, int dh, cudaStream_t st,
                           Dropout dr);
cudaError_t flash_bwd_wide(Strided q, Strided k, Strided v, Strided o, Strided d_o,
                           const float* lse, float* delta, Strided dq, Strided dk, Strided dv,
                           int B, int heads, int nq, int nk, int valid_len, int dh,
                           cudaStream_t st, Dropout dr);

// Whether the forward at these shapes takes its resident kernel (dh 32, no
// dropout, nq == nk <= 320: every MS-SiT fold; sequences packed, see
// flash_attention.cu); else the streamed kernel.
bool resident_fwd(int nq, int nk, int dh, bool dropout);
int resident_pack(int n);

}  // namespace svt
