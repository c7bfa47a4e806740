// Streamed attention (flash_attention.cu): the launchers the block chains
// (fused_block.cu, fused_block_int8.cu, fused_block_bwd.cu) share with the
// public flash_attention entries. Both directions read their operands by
// TMA and run their products on wgmma. Both take head dims 32 and 64
// (dropout at 64 only).
#pragma once

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

// O = softmax(Q K^T / sqrt(dh)) V over keys < valid_len, lse = the row
// log-sum-exp (B, heads, nq) fp32 (skipped when nullptr); dh 32 or 64 (32
// without dropout). With dropout, the max, the sum and lse are the
// undropped softmax's and O = keep(P) V / l * inv_keep. One kernel: a
// producer warpgroup (one thread issues the TMA loads), one or three
// consumer warpgroups of 64 query rows on wgmma; the tiling by shape is in
// flash_attention.cu. A base or stride off 16 bytes returns
// cudaErrorMisalignedAddress; another dh cudaErrorInvalidValue.
cudaError_t flash_fwd(Strided q, Strided k, Strided v, Strided o, float* lse, int B, int heads,
                      int nq, int nk, int valid_len, int dh, cudaStream_t st,
                      Dropout dr = Dropout{});

// The backward from the forward's O and lse -> dQ, dK, dV, dh 32 or 64 (32
// without dropout); delta = rowsum(dO . O) (B, heads, nq) fp32 and ws
// (flash_bwd_workspace floats: the fp32 dQ sums and their turn counters)
// are scratch. Sums in a fixed order, so the outputs repeat bit for bit.
// With dropout, O must be the dropped output the forward returned. Another
// dh returns cudaErrorInvalidValue.
cudaError_t flash_bwd(Strided q, Strided k, Strided v, Strided o, Strided d_o, const float* lse,
                      float* delta, float* ws, Strided dq, Strided dk, Strided dv, int B,
                      int heads, int nq, int nk, int valid_len, int dh, cudaStream_t st,
                      Dropout dr = Dropout{});

// Floats of scratch flash_bwd needs in ws for (B, heads, nq) query rows
// against nk keys at head dim dh: 0 where the resident kernel runs (dh 32,
// no dropout, nq == nk <= 320: the whole sequence in one CTA's shared
// memory, delta and dQ summed there, one launch).
long long flash_bwd_workspace(int B, int heads, int nq, int nk, int dh);

// Whether the backward at these shapes takes the resident kernel, and how
// many sequences it packs into one 64-row tile (N <= 32).
bool resident_bwd(int nq, int nk, int dh, bool dropout);

// Whether the forward at these shapes takes its resident kernel (dh 32, no
// dropout, nq == nk <= 320: every MS-SiT fold; sequences packed, see
// flash_attention.cu); else the streamed kernel.
bool resident_fwd(int nq, int nk, int dh, bool dropout);
int resident_pack(int n);

}  // namespace svt
