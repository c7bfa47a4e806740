// Streamed attention, head dim 64 (flash_attention.cu): the launchers the
// block chains (fused_block.cu, fused_block_bwd.cu) share with the public
// flash_attention entries.
#pragma once

#include "common.cuh"

namespace svt {

// One attention operand: element (b, h, r, d) of a (batch, head, row, 64)
// bf16 tensor lives at p[b * sb + h * sh + r * sr + d]. Rows start on 16
// bytes (the callers check), so one kernel reads both a (B, H, N, 64) tensor
// and a head's 64 columns of the chain's packed (B, N, heads * 64) rows.
struct Strided {
  bf16* p;
  long long sb, sh, sr;
  __host__ __device__ bf16* row(int b, int h, int r) const { return p + b * sb + h * sh + r * sr; }
};

// (B, rows, ld) packed activations whose head h starts at column h * 64 of p.
inline Strided packed(const bf16* p, int rows, int ld) {
  return Strided{const_cast<bf16*>(p), (long long)rows * ld, ATT_DH, ld};
}

// O = softmax(Q K^T / 8) V over keys < valid_len, lse = the row log-sum-exp
// (B, heads, nq) fp32 (skipped when nullptr).
cudaError_t flash_fwd(Strided q, Strided k, Strided v, Strided o, float* lse, int B, int heads,
                      int nq, int nk, int valid_len, cudaStream_t st);

// The backward from the forward's O and lse: dQ and delta = rowsum(dO . O)
// (B, heads, nq) fp32, then dK and dV. Two passes, no atomics.
cudaError_t flash_bwd(Strided q, Strided k, Strided v, Strided o, Strided d_o, const float* lse,
                      float* delta, Strided dq, Strided dk, Strided dv, int B, int heads, int nq,
                      int nk, int valid_len, cudaStream_t st);

}  // namespace svt
