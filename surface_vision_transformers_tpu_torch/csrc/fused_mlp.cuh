// The fused MLP half of the block forward (fused_mlp.cu), which the block
// chain (fused_block.cu) runs at the widths of fused_mlp_route.
#pragma once

#include "common.cuh"

namespace svt {

// What the training forward keeps of the MLP half (all null when serving):
// h2 = LN2(x1) bf16 (M, dim), its (mean, rstd) per row fp32 (M, 2), the fc1
// pre-activation fpre fp32 (M, mlp) and f = GELU(fpre) bf16 (M, mlp).
struct MlpSaves {
  bf16* h2 = nullptr;
  float* stats2 = nullptr;
  float* fpre = nullptr;
  bf16* f = nullptr;
};

// Whether a block chain (train: the training forward) fuses LN2 -> fc1 ->
// GELU -> fc2 (+ residual) into one kernel, and LN1 into the qkv product's
// prologue; the shapes the kernel is built for: dim 96 or 192 (its fc2
// output spans one wgmma of n = dim), mlp a multiple of 128 up to 4 dim (fc1
// in 64-column chunks; the weights' ring). The training form, which writes
// h1, h2, f and fpre all the same, is built at dim 96 only: at dim 192 the
// seven launches measured faster (PERF.md).
bool fused_mlp_route(int dim, int mlp, bool train);

// out (M, dim) bf16 = x1 + (GELU(LN2(x1) W1^T + b1) W2^T + b2), with the
// chain's rounding points (bf16 after LN2 and GELU; fp32 statistics, sums
// and epilogues): W1 (mlp, dim) and W2 (dim, mlp) bf16 in the torch Linear
// layout, the LayerNorm's gamma / beta and the biases fp32. Neither h2 nor
// f reaches device memory unless `s` asks for them. On `st`; returns the
// launch's error. Shapes outside fused_mlp_route return
// cudaErrorInvalidValue, operands off 16 bytes cudaErrorMisalignedAddress.
cudaError_t fused_mlp(const bf16* x1, const float* gamma, const float* beta, const bf16* w1,
                      const float* b1, const bf16* w2, const float* b2, bf16* out, int M,
                      int dim, int mlp, float eps, const MlpSaves& s, cudaStream_t st);

}  // namespace svt
