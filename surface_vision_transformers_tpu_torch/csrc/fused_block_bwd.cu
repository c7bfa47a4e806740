// Hopper (sm_90a) kernels for the SiT transformer block backward.
//
// Replaces the TPU block-backward kernels in
// surface_vision_transformers_tpu/ops/pallas/fused_block.py:
//   fused_block_train      backward: _block_bwd (_block_bwd_kernel) and
//                          _block_bwd_split (_mlp_bwd_kernel[_chunked],
//                          _attn_bwd_kernel)            -> svt_fused_block_bwd
//   fused_block_cls_train  backward: _block_cls_bwd (_block_cls_bwd_kernel)
//                          and _block_cls_bwd_split     -> svt_fused_block_cls_bwd
// Both JAX routes compute the same gradients; one chain serves every width,
// at head dim 64 or (svt_fused_block_bwd: MS-SiT's blocks) 32. MS-SiT's
// first stage (dim 96, qkv 288) makes the dX products' N and K and the
// weight gradients' Mout and Nout ragged against the engine's 128 x 192
// tiles; TMA zero-fills them and the epilogues skip them, as in the forward.
//
// It computes the gradient of the port's own forward (fused_block.cu: exact
// erf-GELU, shifted softmax), not of the TPU kernel's tanh-GELU / clamped
// softmax: GELU' is taken at the fp32 pre-activation the forward kept, and
// no clamp indicator is needed.
//
// What is kept from the forward, and why: the TPU kernel recomputes the
// whole forward from x because VMEM is small. The H100 has 80 GB of HBM, so
// the training forward (svt_fused_block_train_fwd) keeps its chain's
// intermediates -- h1, qkv, attn, x1, h2, GELU output (bf16), the fc1
// pre-activation (fp32), LN (mean, rstd) and the attention row log-sum-exp,
// ~0.6 GB per block at SiT-tiny B=256 -- and the backward recomputes
// nothing but the attention probabilities (from Q, K and the LSE, never
// stored as a score matrix).
//
// The chain, on the caller's stream (full block; the CLS block runs the MLP,
// out-projection and Q on its B*rows top rows and K/V, LN1 and dx on all):
//   dW_fc2 = g^T f            dgl = g W_fc2 -> df1 = dgl * GELU'(fpre)
//   dW_fc1 = df1^T h2         dh2 = df1 W_fc1 -> LN2 backward (+ g) = dx1
//   dW_out = dx1^T attn       da = dx1 W_out
//   attention backward: delta = rowsum(dO . O), then one wgmma pass over key
//                       blocks and the dq pass (flash_attention.cu: any N;
//                       its dQ sums use ws)
//   dW_qkv = dqkv^T h1        dh1 = dqkv W_qkv -> LN1 backward (+ dx1) = dx
// Rounding points follow the TPU kernel: bf16 df1, dx1, da, P (for dV), dS,
// dq/dk/dv and dx; fp32 weight/vector gradients, dh, the LN backward and
// every accumulator.
//
// Bounds on this card: at SiT-tiny B=256 the backward is ~186 GFLOP (dX and
// dW GEMMs ~145, the attention's four gradient products ~41), about 0.19 ms
// at the 989 TFLOP/s bf16 peak; its own inputs and outputs (x, g, weights,
// dx, the 11 gradients) are ~97 MB, 0.03 ms at 3.35 TB/s, so the bound is
// the operations'. Reading back what the forward kept (~0.6 GB, 0.18 ms of
// HBM traffic) is this design's cost, not the bound's.
//
// Every product runs on gemm.cuh's engine (TMA into an mbarrier ring, two
// consumer warpgroups on m64n192k16 wgmma, a persistent grid).
// dX = dY W reads W as (K = out, N = in), N-major; dW = dY^T X reads both
// operands along the token rows, MN-major; nothing is transposed in device
// memory.
//
// Weight gradients reduce over M = B*N = 82,176 rows into small matrices
// (dW_out is 192x192: two 128x192 tiles). The M reduction is split into
// fp32 partials (about one wave of 132 SMs of tiles, gemm::split_k) and a
// second pass sums them in a fixed order; column sums (bias and LN
// gradients) are per-tile partials reduced the same way. No atomics:
// results repeat bit for bit from run to run.
//
// C interface, loaded with ctypes, as fused_block.cu: each entry returns 0 or
// the first CUDA error, synchronises nothing and allocates nothing.

#include <algorithm>

#include "flash_attention.cuh"
#include "gemm.cuh"

namespace {

using namespace svt;

// ---------------------------------------------------------------------------
// Fixed-order sums of partials.

// out[i] = sum_{q < P} part[q * stride + i], summed in order q = 0, 1, ...
__global__ void reduce_kernel(const float* __restrict__ part, int P, long long stride, int count,
                              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int q = 0; q < P; ++q) s += part[q * stride + i];
  out[i] = s;
}

// ---------------------------------------------------------------------------
// LayerNorm backward, one warp per row, LNB_ROWS rows per warp:
//   n = (x - mean) * rstd, d = dh * gamma,
//   out = (d - mean(d) - n * mean(d * n)) * rstd + res
// with res the row's residual cotangent: row r = (sample r / seg, i = r % seg)
// has one iff i < res_seg, at res[(r / seg) * res_seg + i]. Column sums per
// CTA, in fixed order: [cta][q][dim] for q = sum dh*n, sum dh, sum res,
// sum out (the first nsum of them). A lane holds C values of a row: C = 12
// up to dim 384, C = 24 up to dim 768 (SiT-base), so the smaller widths keep
// their registers.

constexpr int LNB_WARPS = 8, LNB_ROWS = 32, LNB_MAX_DIM = 768;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename RT, int C>
__global__ void __launch_bounds__(LNB_WARPS * 32)
    ln_bwd_kernel(const float* __restrict__ dh, const bf16* __restrict__ x,
                  const float* __restrict__ stats, const float* __restrict__ gamma,
                  const RT* __restrict__ res, int seg, int res_seg, float* __restrict__ out_f,
                  bf16* __restrict__ out_b, float* __restrict__ colpart, int nsum, int rows,
                  int dim) {
  __shared__ float sred[4][C * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[4][C];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[q][j] = 0.f;

  const int r0 = (blockIdx.x * LNB_WARPS + warp) * LNB_ROWS;
  for (int rr = 0; rr < LNB_ROWS; ++rr) {
    const int r = r0 + rr;
    if (r >= rows) break;
    const float mu = stats[2LL * r], rstd = stats[2LL * r + 1];
    const long long off = (long long)r * dim;
    float n[C], d[C];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = lane + 32 * j;
      n[j] = d[j] = 0.f;
      if (c < dim) {
        const float dv = dh[off + c];
        n[j] = (__bfloat162float(x[off + c]) - mu) * rstd;
        d[j] = dv * gamma[c];
        s1 += d[j];
        s2 += d[j] * n[j];
        acc[0][j] += dv * n[j];
        acc[1][j] += dv;
      }
    }
    s1 = warp_sum(s1) / dim;
    s2 = warp_sum(s2) / dim;
    const int i = r % seg;
    const RT* rrow = i < res_seg ? res + ((long long)(r / seg) * res_seg + i) * dim : nullptr;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = lane + 32 * j;
      if (c < dim) {
        const float rv = rrow != nullptr ? to_f(rrow[c]) : 0.f;
        const float o = (d[j] - s1 - n[j] * s2) * rstd + rv;
        acc[2][j] += rv;
        acc[3][j] += o;
        if (out_f != nullptr) out_f[off + c] = o;
        if (out_b != nullptr) out_b[off + c] = __float2bfloat16(o);
      }
    }
  }

  for (int w = 0; w < LNB_WARPS; ++w) {  // warps add in turn: fixed order
    if (warp == w)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int c = lane + 32 * j;
          if (q < nsum && c < dim) sred[q][c] = (w == 0 ? 0.f : sred[q][c]) + acc[q][j];
        }
    __syncthreads();
  }
  for (int q = 0; q < nsum; ++q)
    for (int c = threadIdx.x; c < dim; c += blockDim.x)
      colpart[((long long)blockIdx.x * nsum + q) * dim + c] = sred[q][c];
}

// ---------------------------------------------------------------------------
// Host-side launch helpers (all on `st`, no synchronisation).

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// Splits of a dW product's K (the token rows): gemm::split_k's rule.
int dw_splits(int Mout, int Nout, int K) {
  int splits, chunk;
  gemm::split_k(Mout, Nout, K, &splits, &chunk);
  return splits;
}

int ln_bwd_ctas(int rows) { return ceil_div(rows, LNB_WARPS * LNB_ROWS); }

cudaError_t reduce(const float* part, int P, long long stride, int count, float* out,
                   cudaStream_t st) {
  reduce_kernel<<<ceil_div(count, 256), 256, 0, st>>>(part, P, stride, count, out);
  return cudaGetLastError();
}

// out (Mout, Nout) fp32 = A^T B: A (K rows, lda) holds the Mout columns,
// B (K rows through its row map, ldb) the Nout columns; split-K partials in
// `part`, then summed in order.
cudaError_t weight_grad(const bf16* A, int lda, const bf16* B, int ldb, int b_rpg, int b_gstride,
                        int Mout, int Nout, int K, float* out, float* part, cudaStream_t st) {
  int s = 0;
  const cudaError_t e = gemm::weight_grad_partials(gemm::Operand{A, K, Mout, lda},
                                                   gemm::Operand{B, K, Nout, ldb, b_rpg, b_gstride},
                                                   part, &s, st);
  if (e != cudaSuccess) return e;
  return reduce(part, s, (long long)Mout * Nout, Mout * Nout, out, st);
}

// C (M, N) = A W: A (M, K) row-major (lda), W the torch (out=K, in=N) weight;
// fp32 C (Cf), bf16 C (Cb), bf16 C * gelu'(pre) with per-tile column sums
// (colpart), or fp32 C added into Cf's rows through (c_rpg, c_gstride).
template <int EPI>
cudaError_t gemm_nn(const bf16* A, int lda, const bf16* W, int M, int N, int K, float* Cf,
                    bf16* Cb, int ldc, cudaStream_t st, const float* pre = nullptr,
                    float* colpart = nullptr, int c_rpg = 1, int c_gstride = 1) {
  gemm::Epilogue ep;
  ep.cf = Cf;
  ep.cb = Cb;
  ep.ldc = ldc;
  ep.pre = const_cast<float*>(pre);
  ep.colpart = colpart;
  ep.c_rpg = c_rpg;
  ep.c_gstride = c_gstride;
  return gemm::linear_dx<EPI>(gemm::Operand{A, M, K, lda}, W, N, ep, st);
}

// LayerNorm backward over `rows` rows, then its column sums into vecs[q]
// (q < nsum: dscale, dbias, sum res, sum out).
template <typename RT>
cudaError_t ln_bwd(const float* dh, const bf16* x, const float* stats, const float* gamma,
                   const RT* res, int seg, int res_seg, float* out_f, bf16* out_b, int rows,
                   int dim, float* part, int nsum, float* const* vecs, cudaStream_t st) {
  const int ctas = ln_bwd_ctas(rows);
  auto kernel = dim <= 384 ? ln_bwd_kernel<RT, 12> : ln_bwd_kernel<RT, 24>;
  kernel<<<ctas, LNB_WARPS * 32, 0, st>>>(dh, x, stats, gamma, res, seg, res_seg, out_f, out_b,
                                          part, nsum, rows, dim);
  cudaError_t e = cudaGetLastError();
  for (int q = 0; q < nsum && e == cudaSuccess; ++q)
    e = reduce(part + (long long)q * dim, ctas, (long long)nsum * dim, dim, vecs[q], st);
  return e;
}

// The attention backward on the chain's packed activations (B, rows, ld),
// head h at columns h * dh: the streamed kernels of flash_attention.cu.
cudaError_t attn_bwd(const bf16* Q, int ldq, int nq, const bf16* K, const bf16* V, int ldkv, int n,
                     const bf16* O, const bf16* dO, int ldo, const float* lse, float* delta,
                     float* ws, bf16* dQ, int lddq, bf16* dK, bf16* dV, int lddkv, int B,
                     int heads, int dh, int valid_len, cudaStream_t st) {
  return flash_bwd(packed(Q, nq, ldq, dh), packed(K, n, ldkv, dh), packed(V, n, ldkv, dh),
                   packed(O, nq, ldo, dh), packed(dO, nq, ldo, dh), lse, delta, ws,
                   packed(dQ, nq, lddq, dh), packed(dK, n, lddkv, dh), packed(dV, n, lddkv, dh), B,
                   heads, nq, n, valid_len, dh, st);
}

// The MLP branch of either block over its Mr rows (all B*N rows, or the CLS
// block's B*rows): g -> dx1 (fp32 and bf16) and the MLP/LN2/out-bias grads.
int mlp_branch_bwd(const bf16* g, const bf16* w_fc1, const bf16* w_fc2, const float* ln2_s,
                   const bf16* x1, const bf16* h2, const float* fpre, const bf16* f,
                   const float* stats2, float* d_ln2_s, float* d_ln2_b, float* d_wfc1,
                   float* d_bfc1, float* d_wfc2, float* d_bfc2, float* d_bout, bf16* df1,
                   float* dh, float* dx1, bf16* dx1b, float* part, int Mr, int seg, int dim,
                   int mlp, cudaStream_t st) {
  SVT_TRY(weight_grad(g, dim, f, mlp, 0, 0, dim, mlp, Mr, d_wfc2, part, st));
  SVT_TRY(gemm_nn<gemm::B_GELU_GRAD>(g, dim, w_fc2, Mr, mlp, dim, nullptr, df1, mlp, st, fpre,
                                     part));
  SVT_TRY(reduce(part, ceil_div(Mr, gemm::BM), mlp, mlp, d_bfc1, st));
  SVT_TRY(weight_grad(df1, mlp, h2, dim, 0, 0, mlp, dim, Mr, d_wfc1, part, st));
  SVT_TRY(gemm_nn<gemm::B_F32>(df1, mlp, w_fc1, Mr, dim, mlp, dh, nullptr, dim, st));
  float* const vecs[4] = {d_ln2_s, d_ln2_b, d_bfc2, d_bout};
  SVT_TRY(ln_bwd<bf16>(dh, x1, stats2, ln2_s, g, seg, seg, dx1, dx1b, Mr, dim, part, 4, vecs,
                       st));
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Floats of fp32 workspace (`ws`) the backward entries need: the largest set
// of split-K or column partials any one of their steps holds, or the
// attention backward's dQ sums.
long long svt_block_bwd_workspace(int B, int N, int rows, int dim, int heads, int dim_head,
                                  int mlp) {
  const int M = B * N, Mt = B * rows, hd = heads * dim_head;
  long long need = 0;
  const int dw[][3] = {{dim, mlp, Mt},    {mlp, dim, Mt},    {dim, hd, Mt}, {dim, mlp, M},
                       {mlp, dim, M},     {dim, hd, M},      {3 * hd, dim, M},
                       {hd, dim, Mt},     {2 * hd, dim, M}};
  for (const auto& s : dw)
    need = std::max(need, (long long)dw_splits(s[0], s[1], s[2]) * s[0] * s[1]);
  need = std::max(need, (long long)ceil_div(M, gemm::BM) * mlp);
  need = std::max(need, (long long)ln_bwd_ctas(M) * 4 * dim);
  return std::max(need, flash_bwd_workspace(B, heads, rows, dim_head));  // the attention's dQ sums
}

// Backward of svt_fused_block_train_fwd. In: x (B, N, dim) and g = dL/dout
// (B, N, dim) bf16; the bf16 weights; what the training forward kept. Out:
// dx (B, N, dim) bf16; d_ln1_s, d_ln1_b, d_bout, d_ln2_s, d_ln2_b, d_bfc1,
// d_bfc2 (vectors) and d_wqkv (3hd, dim), d_wout (dim, hd), d_wfc1
// (mlp, dim), d_wfc2 (dim, mlp), all fp32 in the torch (out, in) layout.
// Scratch: df1 (B*N, mlp) bf16, dh (B*N, dim) fp32, dx1 (B*N, dim) fp32,
// dx1b (B*N, dim) bf16, da (B*N, hd) bf16, dqkv (B*N, 3hd) bf16, delta
// (B, heads, N) fp32, ws (svt_block_bwd_workspace floats).
int svt_fused_block_bwd(void* x, void* g, void* ln1_s, void* w_qkv, void* w_out, void* ln2_s,
                        void* w_fc1, void* w_fc2, void* h1, void* qkv, void* attn, void* lse,
                        void* x1, void* h2, void* fpre, void* f, void* stats1, void* stats2,
                        void* dx, void* d_ln1_s, void* d_ln1_b, void* d_wqkv, void* d_wout,
                        void* d_bout, void* d_ln2_s, void* d_ln2_b, void* d_wfc1, void* d_bfc1,
                        void* d_wfc2, void* d_bfc2, void* df1, void* dh, void* dx1, void* dx1b,
                        void* da, void* dqkv, void* delta, void* ws, int B, int N, int dim,
                        int heads, int dim_head, int mlp, int valid_len, int device,
                        void* stream) {
  if ((dim_head != ATT_DH && dim_head != 32) || dim > LNB_MAX_DIM)
    return (int)cudaErrorInvalidValue;
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N, hd = heads * dim_head;
  float* part = static_cast<float*>(ws);
  bf16* dx1b_ = static_cast<bf16*>(dx1b);
  bf16* dqkv_ = static_cast<bf16*>(dqkv);
  const bf16* qkv_ = static_cast<const bf16*>(qkv);

  const int err = mlp_branch_bwd(
      (const bf16*)g, (const bf16*)w_fc1, (const bf16*)w_fc2, (const float*)ln2_s,
      (const bf16*)x1, (const bf16*)h2, (const float*)fpre, (const bf16*)f, (const float*)stats2,
      (float*)d_ln2_s, (float*)d_ln2_b, (float*)d_wfc1, (float*)d_bfc1, (float*)d_wfc2,
      (float*)d_bfc2, (float*)d_bout, (bf16*)df1, (float*)dh, (float*)dx1, dx1b_, part, M, N, dim,
      mlp, st);
  if (err) return err;
  SVT_TRY(weight_grad(dx1b_, dim, (const bf16*)attn, hd, 0, 0, dim, hd, M, (float*)d_wout, part,
                      st));
  SVT_TRY(gemm_nn<gemm::B_BF16>(dx1b_, dim, (const bf16*)w_out, M, hd, dim, nullptr, (bf16*)da, hd,
                           st));
  SVT_TRY(attn_bwd(qkv_, 3 * hd, N, qkv_ + hd, qkv_ + 2 * hd, 3 * hd, N, (const bf16*)attn,
                   (const bf16*)da, hd, (const float*)lse, (float*)delta, part, dqkv_, 3 * hd,
                   dqkv_ + hd, dqkv_ + 2 * hd, 3 * hd, B, heads, dim_head, valid_len, st));
  SVT_TRY(weight_grad(dqkv_, 3 * hd, (const bf16*)h1, dim, 0, 0, 3 * hd, dim, M, (float*)d_wqkv,
                      part, st));
  SVT_TRY(gemm_nn<gemm::B_F32>(dqkv_, 3 * hd, (const bf16*)w_qkv, M, dim, 3 * hd, (float*)dh,
                               nullptr, dim, st));
  float* const vecs[2] = {(float*)d_ln1_s, (float*)d_ln1_b};
  SVT_TRY(ln_bwd<float>((const float*)dh, (const bf16*)x, (const float*)stats1,
                        (const float*)ln1_s, (const float*)dx1, N, N, nullptr, (bf16*)dx, M, dim,
                        part, 2, vecs, st));
  return (int)cudaSuccess;
}

// Backward of svt_fused_block_cls_train_fwd: g = dL/dout (B, rows, dim)
// bf16. Outputs as svt_fused_block_bwd (dx covers all N rows). Scratch: df1
// (B*rows, mlp) bf16, dh (B*N, dim) fp32, dx1 (B*rows, dim) fp32, dx1b
// (B*rows, dim) bf16, da (B*rows, hd) bf16, dq (B*rows, hd) bf16, dkv
// (B*N, 2hd) bf16, delta (B, heads, rows) fp32, ws.
int svt_fused_block_cls_bwd(void* x, void* g, void* ln1_s, void* w_qkv, void* w_out,
                            void* ln2_s, void* w_fc1, void* w_fc2, void* h1, void* kv, void* q,
                            void* attn, void* lse, void* x1, void* h2, void* fpre, void* f,
                            void* stats1, void* stats2, void* dx, void* d_ln1_s, void* d_ln1_b,
                            void* d_wqkv, void* d_wout, void* d_bout, void* d_ln2_s,
                            void* d_ln2_b, void* d_wfc1, void* d_bfc1, void* d_wfc2,
                            void* d_bfc2, void* df1, void* dh, void* dx1, void* dx1b, void* da,
                            void* dq, void* dkv, void* delta, void* ws, int B, int N, int rows,
                            int dim, int heads, int dim_head, int mlp, int valid_len, int device,
                            void* stream) {
  if (dim_head != ATT_DH || dim > LNB_MAX_DIM || rows < 1 || rows > N)
    return (int)cudaErrorInvalidValue;
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N, Mt = B * rows, hd = heads * dim_head;
  float* part = static_cast<float*>(ws);
  const bf16* wq = static_cast<const bf16*>(w_qkv);
  const bf16* wkv = wq + (long long)hd * dim;
  const bf16* kv_ = static_cast<const bf16*>(kv);
  bf16* dx1b_ = static_cast<bf16*>(dx1b);
  bf16* dq_ = static_cast<bf16*>(dq);
  bf16* dkv_ = static_cast<bf16*>(dkv);
  float* dh_ = static_cast<float*>(dh);

  const int err = mlp_branch_bwd(
      (const bf16*)g, (const bf16*)w_fc1, (const bf16*)w_fc2, (const float*)ln2_s,
      (const bf16*)x1, (const bf16*)h2, (const float*)fpre, (const bf16*)f, (const float*)stats2,
      (float*)d_ln2_s, (float*)d_ln2_b, (float*)d_wfc1, (float*)d_bfc1, (float*)d_wfc2,
      (float*)d_bfc2, (float*)d_bout, (bf16*)df1, dh_, (float*)dx1, dx1b_, part, Mt, rows, dim,
      mlp, st);
  if (err) return err;
  SVT_TRY(weight_grad(dx1b_, dim, (const bf16*)attn, hd, 0, 0, dim, hd, Mt, (float*)d_wout, part,
                      st));
  SVT_TRY(gemm_nn<gemm::B_BF16>(dx1b_, dim, (const bf16*)w_out, Mt, hd, dim, nullptr, (bf16*)da, hd,
                           st));
  SVT_TRY(attn_bwd((const bf16*)q, hd, rows, kv_, kv_ + hd, 2 * hd, N, (const bf16*)attn,
                   (const bf16*)da, hd, (const float*)lse, (float*)delta, part, dq_, hd, dkv_,
                   dkv_ + hd, 2 * hd, B, heads, ATT_DH, valid_len, st));
  // dW_qkv rows [0, hd) from the top rows' dq, rows [hd, 3hd) from every row's dk/dv
  SVT_TRY(weight_grad(dq_, hd, (const bf16*)h1, dim, rows, N, hd, dim, Mt, (float*)d_wqkv, part,
                      st));
  SVT_TRY(weight_grad(dkv_, 2 * hd, (const bf16*)h1, dim, 0, 0, 2 * hd, dim, M,
                      (float*)d_wqkv + (long long)hd * dim, part, st));
  SVT_TRY(gemm_nn<gemm::B_F32>(dkv_, 2 * hd, wkv, M, dim, 2 * hd, dh_, nullptr, dim, st));
  SVT_TRY(gemm_nn<gemm::B_ADD_F32>(dq_, hd, wq, Mt, dim, hd, dh_, nullptr, dim, st, nullptr,
                                   nullptr, rows, N));
  float* const vecs[2] = {(float*)d_ln1_s, (float*)d_ln1_b};
  SVT_TRY(ln_bwd<float>(dh_, (const bf16*)x, (const float*)stats1, (const float*)ln1_s,
                        (const float*)dx1, N, rows, nullptr, (bf16*)dx, M, dim, part, 2, vecs,
                        st));
  return (int)cudaSuccess;
}

// The backward's products alone, for holding them against their plain
// versions. C (M, N) = A (M, K) W, W the torch (out = K, in = N) weight:
// epi 0 = fp32 C into Cf, 1 = bf16 C into Cb, 2 = bf16 C * gelu'(pre) into
// Cb (pre fp32 (M, N)) with the column sums of each 128-row tile into
// colpart (ceil(M / 128), N).
int svt_block_gemm_nn(int epi, void* A, void* W, void* Cf, void* Cb, void* pre, void* colpart,
                      int M, int N, int K, int device, void* stream) {
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* w = static_cast<const bf16*>(W);
  if (epi == 0) return (int)gemm_nn<gemm::B_F32>(a, K, w, M, N, K, (float*)Cf, nullptr, N, st);
  if (epi == 1) return (int)gemm_nn<gemm::B_BF16>(a, K, w, M, N, K, nullptr, (bf16*)Cb, N, st);
  if (epi == 2)
    return (int)gemm_nn<gemm::B_GELU_GRAD>(a, K, w, M, N, K, nullptr, (bf16*)Cb, N, st,
                                           (const float*)pre, (float*)colpart);
  return (int)cudaErrorInvalidValue;
}

// out (Mout, Nout) fp32 = A^T B over K rows: A (K, Mout), B (K, Nout) bf16;
// part: svt_block_weight_grad_workspace floats.
int svt_block_weight_grad(void* A, void* B, void* out, void* part, int Mout, int Nout, int K,
                          int device, void* stream) {
  SVT_TRY(cudaSetDevice(device));
  return (int)weight_grad((const bf16*)A, Mout, (const bf16*)B, Nout, 0, 0, Mout, Nout, K,
                          (float*)out, (float*)part, static_cast<cudaStream_t>(stream));
}

long long svt_block_weight_grad_workspace(int Mout, int Nout, int K) {
  return (long long)dw_splits(Mout, Nout, K) * Mout * Nout;
}

#ifdef SVT_GEMM_PROFILE
// The engine's cycle counts (gemm.cuh), read and zeroed.
int svt_gemm_profile_bwd(unsigned long long* out) { return svt::gemm::profile_read(out); }
#endif

}  // extern "C"
