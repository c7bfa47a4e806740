// Hopper (sm_90a) kernels for the SiT transformer block backward.
//
// Replaces the TPU block-backward kernels in
// surface_vision_transformers_tpu/ops/pallas/fused_block.py:
//   fused_block_train      backward: _block_bwd (_block_bwd_kernel) and
//                          _block_bwd_split (_mlp_bwd_kernel[_chunked],
//                          _attn_bwd_kernel)            -> svt_fused_block_bwd
//   fused_block_cls_train  backward: _block_cls_bwd (_block_cls_bwd_kernel)
//                          and _block_cls_bwd_split     -> svt_fused_block_cls_bwd
// Both JAX routes compute the same gradients; one chain serves every width
// up to dim 768 and every head dim >= 1 (heads laid out in head_cols columns,
// as fused_block.cu's). MS-SiT's
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
//   attention backward (flash_attention.cu: at dh 32 up to 320 keys one
//                       resident launch; the CLS block's 8 queries one
//                       few-query launch; else a delta pass, one wgmma pass
//                       over key blocks and the dq pass, its dQ sums in ws)
//   dW_qkv = dqkv^T h1        dh1 = dqkv W_qkv -> LN1 backward (+ dx1) = dx
// Up to dim LN_EPILOGUE_MAX_DIM (192: a GEMM tile holds whole rows) each
// LayerNorm backward runs in the epilogue of the product that makes its dh
// (gemm.cuh B_LN2, B_LN1), so dh never reaches device memory; the CLS
// block's LN1, whose dh is dkv W_kv over every row plus dq W_q on the top
// rows, makes the small fp32 dq W_q share first and adds it, with the top
// rows' dx1, in dkv W_kv's epilogue (B_LN1_TOP) where cls_ln1_epilogue
// says. Wider blocks, and the CLS block elsewhere, write dh in fp32 and run
// the standalone ln_bwd_kernel.
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
#include <type_traits>

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

// Many partials (the column sums of every 128-row tile: 10,240 at MS-SiT's
// stage 0), where one thread a column would walk them all in turn: chunk
// blockIdx.y of REDUCE_CHUNK partials summed in order into its first
// partial's slot, for reduce_kernel to add the chunks in order. The order
// depends on P alone.
constexpr int REDUCE_CHUNK = 64, REDUCE_PASS_MIN = 1024;
__global__ void reduce_chunks_kernel(float* __restrict__ part, int P, long long stride,
                                     int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int q0 = blockIdx.y * REDUCE_CHUNK, q1 = min(P, q0 + REDUCE_CHUNK);
  float s = 0.f;
  for (int q = q0; q < q1; ++q) s += part[q * stride + i];
  part[q0 * stride + i] = s;
}

// The column sums of a LayerNorm pass (gemm.cuh's epilogues, ln_bwd_kernel),
// part[cta][q][count] for q < nsum, in one launch: out.p[q][i] = sum_{c < P}
// part[c][q][i] in order c = 0, 1, ..., reduce_kernel's sums (blockIdx.y =
// q), where a launch per q ran before.
struct SumOuts {
  float* p[4];
};
__global__ void reduce_sums_kernel(const float* __restrict__ part, int P, int nsum, int count,
                                   SumOuts out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x, q = blockIdx.y;
  if (i >= count) return;
  const float* base = part + (long long)q * count;
  const long long stride = (long long)nsum * count;
  float s = 0.f;
  for (int c = 0; c < P; ++c) s += base[c * stride + i];
  out.p[q][i] = s;
}

// ---------------------------------------------------------------------------
// LayerNorm backward, standalone (dims above LN_EPILOGUE_MAX_DIM): a group
// of G warps per pair of rows, both rows' loads issued before either row's
// sums, so that a group keeps two rows in flight; groups walk the pairs
// with the grid's stride:
//   n = (x - mean) * rstd, d = dh * gamma,
//   out = (d - mean(d) - n * mean(d * n)) * rstd + res
// over the row's first n_true of its dim columns (the means divide by
// n_true; a padded layout, fused_block.cu) and 0 past them, with res the
// row's residual cotangent: row r = (sample r / seg, i = r % seg)
// has one iff i < res_seg, at res[(r / seg) * res_seg + i]. Thread L of a
// group holds C4 pieces of 4 columns (4 (L + 32 G p) ..): 16-byte loads of dh
// and of an fp32 residual, 8-byte ones of x and of a bf16 residual, kept
// packed until used. Past dim 384 a row takes G = 2 warps, so that a thread
// holds what it does at dim 384 (with one warp a row, dim 768 took 255
// registers and spilled); the two warps' row sums meet in shared memory,
// added in warp order, behind a barrier of the pair. Column sums per CTA, in
// fixed order: [cta][q][dim] for q = sum dh*n, sum dh, and with NSUM 4 sum
// res, sum out. At most LNB_CTAS CTAs, whatever the card, so that the sums'
// order is the shape's alone: one an SM of an H100, all that fits (175-179
// registers a thread); twice as many ran in two waves and left reduce twice
// the partials (scripts/ln_bwd_tilings.py).

constexpr int LNB_WARPS = 8, LNB_CTAS = 132, LNB_MAX_DIM = 768;
constexpr int LN_EPILOGUE_MAX_DIM = gemm::BN;  // dims <= this fold LN into dh's product
constexpr int CLS_MAX_ROWS = 8;  // the CLS block's top rows: min(8, N) of each sample

// Whether the CLS block's LN1 backward runs in dkv W_kv's epilogue
// (B_LN1_TOP): a tile holds whole rows, and of an epilogue thread's two
// rows, 8 apart, at most one is a top row, which holds where rows <= 8 and
// N >= rows + 8 (row r with r % N < rows has (r + 8) % N = r % N + 8 >=
// rows). Else (N < 16 at 8 rows) dkv W_kv's fp32 product takes the top
// rows' share (B_F32 with `top`) and the standalone ln_bwd reads it.
bool cls_ln1_epilogue(int N, int rows, int dim) {
  return dim <= LN_EPILOGUE_MAX_DIM && rows <= CLS_MAX_ROWS && N >= rows + 8;
}

__device__ __forceinline__ void ld4(const float* p, float4& v) {
  v = *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void ld4(const bf16* p, uint2& v) {
  v = *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ float get(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ float get(const uint2& v, int e) {
  const uint32_t w = e < 2 ? v.x : v.y;
  return __uint_as_float(e & 1 ? w & 0xFFFF0000u : w << 16);  // bf16 -> fp32
}

template <typename RT, int C4, int NSUM, int G>
__global__ void __launch_bounds__(LNB_WARPS * 32)
    ln_bwd_kernel(const float* __restrict__ dh, const bf16* __restrict__ x,
                  const float* __restrict__ stats, const float* __restrict__ gamma,
                  const RT* __restrict__ res, int seg, int res_seg, float* __restrict__ out_f,
                  bf16* __restrict__ out_b, float* __restrict__ colpart, int rows, int dim,
                  int n_true) {
  using Raw = typename std::conditional<sizeof(RT) == 4, float4, uint2>::type;
  constexpr int GROUPS = LNB_WARPS / G;
  __shared__ __align__(16) float sgam[LNB_MAX_DIM];
  __shared__ float sred[NSUM][LNB_MAX_DIM];
  __shared__ float4 srow[2][LNB_WARPS];  // a warp's row sums, by the pair's parity
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = warp / G, L = (warp % G) * 32 + lane;
  for (int c = threadIdx.x; c < dim; c += blockDim.x) sgam[c] = gamma[c];
  __syncthreads();
  float acc[NSUM][C4][4];
#pragma unroll
  for (int q = 0; q < NSUM; ++q)
#pragma unroll
    for (int p = 0; p < C4; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][p][e] = 0.f;

  const int pairs = (rows + 1) / 2;
  int parity = 0;
  for (int pr = blockIdx.x * GROUPS + group; pr < pairs; pr += gridDim.x * GROUPS) {
    float4 dv[2][C4];
    uint2 xv[2][C4];
    Raw rv[2][C4];
    float mu[2], rstd[2];
    bool has_res[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // both rows' loads first
      const int r = 2 * pr + k;
      const bool ok = r < rows;
      const long long off = (long long)r * dim;
      const int i = ok ? r % seg : 0;
      const RT* rrow =
          ok && i < res_seg ? res + ((long long)(r / seg) * res_seg + i) * dim : nullptr;
      has_res[k] = rrow != nullptr;
      const float2 st =
          ok ? *reinterpret_cast<const float2*>(stats + 2LL * r) : make_float2(0.f, 0.f);
      mu[k] = st.x;
      rstd[k] = st.y;
#pragma unroll
      for (int p = 0; p < C4; ++p) {
        const int c = 4 * (L + 32 * G * p);
        const bool in = ok && c < dim;
        dv[k][p] = make_float4(0.f, 0.f, 0.f, 0.f);
        xv[k][p] = make_uint2(0u, 0u);
        rv[k][p] = Raw{};
        if (in) {
          ld4(dh + off + c, dv[k][p]);
          ld4(x + off + c, xv[k][p]);
          if (has_res[k]) ld4(rrow + c, rv[k][p]);
        }
      }
    }
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int p = 0; p < C4; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 4 * (L + 32 * G * p) + e;
          const float d = get(dv[k][p], e) * (c < n_true ? sgam[c] : 0.f);
          s1[k] += d;
          s2[k] += d * ((get(xv[k][p], e) - mu[k]) * rstd[k]);
        }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], o);
        s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], o);
      }
    if constexpr (G == 2) {  // the pair's two halves, added in warp order
      if (lane == 0) srow[parity][warp] = make_float4(s1[0], s2[0], s1[1], s2[1]);
      bar_sync(1 + group, 64);
      const float4 a = srow[parity][2 * group], b = srow[parity][2 * group + 1];
      s1[0] = a.x + b.x;
      s2[0] = a.y + b.y;
      s1[1] = a.z + b.z;
      s2[1] = a.w + b.w;
      parity ^= 1;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = 2 * pr + k;
      const long long off = (long long)r * dim;
      const float m1 = s1[k] / n_true, m2 = s2[k] / n_true;
#pragma unroll
      for (int p = 0; p < C4; ++p) {
        const int c = 4 * (L + 32 * G * p);
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dhv = get(dv[k][p], e), rres = has_res[k] ? get(rv[k][p], e) : 0.f;
          const float n = (get(xv[k][p], e) - mu[k]) * rstd[k];
          const float d = dhv * (c + e < n_true ? sgam[c + e] : 0.f);
          o[e] = c + e < n_true ? (d - m1 - n * m2) * rstd[k] + rres : 0.f;
          acc[0][p][e] += dhv * n;
          acc[1][p][e] += dhv;
          if constexpr (NSUM == 4) {
            acc[2][p][e] += rres;
            acc[3][p][e] += r < rows ? o[e] : 0.f;
          }
        }
        if (r < rows && c < dim) {
          if (out_f != nullptr)
            *reinterpret_cast<float4*>(out_f + off + c) = make_float4(o[0], o[1], o[2], o[3]);
          if (out_b != nullptr)
            *reinterpret_cast<uint2*>(out_b + off + c) =
                make_uint2(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]));
        }
      }
    }
  }

  for (int w = 0; w < LNB_WARPS; ++w) {  // warps add in turn: fixed order
    if (warp == w)
#pragma unroll
      for (int q = 0; q < NSUM; ++q)
#pragma unroll
        for (int p = 0; p < C4; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 4 * (L + 32 * G * p) + e;
            if (c < dim) sred[q][c] = (w < G ? 0.f : sred[q][c]) + acc[q][p][e];
          }
    __syncthreads();
  }
  for (int q = 0; q < NSUM; ++q)
    for (int c = threadIdx.x; c < dim; c += blockDim.x)
      colpart[((long long)blockIdx.x * NSUM + q) * dim + c] = sred[q][c];
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

int ln_bwd_ctas(int rows) { return std::min(ceil_div((rows + 1) / 2, LNB_WARPS), LNB_CTAS); }

// The partials are scratch: past REDUCE_PASS_MIN of them, chunk passes
// overwrite them with their chunks' sums until few are left.
cudaError_t reduce(float* part, int P, long long stride, int count, float* out, cudaStream_t st) {
  while (P > REDUCE_PASS_MIN) {
    const int chunks = ceil_div(P, REDUCE_CHUNK);
    reduce_chunks_kernel<<<dim3(ceil_div(count, 256), chunks), 256, 0, st>>>(part, P, stride,
                                                                            count);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    P = chunks;
    stride *= REDUCE_CHUNK;
  }
  reduce_kernel<<<ceil_div(count, 256), 256, 0, st>>>(part, P, stride, count, out);
  return cudaGetLastError();
}

// The nsum column sums of a LayerNorm pass over P CTAs' partials
// (part[cta][q][count]) into vecs[q], one launch.
cudaError_t reduce_sums(const float* part, int P, int nsum, int count, float* const* vecs,
                        cudaStream_t st) {
  SumOuts out{};
  for (int q = 0; q < nsum; ++q) out.p[q] = vecs[q];
  reduce_sums_kernel<<<dim3(ceil_div(count, 256), nsum), 256, 0, st>>>(part, P, nsum, count, out);
  return cudaGetLastError();
}

// out (Mout, Nout) fp32 = A^T B: A (K rows, lda) holds the Mout columns,
// B (K rows through its row map, ldb) the Nout columns; split-K partials in
// `part`, then summed in order. Where K takes one split (the CLS block's
// top rows at SiT-base: 256) the product writes `out` itself, no reduce.
cudaError_t weight_grad(const bf16* A, int lda, const bf16* B, int ldb, int b_rpg, int b_gstride,
                        int Mout, int Nout, int K, float* out, float* part, cudaStream_t st) {
  const bool whole = dw_splits(Mout, Nout, K) == 1;
  int s = 0;
  const cudaError_t e = gemm::weight_grad_partials(gemm::Operand{A, K, Mout, lda},
                                                   gemm::Operand{B, K, Nout, ldb, b_rpg, b_gstride},
                                                   whole ? out : part, &s, st);
  if (e != cudaSuccess || whole) return e;
  return reduce(part, s, (long long)Mout * Nout, Mout * Nout, out, st);
}

// C (M, N) = A W: A (M, K) row-major (lda), W the torch (out=K, in=N) weight;
// fp32 C (Cf; plus the (B * top_rows, N) fp32 `top` on the first top_rows
// rows of each top_seg-row sample), bf16 C (Cb), or bf16 C * gelu'(pre)
// with per-tile column sums (colpart).
template <int EPI>
cudaError_t gemm_nn(const bf16* A, int lda, const bf16* W, int M, int N, int K, float* Cf,
                    bf16* Cb, int ldc, cudaStream_t st, const float* pre = nullptr,
                    float* colpart = nullptr, const float* top = nullptr, int top_rows = 0,
                    int top_seg = 1) {
  gemm::Epilogue ep;
  ep.cf = Cf;
  ep.cb = Cb;
  ep.ldc = ldc;
  ep.pre = const_cast<float*>(pre);
  ep.colpart = colpart;
  ep.top = top;
  ep.top_rows = top_rows;
  ep.top_seg = top_seg;
  return gemm::linear_dx<EPI>(gemm::Operand{A, M, K, lda}, W, N, ep, st);
}

// dh = A W (A (M, K), W the torch (out = K, in = N = dim) weight) with the
// LayerNorm backward (over each row's first ln_n columns) in the product's
// epilogue (dim <= LN_EPILOGUE_MAX_DIM):
// B_LN2 -> dx1 fp32 (out_f) and bf16 (out_b) with residual g (bf16); B_LN1
// -> dx bf16 (out_b) with residual dx1 (fp32); B_LN1_TOP the same where dh
// and the residual dx1 ((B * top_rows, N) fp32 each) join on the first
// top_rows rows of each top_seg-row sample only. Then its column sums into
// vecs[q] (dscale, dbias; B_LN2 also sum res, sum out). dh never exists in
// device memory.
template <int EPI>
cudaError_t gemm_ln(const bf16* A, int lda, const bf16* W, int M, int N, int ln_n, int K,
                    const bf16* x,
                    const float* stats, const float* gamma, const void* res, float* out_f,
                    bf16* out_b, float* part, float* const* vecs, cudaStream_t st,
                    const float* top = nullptr, int top_rows = 0, int top_seg = 1) {
  gemm::Epilogue ep;
  ep.top = top;
  ep.top_rows = top_rows;
  ep.top_seg = top_seg;
  ep.bias = gamma;
  ep.x = x;
  ep.ldx = N;
  ep.stats = stats;
  ep.lres = res;
  ep.ldr = N;
  ep.cf = out_f;
  ep.cb = out_b;
  ep.ldc = N;
  ep.colpart = part;
  ep.ln_n = ln_n;
  const cudaError_t e = gemm::linear_dx<EPI>(gemm::Operand{A, M, K, lda}, W, N, ep, st);
  if (e != cudaSuccess) return e;
  return reduce_sums(part, gemm::ln_ctas(M), EPI == gemm::B_LN2 ? 4 : 2, N, vecs, st);
}

// LayerNorm backward over `rows` rows, then its column sums into vecs[q]
// (q < nsum: dscale, dbias, sum res, sum out).
template <typename RT>
cudaError_t ln_bwd(const float* dh, const bf16* x, const float* stats, const float* gamma,
                   const RT* res, int seg, int res_seg, float* out_f, bf16* out_b, int rows,
                   int dim, int ln_dim, float* part, int nsum, float* const* vecs,
                   cudaStream_t st) {
  if (dim % 4 || (nsum != 2 && nsum != 4)) return cudaErrorInvalidValue;  // 4-column pieces
  const int ctas = ln_bwd_ctas(rows);
  auto kernel = nsum == 2 ? (dim <= 256   ? ln_bwd_kernel<RT, 2, 2, 1>
                             : dim <= 384 ? ln_bwd_kernel<RT, 3, 2, 1>
                                          : ln_bwd_kernel<RT, 3, 2, 2>)
                          : (dim <= 256   ? ln_bwd_kernel<RT, 2, 4, 1>
                             : dim <= 384 ? ln_bwd_kernel<RT, 3, 4, 1>
                                          : ln_bwd_kernel<RT, 3, 4, 2>);
  kernel<<<ctas, LNB_WARPS * 32, 0, st>>>(dh, x, stats, gamma, res, seg, res_seg, out_f, out_b,
                                          part, rows, dim, ln_dim);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_sums(part, ctas, nsum, dim, vecs, st);
}

// The attention backward on the chain's packed activations (B, rows, ld),
// head h at columns h * head_cols(dh): the streamed kernels of
// flash_attention.cu.
cudaError_t attn_bwd(const bf16* Q, int ldq, int nq, const bf16* K, const bf16* V, int ldkv, int n,
                     const bf16* O, const bf16* dO, int ldo, const float* lse, float* delta,
                     float* ws, bf16* dQ, int lddq, bf16* dK, bf16* dV, int lddkv, int B,
                     int heads, int dh, int valid_len, cudaStream_t st) {
  const int dp = head_cols(dh);
  return flash_bwd(packed(Q, nq, ldq, dp), packed(K, n, ldkv, dp), packed(V, n, ldkv, dp),
                   packed(O, nq, ldo, dp), packed(dO, nq, ldo, dp), lse, delta, ws,
                   packed(dQ, nq, lddq, dp), packed(dK, n, lddkv, dp), packed(dV, n, lddkv, dp), B,
                   heads, nq, n, valid_len, dh, st);
}

// The MLP branch of either block over its Mr rows (all B*N rows, or the CLS
// block's B*rows): g -> dx1 (fp32 and bf16) and the MLP/LN2/out-bias grads.
int mlp_branch_bwd(const bf16* g, const bf16* w_fc1, const bf16* w_fc2, const float* ln2_s,
                   const bf16* x1, const bf16* h2, const float* fpre, const bf16* f,
                   const float* stats2, float* d_ln2_s, float* d_ln2_b, float* d_wfc1,
                   float* d_bfc1, float* d_wfc2, float* d_bfc2, float* d_bout, bf16* df1,
                   float* dh, float* dx1, bf16* dx1b, float* part, int Mr, int seg, int dim,
                   int ln_dim, int mlp, cudaStream_t st) {
  SVT_TRY(weight_grad(g, dim, f, mlp, 0, 0, dim, mlp, Mr, d_wfc2, part, st));
  SVT_TRY(gemm_nn<gemm::B_GELU_GRAD>(g, dim, w_fc2, Mr, mlp, dim, nullptr, df1, mlp, st, fpre,
                                     part));
  SVT_TRY(reduce(part, ceil_div(Mr, gemm::BM), mlp, mlp, d_bfc1, st));
  SVT_TRY(weight_grad(df1, mlp, h2, dim, 0, 0, mlp, dim, Mr, d_wfc1, part, st));
  float* const vecs[4] = {d_ln2_s, d_ln2_b, d_bfc2, d_bout};
  if (dim <= LN_EPILOGUE_MAX_DIM)
    return (int)gemm_ln<gemm::B_LN2>(df1, mlp, w_fc1, Mr, dim, ln_dim, mlp, x1, stats2, ln2_s, g,
                                     dx1, dx1b, part, vecs, st);
  SVT_TRY(gemm_nn<gemm::B_F32>(df1, mlp, w_fc1, Mr, dim, mlp, dh, nullptr, dim, st));
  SVT_TRY(ln_bwd<bf16>(dh, x1, stats2, ln2_s, g, seg, seg, dx1, dx1b, Mr, dim, ln_dim, part, 4,
                       vecs, st));
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Floats of fp32 workspace (`ws`) the backward entries need: the largest set
// of split-K or column partials any one of their steps holds, or the
// attention backward's dQ sums.
long long svt_block_bwd_workspace(int B, int N, int rows, int dim, int heads, int dim_head,
                                  int mlp) {
  const int M = B * N, Mt = B * rows, hd = heads * head_cols(dim_head);
  long long need = 0;
  const int dw[][3] = {{dim, mlp, Mt},    {mlp, dim, Mt},    {dim, hd, Mt}, {dim, mlp, M},
                       {mlp, dim, M},     {dim, hd, M},      {3 * hd, dim, M},
                       {hd, dim, Mt},     {2 * hd, dim, M}};
  for (const auto& s : dw)
    need = std::max(need, (long long)dw_splits(s[0], s[1], s[2]) * s[0] * s[1]);
  need = std::max(need, (long long)ceil_div(M, gemm::BM) * mlp);
  need = std::max(need, (long long)ln_bwd_ctas(M) * 4 * dim);
  // the CLS block's top rows' fp32 dq W_q share (rows <= CLS_MAX_ROWS: a
  // full block of so few rows is counted too), then (LN1 in the epilogue)
  // the epilogue's column partials beside it
  if (rows <= CLS_MAX_ROWS)
    need = std::max(need, (long long)Mt * dim + (cls_ln1_epilogue(N, rows, dim)
                                                     ? (long long)gemm::ln_ctas(M) * 2 * dim
                                                     : 0));
  // the attention's dQ sums (none for the resident backward)
  return std::max(need, flash_bwd_workspace(B, heads, rows, N, dim_head));
}

// Floats of fp32 dh scratch the backward entries write (cls_rows: the CLS
// block's top rows, 0 for the full block): B * N * dim where a standalone
// LayerNorm backward reads dh (dims above LN_EPILOGUE_MAX_DIM; the CLS
// block where cls_ln1_epilogue is false), else none.
long long svt_block_bwd_dh_floats(int B, int N, int dim, int cls_rows) {
  const bool standalone =
      cls_rows ? !cls_ln1_epilogue(N, cls_rows, dim) : dim > LN_EPILOGUE_MAX_DIM;
  return standalone ? (long long)B * N * dim : 0;
}

// Backward of svt_fused_block_train_fwd. In: x (B, N, dim) and g = dL/dout
// (B, N, dim) bf16, their LayerNorms over each row's first ln_dim columns
// (a padded layout, fused_block.cu: dx is 0 past them); the bf16 weights;
// what the training forward kept. Out:
// dx (B, N, dim) bf16; d_ln1_s, d_ln1_b, d_bout, d_ln2_s, d_ln2_b, d_bfc1,
// d_bfc2 (vectors) and d_wqkv (3hd, dim), d_wout (dim, hd), d_wfc1
// (mlp, dim), d_wfc2 (dim, mlp), all fp32 in the torch (out, in) layout.
// Scratch: df1 (B*N, mlp) bf16, dh (svt_block_bwd_dh_floats fp32: none up
// to dim 192, where the LayerNorm backwards run in the epilogues of dh's
// products and dh is never written), dx1 (B*N, dim) fp32,
// dx1b (B*N, dim) bf16, da (B*N, hd) bf16, dqkv (B*N, 3hd) bf16, delta
// (B, heads, N) fp32, ws (svt_block_bwd_workspace floats).
int svt_fused_block_bwd(void* x, void* g, void* ln1_s, void* w_qkv, void* w_out, void* ln2_s,
                        void* w_fc1, void* w_fc2, void* h1, void* qkv, void* attn, void* lse,
                        void* x1, void* h2, void* fpre, void* f, void* stats1, void* stats2,
                        void* dx, void* d_ln1_s, void* d_ln1_b, void* d_wqkv, void* d_wout,
                        void* d_bout, void* d_ln2_s, void* d_ln2_b, void* d_wfc1, void* d_bfc1,
                        void* d_wfc2, void* d_bfc2, void* df1, void* dh, void* dx1, void* dx1b,
                        void* da, void* dqkv, void* delta, void* ws, int B, int N, int dim,
                        int ln_dim, int heads, int dim_head, int mlp, int valid_len, int device,
                        void* stream) {
  if (!dim_head_ok(dim_head) || !ln_dim_ok(dim, ln_dim) || dim > LNB_MAX_DIM)
    return (int)cudaErrorInvalidValue;
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N, hd = heads * head_cols(dim_head);
  float* part = static_cast<float*>(ws);
  bf16* dx1b_ = static_cast<bf16*>(dx1b);
  bf16* dqkv_ = static_cast<bf16*>(dqkv);
  const bf16* qkv_ = static_cast<const bf16*>(qkv);

  const int err = mlp_branch_bwd(
      (const bf16*)g, (const bf16*)w_fc1, (const bf16*)w_fc2, (const float*)ln2_s,
      (const bf16*)x1, (const bf16*)h2, (const float*)fpre, (const bf16*)f, (const float*)stats2,
      (float*)d_ln2_s, (float*)d_ln2_b, (float*)d_wfc1, (float*)d_bfc1, (float*)d_wfc2,
      (float*)d_bfc2, (float*)d_bout, (bf16*)df1, (float*)dh, (float*)dx1, dx1b_, part, M, N, dim,
      ln_dim, mlp, st);
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
  float* const vecs[2] = {(float*)d_ln1_s, (float*)d_ln1_b};
  if (dim <= LN_EPILOGUE_MAX_DIM)
    return (int)gemm_ln<gemm::B_LN1>(dqkv_, 3 * hd, (const bf16*)w_qkv, M, dim, ln_dim, 3 * hd,
                                     (const bf16*)x, (const float*)stats1, (const float*)ln1_s,
                                     dx1, nullptr, (bf16*)dx, part, vecs, st);
  SVT_TRY(gemm_nn<gemm::B_F32>(dqkv_, 3 * hd, (const bf16*)w_qkv, M, dim, 3 * hd, (float*)dh,
                               nullptr, dim, st));
  SVT_TRY(ln_bwd<float>((const float*)dh, (const bf16*)x, (const float*)stats1,
                        (const float*)ln1_s, (const float*)dx1, N, N, nullptr, (bf16*)dx, M, dim,
                        ln_dim, part, 2, vecs, st));
  return (int)cudaSuccess;
}

// Backward of svt_fused_block_cls_train_fwd: g = dL/dout (B, rows, dim)
// bf16, rows <= CLS_MAX_ROWS. Outputs as svt_fused_block_bwd (dx covers
// all N rows). Scratch: df1 (B*rows, mlp) bf16, dh (svt_block_bwd_dh_floats
// fp32: none where cls_ln1_epilogue, LN1 then in dkv W_kv's epilogue; the
// top rows' dq W_q share sits at ws's head), dx1 (B*rows, dim) fp32, dx1b
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
                            int dim, int ln_dim, int heads, int dim_head, int mlp, int valid_len,
                            int device, void* stream) {
  if (!dim_head_ok(dim_head) || !ln_dim_ok(dim, ln_dim) || dim > LNB_MAX_DIM || rows < 1 ||
      rows > std::min(N, CLS_MAX_ROWS))
    return (int)cudaErrorInvalidValue;
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N, Mt = B * rows, hd = heads * head_cols(dim_head);
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
      ln_dim, mlp, st);
  if (err) return err;
  SVT_TRY(weight_grad(dx1b_, dim, (const bf16*)attn, hd, 0, 0, dim, hd, Mt, (float*)d_wout, part,
                      st));
  SVT_TRY(gemm_nn<gemm::B_BF16>(dx1b_, dim, (const bf16*)w_out, Mt, hd, dim, nullptr, (bf16*)da, hd,
                           st));
  SVT_TRY(attn_bwd((const bf16*)q, hd, rows, kv_, kv_ + hd, 2 * hd, N, (const bf16*)attn,
                   (const bf16*)da, hd, (const float*)lse, (float*)delta, part, dq_, hd, dkv_,
                   dkv_ + hd, 2 * hd, B, heads, dim_head, valid_len, st));
  // dW_qkv rows [0, hd) from the top rows' dq, rows [hd, 3hd) from every row's dk/dv
  SVT_TRY(weight_grad(dq_, hd, (const bf16*)h1, dim, rows, N, hd, dim, Mt, (float*)d_wqkv, part,
                      st));
  SVT_TRY(weight_grad(dkv_, 2 * hd, (const bf16*)h1, dim, 0, 0, 2 * hd, dim, M,
                      (float*)d_wqkv + (long long)hd * dim, part, st));
  // dh = dkv W_kv over every row + dq W_q on the top rows: the small fp32
  // share first (at ws's head), added where dkv W_kv's product ends
  float* const vecs[2] = {(float*)d_ln1_s, (float*)d_ln1_b};
  float* dqw = part;
  SVT_TRY(gemm_nn<gemm::B_F32>(dq_, hd, wq, Mt, dim, hd, dqw, nullptr, dim, st));
  if (cls_ln1_epilogue(N, rows, dim))  // with LN1's backward in the epilogue: dh never written
    return (int)gemm_ln<gemm::B_LN1_TOP>(dkv_, 2 * hd, wkv, M, dim, ln_dim, 2 * hd,
                                         (const bf16*)x, (const float*)stats1,
                                         (const float*)ln1_s, dx1,
                                         nullptr, (bf16*)dx, part + (long long)Mt * dim, vecs,
                                         st, dqw, rows, N);
  SVT_TRY(gemm_nn<gemm::B_F32>(dkv_, 2 * hd, wkv, M, dim, 2 * hd, dh_, nullptr, dim, st, nullptr,
                               nullptr, dqw, rows, N));
  SVT_TRY(ln_bwd<float>(dh_, (const bf16*)x, (const float*)stats1, (const float*)ln1_s,
                        (const float*)dx1, N, rows, nullptr, (bf16*)dx, M, dim, ln_dim, part, 2,
                        vecs, st));
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

// The LayerNorm epilogue alone: dh = A (M, K) W (W the torch (out = K, in =
// N) weight, N <= 192), then the LayerNorm backward of x's rows (bf16 (M,
// N); stats (M, 2) fp32 mean, rstd; gamma (N,)) plus the residual cotangent
// res: ln 2 = LN2's form (res bf16; out fp32 into Cf and bf16 into Cb; vecs
// (4, N): sum dh n, sum dh, sum res, sum out), ln 1 = LN1's (res fp32; out
// bf16 into Cb; vecs (2, N)). part: svt_block_gemm_ln_workspace floats.
int svt_block_gemm_ln(int ln, void* A, void* W, void* x, void* stats, void* gamma, void* res,
                      void* Cf, void* Cb, void* vecs, void* part, int M, int N, int K, int device,
                      void* stream) {
  if (N > LN_EPILOGUE_MAX_DIM || (ln != 1 && ln != 2)) return (int)cudaErrorInvalidValue;
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* v = static_cast<float*>(vecs);
  float* const rows[4] = {v, v + N, v + 2 * N, v + 3 * N};
  auto launch = ln == 2 ? gemm_ln<gemm::B_LN2> : gemm_ln<gemm::B_LN1>;
  return (int)launch((const bf16*)A, K, (const bf16*)W, M, N, N, K, (const bf16*)x,
                     (const float*)stats, (const float*)gamma, res, (float*)Cf, (bf16*)Cb,
                     (float*)part, rows, st, nullptr, 0, 1);
}

long long svt_block_gemm_ln_workspace(int M, int N) {
  return (long long)gemm::ln_ctas(M) * 4 * N;
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
