// Hopper (sm_90a) kernels for the SiT transformer block backward.
//
// Replaces the TPU block-backward kernels in
// surface_vision_transformers_tpu/ops/pallas/fused_block.py:
//   fused_block_train      backward: _block_bwd (_block_bwd_kernel) and
//                          _block_bwd_split (_mlp_bwd_kernel[_chunked],
//                          _attn_bwd_kernel)            -> svt_fused_block_bwd
//   fused_block_cls_train  backward: _block_cls_bwd (_block_cls_bwd_kernel)
//                          and _block_cls_bwd_split     -> svt_fused_block_cls_bwd
// Both JAX routes compute the same gradients; one chain serves every width.
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
//   attention backward: dQ pass (and delta = rowsum(dO . O)), dK/dV pass
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
// HBM traffic) is this design's cost, not the bound's. The GEMMs use the
// forward's mma.sync
// m16n8k16 tiling (128x64x32, two-stage cp.async), so the same ~10% of peak
// is expected; wgmma/TMA are later work.
//
// Operand layouts: the forward's GEMM reads W[n][k] (K contiguous). Here
// dX = dY W reads W as (K=out, N=in) with N contiguous, and dW = dY^T X
// reads both operands along M (the rows). Both are staged in shared memory
// in their global layout and turned into mma fragments with ldmatrix.trans;
// nothing is transposed in device memory.
//
// Weight gradients reduce over M = B*N = 82,176 rows into small matrices
// (dW_out is 192x192: six 128x64 tiles). The M reduction is split over
// gridDim.z into fp32 partials (about two waves of 132 SMs in all) and a
// second pass sums them in a fixed order; column sums (bias and LN
// gradients) are per-CTA partials reduced the same way. No atomics: results
// repeat bit for bit from run to run.
//
// C interface, loaded with ctypes, as fused_block.cu: each entry returns 0 or
// the first CUDA error, synchronises nothing and allocates nothing.

#include <algorithm>

#include "common.cuh"

namespace {

using namespace svt;

// ---------------------------------------------------------------------------
// GEMM: C[M, N] = sum_k A(m, k) B(k, n), bf16 operands, fp32 accumulation.
//   A_KM false: A(m, k) = A[m * lda + k]  (dY rows; the dX products)
//   A_KM true:  A(m, k) = A[k * lda + m]  (dY^T; the dW products, K = rows)
//   B(k, n) = B[map_row(k) * ldb + n]     (N contiguous: a torch (out, in)
//                                          weight, or the activations X)
// Split-K over gridDim.z in chunks of k_chunk (a multiple of BBK).

enum { BE_PART = 0, BE_F32 = 1, BE_BF16 = 2, BE_GELU_GRAD = 3, BE_ADD_F32 = 4 };

constexpr int BBM = 128, BBN = 64, BBK = 32, B_THREADS = 128;
constexpr int LDA_MK = BBK + 8, LDA_KM = BBM + 8, LDB_KN = BBN + 8;
constexpr int TARGET_CTAS = 264;  // two waves of the H100's 132 SMs

struct GemmArgs {
  const bf16* A;
  int lda;
  const bf16* B;
  int ldb, b_rpg, b_gstride;
  int M, N, K, k_chunk;
  float* Cf;  // BE_PART: partials [split][M][N]; BE_F32, BE_ADD_F32: C (ldc)
  bf16* Cb;   // BE_BF16, BE_GELU_GRAD: C (ldc)
  int ldc, c_rpg, c_gstride;  // output row map (BE_ADD_F32)
  const float* pre;           // BE_GELU_GRAD: fp32 pre-activation (ldc)
  float* colpart;             // BE_GELU_GRAD: column sums per M tile [tile][N]
};

template <bool A_KM, int EPI>
__global__ void __launch_bounds__(B_THREADS) gemm_bwd_kernel(const GemmArgs p) {
  constexpr int A_ELEMS = A_KM ? BBK * LDA_KM : BBM * LDA_MK;
  __shared__ __align__(16) bf16 sA[2][A_ELEMS];
  __shared__ __align__(16) bf16 sB[2][BBK * LDB_KN];
  __shared__ float sCol[4][BBN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BBN, m0 = blockIdx.y * BBM;
  const int kbeg = blockIdx.z * p.k_chunk;
  const int kend = min(p.K, kbeg + p.k_chunk);
  const int KT = kend > kbeg ? (kend - kbeg + BBK - 1) / BBK : 0;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kbeg + kt * BBK;
    if (A_KM) {
#pragma unroll
      for (int i = 0; i < (BBK * BBM / 8) / B_THREADS; ++i) {
        const int c = tid + i * B_THREADS;
        const int kr = c >> 4, mc = (c & 15) * 8;
        const int gk = k0 + kr, gm = m0 + mc;
        const bool ok = gk < kend && gm < p.M;
        const bf16* src = ok ? p.A + (long long)gk * p.lda + gm : p.A;
        cp_async16(&sA[stage][kr * LDA_KM + mc], src, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < (BBM * BBK / 8) / B_THREADS; ++i) {
        const int c = tid + i * B_THREADS;
        const int r = c >> 2, kc = (c & 3) * 8;
        const int gm = m0 + r, gk = k0 + kc;
        const bool ok = gm < p.M && gk < kend;
        const bf16* src = ok ? p.A + (long long)gm * p.lda + gk : p.A;
        cp_async16(&sA[stage][r * LDA_MK + kc], src, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < (BBK * BBN / 8) / B_THREADS; ++i) {
      const int c = tid + i * B_THREADS;
      const int kr = c >> 3, nc = (c & 7) * 8;
      const int gk = k0 + kr, gn = n0 + nc;
      const bool ok = gk < kend && gn < p.N;
      const bf16* src = ok ? p.B + map_row(gk, p.b_rpg, p.b_gstride) * p.ldb + gn : p.B;
      cp_async16(&sB[stage][kr * LDB_KN + nc], src, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  if (KT > 0) {
    load_stage(0, 0);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load_stage((kt + 1) & 1, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a_s = sA[kt & 1];
    const bf16* b_s = sB[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BBK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (A_KM) {
          // stored [k][m]: matrix j covers m + (j & 1) * 8, k + (j >> 1) * 8
          const int j = lane >> 3;
          ldmatrix_x4_trans(af[mi], a_s + (kk + (j >> 1) * 8 + (lane & 7)) * LDA_KM + warp * 32 +
                                        mi * 16 + (j & 1) * 8);
        } else {
          ldmatrix_x4(af[mi], a_s + (warp * 32 + mi * 16 + (lane & 15)) * LDA_MK + kk +
                                  (lane >> 4) * 8);
        }
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, b_s + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB_KN +
                                   nj * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], af[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][2 * nj + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
  float cs[8][2];
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) cs[ni][0] = cs[ni][1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + warp * 32 + mi * 16 + g + half * 8;
      if (r >= p.M) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int c = n0 + ni * 8 + 2 * t;
        if (c >= p.N) continue;
        float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if (EPI == BE_PART) {
          *reinterpret_cast<float2*>(p.Cf + ((long long)blockIdx.z * p.M + r) * p.N + c) =
              make_float2(v0, v1);
        } else if (EPI == BE_F32) {
          *reinterpret_cast<float2*>(p.Cf + (long long)r * p.ldc + c) = make_float2(v0, v1);
        } else if (EPI == BE_ADD_F32) {
          float2* dst = reinterpret_cast<float2*>(
              p.Cf + map_row(r, p.c_rpg, p.c_gstride) * p.ldc + c);
          float2 o = *dst;
          o.x += v0;
          o.y += v1;
          *dst = o;
        } else {
          if (EPI == BE_GELU_GRAD) {
            const float2 f = *reinterpret_cast<const float2*>(p.pre + (long long)r * p.ldc + c);
            v0 *= gelu_erf_grad(f.x);
            v1 *= gelu_erf_grad(f.y);
            cs[ni][0] += v0;
            cs[ni][1] += v1;
          }
          *reinterpret_cast<__nv_bfloat162*>(p.Cb + (long long)r * p.ldc + c) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }

  if (EPI == BE_GELU_GRAD) {  // fp32 column sums of this tile, fixed order
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v = cs[ni][j];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) sCol[warp][ni * 8 + 2 * t + j] = v;
      }
    __syncthreads();
    if (tid < BBN && n0 + tid < p.N)
      p.colpart[(long long)blockIdx.y * p.N + n0 + tid] =
          ((sCol[0][tid] + sCol[1][tid]) + sCol[2][tid]) + sCol[3][tid];
  }
}

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
// sum out (the first nsum of them).

constexpr int LNB_WARPS = 8, LNB_ROWS = 32, LNB_MAXC = 12;  // dim <= 384

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename RT>
__global__ void __launch_bounds__(LNB_WARPS * 32)
    ln_bwd_kernel(const float* __restrict__ dh, const bf16* __restrict__ x,
                  const float* __restrict__ stats, const float* __restrict__ gamma,
                  const RT* __restrict__ res, int seg, int res_seg, float* __restrict__ out_f,
                  bf16* __restrict__ out_b, float* __restrict__ colpart, int nsum, int rows,
                  int dim) {
  __shared__ float sred[4][LNB_MAXC * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[4][LNB_MAXC];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < LNB_MAXC; ++j) acc[q][j] = 0.f;

  const int r0 = (blockIdx.x * LNB_WARPS + warp) * LNB_ROWS;
  for (int rr = 0; rr < LNB_ROWS; ++rr) {
    const int r = r0 + rr;
    if (r >= rows) break;
    const float mu = stats[2LL * r], rstd = stats[2LL * r + 1];
    const long long off = (long long)r * dim;
    float n[LNB_MAXC], d[LNB_MAXC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < LNB_MAXC; ++j) {
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
    for (int j = 0; j < LNB_MAXC; ++j) {
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
        for (int j = 0; j < LNB_MAXC; ++j) {
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
// Attention backward, head dim 64, from the forward's LSE: P = exp(s*scale -
// lse) for keys < valid_len and query rows < valid_len (others contribute
// nothing, as in the TPU kernel), delta = rowsum(dO . O),
// dS = P (dP - delta) * scale. Two passes, no atomics (the split of the TPU
// package's _bwd_tiled): a query pass for dQ (it also writes delta) and a
// key pass for dK and dV.

// dQ: one CTA per (query tile of 64, head, sample); the sample's K and V for
// this head in shared memory, as in the forward; each warp owns 16 queries.
__global__ void __launch_bounds__(ATT_THREADS)
    attn_bwd_dq_kernel(const bf16* __restrict__ Q, int ldq, int nq, const bf16* __restrict__ Kp,
                       const bf16* __restrict__ Vp, int ldkv, int n, const bf16* __restrict__ O,
                       const bf16* __restrict__ dO, int ldo, const float* __restrict__ lse,
                       float* __restrict__ delta, bf16* __restrict__ dQ, int lddq, int valid_len,
                       float scale) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  const int nk = att_keys_padded(n);
  bf16* sQ = reinterpret_cast<bf16*>(att_smem);  // Q tile, then dO tile
  bf16* sK = sQ + ATT_BQ * ATT_LD;
  bf16* sV = sK + nk * ATT_LD;
  const int q0 = blockIdx.x * ATT_BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hoff = h * ATT_DH;
  const long long hrow = ((long long)b * gridDim.y + h) * nq;

  for (int c = tid; c < ATT_BQ * (ATT_DH / 8); c += ATT_THREADS) {
    const int r = c >> 3, dc = (c & 7) * 8;
    const bool ok = q0 + r < nq;
    const bf16* src = ok ? Q + ((long long)b * nq + q0 + r) * ldq + hoff + dc : Q;
    cp_async16(sQ + r * ATT_LD + dc, src, ok);
  }
  for (int c = tid; c < nk * (ATT_DH / 8); c += ATT_THREADS) {
    const int r = c >> 3, dc = (c & 7) * 8;
    const bool ok = r < n;
    const long long off = ((long long)b * n + r) * ldkv + hoff + dc;
    cp_async16(sK + r * ATT_LD + dc, ok ? Kp + off : Kp, ok);
    cp_async16(sV + r * ATT_LD + dc, ok ? Vp + off : Vp, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int qr0 = q0 + warp * 16;
  const bool active = qr0 < nq;
  uint32_t qf[ATT_DH / 16][4], of[ATT_DH / 16][4];
  if (active)
#pragma unroll
    for (int ks = 0; ks < ATT_DH / 16; ++ks)
      ldmatrix_x4(qf[ks], sQ + (warp * 16 + (lane & 15)) * ATT_LD + ks * 16 + (lane >> 4) * 8);
  __syncthreads();
  for (int c = tid; c < ATT_BQ * (ATT_DH / 8); c += ATT_THREADS) {
    const int r = c >> 3, dc = (c & 7) * 8;
    const bool ok = q0 + r < nq;
    const bf16* src = ok ? dO + ((long long)b * nq + q0 + r) * ldo + hoff + dc : dO;
    cp_async16(sQ + r * ATT_LD + dc, src, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;
#pragma unroll
  for (int ks = 0; ks < ATT_DH / 16; ++ks)
    ldmatrix_x4(of[ks], sQ + (warp * 16 + (lane & 15)) * ATT_LD + ks * 16 + (lane >> 4) * 8);

  // delta for the warp's 16 rows: lane pair (2i, 2i+1) sums row i's halves
  const int drow = qr0 + (lane >> 1);
  float dsum = 0.f;
  if (drow < nq) {
    const long long off = ((long long)b * nq + drow) * ldo + hoff + (lane & 1) * 32;
#pragma unroll 8
    for (int d = 0; d < 32; ++d) dsum += __bfloat162float(dO[off + d]) * __bfloat162float(O[off + d]);
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  if (drow < nq && (lane & 1) == 0) delta[hrow + drow] = dsum;

  const int g = lane >> 2, t = lane & 3;
  const int r_lo = qr0 + g, r_hi = qr0 + g + 8;
  const float dl_lo = __shfl_sync(0xffffffffu, dsum, 2 * g);
  const float dl_hi = __shfl_sync(0xffffffffu, dsum, 2 * (g + 8));
  const int qend = min(valid_len, nq);
  const bool ok_lo = r_lo < qend, ok_hi = r_hi < qend;
  const float l_lo = ok_lo ? lse[hrow + r_lo] : 0.f;
  const float l_hi = ok_hi ? lse[hrow + r_hi] : 0.f;
  const int kend = min(valid_len, n);
  const int nchunks = (kend + ATT_BK - 1) / ATT_BK;

  float acc[ATT_DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < ATT_DH / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) {
    float s[4][4], dp[4][4];
    score_chunk(s, qf, sK, ch * ATT_BK, lane);
    score_chunk(dp, of, sV, ch * ATT_BK, lane);  // dP = dO . V^T
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = ch * ATT_BK + nt * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const bool ok = (col + (e & 1)) < kend && (lo ? ok_lo : ok_hi);
        const float pr = ok ? __expf(s[nt][e] * scale - (lo ? l_lo : l_hi)) : 0.f;
        s[nt][e] = pr * (dp[nt][e] - (lo ? dl_lo : dl_hi)) * scale;  // dS
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // dQ += dS . K, 16 keys per mma k-step
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pf[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pf[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pf[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const int key = ch * ATT_BK + j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dq = 0; dq < ATT_DH / 16; ++dq) {
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, sK + key * ATT_LD + dq * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dq], pf, kf[0], kf[1]);
        mma_bf16(acc[2 * dq + 1], pf, kf[2], kf[3]);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < ATT_DH / 8; ++nt) {
    const int d = hoff + nt * 8 + 2 * t;
    if (r_lo < nq)
      *reinterpret_cast<__nv_bfloat162*>(dQ + ((long long)b * nq + r_lo) * lddq + d) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    if (r_hi < nq)
      *reinterpret_cast<__nv_bfloat162*>(dQ + ((long long)b * nq + r_hi) * lddq + d) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}

// dK, dV: one CTA per (key tile of 64, head, sample), each warp owning 16
// keys (their K and V rows as mma A fragments in registers); the CTA walks
// the sample's queries in chunks of 32, staging Q, dO, lse and delta.
constexpr int KV_BK = 64, KV_QC = 32;

__global__ void __launch_bounds__(ATT_THREADS)
    attn_bwd_dkdv_kernel(const bf16* __restrict__ Q, int ldq, int nq,
                         const bf16* __restrict__ Kp, const bf16* __restrict__ Vp, int ldkv, int n,
                         const bf16* __restrict__ dO, int ldo, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dK,
                         bf16* __restrict__ dV, int lddkv, int valid_len, float scale) {
  __shared__ __align__(16) bf16 sK[KV_BK * ATT_LD];
  __shared__ __align__(16) bf16 sV[KV_BK * ATT_LD];
  __shared__ __align__(16) bf16 sQc[KV_QC * ATT_LD];
  __shared__ __align__(16) bf16 sdO[KV_QC * ATT_LD];
  __shared__ float sL[KV_QC], sD[KV_QC];
  const int k0 = blockIdx.x * KV_BK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hoff = h * ATT_DH;
  const long long hrow = ((long long)b * gridDim.y + h) * nq;

  for (int c = tid; c < KV_BK * (ATT_DH / 8); c += ATT_THREADS) {
    const int r = c >> 3, dc = (c & 7) * 8;
    const bool ok = k0 + r < n;
    const long long off = ((long long)b * n + k0 + r) * ldkv + hoff + dc;
    cp_async16(sK + r * ATT_LD + dc, ok ? Kp + off : Kp, ok);
    cp_async16(sV + r * ATT_LD + dc, ok ? Vp + off : Vp, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[ATT_DH / 16][4], vf[ATT_DH / 16][4];
#pragma unroll
  for (int ks = 0; ks < ATT_DH / 16; ++ks) {
    ldmatrix_x4(kf[ks], sK + (warp * 16 + (lane & 15)) * ATT_LD + ks * 16 + (lane >> 4) * 8);
    ldmatrix_x4(vf[ks], sV + (warp * 16 + (lane & 15)) * ATT_LD + ks * 16 + (lane >> 4) * 8);
  }

  const int g = lane >> 2, t = lane & 3;
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  const int kend = min(valid_len, n), qend = min(valid_len, nq);
  float dv[ATT_DH / 8][4], dk[ATT_DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < ATT_DH / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[nt][e] = dk[nt][e] = 0.f;

  for (int qb = 0; qb < qend; qb += KV_QC) {
    __syncthreads();  // the previous chunk's readers are done
    for (int c = tid; c < KV_QC * (ATT_DH / 8); c += ATT_THREADS) {
      const int r = c >> 3, dc = (c & 7) * 8;
      const bool ok = qb + r < nq;
      const long long qo = ((long long)b * nq + qb + r);
      cp_async16(sQc + r * ATT_LD + dc, ok ? Q + qo * ldq + hoff + dc : Q, ok);
      cp_async16(sdO + r * ATT_LD + dc, ok ? dO + qo * ldo + hoff + dc : dO, ok);
    }
    if (tid < KV_QC) {
      const bool ok = qb + tid < nq;
      sL[tid] = ok ? lse[hrow + qb + tid] : 0.f;
      sD[tid] = ok ? delta[hrow + qb + tid] : 0.f;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float st[4][4], dpt[4][4];  // S^T and dP^T: 16 keys x 32 queries
    score_chunk(st, kf, sQc, 0, lane);
    score_chunk(dpt, vf, sdO, 0, lane);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1);
        const int key = e < 2 ? key_lo : key_hi;
        const bool ok = key < kend && qb + ql < qend;
        const float pr = ok ? __expf(st[nt][e] * scale - sL[ql]) : 0.f;
        st[nt][e] = pr;
        dpt[nt][e] = pr * (dpt[nt][e] - sD[ql]) * scale;  // dS^T
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // 16 queries per mma k-step
      uint32_t pf[4], sf[4];
      pf[0] = pack_bf16(st[2 * j][0], st[2 * j][1]);
      pf[1] = pack_bf16(st[2 * j][2], st[2 * j][3]);
      pf[2] = pack_bf16(st[2 * j + 1][0], st[2 * j + 1][1]);
      pf[3] = pack_bf16(st[2 * j + 1][2], st[2 * j + 1][3]);
      sf[0] = pack_bf16(dpt[2 * j][0], dpt[2 * j][1]);
      sf[1] = pack_bf16(dpt[2 * j][2], dpt[2 * j][3]);
      sf[2] = pack_bf16(dpt[2 * j + 1][0], dpt[2 * j + 1][1]);
      sf[3] = pack_bf16(dpt[2 * j + 1][2], dpt[2 * j + 1][3]);
      const int qrow = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dq = 0; dq < ATT_DH / 16; ++dq) {
        uint32_t of[4], qf[4];
        ldmatrix_x4_trans(of, sdO + qrow * ATT_LD + dq * 16 + (lane >> 4) * 8);
        mma_bf16(dv[2 * dq], pf, of[0], of[1]);  // dV += P^T . dO
        mma_bf16(dv[2 * dq + 1], pf, of[2], of[3]);
        ldmatrix_x4_trans(qf, sQc + qrow * ATT_LD + dq * 16 + (lane >> 4) * 8);
        mma_bf16(dk[2 * dq], sf, qf[0], qf[1]);  // dK += dS^T . Q
        mma_bf16(dk[2 * dq + 1], sf, qf[2], qf[3]);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < ATT_DH / 8; ++nt) {
    const int d = hoff + nt * 8 + 2 * t;
    if (key_lo < n) {
      const long long o = ((long long)b * n + key_lo) * lddkv + d;
      *reinterpret_cast<__nv_bfloat162*>(dK + o) = __floats2bfloat162_rn(dk[nt][0], dk[nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(dV + o) = __floats2bfloat162_rn(dv[nt][0], dv[nt][1]);
    }
    if (key_hi < n) {
      const long long o = ((long long)b * n + key_hi) * lddkv + d;
      *reinterpret_cast<__nv_bfloat162*>(dK + o) = __floats2bfloat162_rn(dk[nt][2], dk[nt][3]);
      *reinterpret_cast<__nv_bfloat162*>(dV + o) = __floats2bfloat162_rn(dv[nt][2], dv[nt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host-side launch helpers (all on `st`, no synchronisation).

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// Splits of a dW product's K = rows: about TARGET_CTAS CTAs in all.
int dw_splits(int Mout, int Nout, int K) {
  const int tiles = ceil_div(Mout, BBM) * ceil_div(Nout, BBN);
  return std::max(1, std::min(ceil_div(TARGET_CTAS, tiles), ceil_div(K, BBK)));
}

int dw_k_chunk(int K, int splits) { return ceil_div(ceil_div(K, splits), BBK) * BBK; }

int ln_bwd_ctas(int rows) { return ceil_div(rows, LNB_WARPS * LNB_ROWS); }

cudaError_t reduce(const float* part, int P, long long stride, int count, float* out,
                   cudaStream_t st) {
  reduce_kernel<<<ceil_div(count, 256), 256, 0, st>>>(part, P, stride, count, out);
  return cudaGetLastError();
}

// out (Mout, Nout) fp32 = A^T B: A (K rows, lda) holds the Mout columns,
// B (K rows through its row map, ldb) the Nout columns.
cudaError_t weight_grad(const bf16* A, int lda, const bf16* B, int ldb, int b_rpg, int b_gstride,
                        int Mout, int Nout, int K, float* out, float* part, cudaStream_t st) {
  const int s = dw_splits(Mout, Nout, K);
  GemmArgs p{};
  p.A = A;
  p.lda = lda;
  p.B = B;
  p.ldb = ldb;
  p.b_rpg = b_rpg;
  p.b_gstride = b_gstride;
  p.M = Mout;
  p.N = Nout;
  p.K = K;
  p.k_chunk = dw_k_chunk(K, s);
  p.Cf = part;
  dim3 grid(ceil_div(Nout, BBN), ceil_div(Mout, BBM), s);
  gemm_bwd_kernel<true, BE_PART><<<grid, B_THREADS, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce(part, s, (long long)Mout * Nout, Mout * Nout, out, st);
}

// C (M, N) = A W: A (M, K) row-major (lda), W the torch (out=K, in=N) weight.
template <int EPI>
cudaError_t gemm_nn(const bf16* A, int lda, const bf16* W, int M, int N, int K, float* Cf,
                    bf16* Cb, int ldc, cudaStream_t st, const float* pre = nullptr,
                    float* colpart = nullptr, int c_rpg = 1, int c_gstride = 1) {
  GemmArgs p{};
  p.A = A;
  p.lda = lda;
  p.B = W;
  p.ldb = N;
  p.b_rpg = p.b_gstride = 1;
  p.M = M;
  p.N = N;
  p.K = K;
  p.k_chunk = K;
  p.Cf = Cf;
  p.Cb = Cb;
  p.ldc = ldc;
  p.c_rpg = c_rpg;
  p.c_gstride = c_gstride;
  p.pre = pre;
  p.colpart = colpart;
  dim3 grid(ceil_div(N, BBN), ceil_div(M, BBM), 1);
  gemm_bwd_kernel<false, EPI><<<grid, B_THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

// LayerNorm backward over `rows` rows, then its column sums into vecs[q]
// (q < nsum: dscale, dbias, sum res, sum out).
template <typename RT>
cudaError_t ln_bwd(const float* dh, const bf16* x, const float* stats, const float* gamma,
                   const RT* res, int seg, int res_seg, float* out_f, bf16* out_b, int rows,
                   int dim, float* part, int nsum, float* const* vecs, cudaStream_t st) {
  const int ctas = ln_bwd_ctas(rows);
  ln_bwd_kernel<RT><<<ctas, LNB_WARPS * 32, 0, st>>>(dh, x, stats, gamma, res, seg, res_seg,
                                                     out_f, out_b, part, nsum, rows, dim);
  cudaError_t e = cudaGetLastError();
  for (int q = 0; q < nsum && e == cudaSuccess; ++q)
    e = reduce(part + (long long)q * dim, ctas, (long long)nsum * dim, dim, vecs[q], st);
  return e;
}

cudaError_t attn_bwd(const bf16* Q, int ldq, int nq, const bf16* K, const bf16* V, int ldkv, int n,
                     const bf16* O, const bf16* dO, int ldo, const float* lse, float* delta,
                     bf16* dQ, int lddq, bf16* dK, bf16* dV, int lddkv, int B, int heads,
                     int valid_len, float scale, cudaStream_t st) {
  const size_t smem = att_smem_bytes(n);
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_dq_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  attn_bwd_dq_kernel<<<dim3(ceil_div(nq, ATT_BQ), heads, B), ATT_THREADS, smem, st>>>(
      Q, ldq, nq, K, V, ldkv, n, O, dO, ldo, lse, delta, dQ, lddq, valid_len, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkdv_kernel<<<dim3(ceil_div(n, KV_BK), heads, B), ATT_THREADS, 0, st>>>(
      Q, ldq, nq, K, V, ldkv, n, dO, ldo, lse, delta, dK, dV, lddkv, valid_len, scale);
  return cudaGetLastError();
}

// The MLP branch of either block over its Mr rows (all B*N rows, or the CLS
// block's B*rows): g -> dx1 (fp32 and bf16) and the MLP/LN2/out-bias grads.
int mlp_branch_bwd(const bf16* g, const bf16* w_fc1, const bf16* w_fc2, const float* ln2_s,
                   const bf16* x1, const bf16* h2, const float* fpre, const bf16* f,
                   const float* stats2, float* d_ln2_s, float* d_ln2_b, float* d_wfc1,
                   float* d_bfc1, float* d_wfc2, float* d_bfc2, float* d_bout, bf16* df1,
                   float* dh, float* dx1, bf16* dx1b, float* part, int Mr, int seg, int dim,
                   int mlp, cudaStream_t st) {
  SVT_TRY(weight_grad(g, dim, f, mlp, 1, 1, dim, mlp, Mr, d_wfc2, part, st));
  SVT_TRY(gemm_nn<BE_GELU_GRAD>(g, dim, w_fc2, Mr, mlp, dim, nullptr, df1, mlp, st, fpre, part));
  SVT_TRY(reduce(part, ceil_div(Mr, BBM), mlp, mlp, d_bfc1, st));
  SVT_TRY(weight_grad(df1, mlp, h2, dim, 1, 1, mlp, dim, Mr, d_wfc1, part, st));
  SVT_TRY(gemm_nn<BE_F32>(df1, mlp, w_fc1, Mr, dim, mlp, dh, nullptr, dim, st));
  float* const vecs[4] = {d_ln2_s, d_ln2_b, d_bfc2, d_bout};
  SVT_TRY(ln_bwd<bf16>(dh, x1, stats2, ln2_s, g, seg, seg, dx1, dx1b, Mr, dim, part, 4, vecs,
                       st));
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Floats of fp32 workspace (`ws`) the backward entries need: the largest set
// of split-K or column partials any one of their steps holds.
long long svt_block_bwd_workspace(int B, int N, int rows, int dim, int heads, int dim_head,
                                  int mlp) {
  const int M = B * N, Mt = B * rows, hd = heads * dim_head;
  long long need = 0;
  const int dw[][3] = {{dim, mlp, Mt},    {mlp, dim, Mt},    {dim, hd, Mt}, {dim, mlp, M},
                       {mlp, dim, M},     {dim, hd, M},      {3 * hd, dim, M},
                       {hd, dim, Mt},     {2 * hd, dim, M}};
  for (const auto& s : dw)
    need = std::max(need, (long long)dw_splits(s[0], s[1], s[2]) * s[0] * s[1]);
  need = std::max(need, (long long)ceil_div(M, BBM) * mlp);
  need = std::max(need, (long long)ln_bwd_ctas(M) * 4 * dim);
  return need;
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
  if (dim_head != ATT_DH || dim > LNB_MAXC * 32) return (int)cudaErrorInvalidValue;
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N, hd = heads * dim_head;
  const float scale = 1.0f / sqrtf((float)dim_head);
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
  SVT_TRY(weight_grad(dx1b_, dim, (const bf16*)attn, hd, 1, 1, dim, hd, M, (float*)d_wout, part,
                      st));
  SVT_TRY(gemm_nn<BE_BF16>(dx1b_, dim, (const bf16*)w_out, M, hd, dim, nullptr, (bf16*)da, hd,
                           st));
  SVT_TRY(attn_bwd(qkv_, 3 * hd, N, qkv_ + hd, qkv_ + 2 * hd, 3 * hd, N, (const bf16*)attn,
                   (const bf16*)da, hd, (const float*)lse, (float*)delta, dqkv_, 3 * hd,
                   dqkv_ + hd, dqkv_ + 2 * hd, 3 * hd, B, heads, valid_len, scale, st));
  SVT_TRY(weight_grad(dqkv_, 3 * hd, (const bf16*)h1, dim, 1, 1, 3 * hd, dim, M, (float*)d_wqkv,
                      part, st));
  SVT_TRY(gemm_nn<BE_F32>(dqkv_, 3 * hd, (const bf16*)w_qkv, M, dim, 3 * hd, (float*)dh, nullptr,
                          dim, st));
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
  if (dim_head != ATT_DH || dim > LNB_MAXC * 32 || rows < 1 || rows > N)
    return (int)cudaErrorInvalidValue;
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N, Mt = B * rows, hd = heads * dim_head;
  const float scale = 1.0f / sqrtf((float)dim_head);
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
  SVT_TRY(weight_grad(dx1b_, dim, (const bf16*)attn, hd, 1, 1, dim, hd, Mt, (float*)d_wout, part,
                      st));
  SVT_TRY(gemm_nn<BE_BF16>(dx1b_, dim, (const bf16*)w_out, Mt, hd, dim, nullptr, (bf16*)da, hd,
                           st));
  SVT_TRY(attn_bwd((const bf16*)q, hd, rows, kv_, kv_ + hd, 2 * hd, N, (const bf16*)attn,
                   (const bf16*)da, hd, (const float*)lse, (float*)delta, dq_, hd, dkv_,
                   dkv_ + hd, 2 * hd, B, heads, valid_len, scale, st));
  // dW_qkv rows [0, hd) from the top rows' dq, rows [hd, 3hd) from every row's dk/dv
  SVT_TRY(weight_grad(dq_, hd, (const bf16*)h1, dim, rows, N, hd, dim, Mt, (float*)d_wqkv, part,
                      st));
  SVT_TRY(weight_grad(dkv_, 2 * hd, (const bf16*)h1, dim, 1, 1, 2 * hd, dim, M,
                      (float*)d_wqkv + (long long)hd * dim, part, st));
  SVT_TRY(gemm_nn<BE_F32>(dkv_, 2 * hd, wkv, M, dim, 2 * hd, dh_, nullptr, dim, st));
  SVT_TRY(gemm_nn<BE_ADD_F32>(dq_, hd, wq, Mt, dim, hd, dh_, nullptr, dim, st, nullptr, nullptr,
                              rows, N));
  float* const vecs[2] = {(float*)d_ln1_s, (float*)d_ln1_b};
  SVT_TRY(ln_bwd<float>(dh_, (const bf16*)x, (const float*)stats1, (const float*)ln1_s,
                        (const float*)dx1, N, rows, nullptr, (bf16*)dx, M, dim, part, 2, vecs,
                        st));
  return (int)cudaSuccess;
}

}  // extern "C"
