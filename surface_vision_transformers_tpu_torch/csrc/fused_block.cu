// Hopper (sm_90a) kernels for the SiT transformer block forward.
//
// Replaces the TPU megakernels in
// surface_vision_transformers_tpu/ops/pallas/fused_block.py:
//   fused_block      (_block_kernel)      -> svt_fused_block
//   fused_block_cls  (_block_cls_kernel)  -> svt_fused_block_cls
//
// The TPU kernel keeps a whole block in ~96 MB of VMEM. An H100 SM has 227 KB
// of shared memory, so one block becomes a chain of launches over device
// memory on the caller's stream:
//   LN1 -> QKV GEMM -> attention -> out-proj GEMM (+bias +residual)
//   -> LN2 -> fc1 GEMM (+bias, erf-GELU) -> fc2 GEMM (+bias +residual).
// The CLS variant runs LN1 and the K/V GEMM over every row and the rest on
// the first `rows` (<= 8) rows of each sample only. The training entries
// (svt_fused_block[_cls]_train_fwd) run the same chain and also keep what
// the backward (fused_block_bwd.cu) reads: LN statistics, the fp32 fc1
// pre-activation and the attention row log-sum-exp.
//
// Bounds on this card: at SiT-tiny (dim 192, mlp 768, N 321) the four GEMMs
// are ~70% of the FLOPs and run on bf16 tensor cores (mma.sync m16n8k16,
// fp32 accumulation); every intermediate makes one round trip through HBM,
// so the chain moves ~10x the bytes of the block's input and output.
// Measured on an H100 (PERF.md), a GEMM here reaches ~100 TFLOP/s, a tenth
// of the bf16 peak, far from HBM bandwidth too: the simple mma.sync tiling
// bounds this version. wgmma, TMA, deeper pipelines, LN folded into the GEMM
// prologues and intermediates kept on chip are later work.
//
// Numerics follow the TPU kernel's rounding points (bf16 after LN, QKV,
// P, P.V, x1, GELU; fp32 statistics, scores, softmax sums and epilogues),
// with two deliberate differences: exact erf-GELU (the TPU kernel's tanh
// form was forced by Mosaic) and the shifted softmax (the TPU kernel's
// unshifted form clamped at 60 equals it whenever scores <= 60).
//
// C interface, loaded with ctypes: every entry returns cudaGetLastError()
// after its last launch (or the first failing one), 0 on success. Nothing
// synchronises and nothing allocates: the caller passes outputs and scratch.

#include "common.cuh"

namespace {

using namespace svt;

// ---------------------------------------------------------------------------
// LayerNorm: one warp per row, fp32 statistics (two-pass), bf16 out. With
// `stats` set (training), (mean, rstd) of each row are kept for the backward.

constexpr int LN_THREADS = 256;

__global__ void __launch_bounds__(LN_THREADS)
    layer_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, bf16* __restrict__ y, int rows, int dim,
                      float eps, float* __restrict__ stats) {
  const int row = (blockIdx.x * LN_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + (long long)row * dim;
  float s = 0.f;
  for (int i = lane; i < dim; i += 32) s += __bfloat162float(xr[i]);
  const float mu = warp_sum(s) / dim;
  float v = 0.f;
  for (int i = lane; i < dim; i += 32) {
    float d = __bfloat162float(xr[i]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / dim + eps);
  if (stats != nullptr && lane == 0) {
    stats[2LL * row] = mu;
    stats[2LL * row + 1] = rstd;
  }
  bf16* yr = y + (long long)row * dim;
  for (int i = lane; i < dim; i += 32)
    yr[i] = __float2bfloat16((__bfloat162float(xr[i]) - mu) * rstd * gamma[i] + beta[i]);
}

// ---------------------------------------------------------------------------
// GEMM: C[M, N] = A[M, K] . W[N, K]^T (+ epilogue), W in torch Linear layout.
// 128x64 CTA tile, 4 warps of 32x64, K steps of 32 through a two-stage
// cp.async ring; the ragged M, N and K edges are zero-filled / masked.
// Needs K % 8 == 0, N % 8 == 0 and 16-byte aligned rows (checked by the host).

enum { EPI_NONE = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RES = 2 };

constexpr int GBM = 128, GBN = 64, GBK = 32, GLD = GBK + 8, G_THREADS = 128;

template <int EPI>
__global__ void __launch_bounds__(G_THREADS)
    gemm_kernel(const bf16* __restrict__ A, int lda, int a_rpg, int a_gstride,
                const bf16* __restrict__ W, const float* __restrict__ bias,
                const bf16* __restrict__ R, int ldr, int r_rpg, int r_gstride,
                bf16* __restrict__ C, int ldc, int M, int N, int K,
                float* __restrict__ Cpre) {
  __shared__ __align__(16) bf16 sA[2][GBM * GLD];
  __shared__ __align__(16) bf16 sB[2][GBN * GLD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * GBM;
  const int KT = (K + GBK - 1) / GBK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * GBK;
#pragma unroll
    for (int i = 0; i < (GBM * GBK / 8) / G_THREADS; ++i) {
      const int c = tid + i * G_THREADS;
      const int r = c >> 2, kc = (c & 3) * 8;
      const int gr = m0 + r, gk = k0 + kc;
      const bool ok = gr < M && gk < K;
      const bf16* src = ok ? A + map_row(gr, a_rpg, a_gstride) * lda + gk : A;
      cp_async16(&sA[stage][r * GLD + kc], src, ok);
    }
#pragma unroll
    for (int i = 0; i < (GBN * GBK / 8) / G_THREADS; ++i) {
      const int c = tid + i * G_THREADS;
      const int r = c >> 2, kc = (c & 3) * 8;
      const int gn = n0 + r, gk = k0 + kc;
      const bool ok = gn < N && gk < K;
      const bf16* src = ok ? W + (long long)gn * K + gk : W;
      cp_async16(&sB[stage][r * GLD + kc], src, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  load_stage(0, 0);
  cp_async_commit();
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
    for (int kk = 0; kk < GBK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], a_s + (warp * 32 + mi * 16 + (lane & 15)) * GLD + kk +
                                (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, b_s + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * GLD + kk +
                             ((lane >> 3) & 1) * 8);
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
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + warp * 32 + mi * 16 + g + half * 8;
      if (r >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int c = n0 + ni * 8 + 2 * t;
        if (c >= N) continue;
        float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if (EPI != EPI_NONE) {
          v0 += bias[c];
          v1 += bias[c + 1];
        }
        if (EPI == EPI_BIAS_GELU) {
          if (Cpre != nullptr)  // training: the fp32 pre-activation, for GELU'
            *reinterpret_cast<float2*>(Cpre + (long long)r * ldc + c) = make_float2(v0, v1);
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        }
        if (EPI == EPI_BIAS_RES) {
          const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(
              R + map_row(r, r_rpg, r_gstride) * ldr + c);
          v0 += __low2float(rv);
          v1 += __high2float(rv);
        }
        *reinterpret_cast<__nv_bfloat162*>(C + (long long)r * ldc + c) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
}

// ---------------------------------------------------------------------------
// Attention, head dim 64: one CTA per (query tile of 64, head, sample).
// The sample's K and V for this head sit in shared memory (rows >= n
// zero-filled up to a multiple of 32); each of the 4 warps owns 16 query
// rows. Pass 1 finds the exact row max over the unmasked keys, pass 2 forms
// p = exp(s - max) in fp32, sums it in fp32, rounds it to bf16 for P.V, and
// divides the fp32 P.V by the sum at the end, as the TPU kernel does.

__global__ void __launch_bounds__(ATT_THREADS)
    attention_kernel(const bf16* __restrict__ Q, int ldq, int nq, const bf16* __restrict__ Kp,
                     const bf16* __restrict__ Vp, int ldkv, int n, bf16* __restrict__ O, int ldo,
                     int valid_len, float scale, float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  const int nk = att_keys_padded(n);
  bf16* sQ = reinterpret_cast<bf16*>(att_smem);
  bf16* sK = sQ + ATT_BQ * ATT_LD;
  bf16* sV = sK + nk * ATT_LD;
  const int q0 = blockIdx.x * ATT_BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hoff = h * ATT_DH;

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
  if (qr0 >= nq) return;

  uint32_t qf[ATT_DH / 16][4];
#pragma unroll
  for (int ks = 0; ks < ATT_DH / 16; ++ks)
    ldmatrix_x4(qf[ks], sQ + (warp * 16 + (lane & 15)) * ATT_LD + ks * 16 + (lane >> 4) * 8);

  const int g = lane >> 2, t = lane & 3;
  const int kend = min(valid_len, n);
  const int nchunks = (kend + ATT_BK - 1) / ATT_BK;

  // Pass 1: exact row max (rows g and g + 8 of this warp's 16).
  float m_lo = -INFINITY, m_hi = -INFINITY;
  for (int ch = 0; ch < nchunks; ++ch) {
    float s[4][4];
    score_chunk(s, qf, sK, ch * ATT_BK, lane);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = ch * ATT_BK + nt * 8 + 2 * t;
      if (col < kend) {
        m_lo = fmaxf(m_lo, s[nt][0] * scale);
        m_hi = fmaxf(m_hi, s[nt][2] * scale);
      }
      if (col + 1 < kend) {
        m_lo = fmaxf(m_lo, s[nt][1] * scale);
        m_hi = fmaxf(m_hi, s[nt][3] * scale);
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
  }

  // Pass 2: P = exp(s - max), l = sum P (fp32), O += bf16(P) . V.
  float acc[ATT_DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < ATT_DH / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float l_lo = 0.f, l_hi = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) {
    float s[4][4];
    score_chunk(s, qf, sK, ch * ATT_BK, lane);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = ch * ATT_BK + nt * 8 + 2 * t;
      const bool ok0 = col < kend, ok1 = col + 1 < kend;
      s[nt][0] = ok0 ? __expf(s[nt][0] * scale - m_lo) : 0.f;
      s[nt][1] = ok1 ? __expf(s[nt][1] * scale - m_lo) : 0.f;
      s[nt][2] = ok0 ? __expf(s[nt][2] * scale - m_hi) : 0.f;
      s[nt][3] = ok1 ? __expf(s[nt][3] * scale - m_hi) : 0.f;
      l_lo += s[nt][0] + s[nt][1];
      l_hi += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // 16 keys per mma k-step
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pf[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pf[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pf[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const int key = ch * ATT_BK + j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < ATT_DH / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sV + key * ATT_LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pf, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pf, vf[2], vf[3]);
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const int r_lo = qr0 + g, r_hi = qr0 + g + 8;
  if (lse != nullptr && t == 0) {  // training: row log-sum-exp for the backward
    float* lrow = lse + ((long long)b * gridDim.y + h) * nq;
    if (r_lo < nq) lrow[r_lo] = m_lo + logf(l_lo);
    if (r_hi < nq) lrow[r_hi] = m_hi + logf(l_hi);
  }
#pragma unroll
  for (int nt = 0; nt < ATT_DH / 8; ++nt) {
    const int d = hoff + nt * 8 + 2 * t;
    if (r_lo < nq)
      *reinterpret_cast<__nv_bfloat162*>(O + ((long long)b * nq + r_lo) * ldo + d) =
          __floats2bfloat162_rn(acc[nt][0] * inv_lo, acc[nt][1] * inv_lo);
    if (r_hi < nq)
      *reinterpret_cast<__nv_bfloat162*>(O + ((long long)b * nq + r_hi) * ldo + d) =
          __floats2bfloat162_rn(acc[nt][2] * inv_hi, acc[nt][3] * inv_hi);
  }
}

// ---------------------------------------------------------------------------
// Host-side launch helpers (all on `stream`, no synchronisation).

cudaError_t launch_ln(const bf16* x, const float* g, const float* b, bf16* y, int rows, int dim,
                      float eps, float* stats, cudaStream_t st) {
  const int per_block = LN_THREADS / 32;
  layer_norm_kernel<<<(rows + per_block - 1) / per_block, LN_THREADS, 0, st>>>(x, g, b, y, rows,
                                                                              dim, eps, stats);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_gemm(const bf16* A, int lda, int a_rpg, int a_gstride, const bf16* W,
                        const float* bias, const bf16* R, int ldr, int r_rpg, int r_gstride,
                        bf16* C, int ldc, int M, int N, int K, cudaStream_t st,
                        float* Cpre = nullptr) {
  dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  gemm_kernel<EPI><<<grid, G_THREADS, 0, st>>>(A, lda, a_rpg, a_gstride, W, bias, R, ldr, r_rpg,
                                               r_gstride, C, ldc, M, N, K, Cpre);
  return cudaGetLastError();
}

cudaError_t launch_attention(const bf16* Q, int ldq, int nq, const bf16* K, const bf16* V,
                             int ldkv, int n, bf16* O, int ldo, int B, int heads, int valid_len,
                             float scale, float* lse, cudaStream_t st) {
  const size_t smem = att_smem_bytes(n);
  cudaError_t e = cudaFuncSetAttribute(attention_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((nq + ATT_BQ - 1) / ATT_BQ, heads, B);
  attention_kernel<<<grid, ATT_THREADS, smem, st>>>(Q, ldq, nq, K, V, ldkv, n, O, ldo, valid_len,
                                                    scale, lse);
  return cudaGetLastError();
}

// What a training forward keeps for the backward (fused_block_bwd.cu). The
// serving forward passes none: h2 then reuses h1's buffer and nothing else is
// written. Every pointer below is the forward's own value, so the backward
// differentiates exactly the function the forward computed.
struct Saves {
  bf16* h2;      // LN2 output (rows, dim); serving: nullptr -> h1's buffer
  float* stats1; // LN1 (mean, rstd) per row
  float* stats2; // LN2 (mean, rstd) per row
  float* fpre;   // fc1 pre-activation (rows, mlp), fp32
  float* lse;    // attention row log-sum-exp (B, heads, query rows)
};

int block_fwd(const bf16* xb, void* ln1_s, void* ln1_b, void* w_qkv, void* w_out, void* b_out,
              void* ln2_s, void* ln2_b, void* w_fc1, void* b_fc1, void* w_fc2, void* b_fc2,
              void* out, bf16* h, bf16* qkv, bf16* attn, bf16* x1, bf16* f, const Saves& s,
              int B, int N, int dim, int heads, int dim_head, int mlp, int valid_len, float eps,
              int device, void* stream) {
  if (dim_head != ATT_DH) return (int)cudaErrorInvalidValue;
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N, hd = heads * dim_head;
  bf16* h2 = s.h2 != nullptr ? s.h2 : h;

  SVT_TRY(launch_ln(xb, (const float*)ln1_s, (const float*)ln1_b, h, M, dim, eps, s.stats1, st));
  SVT_TRY(launch_gemm<EPI_NONE>(h, dim, M, 0, (const bf16*)w_qkv, nullptr, nullptr, 0, 1, 0, qkv,
                                3 * hd, M, 3 * hd, dim, st));
  SVT_TRY(launch_attention(qkv, 3 * hd, N, qkv + hd, qkv + 2 * hd, 3 * hd, N, attn, hd, B, heads,
                           valid_len, 1.0f / sqrtf((float)dim_head), s.lse, st));
  SVT_TRY(launch_gemm<EPI_BIAS_RES>(attn, hd, M, 0, (const bf16*)w_out, (const float*)b_out, xb,
                                    dim, M, 0, x1, dim, M, dim, hd, st));
  SVT_TRY(launch_ln(x1, (const float*)ln2_s, (const float*)ln2_b, h2, M, dim, eps, s.stats2, st));
  SVT_TRY(launch_gemm<EPI_BIAS_GELU>(h2, dim, M, 0, (const bf16*)w_fc1, (const float*)b_fc1,
                                     nullptr, 0, 1, 0, f, mlp, M, mlp, dim, st, s.fpre));
  SVT_TRY(launch_gemm<EPI_BIAS_RES>(f, mlp, M, 0, (const bf16*)w_fc2, (const float*)b_fc2, x1, dim,
                                    M, 0, static_cast<bf16*>(out), dim, M, dim, mlp, st));
  return (int)cudaSuccess;
}

int block_cls_fwd(const bf16* xb, void* ln1_s, void* ln1_b, void* w_qkv, void* w_out,
                  void* b_out, void* ln2_s, void* ln2_b, void* w_fc1, void* b_fc1, void* w_fc2,
                  void* b_fc2, void* out, bf16* h, bf16* kv, bf16* q, bf16* attn, bf16* x1,
                  bf16* f, const Saves& s, int B, int N, int rows, int dim, int heads,
                  int dim_head, int mlp, int valid_len, float eps, int device, void* stream) {
  if (dim_head != ATT_DH || rows < 1 || rows > N) return (int)cudaErrorInvalidValue;
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N, Mt = B * rows, hd = heads * dim_head;
  const bf16* wq = static_cast<const bf16*>(w_qkv);
  const bf16* wkv = wq + (long long)hd * dim;
  bf16* h2 = s.h2 != nullptr ? s.h2 : h;

  SVT_TRY(launch_ln(xb, (const float*)ln1_s, (const float*)ln1_b, h, M, dim, eps, s.stats1, st));
  SVT_TRY(launch_gemm<EPI_NONE>(h, dim, M, 0, wkv, nullptr, nullptr, 0, 1, 0, kv, 2 * hd, M,
                                2 * hd, dim, st));
  SVT_TRY(launch_gemm<EPI_NONE>(h, dim, rows, N, wq, nullptr, nullptr, 0, 1, 0, q, hd, Mt, hd,
                                dim, st));
  SVT_TRY(launch_attention(q, hd, rows, kv, kv + hd, 2 * hd, N, attn, hd, B, heads, valid_len,
                           1.0f / sqrtf((float)dim_head), s.lse, st));
  SVT_TRY(launch_gemm<EPI_BIAS_RES>(attn, hd, Mt, 0, (const bf16*)w_out, (const float*)b_out, xb,
                                    dim, rows, N, x1, dim, Mt, dim, hd, st));
  SVT_TRY(launch_ln(x1, (const float*)ln2_s, (const float*)ln2_b, h2, Mt, dim, eps, s.stats2, st));
  SVT_TRY(launch_gemm<EPI_BIAS_GELU>(h2, dim, Mt, 0, (const bf16*)w_fc1, (const float*)b_fc1,
                                     nullptr, 0, 1, 0, f, mlp, Mt, mlp, dim, st, s.fpre));
  SVT_TRY(launch_gemm<EPI_BIAS_RES>(f, mlp, Mt, 0, (const bf16*)w_fc2, (const float*)b_fc2, x1,
                                    dim, Mt, 0, static_cast<bf16*>(out), dim, Mt, dim, mlp, st));
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

const char* svt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x (B, N, dim) -> out (B, N, dim). Weights in torch Linear layout (out, in),
// bf16: w_qkv (3hd, dim), w_out (dim, hd), w_fc1 (mlp, dim), w_fc2 (dim, mlp);
// LN parameters and biases fp32. Scratch: h (B*N, dim), qkv (B*N, 3hd),
// attn (B*N, hd), x1 (B*N, dim), f (B*N, mlp), all bf16.
int svt_fused_block(void* x, void* ln1_s, void* ln1_b, void* w_qkv, void* w_out, void* b_out,
                    void* ln2_s, void* ln2_b, void* w_fc1, void* b_fc1, void* w_fc2, void* b_fc2,
                    void* out, void* ws_h, void* ws_qkv, void* ws_attn, void* ws_x1, void* ws_f,
                    int B, int N, int dim, int heads, int dim_head, int mlp, int valid_len,
                    float eps, int device, void* stream) {
  return block_fwd((const bf16*)x, ln1_s, ln1_b, w_qkv, w_out, b_out, ln2_s, ln2_b, w_fc1, b_fc1,
                   w_fc2, b_fc2, out, (bf16*)ws_h, (bf16*)ws_qkv, (bf16*)ws_attn, (bf16*)ws_x1,
                   (bf16*)ws_f, Saves{}, B, N, dim, heads, dim_head, mlp, valid_len, eps, device,
                   stream);
}

// The training forward: svt_fused_block's arithmetic, with every buffer the
// backward reads kept (the order of ops/fused_block.py's TRAIN_SAVED): h1,
// qkv, attn (bf16), lse (B, heads, N) fp32, x1, h2 (bf16), fpre (B*N, mlp)
// fp32, f (bf16), stats1, stats2 (B*N, 2) fp32.
int svt_fused_block_train_fwd(void* x, void* ln1_s, void* ln1_b, void* w_qkv, void* w_out,
                              void* b_out, void* ln2_s, void* ln2_b, void* w_fc1, void* b_fc1,
                              void* w_fc2, void* b_fc2, void* out, void* h1, void* qkv,
                              void* attn, void* lse, void* x1, void* h2, void* fpre, void* f,
                              void* stats1, void* stats2, int B, int N, int dim,
                              int heads, int dim_head, int mlp, int valid_len, float eps,
                              int device, void* stream) {
  const Saves s{(bf16*)h2, (float*)stats1, (float*)stats2, (float*)fpre, (float*)lse};
  return block_fwd((const bf16*)x, ln1_s, ln1_b, w_qkv, w_out, b_out, ln2_s, ln2_b, w_fc1, b_fc1,
                   w_fc2, b_fc2, out, (bf16*)h1, (bf16*)qkv, (bf16*)attn, (bf16*)x1, (bf16*)f, s,
                   B, N, dim, heads, dim_head, mlp, valid_len, eps, device, stream);
}

// The final block under CLS pooling: x (B, N, dim) -> out (B, rows, dim),
// rows <= 8. LN1 and K/V over all N rows; Q, attention, out-proj, LN2 and the
// MLP over the first `rows` rows of each sample. Scratch: h (B*N, dim),
// kv (B*N, 2hd), q (B*rows, hd), attn (B*rows, hd), x1 (B*rows, dim),
// f (B*rows, mlp), all bf16.
int svt_fused_block_cls(void* x, void* ln1_s, void* ln1_b, void* w_qkv, void* w_out, void* b_out,
                        void* ln2_s, void* ln2_b, void* w_fc1, void* b_fc1, void* w_fc2,
                        void* b_fc2, void* out, void* ws_h, void* ws_kv, void* ws_q,
                        void* ws_attn, void* ws_x1, void* ws_f, int B, int N, int rows, int dim,
                        int heads, int dim_head, int mlp, int valid_len, float eps, int device,
                        void* stream) {
  return block_cls_fwd((const bf16*)x, ln1_s, ln1_b, w_qkv, w_out, b_out, ln2_s, ln2_b, w_fc1,
                       b_fc1, w_fc2, b_fc2, out, (bf16*)ws_h, (bf16*)ws_kv, (bf16*)ws_q,
                       (bf16*)ws_attn, (bf16*)ws_x1, (bf16*)ws_f, Saves{}, B, N, rows, dim, heads,
                       dim_head, mlp, valid_len, eps, device, stream);
}

// Training forward of the CLS block: as svt_fused_block_cls, keeping (the
// order of TRAIN_SAVED_CLS) h1 (B*N, dim), kv (B*N, 2hd), q, attn
// (B*rows, hd), lse (B, heads, rows) fp32, x1, h2 (B*rows, dim), fpre
// (B*rows, mlp) fp32, f, stats1 (B*N, 2) and stats2 (B*rows, 2) fp32.
int svt_fused_block_cls_train_fwd(void* x, void* ln1_s, void* ln1_b, void* w_qkv, void* w_out,
                                  void* b_out, void* ln2_s, void* ln2_b, void* w_fc1,
                                  void* b_fc1, void* w_fc2, void* b_fc2, void* out, void* h1,
                                  void* kv, void* q, void* attn, void* lse, void* x1, void* h2,
                                  void* fpre, void* f, void* stats1, void* stats2, int B, int N,
                                  int rows, int dim, int heads, int dim_head, int mlp,
                                  int valid_len, float eps, int device, void* stream) {
  const Saves s{(bf16*)h2, (float*)stats1, (float*)stats2, (float*)fpre, (float*)lse};
  return block_cls_fwd((const bf16*)x, ln1_s, ln1_b, w_qkv, w_out, b_out, ln2_s, ln2_b, w_fc1,
                       b_fc1, w_fc2, b_fc2, out, (bf16*)h1, (bf16*)kv, (bf16*)q, (bf16*)attn,
                       (bf16*)x1, (bf16*)f, s, B, N, rows, dim, heads, dim_head, mlp, valid_len,
                       eps, device, stream);
}

}  // extern "C"
