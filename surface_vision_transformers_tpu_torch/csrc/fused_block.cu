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
// the first `rows` (<= 8) rows of each sample only. Attention is the
// streamed kernel of flash_attention.cu, at any N (SiT-tiny's 321, SiT-base
// on sub-ico 3's 1,281). The training entries
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

#include "flash_attention.cuh"

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

// Attention on the packed activations (B, rows, ld), head h at columns
// h * 64: the streamed kernel of flash_attention.cu (K and V through shared
// memory in 64- or 128-key tiles by TMA, wgmma, online softmax, any N).
cudaError_t launch_attention(const bf16* Q, int ldq, int nq, const bf16* K, const bf16* V,
                             int ldkv, int n, bf16* O, int ldo, int B, int heads, int valid_len,
                             float* lse, cudaStream_t st) {
  return flash_fwd(packed(Q, nq, ldq), packed(K, n, ldkv), packed(V, n, ldkv), packed(O, nq, ldo),
                   lse, B, heads, nq, n, valid_len, st);
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
                           valid_len, s.lse, st));
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
                           s.lse, st));
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
