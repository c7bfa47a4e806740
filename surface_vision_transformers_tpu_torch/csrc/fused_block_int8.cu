// Hopper (sm_90a) kernels for the W8A8 int8 transformer-block forward.
//
// Replaces the TPU megakernel
// surface_vision_transformers_tpu/ops/pallas/fused_block_int8.py::
// fused_block_int8 (_block_kernel_int8) -> svt_fused_block_int8.
//
// The TPU kernel keeps a block in VMEM and quantizes each activation tile
// in place. Here the block is a chain of launches on the caller's stream:
//   LN1 + row quantization (bf16 x) -> int8 QKV GEMM, dequantized to bf16
//   -> streamed attention (flash_attention.cu) on the packed qkv
//   -> row quantization of the bf16 attention output
//   -> int8 out-proj GEMM + bias + x -> x1 (fp32, not rounded)
//   -> LN2 + row quantization (fp32 x1) -> int8 fc1 GEMM + bias, erf-GELU
//      -> f (fp32) -> row quantization of f
//   -> int8 fc2 GEMM + bias + x1 -> out (bf16).
// A row's int8 scale needs the absmax of the whole row first. The GEMM tiles
// split the attention output across heads and f across MLP columns, so
// those two are quantized by a separate row pass; LN1 and LN2 hold whole
// rows and quantize as they normalise.
//
// Quantization, bit for bit the JAX arithmetic (ops/quant.py is the plain
// version): scale = max(absmax, 1e-30) / 127 and code = clamp(rint(v /
// scale), -127, 127), both IEEE divisions (__fdiv_rn), rint half to even
// (__float2int_rn). Rows past valid_len are quantized too; an all-zero row
// gets scale 1e-30 / 127 and codes 0, no NaN.
//
// The GEMM: C[M, N] = A[M, K] . W[N, K]^T on int8 tensor cores
// (mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32), int32 accumulators, W
// in the torch Linear (out, in) layout with K contiguous. The tiling is
// fused_block.cu's bf16 GEMM in bytes: a 128 x 64 CTA tile, 4 warps of
// 32 x 64, K steps of 64 int8 (64 bytes, the bf16 kernel's 32 elements)
// through a two-stage cp.async ring. An int8 16 x 32 tile is a b16 16 x 16
// tile byte for byte, so ldmatrix on the int8 tiles viewed as b16 gives the
// s8 fragments (A: rows g / g+8, bytes 4t..4t+3 and 16+4t..; B: bytes
// 4t..4t+3 and 16+4t.. of row n = g). Epilogue: (float(acc) * s_row) *
// s_col (int32 -> fp32 rounded to nearest, __int2float_rn), then bias,
// GELU and residuals in fp32; a raw variant writes the int32 accumulators
// (svt_int8_gemm_s32, to hold them bitwise against the plain product).
//
// Bounds on this card, SiT-base (dim 768, mlp 3072, N 1281) at bs 64: the
// four GEMMs are 0.87 T int8 operations (0.44 ms at the 1,979 TOP/s dense
// int8 peak) and attention 0.16 TFLOP of bf16 products (0.16 ms at 989
// TFLOP/s); the block's own input and output are 0.25 GB (0.08 ms at 3.35
// TB/s), so operations bound it. The chain also writes and reads back the
// fp32 x1 and f (2.0 GB of f at bs 128) and the int8 rows: bytes a later
// version keeps on chip by fusing the quantization into the GEMMs.
//
// C interface, loaded with ctypes: every entry returns cudaGetLastError()
// after its last launch (or the first failing one), 0 on success. Nothing
// synchronises and nothing allocates.

#include <stdint.h>

#include "flash_attention.cuh"

namespace {

using namespace svt;

// ---------------------------------------------------------------------------
// Row quantization: one warp per row.

constexpr int RQ_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float quant_scale(float absmax) {
  return __fdiv_rn(fmaxf(absmax, 1e-30f), 127.0f);
}

__device__ __forceinline__ int8_t quant_code(float v, float scale) {
  const int q = __float2int_rn(__fdiv_rn(v, scale));
  return static_cast<int8_t>(max(-127, min(127, q)));
}

// q = codes of each row of h (rows, cols), s = the row scales.
template <typename T>
__global__ void __launch_bounds__(RQ_THREADS)
    quant_rows_kernel(const T* __restrict__ h, int8_t* __restrict__ q, float* __restrict__ s,
                      int rows, int cols) {
  const int row = (blockIdx.x * RQ_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* hr = h + (long long)row * cols;
  float a = 0.f;
  for (int i = lane; i < cols; i += 32) a = fmaxf(a, fabsf(to_f32(hr[i])));
  const float sc = quant_scale(warp_max(a));
  if (lane == 0) s[row] = sc;
  int8_t* qr = q + (long long)row * cols;
  for (int i = lane; i < cols; i += 32) qr[i] = quant_code(to_f32(hr[i]), sc);
}

// LayerNorm in fp32 (two-pass statistics, as fused_block.cu's) quantized
// per row from fp32: the normalised row is recomputed for the absmax and
// for the codes, never stored.
template <typename T>
__global__ void __launch_bounds__(RQ_THREADS)
    ln_quant_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, int8_t* __restrict__ q,
                    float* __restrict__ s, int rows, int dim, float eps) {
  const int row = (blockIdx.x * RQ_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (long long)row * dim;
  float sum = 0.f;
  for (int i = lane; i < dim; i += 32) sum += to_f32(xr[i]);
  const float mu = warp_sum(sum) / dim;
  float var = 0.f;
  for (int i = lane; i < dim; i += 32) {
    const float d = to_f32(xr[i]) - mu;
    var += d * d;
  }
  const float rstd = rsqrtf(warp_sum(var) / dim + eps);
  float a = 0.f;
  for (int i = lane; i < dim; i += 32)
    a = fmaxf(a, fabsf((to_f32(xr[i]) - mu) * rstd * gamma[i] + beta[i]));
  const float sc = quant_scale(warp_max(a));
  if (lane == 0) s[row] = sc;
  int8_t* qr = q + (long long)row * dim;
  for (int i = lane; i < dim; i += 32)
    qr[i] = quant_code((to_f32(xr[i]) - mu) * rstd * gamma[i] + beta[i], sc);
}

// ---------------------------------------------------------------------------
// int8 GEMM with dequantizing epilogues. Needs K % 16 == 0, N % 8 == 0 and
// 16-byte aligned rows (the host checks K % 32 == 0).

enum {
  Q_EPI_S32 = 0,       // int32 accumulators
  Q_EPI_BF16 = 1,      // dequantized, bf16 (qkv)
  Q_EPI_RES_F32 = 2,   // bf16 R + (dequantized + bias), fp32 (x1)
  Q_EPI_GELU_F32 = 3,  // erf-GELU(dequantized + bias), fp32 (f)
  Q_EPI_RES_BF16 = 4,  // fp32 R + (dequantized + bias), bf16 (out)
};

constexpr int QBM = 128, QBN = 64, QBK = 64, QLD = QBK + 16, Q_THREADS = 128;

// c += a (16x32 s8, row) * b (32x8 s8, col); int32 accumulators.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int EPI>
__global__ void __launch_bounds__(Q_THREADS)
    int8_gemm_kernel(const int8_t* __restrict__ A, const float* __restrict__ sa,
                     const int8_t* __restrict__ W, const float* __restrict__ sw,
                     const float* __restrict__ bias, const void* __restrict__ R,
                     void* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) int8_t sA[2][QBM * QLD];
  __shared__ __align__(16) int8_t sB[2][QBN * QLD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * QBN, m0 = blockIdx.y * QBM;
  const int KT = (K + QBK - 1) / QBK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * QBK;
#pragma unroll
    for (int i = 0; i < (QBM * QBK / 16) / Q_THREADS; ++i) {
      const int c = tid + i * Q_THREADS;
      const int r = c >> 2, kc = (c & 3) * 16;
      const int gr = m0 + r, gk = k0 + kc;
      const bool ok = gr < M && gk < K;
      cp_async16(&sA[stage][r * QLD + kc], ok ? A + (long long)gr * K + gk : A, ok);
    }
#pragma unroll
    for (int i = 0; i < (QBN * QBK / 16) / Q_THREADS; ++i) {
      const int c = tid + i * Q_THREADS;
      const int r = c >> 2, kc = (c & 3) * 16;
      const int gn = n0 + r, gk = k0 + kc;
      const bool ok = gn < N && gk < K;
      cp_async16(&sB[stage][r * QLD + kc], ok ? W + (long long)gn * K + gk : W, ok);
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

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
    const int8_t* a_s = sA[kt & 1];
    const int8_t* b_s = sB[kt & 1];
#pragma unroll
    for (int kk = 0; kk < QBK; kk += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], a_s + (warp * 32 + mi * 16 + (lane & 15)) * QLD + kk +
                                (lane >> 4) * 16);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, b_s + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * QLD + kk +
                             ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_s8(acc[mi][2 * nj], af[mi], bfr[0], bfr[1]);
          mma_s8(acc[mi][2 * nj + 1], af[mi], bfr[2], bfr[3]);
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
      const long long o = (long long)r * N;
      const float s_row = EPI == Q_EPI_S32 ? 0.f : sa[r];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int c = n0 + ni * 8 + 2 * t;
        if (c >= N) continue;
        const int a0 = acc[mi][ni][2 * half], a1 = acc[mi][ni][2 * half + 1];
        if (EPI == Q_EPI_S32) {
          *reinterpret_cast<int2*>(static_cast<int*>(C) + o + c) = make_int2(a0, a1);
          continue;
        }
        float v0 = __int2float_rn(a0) * s_row * sw[c];
        float v1 = __int2float_rn(a1) * s_row * sw[c + 1];
        if (EPI == Q_EPI_BF16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(C) + o + c) =
              __floats2bfloat162_rn(v0, v1);
          continue;
        }
        v0 += bias[c];
        v1 += bias[c + 1];
        if (EPI == Q_EPI_RES_F32) {
          const __nv_bfloat162 rv =
              *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(R) + o + c);
          *reinterpret_cast<float2*>(static_cast<float*>(C) + o + c) =
              make_float2(__low2float(rv) + v0, __high2float(rv) + v1);
        } else if (EPI == Q_EPI_GELU_F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(C) + o + c) =
              make_float2(gelu_erf(v0), gelu_erf(v1));
        } else {  // Q_EPI_RES_BF16
          const float2 rv = *reinterpret_cast<const float2*>(static_cast<const float*>(R) + o + c);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(C) + o + c) =
              __floats2bfloat162_rn(rv.x + v0, rv.y + v1);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// Host-side launch helpers (all on `st`, no synchronisation).

int rows_grid(int rows) { return (rows + RQ_THREADS / 32 - 1) / (RQ_THREADS / 32); }

template <typename T>
cudaError_t launch_quant_rows(const T* h, int8_t* q, float* s, int rows, int cols,
                              cudaStream_t st) {
  quant_rows_kernel<T><<<rows_grid(rows), RQ_THREADS, 0, st>>>(h, q, s, rows, cols);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ln_quant(const T* x, const float* g, const float* b, int8_t* q, float* s,
                            int rows, int dim, float eps, cudaStream_t st) {
  ln_quant_kernel<T><<<rows_grid(rows), RQ_THREADS, 0, st>>>(x, g, b, q, s, rows, dim, eps);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_int8_gemm(const int8_t* A, const float* sa, const int8_t* W, const float* sw,
                             const float* bias, const void* R, void* C, int M, int N, int K,
                             cudaStream_t st) {
  dim3 grid((N + QBN - 1) / QBN, (M + QBM - 1) / QBM);
  int8_gemm_kernel<EPI><<<grid, Q_THREADS, 0, st>>>(A, sa, W, sw, bias, R, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, N, dim) bf16 -> out (B, N, dim) bf16. Weights int8 in the torch
// Linear layout (out, in) with fp32 (out,) scales: q_qkv (3hd, dim), q_out
// (dim, hd), q_fc1 (mlp, dim), q_fc2 (dim, mlp); LN parameters and biases
// fp32. Scratch: q8 (B*N, max(dim, hd, mlp)) int8, s (B*N,) fp32, qkv
// (B*N, 3hd) and attn (B*N, hd) bf16, x1 (B*N, dim) and f (B*N, mlp) fp32.
int svt_fused_block_int8(void* x, void* ln1_s, void* ln1_b, void* q_qkv, void* s_qkv,
                         void* q_out, void* s_out, void* b_out, void* ln2_s, void* ln2_b,
                         void* q_fc1, void* s_fc1, void* b_fc1, void* q_fc2, void* s_fc2,
                         void* b_fc2, void* out, void* ws_q8, void* ws_s, void* ws_qkv,
                         void* ws_attn, void* ws_x1, void* ws_f, int B, int N, int dim, int heads,
                         int dim_head, int mlp, int valid_len, float eps, int device,
                         void* stream) {
  if (dim_head != ATT_DH) return (int)cudaErrorInvalidValue;
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N, hd = heads * dim_head;
  const bf16* xb = static_cast<const bf16*>(x);
  int8_t* q8 = static_cast<int8_t*>(ws_q8);
  float* s = static_cast<float*>(ws_s);
  bf16* qkv = static_cast<bf16*>(ws_qkv);
  bf16* attn = static_cast<bf16*>(ws_attn);
  float* x1 = static_cast<float*>(ws_x1);
  float* f = static_cast<float*>(ws_f);
  auto i8 = [](void* p) { return static_cast<const int8_t*>(p); };
  auto f32 = [](void* p) { return static_cast<const float*>(p); };

  SVT_TRY(launch_ln_quant(xb, f32(ln1_s), f32(ln1_b), q8, s, M, dim, eps, st));
  SVT_TRY(launch_int8_gemm<Q_EPI_BF16>(q8, s, i8(q_qkv), f32(s_qkv), nullptr, nullptr, qkv, M,
                                       3 * hd, dim, st));
  SVT_TRY(flash_fwd(packed(qkv, N, 3 * hd), packed(qkv + hd, N, 3 * hd),
                    packed(qkv + 2 * hd, N, 3 * hd), packed(attn, N, hd), nullptr, B, heads, N, N,
                    valid_len, st));
  SVT_TRY(launch_quant_rows(static_cast<const bf16*>(attn), q8, s, M, hd, st));
  SVT_TRY(launch_int8_gemm<Q_EPI_RES_F32>(q8, s, i8(q_out), f32(s_out), f32(b_out), xb, x1, M,
                                          dim, hd, st));
  SVT_TRY(launch_ln_quant(static_cast<const float*>(x1), f32(ln2_s), f32(ln2_b), q8, s, M, dim,
                          eps, st));
  SVT_TRY(launch_int8_gemm<Q_EPI_GELU_F32>(q8, s, i8(q_fc1), f32(s_fc1), f32(b_fc1), nullptr, f,
                                           M, mlp, dim, st));
  SVT_TRY(launch_quant_rows(static_cast<const float*>(f), q8, s, M, mlp, st));
  SVT_TRY(launch_int8_gemm<Q_EPI_RES_BF16>(q8, s, i8(q_fc2), f32(s_fc2), f32(b_fc2), x1, out, M,
                                           dim, mlp, st));
  return (int)cudaSuccess;
}

// The chain's row quantizer alone: h (rows, cols) fp32 (h_is_f32) or bf16
// -> q (rows, cols) int8, s (rows,) fp32.
int svt_quant_rows(void* h, int h_is_f32, void* q, void* s, int rows, int cols, int device,
                   void* stream) {
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qq = static_cast<int8_t*>(q);
  float* ss = static_cast<float*>(s);
  if (h_is_f32) return (int)launch_quant_rows(static_cast<const float*>(h), qq, ss, rows, cols, st);
  return (int)launch_quant_rows(static_cast<const bf16*>(h), qq, ss, rows, cols, st);
}

// The chain's int8 GEMM alone, int32 accumulators out: A (M, K) . W (N, K)^T
// -> acc (M, N).
int svt_int8_gemm_s32(void* A, void* W, void* acc, int M, int N, int K, int device,
                      void* stream) {
  SVT_TRY(cudaSetDevice(device));
  return (int)launch_int8_gemm<Q_EPI_S32>(static_cast<const int8_t*>(A), nullptr,
                                          static_cast<const int8_t*>(W), nullptr, nullptr,
                                          nullptr, acc, M, N, K, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
