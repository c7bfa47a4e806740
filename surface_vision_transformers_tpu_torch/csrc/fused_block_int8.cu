// Hopper (sm_90a) kernels for the W8A8 int8 transformer-block forward.
//
// Replaces the TPU megakernel
// surface_vision_transformers_tpu/ops/pallas/fused_block_int8.py::
// fused_block_int8 (_block_kernel_int8) -> svt_fused_block_int8.
//
// The TPU kernel keeps a block in VMEM and quantizes each activation tile
// in place. Here the block is a chain of launches on the caller's stream:
//   LN1 + row quantization (bf16 x) -> int8 qkv GEMM, dequantized to bf16
//   -> streamed attention (flash_attention.cu) on the packed qkv
//   -> row quantization of the bf16 attention output
//   -> int8 out-proj GEMM + bias + x -> x1 (fp32, not rounded)
//   -> LN2 + row quantization (fp32 x1)
//   -> int8 fc1 GEMM, pass 1: each row's max |erf-GELU(. + bias)| over
//      each 192-column tile -> partials (mlp / 192, M) fp32
//   -> int8 fc1 GEMM, pass 2: the same products and f again, quantized by
//      the row scale the partials give -> f's int8 codes and row scales
//   -> int8 fc2 GEMM + bias + x1 -> out (bf16).
// The four GEMMs run on gemm.cuh's engine with int8 operands (a persistent
// CTA per SM, a TMA producer and a four-stage mbarrier ring, two consumer
// warpgroups on m64n192k32 s8 wgmma, int32 accumulators, outputs out by
// TMA); the epilogues (Q_* in gemm.cuh) dequantize and fuse bias, GELU,
// the residuals and f's quantization.
//
// A row's int8 scale needs the absmax of the whole row first. LN1 and LN2
// hold whole rows and quantize as they normalise (row passes, one warp a
// row, 16-byte loads, the row read from L1 for the statistics, the absmax
// and the codes); the attention output spans every head, which no GEMM tile
// holds, so it has a row pass of its own. f spans every MLP column: the
// maximum is associative, so pass 1 takes it per 192-column tile exactly
// and pass 2 recomputes f (the int32 products are exact, the epilogue
// deterministic) and writes the codes quant_rows(f) would give, bit for
// bit. f never lives in device memory in fp32: the price is fc1's products
// twice.
//
// Quantization, bit for bit the JAX arithmetic (ops/quant.py is the plain
// version; common.cuh's quant_scale / quant_code): scale = max(absmax,
// 1e-30) / 127 and code = clamp(rint(v / scale), -127, 127), both IEEE
// divisions, rint half to even. Rows past valid_len are quantized too; an
// all-zero row gets scale 1e-30 / 127 and codes 0, no NaN.
//
// Bounds on this card, SiT-base (dim 768, mlp 3072, N 1281) at bs 64: the
// four GEMMs are 1.161 T int8 operations (0.587 ms at the 1,979 TOP/s dense
// int8 peak) and attention 0.323 TFLOP of bf16 products (0.326 ms at 989
// TFLOP/s), 0.913 ms together; the block's own input and output are 0.25
// GB (0.08 ms at 3.35 TB/s), so operations bound it. The chain's own round
// trips through HBM beside that: qkv (0.38 GB), the attention output, x1
// in fp32 (0.25 GB, written once and read twice) and the int8 rows; no
// (M, mlp) fp32 tensor.
//
// C interface, loaded with ctypes: every entry returns cudaGetLastError()
// after its last launch (or the first failing one), 0 on success. Nothing
// synchronises and nothing allocates.

#include <stdint.h>
#include <string.h>

#include "flash_attention.cuh"
#include "gemm.cuh"

namespace {

using namespace svt;

// ---------------------------------------------------------------------------
// Row passes: one warp per row, 16 bytes a lane a load (8 bf16 or 4 fp32:
// rows must be multiples of 16 bytes, the wrapper checks).

constexpr int RQ_THREADS = 256;

__device__ __forceinline__ void load16(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __low2float(h[i]);
    v[2 * i + 1] = __high2float(h[i]);
  }
}

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

// V codes of V values at q (V = 8: 8 bytes, V = 4: 4 bytes).
template <int V>
__device__ __forceinline__ void store_codes(int8_t* q, const float (&v)[V], float scale) {
  uint32_t w[2] = {0, 0};
#pragma unroll
  for (int e = 0; e < V; ++e)
    w[e >> 2] |= (uint32_t)(quant_code(v[e], scale) & 0xff) << (8 * (e & 3));
  if (V == 8)
    *reinterpret_cast<uint2*>(q) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(q) = w[0];
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// q = codes of each row of h (rows, cols), s = the row scales.
template <typename T>
__global__ void __launch_bounds__(RQ_THREADS)
    quant_rows_kernel(const T* __restrict__ h, int8_t* __restrict__ q, float* __restrict__ s,
                      int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  const int row = (blockIdx.x * RQ_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* hr = h + (long long)row * cols;
  float a = 0.f, v[V];
  for (int i = V * lane; i < cols; i += 32 * V) {
    load16(hr + i, v);
#pragma unroll
    for (int e = 0; e < V; ++e) a = fmaxf(a, fabsf(v[e]));
  }
  const float sc = quant_scale(warp_max(a));
  if (lane == 0) s[row] = sc;
  int8_t* qr = q + (long long)row * cols;
  for (int i = V * lane; i < cols; i += 32 * V) {
    load16(hr + i, v);
    store_codes<V>(qr + i, v, sc);
  }
}

// LayerNorm in fp32 (two-pass statistics over a row's first n of its dim
// columns, as fused_block.cu's; the rest are a padded layout's zeros, and
// gamma and beta are 0 there, so their codes are 0 and the absmax is the
// row's) quantized per row from fp32: the normalised row is recomputed for
// the absmax and for the codes, never stored.
template <typename T>
__global__ void __launch_bounds__(RQ_THREADS)
    ln_quant_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, int8_t* __restrict__ q,
                    float* __restrict__ s, int rows, int dim, int n, float eps) {
  constexpr int V = 16 / sizeof(T);
  const int row = (blockIdx.x * RQ_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (long long)row * dim;
  float v[V], g[V], b[V];
  float sum = 0.f;
  for (int i = V * lane; i < dim; i += 32 * V) {
    load16(xr + i, v);
#pragma unroll
    for (int e = 0; e < V; ++e) sum += i + e < n ? v[e] : 0.f;
  }
  const float mu = warp_sum(sum) / n;
  float var = 0.f;
  for (int i = V * lane; i < dim; i += 32 * V) {
    load16(xr + i, v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = i + e < n ? v[e] - mu : 0.f;
      var += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(var) / n + eps);
  auto normed = [&](int i) {  // v <- the normalised values at columns i .. i + V - 1
    load16(xr + i, v);
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      load16(gamma + i + e, *reinterpret_cast<float(*)[4]>(g + e));
      load16(beta + i + e, *reinterpret_cast<float(*)[4]>(b + e));
    }
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = (v[e] - mu) * rstd * g[e] + b[e];
  };
  float a = 0.f;
  for (int i = V * lane; i < dim; i += 32 * V) {
    normed(i);
#pragma unroll
    for (int e = 0; e < V; ++e) a = fmaxf(a, fabsf(v[e]));
  }
  const float sc = quant_scale(warp_max(a));
  if (lane == 0) s[row] = sc;
  int8_t* qr = q + (long long)row * dim;
  for (int i = V * lane; i < dim; i += 32 * V) {
    normed(i);
    store_codes<V>(qr + i, v, sc);
  }
}

// ---------------------------------------------------------------------------
// What fc1's epilogues assume of their arithmetic, scanned over every float
// (svt_int8_scan): out[0] counts the finite v >= 0 whose successor w has
// gelu_erf(w) < gelu_erf(v), out[1] takes the bits of the largest
// |gelu_erf(v)| over every finite v < 0 (to be held to GELU_NEG_MAX), and
// out[2] counts the floats v in [0, 128 s], for each scale s in `scales`,
// whose quant_code_r differs from quant_code (the codes are odd in v).

__global__ void gelu_scan_kernel(unsigned* out) {
  unsigned bad = 0, neg = 0;
  for (unsigned b = blockIdx.x * blockDim.x + threadIdx.x; b < 0x7F7FFFFFu;
       b += gridDim.x * blockDim.x) {
    const float v = __uint_as_float(b), w = __uint_as_float(b + 1);
    bad += gelu_erf(w) < gelu_erf(v);
    neg = max(neg, __float_as_uint(fabsf(gelu_erf(-w))));
  }
  atomicAdd(&out[0], bad);
  atomicMax(&out[1], neg);
}

__global__ void div_scan_kernel(const float* scales, int n, unsigned* out) {
  unsigned bad = 0;
  for (int i = 0; i < n; ++i) {
    const float s = scales[i];
    const QuantRecip q = quant_recip(s);
    const unsigned top = __float_as_uint(128.f * s);
    for (unsigned b = blockIdx.x * blockDim.x + threadIdx.x; b <= top;
         b += gridDim.x * blockDim.x) {
      const float v = __uint_as_float(b);
      bad += quant_code_r(v, q) != quant_code(v, s);
    }
  }
  atomicAdd(&out[2], bad);
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
                            int rows, int dim, int n, float eps, cudaStream_t st) {
  ln_quant_kernel<T><<<rows_grid(rows), RQ_THREADS, 0, st>>>(x, g, b, q, s, rows, dim, n, eps);
  return cudaGetLastError();
}

// One int8 product on the engine: C (M, N) = epi(A (M, K) . W (N, K)^T),
// A's rows with their scales sa, W's with sw.
template <int EPI>
cudaError_t int8_gemm(const int8_t* A, const float* sa, const int8_t* W, const float* sw, int M,
                      int N, int K, gemm::Epilogue ep, cudaStream_t st) {
  ep.sa = sa;
  ep.sw = sw;
  return gemm::linear<EPI>(gemm::Operand{A, M, K, K}, W, N, ep, st);
}

// Partials of fc1's row absmax: one per row and 192-column tile.
int fc1_parts(int mlp) { return gemm::cdiv(mlp, gemm::BN); }

// fc1 and f's quantization: f = erf-GELU(dequantized A W^T + bias) is never
// stored; pass 1 writes part (fc1_parts(N), M) fp32, pass 2 the codes q
// (M, N) int8 and the row scales s (M,).
cudaError_t fc1_codes(const int8_t* A, const float* sa, const int8_t* W, const float* sw,
                      const float* bias, float* part, int8_t* q, float* s, int M, int N, int K,
                      cudaStream_t st) {
  gemm::Epilogue ep;
  ep.bias = bias;
  ep.part = part;
  ep.cq = q;
  ep.sq = s;
  ep.ldc = N;
  const cudaError_t e = int8_gemm<gemm::Q_GELU_MAX>(A, sa, W, sw, M, N, K, ep, st);
  return e != cudaSuccess ? e : int8_gemm<gemm::Q_GELU_Q8>(A, sa, W, sw, M, N, K, ep, st);
}

}  // namespace

extern "C" {

// x (B, N, dim) bf16 -> out (B, N, dim) bf16. Weights int8 in the torch
// Linear layout (out, in) with fp32 (out,) scales: q_qkv (3hd, dim), q_out
// (dim, hq), q_fc1 (mlp, dim), q_fc2 (dim, mlp); LN parameters and biases
// fp32. Scratch: qa (B*N, max(dim, hq)) int8 and sa (B*N,) fp32 (LN1's,
// the attention output's and LN2's codes), qf (B*N, mlp) int8 and sf
// (B*N,) fp32 (f's), part (parts, B*N) fp32 with parts = ceil(mlp / 192)
// (any other count returns cudaErrorInvalidValue), qkv (B*N, 3hd) and attn
// (B*N, hq) bf16, x1 (B*N, dim) fp32. dim and mlp multiples of 16 (int8 rows
// on 16 bytes: a width off 16 is laid out padded with zeros, the LayerNorms
// over each row's first ln_dim columns, as fused_block.cu's; zero codes and
// scales add nothing to any absmax or int32 sum), any dim_head >= 1. Heads
// are laid out as the bf16 chain's, in head_cols(dim_head) columns (hd =
// heads head_cols): q_qkv's rows past
// each head's dim_head are zero. The attention output's int8 rows take hq
// = hd rounded up to 16 bytes: its columns past hd are zeroed here, and so
// are q_out's (dim, hq) columns past each head's dim_head and past hd, so
// no row's absmax, scale or int32 sum changes.
int svt_fused_block_int8(void* x, void* ln1_s, void* ln1_b, void* q_qkv, void* s_qkv,
                         void* q_out, void* s_out, void* b_out, void* ln2_s, void* ln2_b,
                         void* q_fc1, void* s_fc1, void* b_fc1, void* q_fc2, void* s_fc2,
                         void* b_fc2, void* out, void* ws_qa, void* ws_sa, void* ws_qf,
                         void* ws_sf, void* ws_part, void* ws_qkv, void* ws_attn, void* ws_x1,
                         int B, int N, int dim, int ln_dim, int heads, int dim_head, int mlp,
                         int parts, int valid_len, float eps, int device, void* stream) {
  if (!dim_head_ok(dim_head) || !ln_dim_ok(dim, ln_dim) || parts != fc1_parts(mlp) || dim % 16 ||
      mlp % 16)
    return (int)cudaErrorInvalidValue;
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N, dp = head_cols(dim_head), hd = heads * dp, hq = (hd + 15) / 16 * 16;
  const bf16* xb = static_cast<const bf16*>(x);
  int8_t* qa = static_cast<int8_t*>(ws_qa);
  float* sa = static_cast<float*>(ws_sa);
  int8_t* qf = static_cast<int8_t*>(ws_qf);
  float* sf = static_cast<float*>(ws_sf);
  bf16* qkv = static_cast<bf16*>(ws_qkv);
  bf16* attn = static_cast<bf16*>(ws_attn);
  float* x1 = static_cast<float*>(ws_x1);
  auto i8 = [](void* p) { return static_cast<const int8_t*>(p); };
  auto f32 = [](void* p) { return static_cast<const float*>(p); };

  SVT_TRY(launch_ln_quant(xb, f32(ln1_s), f32(ln1_b), qa, sa, M, dim, ln_dim, eps, st));
  gemm::Epilogue e_qkv;
  e_qkv.cb = qkv;
  e_qkv.ldc = 3 * hd;
  SVT_TRY(int8_gemm<gemm::Q_BF16>(qa, sa, i8(q_qkv), f32(s_qkv), M, 3 * hd, dim, e_qkv, st));
  if (hq > hd)  // the attention output's columns past hd: zeros in its 16-byte rows
    SVT_TRY(cudaMemset2DAsync(attn + hd, (size_t)hq * 2, 0, (size_t)(hq - hd) * 2, M, st));
  SVT_TRY(flash_fwd(packed(qkv, N, 3 * hd, dp), packed(qkv + hd, N, 3 * hd, dp),
                    packed(qkv + 2 * hd, N, 3 * hd, dp), packed(attn, N, hq, dp), nullptr, B,
                    heads, N, N, valid_len, dim_head, st));
  SVT_TRY(launch_quant_rows(static_cast<const bf16*>(attn), qa, sa, M, hq, st));
  gemm::Epilogue e_out;
  e_out.bias = f32(b_out);
  e_out.res = xb;
  e_out.ldr = dim;
  e_out.cf = x1;
  e_out.ldc = dim;
  SVT_TRY(int8_gemm<gemm::Q_RES_F32>(qa, sa, i8(q_out), f32(s_out), M, dim, hq, e_out, st));
  SVT_TRY(launch_ln_quant(static_cast<const float*>(x1), f32(ln2_s), f32(ln2_b), qa, sa, M, dim,
                          ln_dim, eps, st));
  SVT_TRY(fc1_codes(qa, sa, i8(q_fc1), f32(s_fc1), f32(b_fc1), static_cast<float*>(ws_part), qf,
                    sf, M, mlp, dim, st));
  gemm::Epilogue e_fc2;
  e_fc2.bias = f32(b_fc2);
  e_fc2.resf = x1;
  e_fc2.ldr = dim;
  e_fc2.cb = static_cast<bf16*>(out);
  e_fc2.ldc = dim;
  SVT_TRY(int8_gemm<gemm::Q_RES_BF16>(qf, sf, i8(q_fc2), f32(s_fc2), M, dim, mlp, e_fc2, st));
  return (int)cudaSuccess;
}

// The chain's row quantizer alone: h (rows, cols) fp32 (h_is_f32) or bf16
// -> q (rows, cols) int8, s (rows,) fp32; rows of a multiple of 16 bytes.
int svt_quant_rows(void* h, int h_is_f32, void* q, void* s, int rows, int cols, int device,
                   void* stream) {
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qq = static_cast<int8_t*>(q);
  float* ss = static_cast<float*>(s);
  if (h_is_f32) return (int)launch_quant_rows(static_cast<const float*>(h), qq, ss, rows, cols, st);
  return (int)launch_quant_rows(static_cast<const bf16*>(h), qq, ss, rows, cols, st);
}

// The chain's int8 product alone, int32 accumulators out (Q_S32): A (M, K)
// . W (N, K)^T -> acc (M, N); K a multiple of 16, N of 4.
int svt_int8_gemm_s32(void* A, void* W, void* acc, int M, int N, int K, int device,
                      void* stream) {
  SVT_TRY(cudaSetDevice(device));
  gemm::Epilogue ep;
  ep.cf = static_cast<float*>(acc);
  ep.ldc = N;
  return (int)int8_gemm<gemm::Q_S32>(static_cast<const int8_t*>(A), nullptr,
                                     static_cast<const int8_t*>(W), nullptr, M, N, K, ep,
                                     static_cast<cudaStream_t>(stream));
}

// One of the chain's products alone, on A (M, K) int8 with row scales sa
// and W (N, K) int8 with sw: epi 1 = qkv (C bf16), 2 = out-projection (C
// fp32 = R bf16 + (. + bias)), 3 = fc1's pass 1 (part (ceil(N / 192), M)),
// 4 = fc1's pass 2 (from part: C int8 codes, sq (M,) their scales), 5 = fc2
// (C bf16 = R fp32 + (. + bias)), 6 = fc1 and f's quantization as the chain
// runs it (passes 1 and 2: C, sq, part).
int svt_int8_block_gemm(int epi, void* A, void* sa, void* W, void* sw, void* bias, void* R,
                        void* C, void* part, void* sq, int M, int N, int K, int device,
                        void* stream) {
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* w = static_cast<const int8_t*>(W);
  const float* s_a = static_cast<const float*>(sa);
  const float* s_w = static_cast<const float*>(sw);
  gemm::Epilogue ep;
  ep.bias = static_cast<const float*>(bias);
  ep.ldc = N;
  ep.ldr = N;
  ep.part = static_cast<float*>(part);
  ep.cq = static_cast<int8_t*>(C);
  ep.sq = static_cast<float*>(sq);
  switch (epi) {
    case 1:
      ep.cb = static_cast<bf16*>(C);
      return (int)int8_gemm<gemm::Q_BF16>(a, s_a, w, s_w, M, N, K, ep, st);
    case 2:
      ep.res = static_cast<const bf16*>(R);
      ep.cf = static_cast<float*>(C);
      return (int)int8_gemm<gemm::Q_RES_F32>(a, s_a, w, s_w, M, N, K, ep, st);
    case 3:
      return (int)int8_gemm<gemm::Q_GELU_MAX>(a, s_a, w, s_w, M, N, K, ep, st);
    case 4:
      return (int)int8_gemm<gemm::Q_GELU_Q8>(a, s_a, w, s_w, M, N, K, ep, st);
    case 5:
      ep.resf = static_cast<const float*>(R);
      ep.cb = static_cast<bf16*>(C);
      return (int)int8_gemm<gemm::Q_RES_BF16>(a, s_a, w, s_w, M, N, K, ep, st);
    case 6:
      return (int)fc1_codes(a, s_a, w, s_w, ep.bias, ep.part, ep.cq, ep.sq, M, N, K, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The scans above into out[0..2] (zeroed first), out[3] = the bits of
// GELU_NEG_MAX: scales (n,) fp32 on the device.
int svt_int8_scan(void* scales, int n, void* out, int device, void* stream) {
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* o = static_cast<unsigned*>(out);
  unsigned init[4] = {0, 0, 0, 0};
  memcpy(&init[3], &GELU_NEG_MAX, sizeof(float));
  SVT_TRY(cudaMemcpyAsync(o, init, sizeof(init), cudaMemcpyHostToDevice, st));
  gelu_scan_kernel<<<1024, 256, 0, st>>>(o);
  SVT_TRY(cudaGetLastError());
  div_scan_kernel<<<1024, 256, 0, st>>>(static_cast<const float*>(scales), n, o);
  return (int)cudaGetLastError();
}

#ifdef SVT_GEMM_PROFILE
// The engine's cycle counts (gemm.cuh) in this source's instances, read and
// zeroed.
int svt_gemm_profile_int8(unsigned long long* out) { return svt::gemm::profile_read(out); }
#endif

}  // extern "C"
