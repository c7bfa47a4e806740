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
// on sub-ico 3's 1,281, MS-SiT's folded windows of 20 to 320) and head dim
// 64 or 32 (MS-SiT, serving and training); the CLS block keeps dh 64, the
// only width its backward takes (no MS-SiT pools by CLS).
// The training entries (svt_fused_block[_cls]_train_fwd) run the same chain
// and also keep what the backward (fused_block_bwd.cu) reads: LN
// statistics, the fp32 fc1 pre-activation and the attention row
// log-sum-exp.
//
// Bounds on this card: at SiT-tiny (dim 192, mlp 768, N 321) the four GEMMs
// are ~70% of the FLOPs; every intermediate makes one round trip through HBM,
// so the chain moves ~10x the bytes of the block's input and output (0.82 GB
// at B=256: 0.25 ms at 3.35 TB/s). The GEMMs run on gemm.cuh's engine: a
// persistent, warp-specialised kernel (one producer thread loading A and W
// tiles by TMA into an mbarrier ring, two consumer warpgroups on m64n192k16
// wgmma) with the bias / erf-GELU / residual epilogues fused into a store
// by TMA.
//
// At dims 96 and 192 (fused_mlp_route: MS-SiT's stages 0-1, SiT-tiny; the
// training form at dim 96) the chain is four launches: [LN1 + qkv] -> attention -> out-proj (+res) ->
// [fused MLP]. LN1 runs in the qkv product's prologue (gemm.cuh F_LNA: a
// tile's K-steps hold whole rows, normalised in the ring before its
// products), and LN2 -> fc1 -> GELU -> fc2 (+res) is one kernel
// (fused_mlp.cu), so h, h2 and f never reach device memory when serving:
// at dim 96 the serving chain moves 13 widths of x where the seven launches
// moved 26. Both reproduce the chain's arithmetic, so the outputs are the
// same bits.
//
// The CLS block's attention (8 top rows against at most 4,096 keys:
// cls_fwd_route) is flash_attention.cu's few-query forward (the scores of
// every key in shared memory). At dims 96 / 192 (cls_ln1_in_kv) the chain
// is [LN1 + K/V] (F_LNA over W_kv), the attention launch making its own Q
// (LN1 of the sample's top rows and their product with the head's W_q
// inside the CTA), then the out-projection, LN2, fc1 and fc2 on the top
// rows: six launches where there were eight, and neither h (serving) nor q
// is written. Wider, the eight launches, the attention the few-query one:
// Q made in the CTA (the head's W_q streamed through each CTA) took longer
// there than the Q product. The fused MLP kernel is not used on the top
// rows: on SiT-tiny's 2,048 it took 1.8x as long as the three launches
// (PERF.md).
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
#include "fused_mlp.cuh"
#include "gemm.cuh"

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
// Host-side launch helpers (all on `stream`, no synchronisation).

cudaError_t launch_ln(const bf16* x, const float* g, const float* b, bf16* y, int rows, int dim,
                      float eps, float* stats, cudaStream_t st) {
  const int per_block = LN_THREADS / 32;
  layer_norm_kernel<<<(rows + per_block - 1) / per_block, LN_THREADS, 0, st>>>(x, g, b, y, rows,
                                                                              dim, eps, stats);
  return cudaGetLastError();
}

// The chain's products on gemm.cuh's engine: C = epi(A W^T), W (N, K) in
// the torch Linear layout; A's logical row r at physical row (r / rpg) *
// gstride + r % rpg (rpg 0: A's own rows).
template <int EPI>
cudaError_t launch_gemm(const bf16* A, int M, int K, int rpg, int gstride, const bf16* W, int N,
                        gemm::Epilogue ep, cudaStream_t st) {
  return gemm::linear<EPI>(gemm::Operand{A, M, K, K, rpg, gstride}, W, N, ep, st);
}

gemm::Epilogue out_bf16(bf16* C, int ldc, const float* bias = nullptr, float* pre = nullptr) {
  gemm::Epilogue ep;
  ep.cb = C;
  ep.ldc = ldc;
  ep.bias = bias;
  ep.pre = pre;
  return ep;
}

// C = A W^T + bias + R, R's rows through (rpg, gstride).
gemm::Epilogue out_res(bf16* C, int ldc, const float* bias, const bf16* R, int ldr, int rpg,
                       int gstride) {
  gemm::Epilogue ep = out_bf16(C, ldc, bias);
  ep.res = R;
  ep.ldr = ldr;
  ep.r_rpg = rpg;
  ep.r_gstride = gstride;
  return ep;
}

// Attention on the packed activations (B, rows, ld), head h at columns
// h * dh: the streamed kernel of flash_attention.cu (K and V through shared
// memory in 64- or 128-key tiles by TMA, wgmma, online softmax, any N).
cudaError_t launch_attention(const bf16* Q, int ldq, int nq, const bf16* K, const bf16* V,
                             int ldkv, int n, bf16* O, int ldo, int B, int heads, int dh,
                             int valid_len, float* lse, cudaStream_t st) {
  return flash_fwd(packed(Q, nq, ldq, dh), packed(K, n, ldkv, dh), packed(V, n, ldkv, dh),
                   packed(O, nq, ldo, dh), lse, B, heads, nq, n, valid_len, dh, st);
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
  if (dim_head != ATT_DH && dim_head != 32) return (int)cudaErrorInvalidValue;
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N, hd = heads * dim_head;
  bf16* h2 = s.h2 != nullptr ? s.h2 : h;

  const bool fused = fused_mlp_route(dim, mlp, s.h2 != nullptr);
  if (fused) {  // LN1 in qkv's prologue; the training form keeps h1 and its statistics
    gemm::Epilogue ep = out_bf16(qkv, 3 * hd);
    ep.ln_gamma = (const float*)ln1_s;
    ep.ln_beta = (const float*)ln1_b;
    ep.ln_eps = eps;
    ep.ln_stats = s.stats1;
    ep.ln_out = s.h2 != nullptr ? h : nullptr;
    SVT_TRY(launch_gemm<gemm::F_LNA>(xb, M, dim, 0, 0, (const bf16*)w_qkv, 3 * hd, ep, st));
  } else {
    SVT_TRY(launch_ln(xb, (const float*)ln1_s, (const float*)ln1_b, h, M, dim, eps, s.stats1,
                      st));
    SVT_TRY(launch_gemm<gemm::F_NONE>(h, M, dim, 0, 0, (const bf16*)w_qkv, 3 * hd,
                                      out_bf16(qkv, 3 * hd), st));
  }
  SVT_TRY(launch_attention(qkv, 3 * hd, N, qkv + hd, qkv + 2 * hd, 3 * hd, N, attn, hd, B, heads,
                           dim_head, valid_len, s.lse, st));
  SVT_TRY(launch_gemm<gemm::F_RES>(attn, M, hd, 0, 0, (const bf16*)w_out, dim,
                                   out_res(x1, dim, (const float*)b_out, xb, dim, M, 0), st));
  if (fused) {  // LN2 -> fc1 -> GELU -> fc2 (+ x1): one kernel
    MlpSaves ms;
    if (s.h2 != nullptr) {
      ms.h2 = s.h2;
      ms.stats2 = s.stats2;
      ms.fpre = s.fpre;
      ms.f = f;
    }
    return (int)fused_mlp(x1, (const float*)ln2_s, (const float*)ln2_b, (const bf16*)w_fc1,
                          (const float*)b_fc1, (const bf16*)w_fc2, (const float*)b_fc2,
                          static_cast<bf16*>(out), M, dim, mlp, eps, ms, st);
  }
  SVT_TRY(launch_ln(x1, (const float*)ln2_s, (const float*)ln2_b, h2, M, dim, eps, s.stats2, st));
  SVT_TRY(launch_gemm<gemm::F_GELU>(h2, M, dim, 0, 0, (const bf16*)w_fc1, mlp,
                                    out_bf16(f, mlp, (const float*)b_fc1, s.fpre), st));
  SVT_TRY(launch_gemm<gemm::F_RES>(
      f, M, mlp, 0, 0, (const bf16*)w_fc2, dim,
      out_res(static_cast<bf16*>(out), dim, (const float*)b_fc2, x1, dim, M, 0), st));
  return (int)cudaSuccess;
}

// Whether the CLS chain's attention is the few-query forward
// (ops/fused_block.py::cls_fwd_route), and whether, at dims 96 / 192, it
// makes its own Q with LN1 in the K/V product's prologue (cls_ln1_in_kv:
// F_LNA takes K = 96 or 192; past them the LayerNorm pass writes h and the
// Q product reads it: Q made in the CTA measured slower there, PERF.md).
bool cls_fwd_route(int N, int rows) { return few_query_fwd(rows, N, ATT_DH, false); }
bool cls_ln1_in_kv(int N, int rows, int dim) {
  return cls_fwd_route(N, rows) && (dim == 96 || dim == 192) &&
         few_query_makes_q(rows, N, dim);
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
  const bool train = s.h2 != nullptr;
  bf16* h2 = train ? s.h2 : h;

  if (cls_ln1_in_kv(N, rows, dim)) {  // [LN1 + K/V], the few-query attention making Q
    gemm::Epilogue ep = out_bf16(kv, 2 * hd);
    ep.ln_gamma = (const float*)ln1_s;
    ep.ln_beta = (const float*)ln1_b;
    ep.ln_eps = eps;
    ep.ln_stats = s.stats1;
    ep.ln_out = train ? h : nullptr;
    SVT_TRY(launch_gemm<gemm::F_LNA>(xb, M, dim, 0, 0, wkv, 2 * hd, ep, st));
    FewQ fq;
    fq.x = xb;
    fq.gamma = (const float*)ln1_s;
    fq.beta = (const float*)ln1_b;
    fq.wq = wq;
    fq.dim = dim;
    fq.eps = eps;
    fq.q_out = train ? q : nullptr;
    SVT_TRY(flash_fwd_few_q(fq, packed(kv, N, 2 * hd), packed(kv + hd, N, 2 * hd),
                            packed(attn, rows, hd), s.lse, B, heads, rows, N, valid_len, st));
  } else {  // LN1, K/V, Q, then the attention (the few-query forward on cls_fwd_route)
    SVT_TRY(launch_ln(xb, (const float*)ln1_s, (const float*)ln1_b, h, M, dim, eps, s.stats1,
                      st));
    SVT_TRY(launch_gemm<gemm::F_NONE>(h, M, dim, 0, 0, wkv, 2 * hd, out_bf16(kv, 2 * hd), st));
    SVT_TRY(launch_gemm<gemm::F_NONE>(h, Mt, dim, rows, N, wq, hd, out_bf16(q, hd), st));
    SVT_TRY(launch_attention(q, hd, rows, kv, kv + hd, 2 * hd, N, attn, hd, B, heads, ATT_DH,
                             valid_len, s.lse, st));
  }
  SVT_TRY(launch_gemm<gemm::F_RES>(attn, Mt, hd, 0, 0, (const bf16*)w_out, dim,
                                   out_res(x1, dim, (const float*)b_out, xb, dim, rows, N), st));
  SVT_TRY(launch_ln(x1, (const float*)ln2_s, (const float*)ln2_b, h2, Mt, dim, eps, s.stats2, st));
  SVT_TRY(launch_gemm<gemm::F_GELU>(h2, Mt, dim, 0, 0, (const bf16*)w_fc1, mlp,
                                    out_bf16(f, mlp, (const float*)b_fc1, s.fpre), st));
  SVT_TRY(launch_gemm<gemm::F_RES>(
      f, Mt, mlp, 0, 0, (const bf16*)w_fc2, dim,
      out_res(static_cast<bf16*>(out), dim, (const float*)b_fc2, x1, dim, Mt, 0), st));
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

const char* svt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x (B, N, dim) -> out (B, N, dim), dim_head 32 or 64. Weights in torch
// Linear layout (out, in),
// bf16: w_qkv (3hd, dim), w_out (dim, hd), w_fc1 (mlp, dim), w_fc2 (dim, mlp);
// LN parameters and biases fp32. Scratch: h (B*N, dim), qkv (B*N, 3hd),
// attn (B*N, hd), x1 (B*N, dim), f (B*N, mlp), all bf16; where
// svt_block_fused_mlp(dim, mlp, 0), h and f are not touched (any pointer).
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
// f (B*rows, mlp), all bf16. Where svt_cls_fwd_route(N, rows, dim) says
// (its bits: 1 the few-query attention makes Q, 2 LN1 in the K/V product),
// q is not touched (any pointer), and h where bit 2 is set only as LN2's
// output (B*rows, dim).
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

// The CLS forward's route at these shapes, as bits: 1 the attention is one
// few-query launch that makes its own Q, 2 LN1 runs in the K/V product's
// prologue (ops/fused_block.py: cls_fwd_route, cls_ln1_in_kv,
// cls_fwd_launches).
int svt_cls_fwd_route(int N, int rows, int dim) {
  if (!cls_fwd_route(N, rows)) return 0;
  return 1 | (cls_ln1_in_kv(N, rows, dim) ? 2 : 0);
}

// One forward product of the chain alone, for holding it against its plain
// version: C (M, N) bf16 = epi(A (M, K) . W (N, K)^T) with epi 0 = none,
// 1 = bias + erf-GELU (with Cpre set, the fp32 pre-activation kept there),
// 2 = bias + the residual R (M, N).
int svt_block_gemm(int epi, void* A, void* W, void* bias, void* R, void* C, void* Cpre, int M,
                   int N, int K, int device, void* stream) {
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* w = static_cast<const bf16*>(W);
  bf16* c = static_cast<bf16*>(C);
  if (epi == 0) return (int)launch_gemm<gemm::F_NONE>(a, M, K, 0, 0, w, N, out_bf16(c, N), st);
  if (epi == 1)
    return (int)launch_gemm<gemm::F_GELU>(a, M, K, 0, 0, w, N,
                                          out_bf16(c, N, (const float*)bias, (float*)Cpre), st);
  if (epi == 2)
    return (int)launch_gemm<gemm::F_RES>(
        a, M, K, 0, 0, w, N, out_res(c, N, (const float*)bias, (const bf16*)R, N, M, 0), st);
  return (int)cudaErrorInvalidValue;
}

// Whether the block chains (train: the training forward) run LN1 in the qkv
// product's prologue and the fused MLP kernel at this width
// (fused_mlp_route): 1 or 0.
int svt_block_fused_mlp(int dim, int mlp, int train) {
  return fused_mlp_route(dim, mlp, train != 0) ? 1 : 0;
}

// The fused MLP half alone: out (M, dim) = x1 + fc2(GELU(fc1(LN2(x1)))),
// as the chain runs it where svt_block_fused_mlp; with h2 set (training),
// also h2 (M, dim) bf16, stats2 (M, 2), fpre (M, mlp) fp32 and f (M, mlp)
// bf16.
int svt_block_mlp(void* x1, void* gamma, void* beta, void* w1, void* b1, void* w2, void* b2,
                  void* out, void* h2, void* stats2, void* fpre, void* f, int M, int dim,
                  int mlp, float eps, int device, void* stream) {
  SVT_TRY(cudaSetDevice(device));
  MlpSaves s;
  s.h2 = (bf16*)h2;
  s.stats2 = (float*)stats2;
  s.fpre = (float*)fpre;
  s.f = (bf16*)f;
  return (int)fused_mlp((const bf16*)x1, (const float*)gamma, (const float*)beta,
                        (const bf16*)w1, (const float*)b1, (const bf16*)w2, (const float*)b2,
                        (bf16*)out, M, dim, mlp, eps, s, static_cast<cudaStream_t>(stream));
}

// The qkv product with LN1 in its prologue alone: C (M, N) bf16 =
// LN(x) W^T, x (M, K) with K = 96 or 192, W (N, K); with h set (training),
// also the normalised rows h (M, K) bf16 and stats (M, 2) fp32.
int svt_block_ln_gemm(void* x, void* gamma, void* beta, void* W, void* C, void* h, void* stats,
                      int M, int N, int K, float eps, int device, void* stream) {
  SVT_TRY(cudaSetDevice(device));
  gemm::Epilogue ep = out_bf16(static_cast<bf16*>(C), N);
  ep.ln_gamma = (const float*)gamma;
  ep.ln_beta = (const float*)beta;
  ep.ln_eps = eps;
  ep.ln_stats = (float*)stats;
  ep.ln_out = (bf16*)h;
  if ((h == nullptr) != (stats == nullptr)) return (int)cudaErrorInvalidValue;
  return (int)launch_gemm<gemm::F_LNA>((const bf16*)x, M, K, 0, 0, (const bf16*)W, N, ep,
                                       static_cast<cudaStream_t>(stream));
}

#ifdef SVT_GEMM_PROFILE
// The engine's cycle counts (gemm.cuh), read and zeroed.
int svt_gemm_profile(unsigned long long* out) { return svt::gemm::profile_read(out); }
#endif

}  // extern "C"
