// Hopper (sm_90a) gather-fused patch embedding.
//
// Replaces the TPU kernel
// surface_vision_transformers_tpu/ops/pallas/patch_embed.py::
// pallas_patch_embed (_embed_kernel) -> svt_patch_embed:
//   out[b, l, :] = bf16( sum_k tok[b, l, k] W[:, k] + bias ),
//   tok[b, l, v * C + c] = bf16( x[b, c, idx[l, v]] )      ((v c) order),
// fp32 accumulation and an fp32 bias, rounded once. The TPU version gathers
// the tokens in XLA and writes them to HBM before its GEMM kernel; here the
// gather is the GEMM's A-operand load, so the (B, L, V C) tokens never
// exist in device memory.
//
// One CTA per 64 (sample, patch) rows, 4 warps. It gathers the rows' tokens
// once into shared memory as bf16, in the (v c) K order, zero-padded to Kp
// (a multiple of 64: 612 -> 640 at sub-ico 2, 180 -> 192 at sub-ico 3):
// each thread takes one (row, vertex), reads its table entry and the C
// channels of that vertex (x is channel-major, so the channels are G
// elements apart and each is its own load), and writes C adjacent bf16.
// Then the CTA walks the output columns 64 at a time, streaming W (dim, Kp)
// in 64-wide K slices through a two-stage cp.async ring, bf16 mma.sync
// (m16n8k16, fp32 accumulators) with the warps as 2 x 2 tiles of 32 x 32,
// and adds the bias in the epilogue. x may be fp32 or bf16.
//
// What bounds it on this card: bytes. SiT-tiny at B=256 reads 168 MB of
// fp32 x (each vertex about 1.2 times, adjacent patches sharing boundary
// vertices; L2 absorbs the repeats) and writes 31.5 MB: 0.06 ms at 3.35
// TB/s, against 20 GFLOP (0.02 ms at the bf16 peak). The gather is scalar
// 4-byte loads from scattered vertices; PERF.md has how far from the bound
// that leaves it.
//
// C interface as fused_block.cu's: returns cudaGetLastError(), nothing
// synchronises, nothing allocates.

#include "common.cuh"

namespace {

using namespace svt;

constexpr int PE_BM = 64, PE_BN = 64, PE_BK = 64, PE_WLD = PE_BK + 8, PE_THREADS = 128;

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }

size_t smem_bytes(int Kp) {
  return sizeof(bf16) * ((size_t)PE_BM * (Kp + 8) + 2 * (size_t)PE_BN * PE_WLD);
}

template <typename T>
__global__ void __launch_bounds__(PE_THREADS)
    patch_embed_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                       const bf16* __restrict__ W, const float* __restrict__ bias,
                       bf16* __restrict__ out, int B, int C, int G, int L, int V, int Kp,
                       int dim) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = Kp + 8;
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sW = sA + PE_BM * lda;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = B * L, m0 = blockIdx.x * PE_BM, K = V * C;

  // gather: one (row, vertex) per thread and step, its C channels
  for (int i = tid; i < PE_BM * V; i += PE_THREADS) {
    const int r = i / V, v = i - r * V, m = m0 + r;
    bf16* dst = sA + r * lda + v * C;
    if (m < M) {
      const int b = m / L, l = m - b * L;
      const T* src = x + (long long)b * C * G + idx[(long long)l * V + v];
      for (int c = 0; c < C; ++c) dst[c] = to_bf16(src[(long long)c * G]);
    } else {
      for (int c = 0; c < C; ++c) dst[c] = __float2bfloat16(0.f);
    }
  }
  const int pad = Kp - K;
  for (int i = tid; i < PE_BM * pad; i += PE_THREADS)
    sA[(i / pad) * lda + K + i % pad] = __float2bfloat16(0.f);
  __syncthreads();

  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t = lane & 3;
  const int KS = Kp / PE_BK;
  for (int n0 = 0; n0 < dim; n0 += PE_BN) {
    auto load_w = [&](int stage, int ks) {
#pragma unroll
      for (int i = 0; i < (PE_BN * PE_BK / 8) / PE_THREADS; ++i) {
        const int c = tid + i * PE_THREADS;
        const int r = c >> 3, kc = (c & 7) * 8;
        const bool ok = n0 + r < dim;
        cp_async16(sW + (stage * PE_BN + r) * PE_WLD + kc,
                   ok ? W + (long long)(n0 + r) * Kp + ks * PE_BK + kc : W, ok);
      }
    };
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    load_w(0, 0);
    cp_async_commit();
    for (int ks = 0; ks < KS; ++ks) {
      if (ks + 1 < KS) {
        load_w((ks + 1) & 1, ks + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* w_s = sW + (ks & 1) * PE_BN * PE_WLD;
#pragma unroll
      for (int kk = 0; kk < PE_BK; kk += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(af[mi], sA + (wm * 32 + mi * 16 + (lane & 15)) * lda + ks * PE_BK + kk +
                                  (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, w_s + (wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * PE_WLD +
                               kk + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][2 * nj], af[mi], bfr[0], bfr[1]);
            mma_bf16(acc[mi][2 * nj + 1], af[mi], bfr[2], bfr[3]);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm * 32 + mi * 16 + g + half * 8;
        if (r >= M) continue;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int c = n0 + wn * 32 + ni * 8 + 2 * t;
          if (c >= dim) continue;
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * dim + c) =
              __floats2bfloat162_rn(acc[mi][ni][2 * half] + bias[c],
                                    acc[mi][ni][2 * half + 1] + bias[c + 1]);
        }
      }
  }
}

template <typename T>
int launch_patch_embed(const T* x, const int* idx, const bf16* W, const float* bias, bf16* out,
                       int B, int C, int G, int L, int V, int Kp, int dim, cudaStream_t st) {
  const size_t smem = smem_bytes(Kp);
  SVT_TRY(cudaFuncSetAttribute(patch_embed_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  const int blocks = (B * L + PE_BM - 1) / PE_BM;
  patch_embed_kernel<T><<<blocks, PE_THREADS, smem, st>>>(x, idx, W, bias, out, B, C, G, L, V, Kp,
                                                          dim);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, C, G) fp32 (x_is_f32) or bf16, idx (L, V) int32 vertex ids < G,
// W (dim, Kp) bf16 with K = V * C in (v c) order zero-padded to Kp (a
// multiple of 64), bias (dim,) fp32 -> out (B, L, dim) bf16.
int svt_patch_embed(void* x, int x_is_f32, void* idx, void* W, void* bias, void* out, int B,
                    int C, int G, int L, int V, int Kp, int dim, int device, void* stream) {
  if (Kp % PE_BK || Kp < V * C || dim % 8) return (int)cudaErrorInvalidValue;
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const bf16* w = static_cast<const bf16*>(W);
  const float* b = static_cast<const float*>(bias);
  bf16* o = static_cast<bf16*>(out);
  if (x_is_f32)
    return launch_patch_embed(static_cast<const float*>(x), ix, w, b, o, B, C, G, L, V, Kp, dim,
                              st);
  return launch_patch_embed(static_cast<const bf16*>(x), ix, w, b, o, B, C, G, L, V, Kp, dim, st);
}

}  // extern "C"
