// PTX helpers and small device functions shared by the kernels
// (fused_block.cu: block forward; fused_block_bwd.cu: block backward;
// flash_attention.cu: attention, forward and backward).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace svt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; copies zeros when `pred` is false (src-size 0).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  int src_size = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> bf16x2 (lo in the low half, as mma fragments expect).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// d/dv of gelu_erf: 0.5 (1 + erf(v / sqrt 2)) + v phi(v).
__device__ __forceinline__ float gelu_erf_grad(float v) {
  return 0.5f * (1.0f + erff(v * 0.70710678118654752f)) +
         v * 0.39894228040143268f * __expf(-0.5f * v * v);
}

// Logical row r of a strided row set -> physical row:
// (r / rpg) * gstride + r % rpg. Identity when rpg == M, gstride == 0; the
// first `rows` rows of each N-row sample when rpg == rows, gstride == N.
__device__ __forceinline__ long long map_row(int r, int rpg, int gstride) {
  return (long long)(r / rpg) * gstride + (r % rpg);
}

// Philox4x32-10 (Salmon et al., SC'11): four 32-bit words from a 128-bit
// counter {c0, c1, 0, 0} and a 64-bit key {k0, k1}. The port's plain torch
// copy is ops/flash_attention.py::philox4x32.
__device__ __forceinline__ uint4 philox4x32(uint32_t c0, uint32_t c1, uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// -- attention, head dim 64 (forward and backward)

constexpr int ATT_DH = 64, ATT_BQ = 64, ATT_BK = 32, ATT_LD = ATT_DH + 8, ATT_THREADS = 128;

// s[4][4]: scores of this warp's 16 query rows against keys kb .. kb+31.
__device__ __forceinline__ void score_chunk(float s[4][4], const uint32_t qf[4][4],
                                            const bf16* sK, int kb, int lane) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int np = 0; np < 2; ++np)
#pragma unroll
    for (int ks = 0; ks < ATT_DH / 16; ++ks) {
      uint32_t kf[4];
      ldmatrix_x4(kf, sK + (kb + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ATT_LD + ks * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
      mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
    }
}

}  // namespace svt

#define SVT_TRY(expr)                      \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)
