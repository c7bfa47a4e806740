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

// -- Hopper warpgroup MMA (wgmma), bf16 in, fp32 accumulators
//
// Shared-memory operands are [rows][64] bf16 tiles (128-byte rows) in the
// 128-byte swizzle: the 16-byte chunk c of row r sits at chunk c ^ (r % 8),
// the tile starts on 1024 bytes. One such tile serves as a K-major operand
// (rows = M or N, the 64 columns = K; the k16 step s starts 32 s bytes in)
// and as an MN-major one (rows = K, the 64 columns = M or N; the k16 step s
// starts 2048 s bytes in): 8-row groups 1024 bytes apart either way.

// Element offset of (r, c) in a swizzled [rows][64] bf16 tile.
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 64 + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

// Matrix descriptor of a swizzled tile at p (128-byte swizzle, 8-row groups
// 1024 bytes apart).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from touching accumulators across an asynchronous wgmma.
__device__ __forceinline__ void wg_hold(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Generic-proxy shared-memory writes (st.shared, cp.async) -> visible to wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define SVT_WG_D32                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SVT_WG_R32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64) (+)= A (64 x 16) B (16 x 64), both from shared memory; TA / TB
// 1 for an MN-major operand. d is overwritten when scale_d is 0. Thread
// (warp w, lane 4 g + t) holds d[4 j + e] = (row 16 w + g + 8 (e >> 1), col
// 8 j + 2 t + (e & 1)).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SVT_WG_R32
               ", %32, %33, p, 1, 1, %35, %36;\n}\n"
               : SVT_WG_D32
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// The same with A from registers, as an mma.sync m16k16 fragment per warp
// (rows 16 w .. 16 w + 15).
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SVT_WG_R32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
               : SVT_WG_D32
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// -- attention, head dim 64 (forward and backward)

constexpr int ATT_DH = 64, ATT_BQ = 64, ATT_LD = ATT_DH + 8, ATT_THREADS = 128;

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
