// PTX helpers and small device functions shared by the kernels
// (fused_block.cu: block forward; fused_block_bwd.cu: block backward;
// flash_attention.cu: attention, forward and backward; gemm.cuh: the block
// GEMMs), and the host side of their TMA tensor maps.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// An upper bound of |gelu_erf(v)| over every negative float (the largest
// is 0.16997, near v = -0.75). Over v >= 0 gelu_erf is non-decreasing, so
// the largest |gelu_erf| of a set of values is gelu_erf of their maximum
// whenever that reaches this bound. chip_smoke.py phase 20 scans every
// float for both properties (svt_int8_scan).
constexpr float GELU_NEG_MAX = 0.17f;

// The int8 chain's quantization (fused_block_int8.cu; ops/quant.py is the
// plain version), bit for bit the JAX arithmetic: scale = max(absmax,
// 1e-30) / 127 and code = clamp(rint(v / scale), -127, 127), both IEEE
// divisions, rint half to even.
__device__ __forceinline__ float quant_scale(float absmax) {
  return __fdiv_rn(fmaxf(absmax, 1e-30f), 127.0f);
}

__device__ __forceinline__ int quant_code(float v, float scale) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(v, scale))));
}

// v / s rounded to nearest even, as __fdiv_rn, from r = 1 / s rounded to
// nearest: v r, then two Markstein corrections, each residual v - s q exact
// by FMA while it stays a normal float; the second starts from a faithful
// quotient, so it returns the correctly rounded one.
__device__ __forceinline__ float div_rn(float v, float s, float r) {
  float q = __fmul_rn(v, r);
  q = __fmaf_rn(__fmaf_rn(-q, s, v), r, q);
  return __fmaf_rn(__fmaf_rn(-q, s, v), r, q);
}

// A row's scale in the form quant_code_r takes, made once per row: (k, s k,
// 1 / (s k)) with k = 2^64 below s = 2^-60 (powers of two: exact), so that
// every residual that can move a code is a normal float.
struct QuantRecip {
  float k, s, r;
};
__device__ __forceinline__ QuantRecip quant_recip(float scale) {
  const float k = scale < 0x1p-60f ? 0x1p64f : 1.f;
  const float s = __fmul_rn(scale, k);
  return QuantRecip{k, s, __frcp_rn(s)};
}

// quant_code without a division per value: the same code for every v
// (svt_int8_scan checks every v up to 128 s at a set of scales). The
// quotient is clamped to +-127 (before rounding: the bounds are integers)
// and rounded half to even by adding 1.5 * 2^23, whose float has unit
// spacing; its low bits are then the code (no float-to-int conversion).
__device__ __forceinline__ int quant_code_r(float v, const QuantRecip& q) {
  const float t = fminf(fmaxf(div_rn(__fmul_rn(v, q.k), q.s, q.r), -127.f), 127.f);
  return __float_as_int(__fadd_rn(t, 12582912.f)) - 0x4B400000;
}

// d/dv of gelu_erf: 0.5 (1 + erf(v / sqrt 2)) + v phi(v).
__device__ __forceinline__ float gelu_erf_grad(float v) {
  return 0.5f * (1.0f + erff(v * 0.70710678118654752f)) +
         v * 0.39894228040143268f * __expf(-0.5f * v * v);
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
// 1024 bytes apart). `lbo` matters only to an MN-major operand wider than 64
// (M or N): the bytes from one [rows][64] tile of it to the next.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo = 16) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
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
// Keep the compiler from touching accumulators (or A fragments) across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void wg_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void wg_hold(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void wg_hold(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}
// Generic-proxy shared-memory writes (st.shared, cp.async) -> visible to wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- mbarriers, TMA, named barriers and register budgets (warp-specialised
// kernels: flash_attention.cu's forward and backward, gemm.cuh)

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and expect `bytes` from the copy engine in the current phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`; a wait
// far beyond any kernel's run traps rather than hangs.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (long long n = 0; !done; ++n) {
    if (n > (1ll << 28)) __trap();
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"(smem_u32(bar)), "r"(parity)
                 : "memory");
  }
}

// One box of a 3-D / 4-D tensor map at these coordinates (innermost first)
// into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap& m, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&m)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap& m, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&m)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// One box of shared memory out to a 3-D tensor map by TMA (rows and columns
// past the tensor's edges are not written), in the thread's bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap& m, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(&m)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// `bytes` (a multiple of 16) of shared memory out to global memory by the
// copy engine, in the thread's bulk group (both addresses on 16 bytes).
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gmem),
               "r"(smem_u32(smem)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N of the thread's bulk groups are still reading shared
// memory (READ) or still pending at all.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// A named barrier among `n` threads (id 0 is __syncthreads').
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// A warpgroup's register budget (all four warps execute it).
template <int R>
__device__ __forceinline__ void set_max_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void set_max_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A TMA map of a bf16 (or `type`) tensor of `rank` dimensions (innermost
// first, strides in bytes of dimensions 1..rank-1), boxes of `box` elements
// in the 128-byte (or `swizzle`) swizzle, zero fill past the edges. int8
// tensors map as CU_TENSOR_MAP_DATA_TYPE_UINT8 (CUtensorMapDataType has no
// signed 8-bit type; TMA moves bytes and fills with zero bytes).
// cuTensorMapEncodeTiled is found through the runtime
// (cudaGetDriverEntryPoint), so nothing links against libcuda.
inline cudaError_t encode_tiled(CUtensorMap* m, int rank, const void* p, const cuuint64_t* dims,
                                const cuuint64_t* strides, const cuuint32_t* box,
                                CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(m, type, (cuuint32_t)rank,
                            const_cast<void*>(p), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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

#define SVT_WG_D64                                                                           \
  SVT_WG_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),          \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),          \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),          \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),          \
      "+f"(d[62]), "+f"(d[63])
#define SVT_WG_R64                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, " \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63}"

// The n128 form: d (64 x 128) (+)= A (64 x 16) B (16 x 128); the same
// thread layout, columns 8 j + 2 t + (e & 1) for j < 16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SVT_WG_R64
               ", %64, %65, p, 1, 1, %67, %68;\n}\n"
               : SVT_WG_D64
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

#define SVT_WG_D96 \
  SVT_WG_D64, "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), \
      "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), \
      "+f"(d[94]), "+f"(d[95])
#define SVT_WG_R96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, " \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95}"

// The n192 form (the block GEMMs' tile width): d (64 x 192) (+)= A (64 x 16)
// B (16 x 192); the same thread layout, columns 8 j + 2 t + (e & 1) for j <
// 24. An MN-major B spans three [16][64] pieces, `lbo` bytes apart in its
// descriptor.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " SVT_WG_R96
               ", %96, %97, p, 1, 1, %99, %100;\n}\n"
               : SVT_WG_D96
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

#define SVT_WG_I96 \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), \
  "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), \
  "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), \
  "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), \
  "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), \
  "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), \
  "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), \
  "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), \
  "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), \
  "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), \
  "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), \
  "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), \
  "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), \
  "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), \
  "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), \
  "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])

// The int8 form (the W8A8 block's GEMMs): d (64 x 192) s32 (+)= A (64 x 32)
// B (32 x 192) s8, both K-major from shared memory (s8 wgmma takes no
// transpose): [rows][128] int8 tiles in the 128-byte swizzle, byte for byte
// the bf16 [rows][64] tiles, so a k32 step starts 32 bytes in as a bf16
// k16 step does and the descriptors are the same. The accumulators' thread
// layout is the bf16 form's.
__device__ __forceinline__ void wgmma_s8(int (&d)[96], uint64_t da, uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 " SVT_WG_R96
               ", %96, %97, p;\n}\n"
               : SVT_WG_I96
               : "l"(da), "l"(db), "r"(scale_d));
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

#define SVT_WG_D48                                                                           \
  SVT_WG_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),          \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
#define SVT_WG_R48                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"

// The n96 form with both operands in shared memory (the patch embedding at
// dim 96, patch_embed.cu): d (64 x 96) (+)= A (64 x 16) B (16 x 96);
// columns 8 j + 2 t + (e & 1) for j < 12.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[48], uint64_t da, uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " SVT_WG_R48
               ", %48, %49, p, 1, 1, %51, %52;\n}\n"
               : SVT_WG_D48
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// The fused MLP's fc2 (fused_mlp.cu): d (64 x 96) (+)= A (64 x 16) from
// registers (the GELU'd fc1 chunk as an mma.sync m16k16 fragment per warp)
// B (16 x 96) from shared memory; columns 8 j + 2 t + (e & 1) for j < 12.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " SVT_WG_R48
               ", {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
               : SVT_WG_D48
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// ... and the n192 form (j < 24).
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " SVT_WG_R96
               ", {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
               : SVT_WG_D96
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// f(j) for j = J .. N - 1 in order, j a compile-time constant in each call
// (an array indexed by it stays in registers).
template <int J, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (J < N) {
    f(std::integral_constant<int, J>{});
    static_for<J + 1, N>(f);
  }
}

// The LayerNorm of a row held in shared memory by two threads (lanes 2 k
// and 2 k + 1 of a warp, p = lane & 1), in place, giving fused_block.cu's
// layer_norm_kernel's bits: there lane l sums the row's values l, l + 32, ..
// in order and warp_sum adds the 32 partials by a butterfly (xor 16, 8, 4, 2,
// 1), the same tree at every lane. Lane l's values are the columns of l's
// parity, so the thread of parity p takes the partials of the 16 lanes 2 k +
// p (tree16 adds them as the butterfly's first four levels do) and one
// shuffle the other parity's: no chain of ten shuffles a row, and 16-byte
// loads. NCH = dim / 8: chunk(j) points at the row's values 8 j .. 8 j + 7
// (16 bytes, written back as normalised bf16); gamma_p and beta_p hold the
// columns of the thread's parity (gamma_p[k] = gamma[2 k + p]). -> (mean,
// rstd).
__device__ __forceinline__ float tree16(const float (&s)[16]) {
  return (((s[0] + s[8]) + (s[4] + s[12])) + ((s[2] + s[10]) + (s[6] + s[14]))) +
         (((s[1] + s[9]) + (s[5] + s[13])) + ((s[3] + s[11]) + (s[7] + s[15])));
}

// Value 2 m + p of a chunk of 8 bf16 (no indexed register).
__device__ __forceinline__ float pair_value(const uint4& c, int m, int p) {
  const uint32_t wd = m == 0 ? c.x : m == 1 ? c.y : m == 2 ? c.z : c.w;
  return __uint_as_float(p ? wd & 0xffff0000u : wd << 16);
}

// ln_row_pair's statistics alone: -> (mean, rstd) of the row.
template <int NCH, typename Chunk>
__device__ __forceinline__ float2 ln_stats_pair(Chunk chunk, int p, float eps) {
  const int dim = 8 * NCH;  // an int, as layer_norm_kernel divides by
  float s[16];
  auto value = [&](const uint4& c, int m) { return pair_value(c, m, p); };
#pragma unroll
  for (int k = 0; k < 16; ++k) s[k] = 0.f;
  static_for<0, NCH>([&](auto jc) {  // lane 2 k + p's values, in its order
    constexpr int j = decltype(jc)::value;
    const uint4 c = *reinterpret_cast<const uint4*>(chunk(j));
#pragma unroll
    for (int m = 0; m < 4; ++m) s[(4 * j + m) & 15] += value(c, m);
  });
  float mu = tree16(s);
  mu = (mu + __shfl_xor_sync(0xffffffffu, mu, 1)) / dim;
#pragma unroll
  for (int k = 0; k < 16; ++k) s[k] = 0.f;
  static_for<0, NCH>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    const uint4 c = *reinterpret_cast<const uint4*>(chunk(j));
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float d = value(c, m) - mu;
      s[(4 * j + m) & 15] += d * d;
    }
  });
  float var = tree16(s);
  return make_float2(mu, rsqrtf((var + __shfl_xor_sync(0xffffffffu, var, 1)) / dim + eps));
}

// ln_row_pair's normalisation alone, from the row's (mean, rstd).
template <int NCH, typename Chunk>
__device__ __forceinline__ void ln_apply_pair(Chunk chunk, int p, const float* gamma_p,
                                              const float* beta_p, float mu, float rstd) {
  auto value = [&](const uint4& c, int m) { return pair_value(c, m, p); };
  auto bits = [](float y) { return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(y)); };
  static_for<0, NCH>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    bf16* cp = chunk(j);
    const uint4 c = *reinterpret_cast<const uint4*>(cp);
    const float4 g = *reinterpret_cast<const float4*>(gamma_p + 4 * j);
    const float4 b = *reinterpret_cast<const float4*>(beta_p + 4 * j);
    const uint32_t y0 = bits((value(c, 0) - mu) * rstd * g.x + b.x);
    const uint32_t y1 = bits((value(c, 1) - mu) * rstd * g.y + b.y);
    const uint32_t y2 = bits((value(c, 2) - mu) * rstd * g.z + b.z);
    const uint32_t y3 = bits((value(c, 3) - mu) * rstd * g.w + b.w);
    // y_m is value 8 j + 2 m + p; the thread writes words 2 p, 2 p + 1 of the
    // chunk, each pairing a value of either parity: one shuffle swaps halves
    const uint32_t got = __shfl_xor_sync(0xffffffffu, p ? y0 | y1 << 16 : y2 | y3 << 16, 1);
    const uint2 out = p ? make_uint2((got & 0xffffu) | y2 << 16, (got >> 16) | y3 << 16)
                        : make_uint2(y0 | got << 16, y1 | (got & 0xffff0000u));
    *reinterpret_cast<uint2*>(cp + 4 * p) = out;
  });
}

template <int NCH, typename Chunk>
__device__ __forceinline__ float2 ln_row_pair(Chunk chunk, int p, const float* gamma_p,
                                              const float* beta_p, float eps) {
  const float2 st = ln_stats_pair<NCH>(chunk, p, eps);
  ln_apply_pair<NCH>(chunk, p, gamma_p, beta_p, st.x, st.y);
  return st;
}

// -- the n32 forms and the 64-byte swizzle (the resident attention backward
// at head dim 32, flash_attention.cu)
//
// A [rows][32] bf16 tile (64-byte rows) in the 64-byte swizzle: the 16-byte
// chunk c of row r sits at chunk c ^ ((r / 2) % 4), the tile starts on 512
// bytes. As the 128-byte form, one tile serves as a K-major operand (rows =
// M or N, the 32 columns = K; the k16 step s starts 32 s bytes in) and as an
// MN-major one of width 32 (rows = K, the 32 columns = M or N; the k16 step
// s starts 1024 s bytes in): 8-row groups 512 bytes apart either way.

// Element offset of (r, c) in a swizzled [rows][32] bf16 tile.
__device__ __forceinline__ int sw64(int r, int c) {
  return r * 32 + ((((c >> 3) ^ ((r >> 1) & 3)) << 3) | (c & 7));
}

// Matrix descriptor of a 64-byte-swizzled tile at p (8-row groups 512
// bytes apart; an operand 32 wide in M or N needs no leading offset).
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

#define SVT_WG_D16                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define SVT_WG_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x 32) (+)= A (64 x 16) B (16 x 32), both from shared memory; the
// thread layout of the n64 form, columns 8 j + 2 t + (e & 1) for j < 4.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SVT_WG_R16
               ", %16, %17, p, 1, 1, %19, %20;\n}\n"
               : SVT_WG_D16
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// The same with A from registers (an mma.sync m16k16 fragment per warp).
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SVT_WG_R16
               ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
               : SVT_WG_D16
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// The n8 form (the few-query attention backward, flash_attention.cu: the
// queries on the short side): d (64 x 8) (+)= A (64 x 16) B (16 x 8), both
// from shared memory; thread (warp w, lane 4 g + t) holds d[e] = (row 16 w
// + g + 8 (e >> 1), col 2 t + (e & 1)), the layout of an mma.sync m16n8
// accumulator, so two of them make the A fragment of an m64k16 product.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, "
               "p, 1, 1, %7, %8;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// -- attention, head dim 64 (forward and backward)

constexpr int ATT_DH = 64;

}  // namespace svt

#define SVT_TRY(expr)                      \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)
