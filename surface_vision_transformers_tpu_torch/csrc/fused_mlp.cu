// Hopper (sm_90a) kernel for the MLP half of the block forward at dims 96
// and 192 (MS-SiT's stages 0-1, SiT-tiny):
//   out = x1 + fc2(GELU(fc1(LN2(x1))))
// in one launch, where the chain of fused_block.cu ran three (LN2, fc1 with
// bias and erf-GELU, fc2 with bias and the residual), each sending its
// output through device memory.
//
// Replaces, with the LN1 prologue of the qkv product (gemm.cuh, F_LNA), the
// part of the TPU kernel
// surface_vision_transformers_tpu/ops/pallas/fused_block.py::fused_block
// (_block_kernel) that the chain spread over launches: that kernel keeps
// every intermediate of the block in VMEM.
//
// What bounds it: at dim 96 the block is bound by bytes. The chain moved
// x1 in, h2 out and in, f (M x 4 dim bf16, the largest) out and in, x1
// again and out: eight widths of x plus two of the hidden layer. This
// kernel reads x1 and writes out (the residual's second read of x1 comes
// from L2), so f and h2 never reach device memory when serving. Left: fc1
// and fc2 (2 x 2 x dim x 4 dim operations a row) and one erf a hidden
// value, which the tensor cores and the ALUs share.
//
// Design: a persistent CTA per SM walks tiles of 64 NWG rows of x1. One
// producer thread loads the weights by TMA in chunks of 64 hidden columns
// (W1's 64 rows, W2's 64 columns) into a ring of STAGES stages with full
// and empty mbarriers; at dim 96 the six chunks of the whole MLP fit, so
// they land once and stay (resident), at dim 192 the twelve stream through
// three stages from L2. NWG consumer warpgroups (three at dim 96, two at
// 192: Cfg) own 64 rows each:
//   - x1's rows land by TMA in the warpgroup's buffer (128-byte-swizzled
//     [64][64] blocks); two threads a row normalise them in place (LN2 with
//     layer_norm_kernel's sums in their order, common.cuh ln_row_pair: fp32
//     statistics, one bf16 rounding), so the buffer becomes fc1's A operand;
//   - per chunk c: S = h2 W1_c^T (m64n64k16, both operands in shared
//     memory), then bias, erf-GELU and one bf16 rounding in registers,
//     which become the A fragments of out += f_c W2_c^T (m64n{dim}k16, B
//     K-major in shared memory), so fc2 sums its k16 steps in the order of
//     the engine's K walk; the other warpgroups' products run under this
//     one's erf;
//   - after the last fc1 x1 comes again into the buffer (an L2 hit) for the
//     residual; out = x1 + (acc + b2), rounded once, replaces it there and
//     leaves by TMA.
// The fp32 output accumulator (64 x dim a warpgroup: 48 registers a thread
// at dim 96, 96 at dim 192) is what bounds the width; wider blocks keep the
// engine's chain.
//
// Numerics: the chain's rounding points and orders (bf16 after LN2 and
// GELU; fc1's bias added to the fp32 product, fc2's bias then the residual
// added to its fp32 sum), so the outputs equal the chain's bit for bit.
// The training form (dim 96: at 192 the seven launches measured faster)
// also writes what the backward reads, as the chain did: h2 (by TMA from the
// buffer), LN2's (mean, rstd), and each chunk's fpre fp32 and f by TMA from
// staging tiles (stores from the registers ran the form at half of HBM's
// rate), which take the room of the resident weights: they stream.

#include <algorithm>

#include "fused_mlp.cuh"

namespace {

using namespace svt;

constexpr int CHUNK = 64;            // hidden columns per chunk
constexpr int PRODUCER_REGS = 40;
constexpr int WG_BAR = 1;            // named barriers 1 .. NWG: one warpgroup's own
constexpr int BLOCK = 64 * 64;       // a [64][64] bf16 block, 128-byte swizzle

// By width: the consumer warpgroups (64 rows each) and the weights' ring.
// The registers a thread may use are those of the launch (65536 / THREADS;
// ptxas allocates no more after setmaxnreg): the fp32 output accumulators
// take DIM / 2 of them, a chunk's 32 and its fragments 16, so dim 192 leaves
// room for two warpgroups, dim 96 for three (a warpgroup keeping two chunks
// in flight, two warpgroups measured slower: PERF.md).
// The training form (dim 96) writes fpre and f by TMA from staging tiles,
// which take the shared memory the resident weights held: its weights stream
// through three stages.
template <int DIM, bool TRAIN>
struct Cfg {
  static constexpr int KB = (DIM + 63) / 64;         // [64][64] blocks across a row
  static constexpr int STAGES = DIM <= 96 && !TRAIN ? 6 : 3;  // 6: the whole MLP at dim 96
  static constexpr int MLP_MAX = 4 * DIM;
  static constexpr int NWG = DIM <= 96 ? 3 : 2;
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int CONSUMER_REGS =
      (65536 / THREADS / 8 * 8 * THREADS - PRODUCER_REGS * 128) / (NWG * 128) / 8 * 8;
  static_assert(CONSUMER_REGS <= 256, "setmaxnreg takes at most 256");
};

// A warpgroup's chunk of the training form's saves on its way out: fpre as
// two [64][32] fp32 boxes, f as a [64][64] bf16 block, 128-byte swizzle.
template <int NWG>
struct MlpStaging {
  alignas(1024) float pre[NWG][64 * 64];  // TMA's swizzled boxes start on 1024 bytes
  alignas(1024) bf16 f[NWG][BLOCK];
};
template <>
struct MlpStaging<0> {};

template <int DIM, bool TRAIN>
struct MlpSmem {
  using C = Cfg<DIM, TRAIN>;
  bf16 w1[C::STAGES][C::KB * BLOCK];  // chunk c of W1: its 64 rows, K-major blocks
  bf16 w2[C::STAGES][DIM * 64];       // chunk c of W2: [DIM rows][64 hidden columns]
  bf16 x[C::NWG][C::KB * BLOCK];      // a warpgroup's x1 rows -> h2 -> x1 -> out
  float b1[C::MLP_MAX], b2[DIM];      // read as float2
  float gamma[2][DIM / 2], beta[2][DIM / 2];  // LN2's, by column parity (ln_row_pair)
  uint64_t w_full[C::STAGES], w_empty[C::STAGES], x_full[C::NWG];
  MlpStaging<TRAIN ? C::NWG : 0> save;  // last: its alignment pads only the training form
};

struct Args {
  const float *gamma, *beta, *b1, *b2;
  float eps;
  int M, mlp;
  MlpSaves s;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Element (r, c) of a row-block buffer of [64][64] swizzled blocks.
__device__ __forceinline__ int at(int r, int c) { return (c >> 6) * BLOCK + sw128(r, c & 63); }

template <int DIM, bool TRAIN>
__global__ void __launch_bounds__(Cfg<DIM, TRAIN>::THREADS, 1)
    fused_mlp_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w1,
                     const __grid_constant__ CUtensorMap tm_w2,
                     const __grid_constant__ CUtensorMap tm_out,
                     const __grid_constant__ CUtensorMap tm_h2,
                     const __grid_constant__ CUtensorMap tm_pre,
                     const __grid_constant__ CUtensorMap tm_f, const Args a) {
  using C = Cfg<DIM, TRAIN>;
  constexpr int STAGES = C::STAGES, KB = C::KB, NWG = C::NWG, THREADS = C::THREADS;
  constexpr int X_BYTES = KB * BLOCK * 2;
  constexpr int W_BYTES = KB * BLOCK * 2 + DIM * 64 * 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  MlpSmem<DIM, TRAIN>& sm = *reinterpret_cast<MlpSmem<DIM, TRAIN>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nch = a.mlp / CHUNK;
  const bool resident = nch <= STAGES;  // every chunk in its own stage, loaded once
  const int tiles = cdiv(a.M, 64 * NWG);
  // the warpgroup, broadcast so that the compiler sees it uniform (wgmma
  // behind a branch it cannot prove uniform is serialised)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&sm.w_full[i], 1);
      mbar_init(&sm.w_empty[i], NWG);
    }
    for (int i = 0; i < NWG; ++i) mbar_init(&sm.x_full[i], 1);
  }
  for (int i = threadIdx.x; i < a.mlp; i += THREADS) sm.b1[i] = a.b1[i];
  for (int i = threadIdx.x; i < DIM; i += THREADS) {
    sm.b2[i] = a.b2[i];
    sm.gamma[i & 1][i >> 1] = a.gamma[i];
    sm.beta[i & 1][i >> 1] = a.beta[i];
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    set_max_regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      auto load = [&](int st, int c) {
        mbar_expect(&sm.w_full[st], W_BYTES);
#pragma unroll
        for (int kb = 0; kb < KB; ++kb)
          tma_load_3d(sm.w1[st] + kb * BLOCK, tm_w1, &sm.w_full[st], 64 * kb, CHUNK * c, 0);
        tma_load_3d(sm.w2[st], tm_w2, &sm.w_full[st], CHUNK * c, 0, 0);
      };
      if (resident) {
        for (int c = 0; c < nch; ++c) load(c, c);
      } else {
        int it = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
          for (int c = 0; c < nch; ++c, ++it) {
            const int st = it % STAGES, use = it / STAGES;
            if (use > 0) mbar_wait(&sm.w_empty[st], (use - 1) & 1);
            load(st, c);
          }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 w .. 64 w + 63 of each tile
  set_max_regs_inc<C::CONSUMER_REGS>();
  const int w = wg - 1, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* xs = sm.x[w];
  float acc[DIM / 2];  // out (64 x DIM): (row 16 warp + g + 8 (e >> 1), col 8 j + 2 t + (e & 1))
  float sa[32];          // a chunk of fc1
  uint32_t p[4][4];      // GELU(chunk) as fc2's A fragments, one per 16 hidden columns

  auto x_in = [&](int r0) {  // x1's 64 rows from r0 into the buffer
    if (tid == 0) {
      mbar_expect(&sm.x_full[w], X_BYTES);
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
        tma_load_3d(xs + kb * BLOCK, tm_x, &sm.x_full[w], 64 * kb, r0, 0);
    }
  };

  for (int tile = blockIdx.x, n = 0; tile < tiles; tile += gridDim.x, ++n) {
    const int r0 = (tile * NWG + w) * 64;
    if (tid == 0) bulk_wait_read<0>();  // the last tile's copy out has read the buffer
    x_in(r0);
    mbar_wait(&sm.x_full[w], 0);

    {  // LN2 in place: two threads a row, one a column parity
      const int r = tid >> 1, par = tid & 1;
      const float2 st = ln_row_pair<DIM / 8>([&](int j) { return xs + at(r, 8 * j); }, par,
                                             sm.gamma[par], sm.beta[par], a.eps);
      if (TRAIN && par == 0 && r0 + r < a.M)
        *reinterpret_cast<float2*>(a.s.stats2 + 2LL * (r0 + r)) = st;
    }
    // the accumulators start here (dead under the LayerNorm: its registers)
#pragma unroll
    for (int i = 0; i < DIM / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sa[i] = 0.f;
    fence_async_smem();
    bar_sync(WG_BAR + w, 128);
    if (TRAIN && tid == 0) {  // h2 out from the buffer (read beside fc1's products)
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) tma_store_3d(tm_h2, xs + kb * BLOCK, 64 * kb, r0, 0);
      bulk_commit();
    }

    auto stage_of = [&](int c) { return resident ? c : (n * nch + c) % STAGES; };
    auto fc1 = [&](int c, float (&s)[32]) {  // s = h2 W1_c^T
      const int st = stage_of(c);
      mbar_wait(&sm.w_full[st], resident ? 0 : ((n * nch + c) / STAGES) & 1);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DIM / 16; ++ks)
        wgmma_ss<0, 0>(s, sw128_desc(xs + (ks >> 2) * BLOCK + (ks & 3) * 16),
                       sw128_desc(sm.w1[st] + (ks >> 2) * BLOCK + (ks & 3) * 16), ks);
      wg_commit();
    };
    auto release = [&](int c) {  // chunk c's fc2 is done with its stage
      if (!resident && tid == 0) mbar_arrive(&sm.w_empty[stage_of(c)]);
    };
    // f_c = GELU(s + b1_c) -> out += f_c W2_c^T. s is only read (a value
    // written into a wgmma's accumulators serialises the products, C7515):
    // fragment (kk, i) packs row g + 8 (i & 1), columns 8 j + 2 t, + 1 of
    // s, j = 2 kk + (i >> 1)
    auto fc2 = [&](int c, const float (&s)[32]) {
      const float* bz = sm.b1 + CHUNK * c;
      if constexpr (TRAIN) {  // the staging tiles free: the last chunk's copy out has read them
        if (tid == 0) bulk_wait_read<0>();
        bar_sync(WG_BAR + w, 128);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 2 * kk + (i >> 1), h = i & 1;
          const float2 b = *reinterpret_cast<const float2*>(bz + 8 * j + 2 * t);
          const float v0 = s[4 * j + 2 * h] + b.x, v1 = s[4 * j + 2 * h + 1] + b.y;
          p[kk][i] = pack_bf16(gelu_erf(v0), gelu_erf(v1));
          if constexpr (TRAIN) {  // fpre and f into the staging tiles
            const int rl = 16 * warp + g + 8 * h, cl = (8 * j + 2 * t) & 31;
            *reinterpret_cast<float2*>(sm.save.pre[w] + (j >> 2) * 64 * 32 + rl * 32 +
                                       ((((cl >> 2) ^ (rl & 7)) << 2) | (cl & 3))) =
                make_float2(v0, v1);
            *reinterpret_cast<uint32_t*>(sm.save.f[w] + sw128(rl, 8 * j + 2 * t)) = p[kk][i];
          }
        }
      if constexpr (TRAIN) {  // this chunk of fpre and f out by TMA
        fence_async_smem();
        bar_sync(WG_BAR + w, 128);
        if (tid == 0) {
          tma_store_3d(tm_pre, sm.save.pre[w], CHUNK * c, r0, 0);
          tma_store_3d(tm_pre, sm.save.pre[w] + 64 * 32, CHUNK * c + 32, r0, 0);
          tma_store_3d(tm_f, sm.save.f[w], CHUNK * c, r0, 0);
          bulk_commit();
        }
      }
      const bf16* w2 = sm.w2[stage_of(c)];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<0>(acc, p[kk], sw128_desc(w2 + kk * 16), c > 0 || kk > 0);
      wg_commit();
    };
    auto x_again = [&](int c) {  // after the last fc1: x1 back in for the residual
      if (c != nch - 1) return;
      bar_sync(WG_BAR + w, 128);  // every warp is past the product that read h2
      if (tid == 0) {
        if (TRAIN) bulk_wait_read<0>();  // h2's copy out has read the buffer
        x_in(r0);
      }
    };

    // a chunk at a time; the other warpgroups' products run under this one's erf
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      fc1(c, sa);
      wg_wait<0>();  // fc1 of c and fc2 of c - 1
      wg_hold(sa);
      wg_hold(acc);
      wg_hold(p);
      if (c > 0) release(c - 1);
      x_again(c);
      fc2(c, sa);
    }
    wg_wait<0>();
    wg_hold(acc);
    wg_hold(p);
    release(nch - 1);

    // out = x1 + (acc + b2), one rounding, in place of x1, then out by TMA
    mbar_wait(&sm.x_full[w], 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = 16 * warp + g + 8 * h;
#pragma unroll
      for (int j = 0; j < DIM / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 bz = *reinterpret_cast<const float2*>(sm.b2 + col);
        uint32_t* px = reinterpret_cast<uint32_t*>(xs + at(rl, col));
        const __nv_bfloat162 rb = *reinterpret_cast<const __nv_bfloat162*>(px);
        const float v0 = acc[4 * j + 2 * h] + bz.x + __low2float(rb);
        const float v1 = acc[4 * j + 2 * h + 1] + bz.y + __high2float(rb);
        *px = pack_bf16(v0, v1);
      }
    }
    fence_async_smem();
    bar_sync(WG_BAR + w, 128);
    if (tid == 0) {
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) tma_store_3d(tm_out, xs + kb * BLOCK, 64 * kb, r0, 0);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();  // the last copy out done
}

// A 3-D TMA map of a bf16 (rows, cols) matrix, [box_rows][64] boxes in the
// 128-byte swizzle.
cudaError_t matrix_map(CUtensorMap* m, const void* p, int rows, int cols, int box_rows) {
  if (reinterpret_cast<uintptr_t>(p) % 16 || (cols * 2) % 16) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_tiled(m, 3, p, dims, strides, box);
}

template <int DIM, bool TRAIN>
cudaError_t launch(const bf16* x1, const float* gamma, const float* beta, const bf16* w1,
                   const float* b1, const bf16* w2, const float* b2, bf16* out, int M, int mlp,
                   float eps, const MlpSaves& s, cudaStream_t st) {
  using C = Cfg<DIM, TRAIN>;
  constexpr int smem = sizeof(MlpSmem<DIM, TRAIN>) + 1024;  // + alignment to 1024 bytes
  static bool ready[16];
  static int sms[16];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(fused_mlp_kernel<DIM, TRAIN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  CUtensorMap tm_x, tm_w1, tm_w2, tm_out, tm_h2, tm_pre, tm_f;
  if ((e = matrix_map(&tm_x, x1, M, DIM, 64)) != cudaSuccess) return e;
  if ((e = matrix_map(&tm_w1, w1, mlp, DIM, 64)) != cudaSuccess) return e;
  if ((e = matrix_map(&tm_w2, w2, DIM, mlp, DIM)) != cudaSuccess) return e;
  if ((e = matrix_map(&tm_out, out, M, DIM, 64)) != cudaSuccess) return e;
  tm_h2 = tm_pre = tm_f = tm_out;
  if (TRAIN) {
    if ((e = matrix_map(&tm_h2, s.h2, M, DIM, 64)) != cudaSuccess) return e;
    if ((e = matrix_map(&tm_f, s.f, M, mlp, 64)) != cudaSuccess) return e;
    if (reinterpret_cast<uintptr_t>(s.stats2) % 8 || reinterpret_cast<uintptr_t>(s.fpre) % 16)
      return cudaErrorMisalignedAddress;
    const cuuint64_t dims[3] = {(cuuint64_t)mlp, (cuuint64_t)M, 1};
    const cuuint64_t strides[2] = {(cuuint64_t)mlp * 4, (cuuint64_t)M * mlp * 4};
    const cuuint32_t box[3] = {32, 64, 1};  // [64][32] fp32 boxes, 128-byte swizzle
    if ((e = encode_tiled(&tm_pre, 3, s.fpre, dims, strides, box,
                          CU_TENSOR_MAP_DATA_TYPE_FLOAT32)) != cudaSuccess)
      return e;
  }
  if (reinterpret_cast<uintptr_t>(b1) % 8 || reinterpret_cast<uintptr_t>(b2) % 8)
    return cudaErrorMisalignedAddress;
  const Args a{gamma, beta, b1, b2, eps, M, mlp, s};
  const int tiles = cdiv(M, 64 * C::NWG);
  fused_mlp_kernel<DIM, TRAIN><<<std::min(tiles, sms[dev]), C::THREADS, smem, st>>>(
      tm_x, tm_w1, tm_w2, tm_out, tm_h2, tm_pre, tm_f, a);
  return cudaGetLastError();
}

}  // namespace

namespace svt {

bool fused_mlp_route(int dim, int mlp, bool train) {
  return (dim == 96 || (dim == 192 && !train)) && mlp % 128 == 0 && mlp >= 128 &&
         mlp <= 4 * dim;
}

cudaError_t fused_mlp(const bf16* x1, const float* gamma, const float* beta, const bf16* w1,
                      const float* b1, const bf16* w2, const float* b2, bf16* out, int M,
                      int dim, int mlp, float eps, const MlpSaves& s, cudaStream_t st) {
  const bool train = s.h2 != nullptr;
  if (M < 1 || !fused_mlp_route(dim, mlp, train)) return cudaErrorInvalidValue;
  if (train && (s.stats2 == nullptr || s.fpre == nullptr || s.f == nullptr))
    return cudaErrorInvalidValue;
  if (dim == 96)
    return train ? launch<96, true>(x1, gamma, beta, w1, b1, w2, b2, out, M, mlp, eps, s, st)
                 : launch<96, false>(x1, gamma, beta, w1, b1, w2, b2, out, M, mlp, eps, s, st);
  return launch<192, false>(x1, gamma, beta, w1, b1, w2, b2, out, M, mlp, eps, s, st);
}

}  // namespace svt
