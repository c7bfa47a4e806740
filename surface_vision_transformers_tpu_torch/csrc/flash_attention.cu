// Hopper (sm_90a) streamed attention, head dim 64, forward and backward.
//
// Replaces the TPU kernel
// surface_vision_transformers_tpu/ops/pallas/flash_attention.py::flash_attention
// (_fwd -> _fwd_kernel, _bwd_impl -> _bwd_kernel): softmax(Q K^T / sqrt(dh)) V
// with keys >= valid_len masked and the row log-sum-exp kept, and its
// backward, where query rows >= valid_len contribute nothing.
//
// The TPU kernel holds a (sample, head)'s whole (N, N) fp32 score tile in
// VMEM (N <= 1536). An H100 block has 227 KB of shared memory, so here K and
// V stream through it in tiles of 64 keys (double-buffered cp.async) and the
// score matrix never exists, so no sequence length is refused:
//   forward  one CTA per (64 queries, head, sample); each of 4 warps holds
//            16 query rows as mma fragments and an online softmax (running
//            max and sum, the accumulator rescaled per tile); writes O and
//            lse = m + log l.
//   dQ pass  one CTA per (64 queries, head, sample): delta = rowsum(dO . O),
//            then P = exp(s - lse), dS = P (dP - delta) / 8 and dQ += dS K
//            over the K/V tiles.
//   dK/dV    one CTA per (64 keys, head, sample): each warp holds 16 keys'
//            K and V rows as fragments and walks the queries in chunks of 32
//            (double-buffered), dV += P^T dO, dK += dS^T Q.
// No atomics: outputs repeat bit for bit from run to run. The block chains
// call the same launchers on their packed activations (flash_attention.cuh),
// and so does flash_attention_qkv on the packed (B, N, 3 H 64) qkv, through
// strides, writing dq, dk and dv into one packed gradient.
//
// Dropout (flash_attention_qkv_dropout, replacing _fwd_packed_drop /
// _bwd_packed_drop) is a compile-time flag on all three kernels. The TPU
// kernel regenerates its mask from the Mosaic PRNG seeded per (batch, head)
// over the whole (N, N) tile; here the three passes tile the scores three
// ways (64 x 64 forward, 64 x 32 dQ, 16 keys x 32 queries dK/dV), so the
// keep bit of score (b, h, row, col) is a pure function of its absolute
// coordinates: word col & 3 of Philox4x32-10 at counter {row, col / 4} under
// key {seed, b * heads + h} (common.cuh), kept when >= threshold. A counter
// built from tile or block indices would give a forward and a backward that
// disagree, which no forward-only check sees. The row max, the sum l and lse
// are the undropped softmax's; O = keep(P) V / l / (1 - rate); dV = P~^T dO
// with P~ = keep(P) / (1 - rate); dP = keep(dO V^T) / (1 - rate); dS =
// P (dP - delta) / 8. delta = rowsum(dO . O) stays the right correction
// because O is the dropped output the forward returned (rowsum(P dP) =
// dO . (P~ V)). Each thread draws one Philox (ten rounds of two 32-bit
// multiplies with their high halves) per two scores in the forward and the
// dQ pass and one per score in the dK/dV pass (a thread's consecutive scores
// there are consecutive queries, which share no counter): integer work the
// no-dropout kernels do not have; PERF.md has its cost beside theirs.
//
// Numerics: scores, softmax, sums and accumulators in fp32; P rounded to
// bf16 before P.V and divided by the sum after it; P and dS rounded to bf16
// before their products. The forward's P is relative to the running max, so
// it can differ from the TPU kernel's (relative to the final max) in the last
// bf16 bit. exp(s / 8 - m) is formed as 2^(s * log2(e) / 8 - m log2(e)), one
// fused multiply-add and one ex2 per score; only the tile holding the last
// valid key is masked; rows >= valid_len take lse = +inf in the backward, so
// their P is 0 without a test per score.
//
// What bounds it on this card: at SiT-base (B 128, 12 heads, N 1281) the
// forward is 4 B H N^2 64 = 0.65 TFLOP against 0.3 GB of q, k, v, o, lse,
// so operations bound it (0.65 ms at the bf16 peak); the backward does 2.5x
// the operations, and its two passes recompute P twice. At dh = 64 each
// score costs as much in the exp unit and the fp32 pipe as in the tensor
// cores, hence the short per-score instruction path. This version runs
// mma.sync m16n8k16 (no wgmma/TMA, no warp specialisation); PERF.md has its
// times beside SDPA's.

#include "flash_attention.cuh"

namespace {

using namespace svt;

constexpr int FA_BK = 64;              // keys per streamed K/V tile
constexpr int KV_BK = 64, KV_QC = 32;  // dK/dV pass: keys per CTA, queries per chunk
constexpr float kScale = 0.125f;       // 1 / sqrt(64), exact
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kScaleLog2 = kScale * kLog2e;  // exp(s / 8 - x) = 2^(s * kScaleLog2 - x log2 e)

// 2^x on the special-function unit; 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Copy rows r0 .. r0 + rows - 1 of (b, h) into a [rows][ATT_LD] tile; rows
// >= n are zero-filled.
__device__ __forceinline__ void load_tile(bf16* dst, const Strided& t, int b, int h, int r0,
                                          int rows, int n, int tid) {
  for (int c = tid; c < rows * (ATT_DH / 8); c += ATT_THREADS) {
    const int r = c >> 3, dc = (c & 7) * 8;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * ATT_LD + dc, ok ? t.row(b, h, r0 + r) + dc : t.p, ok);
  }
}

// 16 rows of a [.][ATT_LD] tile as four m16k16 A fragments (dh = 64).
__device__ __forceinline__ void load_frags(uint32_t f[ATT_DH / 16][4], const bf16* s, int lane) {
#pragma unroll
  for (int ks = 0; ks < ATT_DH / 16; ++ks)
    ldmatrix_x4(f[ks], s + (lane & 15) * ATT_LD + ks * 16 + (lane >> 4) * 8);
}

// The two m16k16 fragments of P (rows g, g + 8; 16 keys from s[2j], s[2j+1]).
__device__ __forceinline__ void pack_p(uint32_t pf[4], float (*s)[4], int j) {
  pf[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
  pf[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
  pf[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
  pf[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
}

// acc (16 x 64) += P (16 x 16 keys) . T[keys key0 .. key0 + 15][0 .. 63].
__device__ __forceinline__ void mma_pv(float acc[ATT_DH / 8][4], const uint32_t pf[4],
                                       const bf16* sT, int key0, int lane) {
  const int key = key0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int dp = 0; dp < ATT_DH / 16; ++dp) {
    uint32_t f[4];
    ldmatrix_x4_trans(f, sT + key * ATT_LD + dp * 16 + (lane >> 4) * 8);
    mma_bf16(acc[2 * dp], pf, f[0], f[1]);
    mma_bf16(acc[2 * dp + 1], pf, f[2], f[3]);
  }
}

// Dropout words of scores (row, col) and (row, col + 1), col even.
__device__ __forceinline__ uint2 drop_pair(const Dropout& dr, uint32_t bh, int row, int col) {
  const uint4 w = philox4x32((uint32_t)row, (uint32_t)col >> 2, dr.seed, bh);
  return (col & 2) ? make_uint2(w.z, w.w) : make_uint2(w.x, w.y);
}

// The dropout word of score (row, col).
__device__ __forceinline__ uint32_t drop_word(const Dropout& dr, uint32_t bh, int row, int col) {
  const uint4 w = philox4x32((uint32_t)row, (uint32_t)col >> 2, dr.seed, bh);
  const int e = col & 3;
  return e == 0 ? w.x : e == 1 ? w.y : e == 2 ? w.z : w.w;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Keys kb .. kb + 63 of a fragment row set: those >= kend to -inf (only the
// last tile has any).
__device__ __forceinline__ void mask_keys(float (*s)[4], int nt_count, int kb, int kend, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= nt_count) break;
    const int col = kb + nt * 8 + 2 * t;
    if (col >= kend) s[nt][0] = s[nt][2] = -INFINITY;
    if (col + 1 >= kend) s[nt][1] = s[nt][3] = -INFINITY;
  }
}

template <bool DROP>
__global__ void __launch_bounds__(ATT_THREADS)
    flash_fwd_kernel(const Strided q, const Strided k, const Strided v, const Strided o,
                     float* __restrict__ lse, int nq, int nk, int valid_len, const Dropout dr) {
  __shared__ __align__(16) bf16 sQ[ATT_BQ * ATT_LD];
  __shared__ __align__(16) bf16 sK[2][FA_BK * ATT_LD];
  __shared__ __align__(16) bf16 sV[2][FA_BK * ATT_LD];
  const int q0 = blockIdx.x * ATT_BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kend = min(valid_len, nk);
  const int ntiles = (kend + FA_BK - 1) / FA_BK;
  const bool active = q0 + warp * 16 < nq;

  load_tile(sQ, q, b, h, q0, ATT_BQ, nq, tid);
  load_tile(sK[0], k, b, h, 0, FA_BK, nk, tid);
  load_tile(sV[0], v, b, h, 0, FA_BK, nk, tid);
  cp_async_commit();

  uint32_t qf[ATT_DH / 16][4];
  float acc[ATT_DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < ATT_DH / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  // running row max of the raw scores Q.K, and sum of exp(s / 8 - max / 8)
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < ntiles) {
      load_tile(sK[st ^ 1], k, b, h, (tile + 1) * FA_BK, FA_BK, nk, tid);
      load_tile(sV[st ^ 1], v, b, h, (tile + 1) * FA_BK, FA_BK, nk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      if (tile == 0) load_frags(qf, sQ + warp * 16 * ATT_LD, lane);
      float s[8][4];
      score_chunk(s, qf, sK[st], 0, lane);
      score_chunk(s + 4, qf, sK[st], 32, lane);
      if ((tile + 1) * FA_BK > kend) mask_keys(s, 8, tile * FA_BK, kend, t);
      // this tile's row max (every tile started holds a key < kend: finite)
      float tm_lo = -INFINITY, tm_hi = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        tm_lo = fmaxf(tm_lo, fmaxf(s[nt][0], s[nt][1]));
        tm_hi = fmaxf(tm_hi, fmaxf(s[nt][2], s[nt][3]));
      }
      const float mn_lo = fmaxf(m_lo, quad_max(tm_lo)), mn_hi = fmaxf(m_hi, quad_max(tm_hi));
      const float a_lo = exp2_approx((m_lo - mn_lo) * kScaleLog2);  // 0 at tile 0
      const float a_hi = exp2_approx((m_hi - mn_hi) * kScaleLog2);
      m_lo = mn_lo;
      m_hi = mn_hi;
      l_lo *= a_lo;
      l_hi *= a_hi;
#pragma unroll
      for (int nt = 0; nt < ATT_DH / 8; ++nt) {
        acc[nt][0] *= a_lo;
        acc[nt][1] *= a_lo;
        acc[nt][2] *= a_hi;
        acc[nt][3] *= a_hi;
      }
      const float ms_lo = m_lo * kScaleLog2, ms_hi = m_hi * kScaleLog2;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {  // P = exp(s/8 - m/8); masked: 2^-inf = 0
        s[nt][0] = exp2_approx(fmaf(s[nt][0], kScaleLog2, -ms_lo));
        s[nt][1] = exp2_approx(fmaf(s[nt][1], kScaleLog2, -ms_lo));
        s[nt][2] = exp2_approx(fmaf(s[nt][2], kScaleLog2, -ms_hi));
        s[nt][3] = exp2_approx(fmaf(s[nt][3], kScaleLog2, -ms_hi));
        l_lo += s[nt][0] + s[nt][1];
        l_hi += s[nt][2] + s[nt][3];
      }
      if constexpr (DROP) {  // l keeps the undropped sum; P.V takes keep(P)
        const uint32_t bh = (uint32_t)(b * gridDim.y + h);
        const int r_lo = q0 + warp * 16 + g;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = tile * FA_BK + nt * 8 + 2 * t;
          const uint2 lo = drop_pair(dr, bh, r_lo, col), hi = drop_pair(dr, bh, r_lo + 8, col);
          if (lo.x < dr.threshold) s[nt][0] = 0.f;
          if (lo.y < dr.threshold) s[nt][1] = 0.f;
          if (hi.x < dr.threshold) s[nt][2] = 0.f;
          if (hi.y < dr.threshold) s[nt][3] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // O += bf16(P) . V, 16 keys per k-step
        uint32_t pf[4];
        pack_p(pf, s, j);
        mma_pv(acc, pf, sV[st], j * 16, lane);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  if (!active) return;

  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const float inv_lo = (DROP ? dr.inv_keep : 1.f) / l_lo;
  const float inv_hi = (DROP ? dr.inv_keep : 1.f) / l_hi;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  if (lse != nullptr && t == 0) {
    float* lrow = lse + ((long long)b * gridDim.y + h) * nq;
    if (r_lo < nq) lrow[r_lo] = m_lo * kScale + logf(l_lo);
    if (r_hi < nq) lrow[r_hi] = m_hi * kScale + logf(l_hi);
  }
#pragma unroll
  for (int nt = 0; nt < ATT_DH / 8; ++nt) {
    const int d = nt * 8 + 2 * t;
    if (r_lo < nq)
      *reinterpret_cast<__nv_bfloat162*>(o.row(b, h, r_lo) + d) =
          __floats2bfloat162_rn(acc[nt][0] * inv_lo, acc[nt][1] * inv_lo);
    if (r_hi < nq)
      *reinterpret_cast<__nv_bfloat162*>(o.row(b, h, r_hi) + d) =
          __floats2bfloat162_rn(acc[nt][2] * inv_hi, acc[nt][3] * inv_hi);
  }
}

// dQ pass. Per 32 keys of a tile: S = Q K^T, dP = dO V^T, P = exp(S/8 -
// lse) on keys < kend and rows < qend (the others' lse is taken as +inf, so
// P = 0), dS = P (dP - delta) / 8, dQ += bf16(dS) K.
template <bool DROP>
__global__ void __launch_bounds__(ATT_THREADS)
    flash_bwd_dq_kernel(const Strided q, const Strided k, const Strided v, const Strided o,
                        const Strided d_o, const float* __restrict__ lse,
                        float* __restrict__ delta, const Strided dq, int nq, int nk,
                        int valid_len, const Dropout dr) {
  __shared__ __align__(16) bf16 sQ[ATT_BQ * ATT_LD];  // the Q tile, then the dO tile
  __shared__ __align__(16) bf16 sK[2][FA_BK * ATT_LD];
  __shared__ __align__(16) bf16 sV[2][FA_BK * ATT_LD];
  const int q0 = blockIdx.x * ATT_BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long hrow = ((long long)b * gridDim.y + h) * nq;
  const int qr0 = q0 + warp * 16;
  const bool active = qr0 < nq;
  const int qend = min(valid_len, nq), kend = min(valid_len, nk);
  const int ntiles = q0 < qend ? (kend + FA_BK - 1) / FA_BK : 0;

  load_tile(sQ, q, b, h, q0, ATT_BQ, nq, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[ATT_DH / 16][4], of[ATT_DH / 16][4];
  if (active) load_frags(qf, sQ + warp * 16 * ATT_LD, lane);
  __syncthreads();
  load_tile(sQ, d_o, b, h, q0, ATT_BQ, nq, tid);
  if (ntiles > 0) {
    load_tile(sK[0], k, b, h, 0, FA_BK, nk, tid);
    load_tile(sV[0], v, b, h, 0, FA_BK, nk, tid);
  }
  cp_async_commit();

  // delta for the warp's 16 rows: lane pair (2i, 2i+1) sums row i's halves
  const int drow = qr0 + (lane >> 1);
  float dsum = 0.f;
  if (drow < nq) {
    const bf16* orow = o.row(b, h, drow) + (lane & 1) * 32;
    const bf16* grow = d_o.row(b, h, drow) + (lane & 1) * 32;
#pragma unroll 8
    for (int d = 0; d < 32; ++d) dsum += __bfloat162float(grow[d]) * __bfloat162float(orow[d]);
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  if (drow < nq && (lane & 1) == 0) delta[hrow + drow] = dsum;
  const float dl_lo = __shfl_sync(0xffffffffu, dsum, 2 * g);
  const float dl_hi = __shfl_sync(0xffffffffu, dsum, 2 * (g + 8));
  const int r_lo = qr0 + g, r_hi = r_lo + 8;
  const float l_lo = r_lo < qend ? lse[hrow + r_lo] * kLog2e : INFINITY;
  const float l_hi = r_hi < qend ? lse[hrow + r_hi] * kLog2e : INFINITY;

  float acc[ATT_DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < ATT_DH / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  cp_async_wait<0>();
  __syncthreads();
  if (active) load_frags(of, sQ + warp * 16 * ATT_LD, lane);

  for (int tile = 0; tile < ntiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < ntiles) {
      load_tile(sK[st ^ 1], k, b, h, (tile + 1) * FA_BK, FA_BK, nk, tid);
      load_tile(sV[st ^ 1], v, b, h, (tile + 1) * FA_BK, FA_BK, nk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int half = 0; half < FA_BK / ATT_BK; ++half) {
        const int kb = tile * FA_BK + half * ATT_BK;
        float s[4][4], dp[4][4];
        score_chunk(s, qf, sK[st], half * ATT_BK, lane);
        score_chunk(dp, of, sV[st], half * ATT_BK, lane);  // dP = dO . V^T
        if (kb + ATT_BK > kend) mask_keys(s, 4, kb, kend, t);
        if constexpr (DROP) {  // dP = keep(dO . V^T) / (1 - rate)
          const uint32_t bh = (uint32_t)(b * gridDim.y + h);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = kb + nt * 8 + 2 * t;
            const uint2 lo = drop_pair(dr, bh, r_lo, col), hi = drop_pair(dr, bh, r_hi, col);
            dp[nt][0] = lo.x >= dr.threshold ? dp[nt][0] * dr.inv_keep : 0.f;
            dp[nt][1] = lo.y >= dr.threshold ? dp[nt][1] * dr.inv_keep : 0.f;
            dp[nt][2] = hi.x >= dr.threshold ? dp[nt][2] * dr.inv_keep : 0.f;
            dp[nt][3] = hi.y >= dr.threshold ? dp[nt][3] * dr.inv_keep : 0.f;
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float p0 = exp2_approx(fmaf(s[nt][0], kScaleLog2, -l_lo));
          const float p1 = exp2_approx(fmaf(s[nt][1], kScaleLog2, -l_lo));
          const float p2 = exp2_approx(fmaf(s[nt][2], kScaleLog2, -l_hi));
          const float p3 = exp2_approx(fmaf(s[nt][3], kScaleLog2, -l_hi));
          s[nt][0] = p0 * (dp[nt][0] - dl_lo) * kScale;  // dS
          s[nt][1] = p1 * (dp[nt][1] - dl_lo) * kScale;
          s[nt][2] = p2 * (dp[nt][2] - dl_hi) * kScale;
          s[nt][3] = p3 * (dp[nt][3] - dl_hi) * kScale;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // dQ += dS . K, 16 keys per k-step
          uint32_t pf[4];
          pack_p(pf, s, j);
          mma_pv(acc, pf, sK[st], half * ATT_BK + j * 16, lane);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int nt = 0; nt < ATT_DH / 8; ++nt) {
    const int d = nt * 8 + 2 * t;
    if (r_lo < nq)
      *reinterpret_cast<__nv_bfloat162*>(dq.row(b, h, r_lo) + d) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    if (r_hi < nq)
      *reinterpret_cast<__nv_bfloat162*>(dq.row(b, h, r_hi) + d) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}

// dK/dV pass: S^T and dP^T for the warp's 16 keys x a chunk of 32 queries.
// Queries >= qend get lse = +inf (P = 0); keys >= kend are masked in the
// warps that hold any.
template <bool DROP>
__global__ void __launch_bounds__(ATT_THREADS)
    flash_bwd_dkdv_kernel(const Strided q, const Strided k, const Strided v, const Strided d_o,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const Strided dk, const Strided dv, int nq, int nk, int valid_len,
                          const Dropout dr) {
  __shared__ __align__(16) bf16 sK[KV_BK * ATT_LD];
  __shared__ __align__(16) bf16 sV[KV_BK * ATT_LD];
  __shared__ __align__(16) bf16 sQc[2][KV_QC * ATT_LD];
  __shared__ __align__(16) bf16 sdO[2][KV_QC * ATT_LD];
  __shared__ float sL[2][KV_QC], sD[2][KV_QC];
  const int k0 = blockIdx.x * KV_BK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long hrow = ((long long)b * gridDim.y + h) * nq;
  const int kend = min(valid_len, nk), qend = min(valid_len, nq);
  const int nchunks = k0 < kend ? (qend + KV_QC - 1) / KV_QC : 0;

  auto load_chunk = [&](int st, int qb) {
    load_tile(sQc[st], q, b, h, qb, KV_QC, nq, tid);
    load_tile(sdO[st], d_o, b, h, qb, KV_QC, nq, tid);
    if (tid < KV_QC) {
      const bool ok = qb + tid < qend;
      sL[st][tid] = ok ? lse[hrow + qb + tid] * kLog2e : INFINITY;
      sD[st][tid] = ok ? delta[hrow + qb + tid] : 0.f;
    }
  };

  load_tile(sK, k, b, h, k0, KV_BK, nk, tid);
  load_tile(sV, v, b, h, k0, KV_BK, nk, tid);
  if (nchunks > 0) load_chunk(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[ATT_DH / 16][4], vf[ATT_DH / 16][4];
  load_frags(kf, sK + warp * 16 * ATT_LD, lane);
  load_frags(vf, sV + warp * 16 * ATT_LD, lane);

  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  const bool mask = k0 + warp * 16 + 16 > kend;  // this warp holds keys >= kend
  float dva[ATT_DH / 8][4], dka[ATT_DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < ATT_DH / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[nt][e] = dka[nt][e] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    const int st = c & 1;
    if (c + 1 < nchunks) {
      load_chunk(st ^ 1, (c + 1) * KV_QC);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[4][4], dp[4][4];  // S^T and dP^T: 16 keys x 32 queries
    score_chunk(s, kf, sQc[st], 0, lane);
    score_chunk(dp, vf, sdO[st], 0, lane);
    if (mask)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (key_lo >= kend) s[nt][0] = s[nt][1] = -INFINITY;
        if (key_hi >= kend) s[nt][2] = s[nt][3] = -INFINITY;
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1);
        const float pr = exp2_approx(fmaf(s[nt][e], kScaleLog2, -sL[st][ql]));
        if constexpr (DROP) {  // P~ = keep(P) / (1 - rate) for dV; keep(dP) / (1 - rate)
          const bool kept = drop_word(dr, (uint32_t)(b * gridDim.y + h), c * KV_QC + ql,
                                      e < 2 ? key_lo : key_hi) >= dr.threshold;
          s[nt][e] = kept ? pr * dr.inv_keep : 0.f;
          dp[nt][e] = pr * ((kept ? dp[nt][e] * dr.inv_keep : 0.f) - sD[st][ql]) * kScale;
        } else {
          s[nt][e] = pr;
          dp[nt][e] = pr * (dp[nt][e] - sD[st][ql]) * kScale;  // dS^T
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // 16 queries per k-step
      uint32_t pf[4], sf[4];
      pack_p(pf, s, j);
      pack_p(sf, dp, j);
      mma_pv(dva, pf, sdO[st], j * 16, lane);  // dV += P^T . dO
      mma_pv(dka, sf, sQc[st], j * 16, lane);  // dK += dS^T . Q
    }
    __syncthreads();  // this stage is refilled two chunks on
  }
#pragma unroll
  for (int nt = 0; nt < ATT_DH / 8; ++nt) {
    const int d = nt * 8 + 2 * t;
    if (key_lo < nk) {
      *reinterpret_cast<__nv_bfloat162*>(dk.row(b, h, key_lo) + d) =
          __floats2bfloat162_rn(dka[nt][0], dka[nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv.row(b, h, key_lo) + d) =
          __floats2bfloat162_rn(dva[nt][0], dva[nt][1]);
    }
    if (key_hi < nk) {
      *reinterpret_cast<__nv_bfloat162*>(dk.row(b, h, key_hi) + d) =
          __floats2bfloat162_rn(dka[nt][2], dka[nt][3]);
      *reinterpret_cast<__nv_bfloat162*>(dv.row(b, h, key_hi) + d) =
          __floats2bfloat162_rn(dva[nt][2], dva[nt][3]);
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

namespace svt {

cudaError_t flash_fwd(Strided q, Strided k, Strided v, Strided o, float* lse, int B, int heads,
                      int nq, int nk, int valid_len, cudaStream_t st, Dropout dr) {
  const dim3 grid(ceil_div(nq, ATT_BQ), heads, B);
  if (dr.on)
    flash_fwd_kernel<true><<<grid, ATT_THREADS, 0, st>>>(q, k, v, o, lse, nq, nk, valid_len, dr);
  else
    flash_fwd_kernel<false><<<grid, ATT_THREADS, 0, st>>>(q, k, v, o, lse, nq, nk, valid_len, dr);
  return cudaGetLastError();
}

cudaError_t flash_bwd(Strided q, Strided k, Strided v, Strided o, Strided d_o, const float* lse,
                      float* delta, Strided dq, Strided dk, Strided dv, int B, int heads, int nq,
                      int nk, int valid_len, cudaStream_t st, Dropout dr) {
  const dim3 grid_q(ceil_div(nq, ATT_BQ), heads, B), grid_k(ceil_div(nk, KV_BK), heads, B);
  if (dr.on)
    flash_bwd_dq_kernel<true><<<grid_q, ATT_THREADS, 0, st>>>(q, k, v, o, d_o, lse, delta, dq,
                                                              nq, nk, valid_len, dr);
  else
    flash_bwd_dq_kernel<false><<<grid_q, ATT_THREADS, 0, st>>>(q, k, v, o, d_o, lse, delta, dq,
                                                               nq, nk, valid_len, dr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (dr.on)
    flash_bwd_dkdv_kernel<true><<<grid_k, ATT_THREADS, 0, st>>>(q, k, v, d_o, lse, delta, dk,
                                                                dv, nq, nk, valid_len, dr);
  else
    flash_bwd_dkdv_kernel<false><<<grid_k, ATT_THREADS, 0, st>>>(q, k, v, d_o, lse, delta, dk,
                                                                 dv, nq, nk, valid_len, dr);
  return cudaGetLastError();
}

Dropout make_dropout(unsigned seed, unsigned threshold, float inv_keep, int on) {
  Dropout dr;
  dr.seed = seed;
  dr.threshold = threshold;
  dr.inv_keep = inv_keep;
  dr.on = on;
  return dr;
}

}  // namespace svt

extern "C" {

// flash_attention forward: q (B, heads, nq, 64), k and v (B, heads, nk, 64),
// o (B, heads, nq, 64), each bf16 at (batch, head, row) strides in elements
// with its last dimension contiguous; lse (B, heads, nq) fp32 contiguous.
// Dropout on the probabilities when `drop` (seed, threshold on the Philox
// word, inv_keep = 1 / (1 - rate)).
int svt_flash_attention_fwd(void* q, long long q_sb, long long q_sh, long long q_sr, void* k,
                            long long k_sb, long long k_sh, long long k_sr, void* v,
                            long long v_sb, long long v_sh, long long v_sr, void* o,
                            long long o_sb, long long o_sh, long long o_sr, void* lse, int B,
                            int heads, int nq, int nk, int valid_len, unsigned seed,
                            unsigned threshold, float inv_keep, int drop, int device,
                            void* stream) {
  SVT_TRY(cudaSetDevice(device));
  return (int)flash_fwd({(bf16*)q, q_sb, q_sh, q_sr}, {(bf16*)k, k_sb, k_sh, k_sr},
                        {(bf16*)v, v_sb, v_sh, v_sr}, {(bf16*)o, o_sb, o_sh, o_sr},
                        (float*)lse, B, heads, nq, nk, valid_len,
                        static_cast<cudaStream_t>(stream),
                        make_dropout(seed, threshold, inv_keep, drop));
}

// flash_attention backward: the forward's operands, o and lse, the output
// cotangent d_o (as o) -> dq (as q), dk, dv (as k); delta (B, heads, nq) fp32
// scratch. Dropout as the forward's, which gave o.
int svt_flash_attention_bwd(void* q, long long q_sb, long long q_sh, long long q_sr, void* k,
                            long long k_sb, long long k_sh, long long k_sr, void* v,
                            long long v_sb, long long v_sh, long long v_sr, void* o,
                            long long o_sb, long long o_sh, long long o_sr, void* d_o,
                            long long do_sb, long long do_sh, long long do_sr, void* lse,
                            void* delta, void* dq, long long dq_sb, long long dq_sh,
                            long long dq_sr, void* dk, long long dk_sb, long long dk_sh,
                            long long dk_sr, void* dv, long long dv_sb, long long dv_sh,
                            long long dv_sr, int B, int heads, int nq, int nk, int valid_len,
                            unsigned seed, unsigned threshold, float inv_keep, int drop,
                            int device, void* stream) {
  SVT_TRY(cudaSetDevice(device));
  return (int)flash_bwd({(bf16*)q, q_sb, q_sh, q_sr}, {(bf16*)k, k_sb, k_sh, k_sr},
                        {(bf16*)v, v_sb, v_sh, v_sr}, {(bf16*)o, o_sb, o_sh, o_sr},
                        {(bf16*)d_o, do_sb, do_sh, do_sr}, (const float*)lse, (float*)delta,
                        {(bf16*)dq, dq_sb, dq_sh, dq_sr}, {(bf16*)dk, dk_sb, dk_sh, dk_sr},
                        {(bf16*)dv, dv_sb, dv_sh, dv_sr}, B, heads, nq, nk, valid_len,
                        static_cast<cudaStream_t>(stream),
                        make_dropout(seed, threshold, inv_keep, drop));
}

}  // extern "C"
