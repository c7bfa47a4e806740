// Attention at head widths past the widest wgmma tile: heads laid out in
// more than 128 columns (dh 129 and up; flash_attention.cuh head_cols),
// forward and backward, with or without dropout, at any number of queries
// and keys.
//
// Replaces the same TPU kernels as flash_attention.cu
// (surface_vision_transformers_tpu/ops/pallas/flash_attention.py: _fwd,
// _bwd_impl, _fwd_packed, _bwd_packed, _fwd_packed_drop, _bwd_packed_drop,
// _fwd_tiled, _bwd_tiled, whose BlockSpecs span the whole head at any D) at
// those widths; the few-query shapes (the CLS block's 8 rows) and the block
// chains' attention run here too at these widths.
//
// What changes with the width: S = Q K^T and dP = dO V^T are sums over the
// head, so they are made in steps of 64 columns (a 64 x 64 score tile never
// grows with dh); only O (forward) and dQ, dK, dV (backward) hold the head's
// columns, so they are made in passes over the same keys of at most
// WIDE_FWD_PASS (128), WIDE_Q_PASS (128) and WIDE_KV_PASS (64) columns, each
// pass recomputing the scores. No width is refused for itself: a wider head
// runs more steps and passes.
//
// Each CTA is four warps, each warp 16 rows of a 64-row tile, every product
// a warp's m16n8k16 mma.sync (bf16 in, fp32 accumulators) from
// shared-memory tiles loaded by cp.async (zeros past the rows and the head's
// columns) and read by ldmatrix; the scores stay in registers and become
// the next product's A operand (P, dS) without a trip through shared
// memory. Numerics are the plain version's (ops/flash_attention.py): fp32
// scores scaled by 1 / sqrt(dh) of the true width (Width), P rounded to bf16
// before P.V and the sum of the unrounded P divided out after it (an online
// softmax, rescaled between key blocks as the streamed kernel's), lse = m +
// log l; in the backward P = exp(s - lse) over keys and query rows <
// valid_len, delta = rowsum(dO . O), dS = bf16(P (dP - delta) / sqrt(dh)),
// P~ = bf16(keep(P) / (1 - rate)) for dV; with dropout the keep bit of (row,
// key) is Philox4x32-10's word key & 3 at counter {row, key / 4} under key
// {seed, b * heads + h}, as every other attention kernel draws it. Every sum
// is in a fixed order and nothing is atomic, so the outputs repeat bit for
// bit.
//
// Three launches backward: delta, then dK and dV (a CTA a 64-key block and
// column pass, the query tiles streamed past it), then dQ (a CTA a 64-query
// tile and column pass, the key blocks streamed past it). What bounds them,
// and their times: PERF.md.

#include "flash_attention.cuh"

namespace {

using namespace svt;

constexpr int WT = 64;              // rows of a CTA's tile; keys (or queries) a block
constexpr int WSTEP = 64;           // columns of a score step
constexpr int WLD = WSTEP + 8;      // row pitch of a step tile (ldmatrix without conflicts)
constexpr int WIDE_THREADS = 128;   // four warps, 16 rows each
constexpr int WIDE_FWD_PASS = 128;  // O's columns a forward pass
constexpr int WIDE_Q_PASS = 128;    // dQ's columns a pass
constexpr int WIDE_KV_PASS = 64;    // dK's and dV's columns a pass
constexpr int STEP_ELEMS = WT * WLD;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// The rows of one (sample, head) of an operand: row r at p + r * sr.
struct Rows {
  const bf16* p;
  long long sr;
  int n;
};
__device__ __forceinline__ Rows rows_of(const Strided& t, int b, int h, int n) {
  return Rows{t.p + b * t.sb + h * t.sh, t.sr, n};
}

// 64 rows from r0 and C columns from c0 of src into dst ([64][C + 8] bf16)
// by cp.async, zeros past src's rows and past the head's dp columns.
template <int C>
__device__ __forceinline__ void load_tile(bf16* dst, const Rows& src, int r0, int c0, int dp) {
  constexpr int PR = C / 8, LD = C + 8;
  for (int v = threadIdx.x; v < WT * PR; v += WIDE_THREADS) {
    const int r = v / PR, c = (v - r * PR) * 8;
    const bool ok = r0 + r < src.n && c0 + c < dp;
    cp_async16(dst + r * LD + c, ok ? src.p + (r0 + r) * src.sr + c0 + c : src.p, ok);
  }
}

__device__ __forceinline__ void tiles_landed() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// s (the warp's 16 rows x 64 columns: 8 n8 tiles) += rows [16 warp, +16) of
// a times the 64 rows of b, over a step's 64 columns (a, b [64][WLD]).
__device__ __forceinline__ void step_products(float (&s)[8][4], const bf16* a, const bf16* b,
                                              int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < WSTEP / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (16 * warp + (lane & 15)) * WLD + 16 * kk + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (16 * j + (lane & 7) + ((lane >> 4) << 3)) * WLD + 16 * kk +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * j], af, bf[0], bf[1]);
      mma_bf16(s[2 * j + 1], af, bf[2], bf[3]);
    }
  }
}

// The warp's 16 x 64 fp32 tile x as bf16 A operands over its 64 columns
// (four k16 steps): the accumulator layout of two n8 tiles is the A layout
// of one k16 step.
__device__ __forceinline__ void as_a(uint32_t (&a)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// acc (the warp's 16 rows x NT n8 tiles) += a (16 x 64, as_a) times blk's
// 64 rows (blk [64][LD], its columns the product's N), the tiles past cw
// columns skipped.
template <int NT, int LD>
__device__ __forceinline__ void apply(float (&acc)[NT][4], const uint32_t (&a)[4][4],
                                      const bf16* blk, int cw, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      if (16 * j >= cw) break;
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, blk + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                16 * j + (lane >> 4) * 8);
      mma_bf16(acc[2 * j], a[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * j + 1], a[kk], bf[2], bf[3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Whether (row, key) is kept: Philox word key & 3 at counter {row, key / 4}.
__device__ __forceinline__ bool kept(const Dropout& dr, int row, int key, uint32_t bh) {
  const uint4 w = philox4x32((uint32_t)row, (uint32_t)key >> 2, dr.seed, bh);
  const uint32_t x = (key & 3) == 0 ? w.x : (key & 3) == 1 ? w.y : (key & 3) == 2 ? w.z : w.w;
  return x >= dr.threshold;
}

// The warp's accumulator element (t, e): row 16 warp + lane / 4 (+ 8 where
// e >= 2), column 8 t + 2 (lane % 4) (+ 1 where e is odd).
__device__ __forceinline__ int acc_row(int warp, int lane, int e) {
  return 16 * warp + (lane >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int acc_col(int t, int lane, int e) {
  return 8 * t + 2 * (lane & 3) + (e & 1);
}

// -- forward -------------------------------------------------------------------
//
// One CTA a (64-query tile, column pass, head, sample). Per 64-key block: S
// in steps of 64 columns (Q's and K's step tiles), the online softmax (a
// row's four lanes reduce its max and sum by shuffles), P rounded to bf16 in
// registers, V's block at the pass's columns, O += P V.

template <bool DROP>
__global__ void __launch_bounds__(WIDE_THREADS)
    wide_fwd_kernel(Strided q, Strided k, Strided v, Strided o, float* lse, int heads, int nq,
                    int nk, int valid_len, int dp, int passes, Width wd, Dropout dr) {
  __shared__ __align__(128) bf16 qs[STEP_ELEMS], ks[STEP_ELEMS];
  __shared__ __align__(128) bf16 vs[WT * (WIDE_FWD_PASS + 8)];
  const int qt = blockIdx.x / passes, pass = blockIdx.x - qt * passes;
  const int h = blockIdx.y, b = blockIdx.z, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * WT, c0 = pass * WIDE_FWD_PASS, cw = min(WIDE_FWD_PASS, dp - c0);
  const Rows Q = rows_of(q, b, h, nq), K = rows_of(k, b, h, nk), V = rows_of(v, b, h, nk);
  const int kend = min(valid_len, nk);
  const uint32_t bh = (uint32_t)(b * heads + h);
  constexpr int NT = WIDE_FWD_PASS / 8;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < kend; k0 += WT) {
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    for (int d0 = 0; d0 < dp; d0 += WSTEP) {
      __syncthreads();  // the last step's (and block's) reads are done
      load_tile<WSTEP>(qs, Q, q0, d0, dp);
      load_tile<WSTEP>(ks, K, k0, d0, dp);
      tiles_landed();
      step_products(s, qs, ks, warp, lane);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t][e] = k0 + acc_col(t, lane, e) < kend ? s[t][e] * wd.scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(mx[i]));  // finite: key 0 is never masked
      alpha[i] = __expf(m[i] - mn);
      m[i] = mn;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t][e] = __expf(s[t][e] - m[e >> 1]);
        rs[e >> 1] += s[t][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(rs[i]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    if (DROP) {
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!kept(dr, q0 + acc_row(warp, lane, e), k0 + acc_col(t, lane, e), bh)) s[t][e] = 0.f;
    }
    uint32_t pa[4][4];
    as_a(pa, s);
    __syncthreads();  // every warp is past S's step tiles; the last block's V is read
    load_tile<WIDE_FWD_PASS>(vs, V, k0, c0, dp);
    tiles_landed();
    apply<NT, WIDE_FWD_PASS + 8>(acc, pa, vs, cw, lane);
  }

  const float post = DROP ? dr.inv_keep : 1.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + acc_row(warp, lane, 2 * i);
    if (row >= nq) continue;
    bf16* orow = o.p + b * o.sb + h * o.sh + row * o.sr + c0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = acc_col(j, lane, 0);
      if (c < cw)
        *reinterpret_cast<uint32_t*>(orow + c) =
            pack_bf16(acc[j][2 * i] / l[i] * post, acc[j][2 * i + 1] / l[i] * post);
    }
    if (lse != nullptr && pass == 0 && (lane & 3) == 0)
      lse[((long long)b * heads + h) * nq + row] = m[i] + logf(l[i]);
  }
}

// -- backward --------------------------------------------------------------------

// delta = rowsum(dO . O) over the head's dp columns: one warp a row.
__global__ void __launch_bounds__(256)
    wide_delta_kernel(Strided o, Strided d_o, float* delta, int heads, int nq, long long rows,
                      int dp) {
  const long long r = ((long long)blockIdx.x * 256 + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int i = (int)(r % nq);
  const long long bh = r / nq;
  const int h = (int)(bh % heads), b = (int)(bh / heads);
  const bf16* orow = o.p + b * o.sb + h * o.sh + i * o.sr;
  const bf16* drow = d_o.p + b * d_o.sb + h * d_o.sh + i * d_o.sr;
  float a = 0.f;
  for (int c = 8 * lane; c < dp; c += 256) {
    const uint4 uo = *reinterpret_cast<const uint4*>(orow + c);
    const uint4 ud = *reinterpret_cast<const uint4*>(drow + c);
    const __nv_bfloat162* eo = reinterpret_cast<const __nv_bfloat162*>(&uo);
    const __nv_bfloat162* ed = reinterpret_cast<const __nv_bfloat162*>(&ud);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(eo[e]), y = __bfloat1622float2(ed[e]);
      a = fmaf(x.x, y.x, a);
      a = fmaf(x.y, y.y, a);
    }
  }
  a = warp_sum(a);
  if (lane == 0) delta[r] = a;
}

// Shared memory of the dK / dV kernel: the step tiles of K, V, Q and dO,
// then the query tile's Q and dO at the pass's columns, then its lse and
// delta.
constexpr int KV_SMEM = 6 * STEP_ELEMS * 2 + 2 * WT * 4;

// One CTA a (64-key block, column pass, head, sample); the query tiles below
// min(valid_len, nq) streamed past it. A warp's 16 rows are keys: S^T = K
// Q^T and dP^T = V dO^T, then dV += P~^T dO and dK += dS^T Q.
template <bool DROP>
__global__ void __launch_bounds__(WIDE_THREADS)
    wide_bwd_kv_kernel(Strided q, Strided k, Strided v, Strided d_o, const float* lse,
                       const float* delta, Strided dk, Strided dv, int heads, int nq, int nk,
                       int valid_len, int dp, int passes, Width wd, Dropout dr) {
  extern __shared__ __align__(128) unsigned char kv_smem[];
  bf16* ks = reinterpret_cast<bf16*>(kv_smem);
  bf16* vs = ks + STEP_ELEMS;
  bf16* qs = vs + STEP_ELEMS;
  bf16* ds = qs + STEP_ELEMS;
  bf16* qc = ds + STEP_ELEMS;  // the pass's columns
  bf16* dc = qc + STEP_ELEMS;
  float* lse_s = reinterpret_cast<float*>(dc + STEP_ELEMS);
  float* delta_s = lse_s + WT;
  const int kt = blockIdx.x / passes, pass = blockIdx.x - kt * passes;
  const int h = blockIdx.y, b = blockIdx.z, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = kt * WT, c0 = pass * WIDE_KV_PASS, cw = min(WIDE_KV_PASS, dp - c0);
  const Rows Q = rows_of(q, b, h, nq), K = rows_of(k, b, h, nk), V = rows_of(v, b, h, nk),
             DO = rows_of(d_o, b, h, nq);
  const int kend = min(valid_len, nk), qend = min(valid_len, nq);
  const long long rbase = ((long long)b * heads + h) * nq;
  const uint32_t bh = (uint32_t)(b * heads + h);
  constexpr int NT = WIDE_KV_PASS / 8;
  float gk[NT][4], gv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.f;

  for (int q0 = 0; k0 < kend && q0 < qend; q0 += WT) {
    float s[8][4], pd[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = pd[t][e] = 0.f;
    for (int d0 = 0; d0 < dp; d0 += WSTEP) {
      __syncthreads();
      if (d0 == 0 && threadIdx.x < WT) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < nq ? lse[rbase + qi] : 0.f;
        delta_s[threadIdx.x] = qi < nq ? delta[rbase + qi] : 0.f;
      }
      load_tile<WSTEP>(ks, K, k0, d0, dp);
      load_tile<WSTEP>(vs, V, k0, d0, dp);
      load_tile<WSTEP>(qs, Q, q0, d0, dp);
      load_tile<WSTEP>(ds, DO, q0, d0, dp);
      tiles_landed();
      step_products(s, ks, qs, warp, lane);
      step_products(pd, vs, ds, warp, lane);
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + acc_row(warp, lane, e), qj = acc_col(t, lane, e), qi = q0 + qj;
        const bool ok = key < kend && qi < qend;
        const float p = ok ? __expf(s[t][e] * wd.scale - lse_s[qj]) : 0.f;
        float pv = p, dpv = pd[t][e];
        if (DROP) {
          const bool keep = kept(dr, qi, key, bh);
          pv = keep ? p * dr.inv_keep : 0.f;
          dpv = keep ? dpv * dr.inv_keep : 0.f;
        }
        s[t][e] = pv;
        pd[t][e] = ok ? p * (dpv - delta_s[qj]) * wd.scale : 0.f;
      }
    uint32_t pa[4][4], da[4][4];
    as_a(pa, s);
    as_a(da, pd);
    __syncthreads();  // the step tiles and lse / delta are read; the last tile's Q and dO too
    load_tile<WIDE_KV_PASS>(qc, Q, q0, c0, dp);
    load_tile<WIDE_KV_PASS>(dc, DO, q0, c0, dp);
    tiles_landed();
    apply<NT, WLD>(gv, pa, dc, cw, lane);
    apply<NT, WLD>(gk, da, qc, cw, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + acc_row(warp, lane, 2 * i);
    if (key >= nk) continue;
    bf16* krow = dk.p + b * dk.sb + h * dk.sh + key * dk.sr + c0;
    bf16* vrow = dv.p + b * dv.sb + h * dv.sh + key * dv.sr + c0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = acc_col(j, lane, 0);
      if (c >= cw) continue;
      *reinterpret_cast<uint32_t*>(krow + c) = pack_bf16(gk[j][2 * i], gk[j][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(vrow + c) = pack_bf16(gv[j][2 * i], gv[j][2 * i + 1]);
    }
  }
}

// Shared memory of the dQ kernel: the step tiles of Q, dO, K and V, then the
// key block's K at the pass's columns.
constexpr int Q_SMEM = 4 * STEP_ELEMS * 2 + WT * (WIDE_Q_PASS + 8) * 2;

// One CTA a (64-query tile, column pass, head, sample); the key blocks below
// min(valid_len, nk) streamed past it: S = Q K^T and dP = dO V^T, then dQ
// += dS K.
template <bool DROP>
__global__ void __launch_bounds__(WIDE_THREADS)
    wide_bwd_q_kernel(Strided q, Strided k, Strided v, Strided d_o, const float* lse,
                      const float* delta, Strided dq, int heads, int nq, int nk, int valid_len,
                      int dp, int passes, Width wd, Dropout dr) {
  extern __shared__ __align__(128) unsigned char q_smem[];
  bf16* qs = reinterpret_cast<bf16*>(q_smem);
  bf16* ds = qs + STEP_ELEMS;
  bf16* ks = ds + STEP_ELEMS;
  bf16* vs = ks + STEP_ELEMS;
  bf16* kb = vs + STEP_ELEMS;  // [64][WIDE_Q_PASS + 8]: the pass's columns
  const int qtile = blockIdx.x / passes, pass = blockIdx.x - qtile * passes;
  const int h = blockIdx.y, b = blockIdx.z, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qtile * WT, c0 = pass * WIDE_Q_PASS, cw = min(WIDE_Q_PASS, dp - c0);
  const Rows Q = rows_of(q, b, h, nq), K = rows_of(k, b, h, nk), V = rows_of(v, b, h, nk),
             DO = rows_of(d_o, b, h, nq);
  const int kend = min(valid_len, nk), qend = min(valid_len, nq);
  const long long rbase = ((long long)b * heads + h) * nq;
  const uint32_t bh = (uint32_t)(b * heads + h);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + acc_row(warp, lane, 2 * i);
    lse_r[i] = qi < qend ? lse[rbase + qi] : 0.f;
    delta_r[i] = qi < qend ? delta[rbase + qi] : 0.f;
  }
  constexpr int NT = WIDE_Q_PASS / 8;
  float gq[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) gq[j][0] = gq[j][1] = gq[j][2] = gq[j][3] = 0.f;

  for (int k0 = 0; q0 < qend && k0 < kend; k0 += WT) {
    float s[8][4], pd[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = pd[t][e] = 0.f;
    for (int d0 = 0; d0 < dp; d0 += WSTEP) {
      __syncthreads();
      load_tile<WSTEP>(qs, Q, q0, d0, dp);
      load_tile<WSTEP>(ds, DO, q0, d0, dp);
      load_tile<WSTEP>(ks, K, k0, d0, dp);
      load_tile<WSTEP>(vs, V, k0, d0, dp);
      tiles_landed();
      step_products(s, qs, ks, warp, lane);
      step_products(pd, ds, vs, warp, lane);
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + acc_row(warp, lane, e), key = k0 + acc_col(t, lane, e);
        const bool ok = qi < qend && key < kend;
        const float p = ok ? __expf(s[t][e] * wd.scale - lse_r[e >> 1]) : 0.f;
        float dpv = pd[t][e];
        if (DROP) dpv = kept(dr, qi, key, bh) ? dpv * dr.inv_keep : 0.f;
        pd[t][e] = ok ? p * (dpv - delta_r[e >> 1]) * wd.scale : 0.f;
      }
    uint32_t da[4][4];
    as_a(da, pd);
    __syncthreads();  // the step tiles are read; the last block's K too
    load_tile<WIDE_Q_PASS>(kb, K, k0, c0, dp);
    tiles_landed();
    apply<NT, WIDE_Q_PASS + 8>(gq, da, kb, cw, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + acc_row(warp, lane, 2 * i);
    if (qi >= nq) continue;
    bf16* qrow = dq.p + b * dq.sb + h * dq.sh + qi * dq.sr + c0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = acc_col(j, lane, 0);
      if (c < cw)
        *reinterpret_cast<uint32_t*>(qrow + c) = pack_bf16(gq[j][2 * i], gq[j][2 * i + 1]);
    }
  }
}

// The dynamic shared-memory limit of `kernel`, set once per device.
template <typename Kernel>
cudaError_t smem_limit(Kernel kernel, int bytes, bool (&ready)[16]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 16 && ready[dev])) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 16) ready[dev] = true;
  return e;
}

template <bool DROP>
cudaError_t wide_bwd(const Strided& q, const Strided& k, const Strided& v, const Strided& o,
                     const Strided& d_o, const float* lse, float* delta, const Strided& dq,
                     const Strided& dk, const Strided& dv, int B, int heads, int nq, int nk,
                     int valid_len, const Width& wd, const Dropout& dr, cudaStream_t st) {
  static bool kv_ready[16], q_ready[16];
  cudaError_t e;
  if ((e = smem_limit(wide_bwd_kv_kernel<DROP>, KV_SMEM, kv_ready)) != cudaSuccess) return e;
  if ((e = smem_limit(wide_bwd_q_kernel<DROP>, Q_SMEM, q_ready)) != cudaSuccess) return e;
  const int dp = wd.dh;
  const long long rows = (long long)B * heads * nq;
  wide_delta_kernel<<<(unsigned)((rows * 32 + 255) / 256), 256, 0, st>>>(o, d_o, delta, heads, nq,
                                                                          rows, dp);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int kv_passes = cdiv(dp, WIDE_KV_PASS), q_passes = cdiv(dp, WIDE_Q_PASS);
  wide_bwd_kv_kernel<DROP><<<dim3(cdiv(nk, WT) * kv_passes, heads, B), WIDE_THREADS, KV_SMEM,
                             st>>>(q, k, v, d_o, lse, delta, dk, dv, heads, nq, nk, valid_len,
                                   dp, kv_passes, wd, dr);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wide_bwd_q_kernel<DROP><<<dim3(cdiv(nq, WT) * q_passes, heads, B), WIDE_THREADS, Q_SMEM, st>>>(
      q, k, v, d_o, lse, delta, dq, heads, nq, nk, valid_len, dp, q_passes, wd, dr);
  return cudaGetLastError();
}

}  // namespace

namespace svt {

cudaError_t flash_fwd_wide(Strided q, Strided k, Strided v, Strided o, float* lse, int B,
                           int heads, int nq, int nk, int valid_len, int dh, cudaStream_t st,
                           Dropout dr) {
  const Width wd = width_of(dh);
  const int passes = cdiv(wd.dh, WIDE_FWD_PASS);
  const dim3 grid(cdiv(nq, WT) * passes, heads, B);
  if (dr.on)
    wide_fwd_kernel<true><<<grid, WIDE_THREADS, 0, st>>>(q, k, v, o, lse, heads, nq, nk,
                                                         valid_len, wd.dh, passes, wd, dr);
  else
    wide_fwd_kernel<false><<<grid, WIDE_THREADS, 0, st>>>(q, k, v, o, lse, heads, nq, nk,
                                                          valid_len, wd.dh, passes, wd, dr);
  return cudaGetLastError();
}

cudaError_t flash_bwd_wide(Strided q, Strided k, Strided v, Strided o, Strided d_o,
                           const float* lse, float* delta, Strided dq, Strided dk, Strided dv,
                           int B, int heads, int nq, int nk, int valid_len, int dh,
                           cudaStream_t st, Dropout dr) {
  const Width wd = width_of(dh);
  return dr.on ? wide_bwd<true>(q, k, v, o, d_o, lse, delta, dq, dk, dv, B, heads, nq, nk,
                                valid_len, wd, dr, st)
               : wide_bwd<false>(q, k, v, o, d_o, lse, delta, dq, dk, dv, B, heads, nq, nk,
                                 valid_len, wd, dr, st);
}

}  // namespace svt
