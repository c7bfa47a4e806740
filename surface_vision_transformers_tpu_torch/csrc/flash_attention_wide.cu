// Attention at head widths past the widest tile of flash_attention.cu: heads
// laid out in more than 128 columns (dh 129 and up; flash_attention.cuh
// head_cols), forward and backward, with or without dropout, at any number
// of queries and keys.
//
// Replaces the same TPU kernels as flash_attention.cu
// (surface_vision_transformers_tpu/ops/pallas/flash_attention.py: _fwd,
// _bwd_impl, _fwd_packed, _bwd_packed, _fwd_packed_drop, _bwd_packed_drop,
// _fwd_tiled, _bwd_tiled, whose BlockSpecs span the whole head at any D) at
// those widths; the few-query shapes (the CLS block's 8 rows), the
// sequence-parallel shapes (queries != keys) and the block chains'
// attention run here too at these widths.
//
// What bounds it on this card: at B 256, N 321, dh 192 (three heads) the
// forward is 4 B H N^2 dh = 61 GFLOP against 0.38 GB of q, k, v, o and lse,
// so bytes bound it (0.11 ms at 3.35 TB/s; the products alone 0.06 ms at
// the bf16 peak); the backward reads twice that for 2.5x the products. The
// head's width is what changes: a 64 x 64 score tile costs dh / 16 k16
// steps, and O (dQ, dK, dV) grows to dh / 2 fp32 registers a thread.
//
// Forward (wide_fwd_kernel): wgmma fed from shared memory that TMA fills
// ahead of it, the scores' sums whole (one pass over the head, no score made
// twice) wherever O fits the registers.
//
// - Panels. Every operand moves as panels of 64 rows x 32 columns (4 KB) in
//   the 64-byte swizzle, one TMA box each. The box is 32 columns because
//   the 64-byte swizzle spans 64 bytes (the 128-byte one would allow 64
//   columns a box); 32-column panels split a head evenly at dp 192 (6
//   panels) and waste 24 columns at dp 136, where 64-column panels would
//   waste 56. One panel serves as a K-major operand (two k16 steps 32 bytes
//   apart) and as an MN-major one of width 32 (k16 steps 1024 bytes apart),
//   so the same tile shape feeds S = Q K^T and P V. The tensor maps'
//   innermost extent is the head's dp, not the packed row (packed qkv is
//   (B, N, 3 H dp)): a box past dp is zero-filled by TMA instead of reading
//   the next head's columns, so dp 136's last panel holds its 8 live
//   columns and 24 zeros, and S's k16 steps wholly past dp are skipped.
// - A ring. One thread of the producer warpgroup issues every load by TMA
//   into a ring of panel slots (as many as shared memory holds beside the
//   resident Q, up to RING_MAX), each slot with a full and an empty
//   mbarrier; the consumers take the panels in the order the producer
//   pushes them, so loads run as far ahead as the ring allows. A key
//   block's score sums over the head are one commit group where the ring
//   holds all their panels beside V's, else groups of `chunk` panels, each
//   released once the next is issued and it is done. Q is loaded once and
//   stays resident; past RES_PANELS panels (dp 384) it comes through the
//   ring with K, so no width is refused.
// - wgmma. Consumer warpgroups of 128 threads and a producer warpgroup,
//   which gives its registers to the consumers (setmaxnreg); the products
//   are wgmma m64n64k16 (S) and m64n32k16 (O, a panel), bf16 in, fp32
//   accumulators. Shared memory above 48 KB needs cudaFuncSetAttribute,
//   done once per device.
// - Passes only past dp 256: O holds at most PASS_PANELS panels (256
//   columns, 128 fp32 registers a thread) a CTA; wider heads run
//   ceil(panels / 8) passes, each a CTA of its own that makes the scores
//   again (dp 384: two passes of 192 columns, against three of 128 before).
//
// A CTA a (128 queries, pass, head, sample), warpgroup w holding rows 64 w
// .. with its Q resident (at most 64 queries, as the CLS block's 8, or a
// streamed width: one consumer warpgroup, two CTAs an SM where shared
// memory allows). Per 64-key block: S = Q K^T over the head's panels, the
// online softmax in registers (exp2 with the true width's scale), P rounded
// to bf16 as the register A operand of O += P V (V read MN-major). Block j
// + 1's S and block j's P V are issued together, and the softmax runs under
// the other warpgroup's products. O leaves as bf16 pairs from the
// registers, lse = m / sqrt(dh) + log l from pass 0.
//
// Backward, three launches of warp-level mma.sync m16n8k16 on four-warp
// CTAs (each warp 16 rows of a 64-row tile), operands loaded by cp.async
// into shared-memory step tiles (zeros past the rows and the head's
// columns) and read by ldmatrix: delta = rowsum(dO . O) (a warp a row);
// dK / dV (wide_bwd_kv_kernel: a CTA a 64-key block and column pass, the
// query tiles streamed past it); dQ (wide_bwd_q_kernel: a CTA a 64-query
// tile and column pass, the key blocks streamed past it). S and dP are
// summed over the head in steps of WSTEP columns; dK and dV are made in
// passes of WIDE_KV_PASS columns and dQ in WIDE_Q_PASS, each pass making the
// scores again; P~ and dS stay in registers as the next product's A
// operand. A wgmma backward of the forward's design (dK / dV with K and V
// resident and Q, dO through the ring; dQ with Q and dO resident and K, V
// through the ring; S and dP once a tile pair, P~^T and dS^T staged in
// shared memory) was built and measured slower than this one at every width
// without dropout (PERF.md): ptxas held its 384-thread CTAs at 168
// registers, spilled the dK / dV accumulators and serialised the wgmma
// (C7518 / C7520).
//
// Numerics are the plain version's (ops/flash_attention.py): fp32 scores
// scaled by 1 / sqrt(dh) of the true width (Width), P rounded to bf16
// before P.V and the sum of the unrounded P divided out after it (an online
// softmax, rescaled between key blocks), lse = m + log l; in the backward P
// = exp(s - lse) over keys and query rows < valid_len (the others
// contribute nothing), delta = rowsum(dO . O), dS = bf16(P (dP - delta) /
// sqrt(dh)), P~ = bf16(keep(P) / (1 - rate)) for dV; with dropout the keep
// bit of (row, key) is Philox4x32-10's word key & 3 at counter {row, key /
// 4} under key {seed, b * heads + h}, as every other attention kernel draws
// it (the forward takes one call for four keys: threads 2u and 2u + 1 of a
// quad hold keys 4u .. 4u + 3 of rows g and g + 8, so each draws one row and
// a shuffle swaps halves). Every sum is in a fixed order and nothing is
// atomic, so the outputs repeat bit for bit. Times beside SDPA and the
// bound: PERF.md.

#include <algorithm>

#include "flash_attention.cuh"

namespace {

using namespace svt;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// -- forward -------------------------------------------------------------------

constexpr int PC = 32;                   // columns of a panel
constexpr int PANEL = 64 * PC;           // its bf16 elements: 64 rows x 32 columns, 4 KB
constexpr int PANEL_BYTES = PANEL * 2;
constexpr int PASS_PANELS = 8;           // panels of O a CTA makes (256 columns)
constexpr int RES_PANELS = 12;           // resident Q up to 12 panels (dp 384)
constexpr int RING_MAX = 48;             // ring slots at most
constexpr int PRODUCER_REGS = 24;        // registers: the producer warpgroup gives up the
constexpr int CONSUMER_REGS = 240;       // rest to the consumers (128 x 24 + 256 x 240 <= 65536)
// The forward with one consumer warpgroup (at most 64 queries, or the
// streamed widths): two CTAs an SM, 2 x (128 x 24 + 128 x 232) registers,
// up to half the SM's shared memory each (less the block's reserved 1 KB).
constexpr int CONSUMER1_REGS = 232;
constexpr int SMEM_SM = 233472;
constexpr int BAR_BYTES = 1024;          // the mbarriers, at the start of shared memory

// How a launch cuts the head: dp columns in qp panels; `passes` column
// passes of at most pp panels each (blockIdx.x = tile * passes + pass);
// the ring's slots; whether the resident operands stream through the ring
// (past RES_PANELS); the panels of a commit group of the scores' sums
// (chunk: all qp where the ring holds them beside V's); byte offsets of the
// resident panels and the ring in shared memory (after the mbarriers).
struct Geo {
  int dp, qp, passes, pp, ring, stream, chunk;
  int res_off, ring_off;
};

// The calling thread's warpgroup, as a value the compiler knows to be the
// same across the warp (so that branches on it are not divergent paths
// around wgmma).
__device__ __forceinline__ int warpgroup() { return __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0); }

// Shared memory of a CTA: the mbarriers (full[RING_MAX], empty[RING_MAX],
// the resident panels'), then the regions Geo places, from a base aligned to
// 1024 bytes.
struct Smem {
  unsigned char* base;
  __device__ uint64_t* full() const { return reinterpret_cast<uint64_t*>(base); }
  __device__ uint64_t* empty() const { return full() + RING_MAX; }
  __device__ uint64_t* res_bar() const { return full() + 2 * RING_MAX; }
  __device__ bf16* at(int off) const { return reinterpret_cast<bf16*>(base + off); }
};
__device__ __forceinline__ Smem smem_of(unsigned char* raw) {
  return Smem{reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                               ~uintptr_t(1023))};
}

// The barriers: full (one arrival and the TMA bytes) and empty (one arrival
// a consumer warpgroup) for each ring slot, and the resident panels' full.
__device__ __forceinline__ void init_bars(const Smem& sm, const Geo& g, int consumers) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < g.ring; ++i) {
      mbar_init(&sm.full()[i], 1);
      mbar_init(&sm.empty()[i], consumers);
    }
    mbar_init(sm.res_bar(), 1);
  }
  __syncthreads();
}

// The producer's end of the ring: use u goes to slot u % ring once the
// consumers have released the use before it there.
struct Pusher {
  uint64_t* full;
  uint64_t* empty;
  bf16* slots;
  int ring, u;
  __device__ void push(const CUtensorMap& m, bool hf, int panel, int row, int h, int b) {
    const int s = u % ring;
    if (u >= ring) mbar_wait(&empty[s], (u / ring - 1) & 1);
    mbar_expect(&full[s], PANEL_BYTES);
    load(slots + s * PANEL, m, &full[s], hf, panel, row, h, b);
    ++u;
  }
  // One panel of an operand's 4-D map (columns; rows and heads in the map's
  // order; samples).
  __device__ static void load(bf16* dst, const CUtensorMap& m, uint64_t* bar, bool hf, int panel,
                              int row, int h, int b) {
    tma_load_4d(dst, m, bar, panel * PC, hf ? h : row, hf ? row : h, b);
  }
};

// A consumer warpgroup's end: the panels in the order they were pushed.
struct Taker {
  uint64_t* full;
  uint64_t* empty;
  bf16* slots;
  int ring, u;
  __device__ bf16* take() {
    const int s = u % ring;
    mbar_wait(&full[s], (u / ring) & 1);
    ++u;
    return slots + s * PANEL;
  }
  __device__ bf16* at(int v) const { return slots + (v % ring) * PANEL; }
  // Wait for the next n uses to land (their slots: at()).
  __device__ void wait(int n) {
    for (int i = 0; i < n; ++i) take();
  }
  // Use v's slot may be refilled as far as this warpgroup goes.
  __device__ void release(int v, bool leader) const {
    if (leader) mbar_arrive(&empty[v % ring]);
  }
};

template <int M, int N>
__device__ __forceinline__ void hold2(float (&d)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) wg_hold(d[i]);
}

// 2^x on the special-function unit; 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Keep bits of a score tile whose keys are columns: SA accumulators a
// thread, SA / 4 groups of 8 keys from key0, rows `row` and row + 8. Keys
// 4u .. 4u + 3 of a group share a Philox counter; threads 2u and 2u + 1
// hold them for rows g and g + 8. The even thread draws row g, the odd one
// row g + 8, and one shuffle swaps the halves the other needs: one call per
// four scores. -> bit 4 j + e: the keep bit of accumulator 4 j + e.
template <int SA>
__device__ __forceinline__ uint32_t keep_cols(const Dropout& dr, int row, int key0, int t,
                                              uint32_t bh) {
  const bool odd = t & 1;
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < SA / 4; ++j) {
    const uint4 w = philox4x32((uint32_t)(row + (odd ? 8 : 0)),
                               (uint32_t)(key0 + 8 * j) / 4 + (t >> 1), dr.seed, bh);
    const uint32_t lo = (w.x >= dr.threshold) | (w.y >= dr.threshold) << 1;
    const uint32_t hi = (w.z >= dr.threshold) | (w.w >= dr.threshold) << 1;
    const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 1);
    const uint32_t k0 = odd ? got : lo, k1 = odd ? hi : got;  // rows g, g + 8
    bits |= (k0 | k1 << 2) << (4 * j);
  }
  return bits;
}

// Tile scores s (raw Q.K of keys key0 + column) -> P = exp((s - m) / sqrt(dh))
// in place, with the running row max m and sum l (this thread's columns)
// carried over and the old max's rescale factor a returned per row. With
// MASK (the block that holds valid_len), columns >= kvalid take P = 0. With
// dropout, P is then zeroed where the keep bit is clear (l stays the
// undropped sum).
template <bool DROP, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&a)[2], int kvalid, int key0, int row,
                                             uint32_t bh, const Dropout& dr, int t, float slog2) {
  if constexpr (MASK) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t + (e & 1) >= kvalid) s[4 * j + e] = -INFINITY;
  }
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mx[r][c] = fmaxf(s[4 * c + 2 * r], s[4 * c + 2 * r + 1]);
      sum[r][c] = 0.f;
    }
#pragma unroll
  for (int j = 4; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r][j & 3] = fmaxf(mx[r][j & 3], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // every block holds a key < kend: the new max is finite
    const float mn =
        fmaxf(m[r], quad_max(fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]))));
    a[r] = exp2_approx((m[r] - mn) * slog2);  // 0 at the first block
    m[r] = mn;
    ms[r] = mn * slog2;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], slog2, -ms[e >> 1]));
      sum[e >> 1][j & 3] += s[4 * j + e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * a[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
  if constexpr (DROP) {
    const uint32_t keep = keep_cols<32>(dr, row, key0, t, bh);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (!((keep >> i) & 1)) s[i] = 0.f;
  }
}

// A CTA a (64 NWG queries, column pass, head, sample): warpgroup w owns
// query rows q0 + 64 w .. and O's pass panels (acc[l], l < np). The ring
// carries, per 64-key block j, K_j's qp panels (each after the matching Q
// panel where Q streams) and V_j's np pass panels, in the order S(0), S(1),
// V(0), S(2), V(1), ..., V(last): block j + 1's S is issued with block j's
// P V.
template <bool DROP, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, NWG == 1 ? 2 : 1)
    wide_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, int hf_q, int hf_k, int hf_v,
                    const Strided o, float* __restrict__ lse, int nq, int nk, int valid_len,
                    const Geo g, const Width wd, const Dropout dr) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem sm = smem_of(smem_raw);
  const int tile = blockIdx.x / g.passes, pass = blockIdx.x - tile * g.passes;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int q0 = tile * 64 * NWG;
  const int active = min(NWG, cdiv(nq - q0, 64));  // warpgroups holding query rows
  const int kend = min(valid_len, nk), nkb = cdiv(kend, 64);
  const int p0 = pass * g.pp, np = min(g.pp, g.qp - p0);  // this pass's O panels
  bf16* qres = sm.at(g.res_off);
  init_bars(sm, g, active);
  const int w = warpgroup();

  if (w == NWG) {  // the producer
    set_max_regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == NWG * 128) {
      if (!g.stream) {
        mbar_expect(sm.res_bar(), active * g.qp * PANEL_BYTES);
        for (int x = 0; x < active; ++x)
          for (int p = 0; p < g.qp; ++p)
            Pusher::load(qres + (x * g.qp + p) * PANEL, tm_q, sm.res_bar(), hf_q, p, q0 + 64 * x,
                         h, b);
      }
      Pusher r{sm.full(), sm.empty(), sm.at(g.ring_off), g.ring, 0};
      auto push_s = [&](int j) {
        for (int p = 0; p < g.qp; ++p) {
          if (g.stream) r.push(tm_q, hf_q, p, q0, h, b);
          r.push(tm_k, hf_k, p, 64 * j, h, b);
        }
      };
      auto push_v = [&](int j) {
        for (int l = 0; l < np; ++l) r.push(tm_v, hf_v, p0 + l, 64 * j, h, b);
      };
      push_s(0);
      for (int j = 0; j + 1 < nkb; ++j) {
        push_s(j + 1);
        push_v(j);
      }
      push_v(nkb - 1);
    }
    return;
  }

  set_max_regs_inc<NWG == 1 ? CONSUMER1_REGS : CONSUMER_REGS>();
  if (w >= active) return;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int row = q0 + 64 * w + 16 * warp + (lane >> 2);  // this thread's rows: row, row + 8
  const uint32_t bh = (uint32_t)(b * heads + h);
  const bool lead = tid == 0;
  Taker r{sm.full(), sm.empty(), sm.at(g.ring_off), g.ring, 0};
  const bf16* qw = qres + w * g.qp * PANEL;

  float acc[PASS_PANELS][16], s[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2];
  uint32_t pf[4][4];
#pragma unroll
  for (int i = 0; i < PASS_PANELS; ++i)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[i][e] = 0.f;
  if (!g.stream) mbar_wait(sm.res_bar(), 0);

  // S = Q K_j^T over the head's panels, g.chunk panels a commit group, a
  // group's slots released once the next is issued and it is done; -> the
  // first use of the last group, still in flight.
  const int per = g.stream ? 2 : 1;  // ring uses a panel of S
  auto issue_s = [&]() {
    int prev = r.u;
    for (int c0 = 0; c0 < g.qp; c0 += g.chunk) {
      const int u = r.u, ce = min(g.qp, c0 + g.chunk);
      r.wait(per * (ce - c0));
      wg_hold(s);
      wg_fence();
      for (int p = c0; p < ce; ++p) {
        const int v = u + per * (p - c0);
        const bf16* qs = g.stream ? r.at(v) : qw + p * PANEL;
        const bf16* ks = r.at(v + per - 1);
        wgmma_ss<0, 0>(s, sw64_desc(qs), sw64_desc(ks), p > 0);
        if (PC * p + 16 < g.dp) wgmma_ss<0, 0>(s, sw64_desc(qs + 16), sw64_desc(ks + 16), 1);
      }
      wg_commit();
      if (c0 > 0) {
        wg_wait<1>();
        for (int v = prev; v < u; ++v) r.release(v, lead);
      }
      prev = u;
    }
    return prev;
  };
  // O += P V_j over the pass's panels (the 16-key steps below kv_steps).
  auto issue_pv = [&](int kv_steps) {
    const bf16* vs[PASS_PANELS];
#pragma unroll
    for (int i = 0; i < PASS_PANELS; ++i) vs[i] = i < np ? r.take() : nullptr;
    hold2(acc);
    wg_hold(pf);
    wg_fence();
#pragma unroll
    for (int i = 0; i < PASS_PANELS; ++i)
      if (i < np)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < kv_steps) wgmma_rs<1>(acc[i], pf[kk], sw64_desc(vs[i] + kk * 16 * PC), 1);
    wg_commit();
  };
  auto softmax = [&](int j) {  // block j's scores in s -> P
    if (kend - 64 * j < 64)
      softmax_tile<DROP, true>(s, m, l, a, kend - 64 * j, 64 * j, row, bh, dr, t, wd.slog2);
    else
      softmax_tile<DROP, false>(s, m, l, a, 64, 64 * j, row, bh, dr, t, wd.slog2);
  };
  auto pack = [&]() {  // P (fp32 accumulator layout) -> bf16 A fragments, one per 16 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pf[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  };

  int sfirst = issue_s();
  wg_wait<0>();
  wg_hold(s);
  for (int v = sfirst; v < r.u; ++v) r.release(v, lead);
  softmax(0);
  pack();
  // Block j + 1's S and block j's P V go to the tensor cores together; the
  // softmax waits for both, so that no instruction writes an accumulator
  // while a product is in flight (ptxas would serialise every wgmma), and
  // runs under the other warpgroup's (or CTA's) products.
  for (int j = 0; j + 1 < nkb; ++j) {
    sfirst = issue_s();
    issue_pv(4);
    wg_wait<0>();
    wg_hold(s);
    hold2(acc);
    wg_hold(pf);
    for (int v = sfirst; v < r.u; ++v) r.release(v, lead);
    softmax(j + 1);
#pragma unroll
    for (int i = 0; i < PASS_PANELS; ++i)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[i][e] *= a[(e >> 1) & 1];
    pack();
    hold2(acc);  // the rescale stays before the next products
    wg_hold(pf);
  }
  const int v0 = r.u;
  issue_pv(cdiv(kend - 64 * (nkb - 1), 16));  // 16-key steps wholly past kend skipped
  wg_wait<0>();
  hold2(acc);
  for (int v = v0; v < r.u; ++v) r.release(v, lead);

  // O = acc / l (x 1 / (1 - rate)), lse = m / sqrt(dh) + log l
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = (DROP ? dr.inv_keep : 1.f) / l[i];
  }
  if (lse != nullptr && pass == 0 && t == 0) {
    float* lrow = lse + (long long)bh * nq;
    if (row < nq) lrow[row] = m[0] * wd.scale + logf(l[0]);
    if (row + 8 < nq) lrow[row + 8] = m[1] * wd.scale + logf(l[1]);
  }
#pragma unroll
  for (int i = 0; i < PASS_PANELS; ++i) {
    if (i >= np) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = PC * (p0 + i) + 8 * j + 2 * t;
      if (c >= g.dp) continue;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        if (row + 8 * rr < nq)
          *reinterpret_cast<uint32_t*>(o.row(b, h, row + 8 * rr) + c) =
              pack_bf16(acc[i][4 * j + 2 * rr] * inv[rr], acc[i][4 * j + 2 * rr + 1] * inv[rr]);
    }
  }
}

// -- backward -------------------------------------------------------------------

constexpr int WT = 64;              // rows of a CTA's tile; keys (or queries) a block
constexpr int WSTEP = 64;           // columns of a score step
constexpr int WLD = WSTEP + 8;      // row pitch of a step tile (ldmatrix without conflicts)
constexpr int WIDE_THREADS = 128;   // four warps, 16 rows each
constexpr int WIDE_Q_PASS = 128;    // dQ's columns a pass
constexpr int WIDE_KV_PASS = 64;    // dK's and dV's columns a pass
constexpr int STEP_ELEMS = WT * WLD;

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

// -- host side -------------------------------------------------------------------

// The most dynamic shared memory a block may take on the current device
// (read once per device).
int smem_optin() {
  static int bytes[16];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 16 && bytes[dev]) return bytes[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  if (dev < 16) bytes[dev] = n;
  return n;
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

// The forward's cut of a head of dp columns, and its shared memory: res_sets
// warpgroups' resident Q up to RES_PANELS panels, then as many ring slots as
// fit in `budget` bytes (the device's most a block by default). A CTA holds
// at once a key block's V panels (its second product) and its score sums:
// all of them in one commit group where the ring has room, else two chunks
// in flight.
cudaError_t plan(int dp, Geo& g, int& smem, int res_sets, int budget = 0) {
  g.dp = dp;
  g.qp = cdiv(dp, PC);
  g.passes = cdiv(g.qp, PASS_PANELS);
  g.pp = cdiv(g.qp, g.passes);
  g.stream = g.qp > RES_PANELS;
  const int res = g.stream ? 0 : res_sets * g.qp * PANEL_BYTES;
  const int per = g.stream ? 2 : 1;  // ring uses a panel of the sums
  g.res_off = BAR_BYTES;
  g.ring_off = g.res_off + res;
  const int avail = (budget ? budget : smem_optin()) - 1024 - g.ring_off;  // 1024: alignment
  g.ring = std::min(RING_MAX, avail / PANEL_BYTES);
  const bool whole = g.ring >= per * g.qp + g.pp;  // a block's sums in one group beside V's
  g.chunk = whole ? g.qp : std::min(g.qp, (g.ring - g.pp) / (2 * per));
  if (g.chunk < 1) return cudaErrorInvalidConfiguration;
  smem = 1024 + g.ring_off + g.ring * PANEL_BYTES;
  return cudaSuccess;
}

// A TMA map of the (B, heads, n, dp) operand t in 64 x 32 panels (64-byte
// swizzle, zero fill past dp and past n); the two middle dimensions in
// increasing stride (heads first for the packed (B, n, heads * dp) layouts).
cudaError_t panel_map(CUtensorMap* m, int& hf, const Strided& t, int B, int heads, int n,
                      int dp) {
  hf = t.sh < t.sr;
  const cuuint64_t dims[4] = {(cuuint64_t)dp, (cuuint64_t)(hf ? heads : n),
                              (cuuint64_t)(hf ? n : heads), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(hf ? t.sh : t.sr) * 2,
                                 (cuuint64_t)(hf ? t.sr : t.sh) * 2, (cuuint64_t)t.sb * 2};
  const cuuint32_t box[4] = {PC, hf ? 1u : 64u, hf ? 64u : 1u, 1};
  return encode_tiled(m, 4, t.p, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      CU_TENSOR_MAP_SWIZZLE_64B);
}

template <bool DROP, int NWG>
cudaError_t launch_fwd(const Strided& q, const Strided& k, const Strided& v, const Strided& o,
                       float* lse, int B, int heads, int nq, int nk, int valid_len,
                       const Width& wd, const Dropout& dr, cudaStream_t st) {
  static bool ready[16];
  cudaError_t e = smem_limit(wide_fwd_kernel<DROP, NWG>, smem_optin(), ready);
  if (e != cudaSuccess) return e;
  Geo g;
  int smem = 0;
  const bool streamed = cdiv(wd.dh, PC) > RES_PANELS;  // one CTA an SM takes all it may
  if ((e = plan(wd.dh, g, smem, NWG, NWG == 1 && !streamed ? SMEM_SM / 2 - 1024 : 0)) !=
      cudaSuccess)
    return e;
  CUtensorMap tq, tk, tv;
  int hq, hk, hv;
  if ((e = panel_map(&tq, hq, q, B, heads, nq, wd.dh)) != cudaSuccess) return e;
  if ((e = panel_map(&tk, hk, k, B, heads, nk, wd.dh)) != cudaSuccess) return e;
  if ((e = panel_map(&tv, hv, v, B, heads, nk, wd.dh)) != cudaSuccess) return e;
  const dim3 grid(cdiv(nq, 64 * NWG) * g.passes, heads, B);
  wide_fwd_kernel<DROP, NWG><<<grid, (NWG + 1) * 128, smem, st>>>(tq, tk, tv, hq, hk, hv, o, lse,
                                                                  nq, nk, valid_len, g, wd, dr);
  return cudaGetLastError();
}

// Two consumer warpgroups (128 queries a CTA, sharing K and V) where the
// queries fill them and Q stays resident; else one (two CTAs an SM).
template <bool DROP>
cudaError_t wide_fwd(const Strided& q, const Strided& k, const Strided& v, const Strided& o,
                     float* lse, int B, int heads, int nq, int nk, int valid_len, const Width& wd,
                     const Dropout& dr, cudaStream_t st) {
  if (nq > 64 && cdiv(wd.dh, PC) <= RES_PANELS)
    return launch_fwd<DROP, 2>(q, k, v, o, lse, B, heads, nq, nk, valid_len, wd, dr, st);
  return launch_fwd<DROP, 1>(q, k, v, o, lse, B, heads, nq, nk, valid_len, wd, dr, st);
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
  return dr.on ? wide_fwd<true>(q, k, v, o, lse, B, heads, nq, nk, valid_len, wd, dr, st)
               : wide_fwd<false>(q, k, v, o, lse, B, heads, nq, nk, valid_len, wd, dr, st);
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
