// Hopper (sm_90a) gather-fused patch embedding.
//
// Replaces the TPU kernel
// surface_vision_transformers_tpu/ops/pallas/patch_embed.py::
// pallas_patch_embed (_embed_kernel) -> svt_patch_embed:
//   out[b, l, :] = bf16( sum_k tok[b, l, k] W[:, k] + bias ),
//   tok[b, l, v * C + c] = bf16( x[b, c, idx[l, v]] )      ((v c) order, C 1 .. 8),
// fp32 accumulation and an fp32 bias, rounded once. The TPU version gathers
// the tokens in XLA and writes them to HBM before its GEMM kernel; here the
// gather is the GEMM's A-operand load, so the (B, L, C V) tokens never
// exist in device memory.
//
// What bounds it on this card: bytes, and the latency of the gather. At
// SiT-tiny (sub-ico 2, B = 256) it reads 168 MB of fp32 x (each vertex
// about 1.2 times: adjacent patches share boundary vertices, which L2
// absorbs) and writes 31.5 MB: 0.06 ms at 3.35 TB/s, against 19 GFLOP
// (0.02 ms at the bf16 peak). Every token value is a scattered 2- or 4-byte
// load, so the rate is set by the loads an SM keeps in flight (Little's
// law: about 25 KB an SM at HBM's rate and ~1 us of latency), not by the
// bytes. The design before this one (mma.sync, one CTA a 64-row tile, the
// gather and the product one after the other, one (row, vertex) a thread
// at a time) kept about 4 KB in flight; PERF.md has both.
//
// The kernel: a persistent CTA per SM, warp-specialised (embed_plan).
//   gather     two warpgroups (256 threads). The CTA walks a contiguous run
//              of (patch group, sample) items, groups outer, so its slice of
//              the (L, V) table sits in shared memory and changes at most a
//              few times a call, and the CTAs at work at once cover every
//              group of the same few samples (boundary vertices shared
//              through L2). An item's A tile is its rows x Kp in 64-deep
//              K-slices ([64][64] bf16 blocks, 128-byte swizzle, the layout
//              wgmma reads). A lane owns four adjacent columns of a slice
//              and takes 8 rows at a time (a slice of 128 rows, or two of
//              64): the table entries, then all 32 value loads before any
//              store, then each value rounded to bf16 once and the four
//              stored as 8 bytes. At C = 4 the four columns are one
//              vertex's channels (16 vertices a slice): one table entry a
//              row. At other C (the general walk) column k is channel k % C
//              of vertex k / C, so a lane's columns come from up to four
//              vertices (at C = 3, 5, 6 and 7 vertices straddle slices),
//              and each column reads its own entry. The group's table rows
//              sit in shared memory where they fit beside two A slices;
//              else (sub-ico 1: 64 rows x 561 vertices, 144 KB) the entries
//              are read through L1 / L2 (the whole table is 180 KB), one
//              dependent load more a row. A
//              slice has its own full and empty mbarriers in a ring of as
//              many slices as the shared memory holds (up to 8), so the next
//              item's gather fills the slices the products are done with.
//   products   consumer warpgroups on N-tiles of NB = 192 columns (96 at
//              dims <= 96). At dims <= 96 (MS-SiT's) an item is 128
//              patches and two warpgroups take its 64-row halves, so both
//              read each W slice: the items are many and short, and one
//              warpgroup's epilogue runs under the other's products; up to
//              192 an item is 64 patches and one warpgroup takes it (two,
//              with registers capped at 128 a thread, spilled and ran
//              slower); past 192 two take their own N-tiles, each with a W
//              stream of its own. Per K-slice four m64nNBk16 wgmma
//              against W's K-slice [NB][64], which thread 0 of the first
//              warpgroup of an N-part loads by TMA through a ring (full
//              barriers; empty ones only where two halves read a stage: a
//              loader waiting on its own release ran the kernel slower);
//              where a part's slices all fit, as at sub-ico 5, they load
//              once and stay. A K-slice and its W stage are released as
//              soon as their products are done (scripts/embed_variants.py
//              times the release after the next slice's products beside
//              it). Past two N-tiles a
//              warpgroup makes more than one pass over an item's slices,
//              which then stay until its last pass (SiT-base on sub-ico 3:
//              three slices an item); where they do not fit the ring, each
//              pass is an item of its own, gathered again (reps).
//   epilogue   the fp32 bias added and rounded once to bf16, then out by TMA
//              store in [64 rows][64 columns] boxes through two staging
//              buffers a warpgroup (rows past L and columns past dim are
//              not written), under the next item's products.
// Sums in a fixed order (the K-slices in turn, no atomics): two calls give
// the same bits.
//
// Built with -DSVT_EMBED_PART=1 the products are skipped (the gather
// alone); with 2 the gather writes a constant tile without loading x or the
// table (the products alone): scripts/fwd_parts.py times both. Neither
// computes the embedding.
//
// C interface as fused_block.cu's: returns cudaGetLastError(), nothing
// synchronises, nothing allocates.

#include <algorithm>

#include "common.cuh"

#ifndef SVT_EMBED_PART
#define SVT_EMBED_PART 0
#endif

namespace {

using namespace svt;

constexpr int PE_CH = 4;         // the packed walk's channels: a vertex is 8 bytes of a slice
constexpr int PE_CH_MAX = 8;     // channels the general walk takes
constexpr int PE_BK = 64;        // K-slice depth: 16 vertices at C = 4
constexpr int PE_GATHER = 256;   // gather threads (two warpgroups)
constexpr int PE_ITEMS = 8;      // (row, vertex) items a gather thread loads at a time
constexpr int PE_SMEM_MAX = 232448 - 1024;  // an H100 block's, less the alignment
constexpr int PE_MAX_SA = 8;     // A ring slices at most
constexpr int PE_GATHER_BAR = 1;  // named barriers: the gather threads', then one a consumer
constexpr int PE_CONS_BAR = 2;

// How a call is tiled (host and device agree on it): items of 64 MW rows
// (patches of one sample), MW x NW consumer warpgroups, warpgroup c on rows
// 64 (c % MW) .. and the N-tiles c / MW, c / MW + NW, ...
struct EmbedPlan {
  int mw, nw;   // the consumers' split of an item's rows and of its N-tiles
  int nb;       // N-tile width: 192, or 96 at dim <= 96
  int nt;       // N-tiles
  int passes;   // a consumer's N-tiles an item
  int reps;     // items a (group, sample): 1, or one a pass where an item's slices do not fit
  int ks;       // K-slices of an item
  int sa, sw;   // A ring slices; W ring stages an N-part
  int groups;   // patch groups of 64 MW
  int a_off, w_off, stage_off, table_off, bar_off, bytes;  // shared memory layout
  // 1: the group's table rows in shared memory; 0: read through L2. Last,
  // as the kernel's C is: the packed walk's parameters keep their offsets,
  // and its machine code stays the one before the general walk existed
  // (scripts/embed_sass_compare.py)
  int tab;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// -> the plan, bytes 0 where the tiling cannot take these shapes. At dims
// <= 96 two consumers on an item's two 64-row halves (MW 2), sharing each W
// slice; up to 192 one consumer (NB 192); past 192 two on an item's
// N-tiles (NW 2), each with its W stream. The A ring takes the shared
// memory the rest leaves, up to 8 slices; the group's table rows stay in
// shared memory unless that leaves fewer than two.
__host__ __device__ inline EmbedPlan embed_plan(int L, int V, int C, int Kp, int dim) {
  EmbedPlan p;
  p.nb = dim <= 96 ? 96 : 192;
  p.nt = cdiv(dim, p.nb);
  p.mw = p.nb == 96 ? 2 : 1;
  p.nw = p.nt > 1 ? 2 : 1;
  p.ks = Kp / PE_BK;
  p.passes = cdiv(p.nt, p.nw);
  const int rows = 64 * p.mw, slice = rows * PE_BK * 2;
  const int w_item = p.passes * p.ks;  // W slices an N-part reads an item
  p.sw = p.nb == 96 && w_item <= 4 ? w_item : p.nw == 1 ? 3 : 2;
  p.groups = cdiv(L, rows);
  const int w_bytes = p.nw * p.sw * p.nb * PE_BK * 2, stage_bytes = p.mw * p.nw * 2 * 64 * 64 * 2;
  const int rest = w_bytes + stage_bytes + (2 * PE_MAX_SA + 2 * p.nw * p.sw) * 8;
  p.tab = (PE_SMEM_MAX - rest - rows * V * 4) / slice >= 2;
  p.sa = (PE_SMEM_MAX - rest - (p.tab ? rows * V * 4 : 0)) / slice;
  if (p.sa > PE_MAX_SA) p.sa = PE_MAX_SA;
  p.reps = p.passes > 1 && p.ks > p.sa ? p.passes : 1;  // else an item's slices stay every pass
  if (p.reps > 1) p.passes = 1;
  p.a_off = 0;
  p.w_off = p.a_off + (p.sa > 0 ? p.sa : 0) * slice;
  p.stage_off = p.w_off + w_bytes;
  p.table_off = p.stage_off + stage_bytes;
  p.bar_off = p.table_off + (p.tab ? (rows * V * 4 + 7) & ~7 : 0);
  p.bytes = p.bar_off + (2 * p.sa + 2 * p.nw * p.sw) * 8;
  if (p.sa < 2 || Kp % PE_BK || Kp < V * C || C < 1 || C > PE_CH_MAX) p.bytes = 0;
  return p;
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Table entry i of a group's rows: from shared memory (TAB), else through
// the read-only data path.
template <bool TAB>
__device__ __forceinline__ int table_at(const int* t, int i) {
  if constexpr (TAB) return t[i];
  else return __ldg(t + i);
}

// CH = 4: the packed walk (a lane's four columns are one vertex's
// channels); CH = 0: the general walk, any C in 1 .. 8. TAB: the plan's tab.
template <typename T, int NB, int MW, int NW, int CH, bool TAB>
__global__ void __launch_bounds__((MW * NW + 2) * 128, 1)
    patch_embed_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                       const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_out,
                       const float* __restrict__ bias, int B, int G, int L, int V, int dim,
                       const EmbedPlan pl, int C) {
  constexpr int NC = MW * NW, ROWS = 64 * MW;
  // with two consumers on 192-column tiles the gather gives them registers
  constexpr bool SHIFT = NC == 2 && NB == 192;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sa = reinterpret_cast<bf16*>(base + pl.a_off);
  int* table = reinterpret_cast<int*>(base + pl.table_off);
  uint64_t* a_full = reinterpret_cast<uint64_t*>(base + pl.bar_off);
  uint64_t* a_empty = a_full + pl.sa;
  uint64_t* w_full = a_empty + pl.sa;     // [NW][sw]
  uint64_t* w_empty = w_full + NW * pl.sw;  // [NW][sw]
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  // this CTA's items: a contiguous run of (group, sample, rep), groups outer
  const long long per_group = (long long)B * pl.reps;
  const long long items = pl.groups * per_group;
  const long long i0 = items * blockIdx.x / gridDim.x, i1 = items * (blockIdx.x + 1) / gridDim.x;

  if (threadIdx.x == 0) {
    for (int i = 0; i < pl.sa; ++i) {
      mbar_init(&a_full[i], PE_GATHER);
      mbar_init(&a_empty[i], NC);
    }
    for (int i = 0; i < NW * pl.sw; ++i) {
      mbar_init(&w_full[i], 1);
      mbar_init(&w_empty[i], MW);
    }
  }
  __syncthreads();

  if (wg >= NC) {  // -- the gather: threads 0 .. 255 of its two warpgroups
    if (SHIFT) set_max_regs_dec<112>();
    const int gt = threadIdx.x - NC * 128;
    // columns 4 vl .. 4 vl + 3 of a slice (at C = 4 vertex 16 s + vl), rows rq + 16 i
    const int vl = gt & 15, rq = gt >> 4;
    constexpr int SLICES = MW == 1 ? 2 : 1, PER = PE_ITEMS / SLICES;  // a step's
    const long long slices = (i1 - i0) * pl.ks;
    int cur = -1;  // the group whose table rows are in shared memory
    // slice a of this CTA: item i0 + a / ks, K-slice a % ks
    auto group_of = [&](long long a) { return (int)((i0 + a / pl.ks) / per_group); };
    for (long long a = 0; a < slices;) {
      const int g = group_of(a);
      // the group's table rows, once every gather thread is done with the last
      if (TAB && g != cur) {
        bar_sync(PE_GATHER_BAR, PE_GATHER);
        for (int e = gt; e < ROWS * V; e += PE_GATHER) {
          const int l = g * ROWS + e / V;
          table[e] = l < L ? idx[(long long)g * ROWS * V + e] : 0;
        }
        bar_sync(PE_GATHER_BAR, PE_GATHER);
        cur = g;
      }
      const int* trows = TAB ? table : idx + (long long)g * ROWS * V;  // the group's rows
      const int ns = SLICES == 2 && a + 1 < slices && group_of(a + 1) == g ? 2 : 1;
      T val[SLICES][PER][4];
#pragma unroll
      for (int q = 0; q < SLICES; ++q) {
        if (q >= ns) continue;
        const long long aq = a + q;
        const int b = (int)((i0 + aq / pl.ks) / pl.reps % B), s = (int)(aq % pl.ks);
        const T* xb = x + (long long)b * (CH == PE_CH ? PE_CH : C) * G;
        if constexpr (CH == PE_CH) {
          const int v = 16 * s + vl;
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            const int r = rq + 16 * i;
            const bool ok = v < V && g * ROWS + r < L;
#if SVT_EMBED_PART == 2
#pragma unroll
            for (int c = 0; c < PE_CH; ++c) val[q][i][c] = T(ok ? (float)((r + v + c) & 7) : 0.f);
#else
            const int vi = ok ? table_at<TAB>(trows, r * V + v) : 0;
#pragma unroll
            for (int c = 0; c < PE_CH; ++c) val[q][i][c] = ok ? xb[(long long)c * G + vi] : T(0.f);
#endif
          }
        } else {
          // column k = 64 s + 4 vl + e is channel k % C of vertex k / C
          int ve[4], ce[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = PE_BK * s + 4 * vl + e, v = k / C;
            ve[e] = k < V * C ? v : -1;  // -1: the K padding
            ce[e] = k - v * C;
          }
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            const int r = rq + 16 * i;
            const bool row_ok = g * ROWS + r < L;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool ok = row_ok && ve[e] >= 0;
#if SVT_EMBED_PART == 2
              val[q][i][e] = T(ok ? (float)((r + ve[e] + ce[e]) & 7) : 0.f);
#else
              const int vi = ok ? table_at<TAB>(trows, r * V + ve[e]) : 0;
              val[q][i][e] = ok ? xb[(long long)ce[e] * G + vi] : T(0.f);
#endif
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < SLICES; ++q) {
        if (q >= ns) continue;
        const long long aq = a + q;
        const int slot = (int)(aq % pl.sa), use = (int)(aq / pl.sa);
        if (use > 0) mbar_wait(&a_empty[slot], (use - 1) & 1);
        bf16* dst = sa + slot * (ROWS * PE_BK);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int r = rq + 16 * i;  // row r of the item: half r / 64, its row r % 64
          const uint2 pk = make_uint2(pack_bf16(to_f32(val[q][i][0]), to_f32(val[q][i][1])),
                                      pack_bf16(to_f32(val[q][i][2]), to_f32(val[q][i][3])));
          *reinterpret_cast<uint2*>(dst + (r >> 6) * 64 * PE_BK + sw128(r & 63, vl * 4)) = pk;
        }
        fence_async_smem();
        mbar_arrive(&a_full[slot]);
      }
      a += ns;
    }
    return;
  }

  // -- a consumer warpgroup: rows 64 (wg % MW) .. of each item, its N-tiles
  // wg / MW, wg / MW + NW, ..; the first warpgroup of an N-part loads its W
  if (SHIFT) set_max_regs_inc<144>();
  const int half = wg % MW, part = wg / MW;
  const bool loader = half == 0 && tid == 0;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int per_item = pl.passes * pl.ks;
  const bool resident = pl.reps == 1 && per_item <= pl.sw;  // W slices load once and stay
  bf16* sw = reinterpret_cast<bf16*>(base + pl.w_off) + part * pl.sw * NB * PE_BK;
  uint64_t* wf = w_full + part * pl.sw;
  uint64_t* we = w_empty + part * pl.sw;
  bf16* stg = reinterpret_cast<bf16*>(base + pl.stage_off) + wg * 2 * 64 * 64;
  const long long w_total = resident ? per_item : (i1 - i0) * per_item;
  // this part's N-tile at pass p of item it (past the last: products on a
  // real tile, never stored)
  auto ntile = [&](long long it, int p) {
    return part + ((int)(it % pl.reps) * pl.passes + p) * NW;
  };
  // W slice w of this part's walk (item, pass, K-slice) into its stage, once
  // both halves are done with the slice before it there
  auto load_w = [&](long long w) {
    const int j = (int)(w % per_item), p = j / pl.ks, s = j % pl.ks;
    const int st = (int)(w % pl.sw), use = (int)(w / pl.sw), nt = ntile(i0 + w / per_item, p);
    if (MW > 1 && use > 0) mbar_wait(&we[st], (use - 1) & 1);  // one reader: its own release
    mbar_expect(&wf[st], NB * PE_BK * 2);
    tma_load_3d(sw + st * NB * PE_BK, tm_w, &wf[st], s * PE_BK, nt < pl.nt ? nt * NB : 0, 0);
  };
  if (loader)
    for (long long w = 0; w < pl.sw && w < w_total; ++w) load_w(w);

  float acc[NB / 2];
  long long w = 0;  // W slices consumed
  int nbox = 0;     // boxes stored: staging buffer nbox & 1
  for (long long it = i0; it < i1; ++it) {
    const int grp = (int)(it / per_group), b = (int)(it / pl.reps % B);
    const long long a0 = (it - i0) * pl.ks;  // the item's first A slice
    for (int p = 0; p < pl.passes; ++p) {
      const int nt = ntile(it, p);
      for (int s = 0; s < pl.ks; ++s, ++w) {
        const long long a = a0 + s;
        const int slot = (int)(a % pl.sa);
        mbar_wait(&a_full[slot], (int)((a / pl.sa) & 1));
        const long long wi = resident ? p * pl.ks + s : w;
        const int st = (int)(wi % pl.sw);
        mbar_wait(&wf[st], resident ? 0 : (int)((wi / pl.sw) & 1));
#if SVT_EMBED_PART != 1
        const bf16* at = sa + slot * (ROWS * PE_BK) + half * 64 * PE_BK;
        const bf16* bt = sw + st * NB * PE_BK;
        wg_hold(acc);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < PE_BK / 16; ++ks)
          wgmma_ss<0, 0>(acc, sw128_desc(at + ks * 16), sw128_desc(bt + ks * 16), s > 0 || ks > 0);
        wg_commit();
        wg_hold(acc);
        wg_wait<0>();
        wg_hold(acc);
#endif
        // the slice's products are done: release its A slice (on the last
        // pass over the item) and its W stage, and refill the stage
        if (tid == 0) {
          if (p == pl.passes - 1) mbar_arrive(&a_empty[slot]);
          if (MW > 1 && !resident) mbar_arrive(&we[st]);
        }
        if (loader && !resident && w + pl.sw < w_total) load_w(w + pl.sw);
      }
#if SVT_EMBED_PART != 1
      // epilogue: + bias, one rounding, out by TMA in [64][64] boxes
#pragma unroll
      for (int bx = 0; bx < (NB + 63) / 64; ++bx) {
        const int col0 = nt * NB + 64 * bx, row0 = grp * ROWS + half * 64;
        if (nt >= pl.nt || col0 >= dim || row0 >= L) continue;
        bf16* buf = stg + (nbox & 1) * 64 * 64;
        if (tid == 0) bulk_wait_read<1>();  // the box two before this one has left buf
        bar_sync(PE_CONS_BAR + wg, 128);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * bx + jj, c = col0 + 8 * jj + 2 * t;
          if (j >= NB / 8) break;  // n = 96: the second box's last 32 columns are past the tile
          const float b0 = c < dim ? bias[c] : 0.f, b1 = c + 1 < dim ? bias[c + 1] : 0.f;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            *reinterpret_cast<uint32_t*>(buf + sw128(16 * warp + g + 8 * rr, 8 * jj + 2 * t)) =
                pack_bf16(acc[4 * j + 2 * rr] + b0, acc[4 * j + 2 * rr + 1] + b1);
        }
        fence_async_smem();
        bar_sync(PE_CONS_BAR + wg, 128);
        if (tid == 0) {
          tma_store_3d(tm_out, buf, col0, row0, b);
          bulk_commit();
        }
        ++nbox;
      }
#endif
    }
  }
  if (tid == 0) bulk_wait<0>();
}

// out (B, L, dim) as a 3-D map (dim, L, B), [64][64] boxes, 128-byte swizzle.
cudaError_t out_map(CUtensorMap* m, bf16* out, int B, int L, int dim) {
  const cuuint64_t dims[3] = {(cuuint64_t)dim, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)dim * 2, (cuuint64_t)L * dim * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return encode_tiled(m, 3, out, dims, strides, box);
}

// W (dim, Kp) as a 3-D map (Kp, dim, 1), [nb rows][64] boxes, 128-byte
// swizzle; rows past dim come in as zeros.
cudaError_t w_map(CUtensorMap* m, const bf16* W, int Kp, int dim, int nb) {
  const cuuint64_t dims[3] = {(cuuint64_t)Kp, (cuuint64_t)dim, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)Kp * 2, (cuuint64_t)dim * Kp * 2};
  const cuuint32_t box[3] = {PE_BK, (cuuint32_t)nb, 1};
  return encode_tiled(m, 3, W, dims, strides, box);
}

template <typename T, int NB, int MW, int NW, int CH, bool TAB>
cudaError_t launch_embed(const T* x, const int* idx, const CUtensorMap& tm_w,
                         const CUtensorMap& tm_out, const float* bias, int B, int C, int G,
                         int L, int V, int dim, const EmbedPlan& pl, cudaStream_t st) {
  static bool ready[16];
  static int sms[16];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(patch_embed_kernel<T, NB, MW, NW, CH, TAB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, PE_SMEM_MAX + 1024);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  const long long items = (long long)pl.groups * B * pl.reps;
  const int ctas = (int)std::min<long long>(items, sms[dev]);
  patch_embed_kernel<T, NB, MW, NW, CH, TAB><<<ctas, (MW * NW + 2) * 128, pl.bytes + 1024, st>>>(
      x, idx, tm_w, tm_out, bias, B, G, L, V, dim, pl, C);
  return cudaGetLastError();
}

template <typename T, int CH, bool TAB>
cudaError_t embed_walk(const T* x, const int* idx, const CUtensorMap& tm_w,
                       const CUtensorMap& tm_out, const float* bias, int B, int C, int G, int L,
                       int V, int dim, const EmbedPlan& pl, cudaStream_t st) {
  if (pl.nb == 96)
    return launch_embed<T, 96, 2, 1, CH, TAB>(x, idx, tm_w, tm_out, bias, B, C, G, L, V, dim,
                                              pl, st);
  if (pl.nw == 1)
    return launch_embed<T, 192, 1, 1, CH, TAB>(x, idx, tm_w, tm_out, bias, B, C, G, L, V, dim,
                                               pl, st);
  return launch_embed<T, 192, 1, 2, CH, TAB>(x, idx, tm_w, tm_out, bias, B, C, G, L, V, dim,
                                             pl, st);
}

template <typename T>
cudaError_t embed(const T* x, const int* idx, const bf16* W, const float* bias, bf16* out, int B,
                  int C, int G, int L, int V, int Kp, int dim, cudaStream_t st) {
  const EmbedPlan pl = embed_plan(L, V, C, Kp, dim);
  if (pl.bytes == 0) return cudaErrorInvalidValue;
  CUtensorMap tm_w, tm_out;
  cudaError_t e = w_map(&tm_w, W, Kp, dim, pl.nb);
  if (e == cudaSuccess) e = out_map(&tm_out, out, B, L, dim);
  if (e != cudaSuccess) return e;
  if (C == PE_CH && pl.tab)
    return embed_walk<T, PE_CH, true>(x, idx, tm_w, tm_out, bias, B, C, G, L, V, dim, pl, st);
  if (C == PE_CH)
    return embed_walk<T, PE_CH, false>(x, idx, tm_w, tm_out, bias, B, C, G, L, V, dim, pl, st);
  if (pl.tab)
    return embed_walk<T, 0, true>(x, idx, tm_w, tm_out, bias, B, C, G, L, V, dim, pl, st);
  return embed_walk<T, 0, false>(x, idx, tm_w, tm_out, bias, B, C, G, L, V, dim, pl, st);
}

}  // namespace

extern "C" {

// x (B, C, G) fp32 (x_is_f32) or bf16, C 1 .. 8, idx (L, V) int32 vertex
// ids < G, W (dim, Kp) bf16 with K = V * C in (v c) order zero-padded to Kp
// (a multiple of 64), bias (dim,) fp32 -> out (B, L, dim) bf16. Pointers on
// 16 bytes, dim a multiple of 8. Shapes the tiling does not take
// (svt_patch_embed_smem 0) return cudaErrorInvalidValue.
int svt_patch_embed(void* x, int x_is_f32, void* idx, void* W, void* bias, void* out, int B,
                    int C, int G, int L, int V, int Kp, int dim, int device, void* stream) {
  if (dim % 8 || B < 1 || L < 1 || V < 1) return (int)cudaErrorInvalidValue;
  SVT_TRY(cudaSetDevice(device));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const bf16* w = static_cast<const bf16*>(W);
  const float* b = static_cast<const float*>(bias);
  bf16* o = static_cast<bf16*>(out);
  if (x_is_f32)
    return (int)embed(static_cast<const float*>(x), ix, w, b, o, B, C, G, L, V, Kp, dim, st);
  return (int)embed(static_cast<const bf16*>(x), ix, w, b, o, B, C, G, L, V, Kp, dim, st);
}

// Bytes of shared memory the kernel takes at these shapes (its plan), 0
// where the tiling cannot take them (ops/patch_embed.py::embed_plan).
int svt_patch_embed_smem(int L, int V, int C, int Kp, int dim) {
  const EmbedPlan p = embed_plan(L, V, C, Kp, dim);
  return p.bytes ? p.bytes + 1024 : 0;
}

}  // extern "C"
