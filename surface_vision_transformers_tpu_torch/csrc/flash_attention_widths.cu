// The attention kernels at every head width laid out in up to 128 columns
// besides 32 and 64: heads of head_cols(dh) = dh rounded up to 8 columns
// (the padded heads of dh off 8 too, 25-31 and 57-63 included, whose layout
// is 32 or 64 columns but whose scale is dh's), with or without dropout (dh
// 32 with dropout too).
//
// Replaces the same TPU kernels as flash_attention.cu
// (surface_vision_transformers_tpu/ops/pallas/flash_attention.py: _fwd,
// _bwd_impl, _fwd_packed, _bwd_packed, _fwd_packed_drop, _bwd_packed_drop,
// _fwd_tiled, _bwd_tiled, whose BlockSpecs span the whole head at any D) at
// those widths. The kernels are flash_attention.cu's own, built with DH = 0:
// a head laid out in dp = head_cols(dh) columns runs in the smallest tile of
// 32, 64 or 128 columns that holds it, the TMA boxes and cp.async loads
// zero-fill the columns past dp (a head's columns start at h dp 2 bytes:
// 16-byte aligned), the products skip the k16 steps wholly past dp, the
// softmax takes 1 / sqrt(dh) of the true width at run time (Width: the plain
// version's scale, not the tile's or the layout's), and the stores stop at
// dp (the columns past dh come out zero). At 128 columns (dp 72-128) a
// tile is two 64-column halves in the 128-byte swizzle; the forward keeps
// one tiling (64 queries, 64-key tiles: O takes 64 registers a thread), the
// backward's key block 176 KB of shared memory (one CTA an SM) and n128
// products for dV and dK; the few-query kernels run dQ^T and O^T as two m64
// halves of dh. The route rules (resident, few-query, streamed) are the
// same functions of the shape at every width, except that the resident
// kernels stay dh 32's and the CLS chain's Q is made in the few-query CTA
// only up to dh 64.
//
// This file only builds those instantiations, apart from flash_attention.cu,
// so that the build compiles the two at once (one nvcc each).
//
// What bounds them: the products' work at a fixed inner width heads x dh is
// the same at every dh, but the scores (B heads N^2) grow as dh shrinks, so
// below dh 64 the exp unit and the softmax's fp32 work, not the tensor
// cores, set the pace; PERF.md has each width's time beside dh 64's at the
// same inner width, SDPA's and the bound.

#define SVT_ATT_WIDTHS
#include "flash_attention.cu"
