"""Multi-head attention with its row log-sum-exp, forward and backward:
a Hopper kernel and plain versions.

``flash_attention`` replaces the TPU kernel
``surface_vision_transformers_tpu/ops/pallas/flash_attention.py::
flash_attention`` (``_fwd`` / ``_fwd_kernel``, ``_bwd_impl`` /
``_bwd_kernel``) with its layout: q (B, H, Nq, dh), k and v (B, H, Nk, dh),
output (B, H, Nq, dh), Nq may differ from Nk. Keys >= ``valid_len`` are
masked; in the backward, query rows >= ``valid_len`` get P = 0, so their dq
is 0 and they add nothing to dk and dv. The softmax is shifted and in
float32, P is rounded to the input dtype before P.V and the sum divided out
after it; the backward forms P from the kept LSE.

The kernel (CUDA C++ for ``sm_90a``, ``csrc/flash_attention.cu``) streams K
and V through shared memory in tiles with an online softmax, so it takes any
sequence length, bfloat16. Both directions, with or without dropout, take
every head dim dh >= 1 (``check_dim_head``), the JAX package's widths. The
kernels lay a head out in ``head_cols(dh)`` columns (dh rounded up to 8,
so that every head starts on 16 bytes, as TMA needs), the columns past dh
zero; the wrappers give them a zero-padded copy where dh is no multiple of
8 (``pad_heads``) and crop the outputs. Zero columns add nothing to any
score, and O, dQ, dK and dV come out zero there, so this is exact; the
kernels take the softmax scale of dh, not of the layout. dh 64 and dh 32
(MS-SiT's heads) run on kernels built for them, the other layouts up to 128
columns (``csrc/flash_attention_widths.cu``) in the smallest tile of 32, 64
or 128 columns that holds the head, the softmax scale dh ** -0.5 given at
run time (a padded head of dh 25-31 or 57-63 there too, never on the
kernels built for 32 or 64, whose scale is their layout's). Heads laid out
past 128 columns (``wide_fwd``, ``csrc/flash_attention_wide.cu``) run
a ``wgmma`` forward fed by TMA in 32-column panels, whose scores are summed
over the whole head once a key block, O made in one pass up to 256 columns;
and a backward of ``mma.sync`` products that sums the scores over the head
in steps of 64 columns and makes dQ in passes of 128 columns, dK and dV of
64, over the same keys (each pass recomputes the scores; PERF.md has their
times), at every shape, the few-query ones too, with or without dropout.
The plain versions take any dh. At dh 32
the forward runs on 32-column tiles (no zero columns); where queries = keys
<= 320 and the sequence is not a whole number of 64-row tiles
(``resident_fwd``: MS-SiT's axial folds of 20 and 80) a kernel of its own
lays sequences side by side (``fwd_pack``), so that no query tile is
mostly empty: each CTA loads a 64-row query tile and the keys its rows can
see, under a block-diagonal mask.
At every width the forward of at most 8 queries against more keys, up to
``FEW_FWD_MAX_KEYS`` (``few_query_fwd``: the CLS block's 8 rows), is one
launch that keeps every key's scores in shared memory (an exact softmax,
the queries on the short side of every product); the CLS block's chain
runs the same kernel with its Q made inside it.
The backward at dh 32 up to 320 keys (``resident_bwd``: every MS-SiT fold) is
one launch that keeps the whole sequence in shared memory, packing
sequences of up to 32 rows into one tile (``resident_pack``); for at most
8 queries against more keys (``few_query_bwd``: the CLS block's 8 rows)
one launch that streams the keys past the few queries; elsewhere it
streams the queries past each 64-key block once (wgmma) and sums dq in a
fixed order in an fp32 workspace the wrapper allocates
(``bwd_workspace_floats``). Either way its outputs repeat bit for bit. It reads
its operands through (batch, head, row) strides, so views of packed
activations need no copy, and writes its outputs as (B, H, N, dh) views of
(B, N, H, dh) storage, where merging the heads back is free. What bounds it,
and its times: the kernel source and PERF.md.

``flash_attention_qkv`` replaces ``flash_attention_qkv`` of the same TPU
file (``_fwd_packed``, ``_bwd_packed``): the kernels read q, k and v as
strided views of the packed (B, N, 3*H*dh) qkv and write dq, dk and dv into
one packed gradient. ``flash_attention_qkv_dropout`` replaces
``flash_attention_qkv_dropout`` (``_fwd_packed_drop``, ``_bwd_packed_drop``):
the same kernels compiled with dropout, the mask drawn by a Philox
generator from (seed, sample, head, row, col) in every pass, so the
backward regenerates it. ``flash_attention_tiled`` replaces
``flash_attention_tiled`` (``_fwd_tiled``, ``_bwd_tiled``), the long-sequence
entry, over the same streamed kernels. Each public wrapper counts its
launches in ``<wrapper>.launches``; the few-query kernel's launches, from
these wrappers and from the CLS block's backward chain, are counted in
``few_query_bwd.launches`` too, and the few-query forward's, from the
forward wrappers and the CLS block's forward chain, in
``few_query_fwd.launches``; the wide kernels', from every wrapper and
chain, in ``wide_fwd.launches`` and ``wide_bwd.launches``.

Dispatch: tensors on the CPU run the plain versions beside the kernel; CUDA
tensors launch the kernel or raise. There is no fallback.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from surface_vision_transformers_tpu_torch.ops import _native
from surface_vision_transformers_tpu_torch.serving import svt_ops
from surface_vision_transformers_tpu_torch.serving.svt_ops import head_cols

# A head's layout: its columns rounded up to DIM_HEAD_STEP; MAX_DIM_HEAD the
# widest wgmma tile (heads laid out wider run the wide kernels); DIM_HEADS
# the widths laid out as they are on those tiles
DIM_HEAD_STEP, MAX_DIM_HEAD = 8, svt_ops.MAX_TILE_COLS
DIM_HEADS = tuple(range(DIM_HEAD_STEP, MAX_DIM_HEAD + 1, DIM_HEAD_STEP))
RESIDENT_MAX_N = 320  # the resident backward's longest sequence: five 64-row tiles
FEW_MAX_Q = 8  # the few-query kernels' query rows: the n of their m64n8 products
# The few-query forward's fp32 scores: 32 bytes a key of shared memory, beside
# two ring stages of 64 keys at every tile width (16 KB at 128 columns)
FEW_FWD_MAX_KEYS = 4096
_BWD_TILE, _BWD_CHAINS = 64, 4  # the streamed backward's query tile and dQ sums per tile


def resident_bwd(nq: int, nk: int, dh: int, dropout: bool = False) -> bool:
    """Whether the backward at these shapes runs the resident kernel
    (``csrc/flash_attention.cu``: one launch, the whole sequence in one
    CTA's shared memory, delta and dQ summed there): head dim 32, no
    dropout, as many queries as keys, at most ``RESIDENT_MAX_N``. Else the
    streamed kernels (a delta pass, the main pass, a dq pass)."""
    return dh == 32 and not dropout and nq == nk and nq <= RESIDENT_MAX_N


def few_query_bwd(nq: int, nk: int, dh: int, dropout: bool = False) -> bool:
    """Whether the backward at these shapes runs the few-query kernel
    (``csrc/flash_attention.cu``: one launch, one CTA a (sample, head), K and
    V streamed past its query rows, every product with the queries on its
    short side, delta and dQ summed in the CTA): any head dim the kernels
    take up to ``MAX_DIM_HEAD`` columns, no dropout, at most ``FEW_MAX_Q``
    queries against more keys (the CLS block's 8 rows against all N keys).
    Wider heads run the wide kernels at these shapes too."""
    return 1 <= dh <= MAX_DIM_HEAD and not dropout and nq <= FEW_MAX_Q < nk


few_query_bwd.launches = 0


def few_query_fwd(nq: int, nk: int, dh: int, dropout: bool = False) -> bool:
    """Whether the forward at these shapes runs the few-query kernel
    (``csrc/flash_attention.cu``: one launch, one CTA a (sample, head), the
    queries on the short side of m64n8 products, the fp32 scores of every
    key kept in shared memory, an exact two-pass softmax): any head dim up
    to ``MAX_DIM_HEAD``, no dropout, at most ``FEW_MAX_Q`` queries against more
    keys, up to ``FEW_FWD_MAX_KEYS`` (the scores' shared memory). The CLS
    block's chain runs the same kernel, with its Q made inside it up to dh
    64 (``fused_block.cls_fwd_route``, ``cls_ln1_in_kv``)."""
    return (1 <= dh <= MAX_DIM_HEAD and not dropout
            and nq <= FEW_MAX_Q < nk <= FEW_FWD_MAX_KEYS)


few_query_fwd.launches = 0


def count_few_query_fwd(nq: int, nk: int, dh: int, dropout: bool = False) -> None:
    """A forward launched at these shapes ran the few-query kernel once
    where ``few_query_fwd`` says: add it to ``few_query_fwd.launches``."""
    if few_query_fwd(nq, nk, dh, dropout):
        few_query_fwd.launches += 1


def count_few_query(nq: int, nk: int, dh: int, dropout: bool = False) -> None:
    """A backward launched at these shapes ran the few-query kernel once
    where ``few_query_bwd`` says: add it to ``few_query_bwd.launches``."""
    if few_query_bwd(nq, nk, dh, dropout):
        few_query_bwd.launches += 1


def wide_fwd(dh: int) -> bool:
    """Whether the forward at head dim dh runs the wide kernel
    (``csrc/flash_attention_wide.cu``): heads laid out past
    ``MAX_DIM_HEAD`` columns (dh > 128), at every shape, with or without
    dropout: a CTA two 64-query warpgroups, Q resident, K and V through a
    ring of 32-column panels filled by TMA; S over the whole head a key
    block, O in registers, one column pass up to 256 columns (two at
    384)."""
    return head_cols(dh) > MAX_DIM_HEAD


wide_fwd.launches = 0


def wide_bwd(dh: int) -> bool:
    """Whether the backward at head dim dh runs the wide kernels (a delta
    pass; dK and dV a 64-key block a CTA, in passes of up to 64 columns; dQ
    a 64-query tile a CTA, in passes of up to 128): where ``wide_fwd``."""
    return wide_fwd(dh)


wide_bwd.launches = 0


def resident_fwd(nq: int, nk: int, dh: int, dropout: bool = False) -> bool:
    """Whether the forward at these shapes runs its resident kernel
    (``csrc/flash_attention.cu``: one 64-row query tile a CTA, the keys its
    rows see in shared memory, sequences packed): the shapes of
    ``resident_bwd`` whose sequence is not a whole number of 64-row tiles
    (MS-SiT's axial folds of 20 and 80 rows). Else the streamed kernel (K
    and V through a ring of 64- or 128-key tiles of 32, 64 or 128 columns:
    ``tile_width``)."""
    return resident_bwd(nq, nk, dh, dropout) and nq % 64 != 0


def tile_width(dh: int) -> int:
    """Columns of the tiles a head of dh columns runs in up to
    ``MAX_DIM_HEAD`` (the smallest of 32, 64 and 128 that holds its
    ``head_cols(dh)``; zeros past dh). The streamed backward and the
    few-query kernels take 64 where this says 32; wider heads run the wide
    kernels (``wide_fwd``)."""
    return 32 if dh <= 32 else 64 if dh <= 64 else 128


def fwd_pack(n: int) -> int:
    """Sequences of n rows the resident forward lays side by side (a unit,
    whose 64-row query tiles may cross sequences under a block-diagonal
    mask): 64 // n where n <= 32 (one tile), else 320 // n (up to five
    tiles; stage 1's axial fold: four of 80 rows in five full tiles)."""
    return 64 // n if n <= 32 else RESIDENT_MAX_N // n


def resident_pack(n: int) -> int:
    """Sequences of n rows the resident backward packs into one 64-row
    tile, under a block-diagonal mask: 64 // n where n <= 32, else 1."""
    return 64 // n if n <= 32 else 1


def bwd_workspace_floats(B: int, H: int, nq: int, nk: int, dh: int) -> int:
    """Floats of fp32 scratch the backward asks for
    (``svt_flash_attention_bwd_workspace``): none on the resident,
    few-query and wide routes; else four dQ sums of a 64-query tile of the
    head's ``head_cols(dh)`` columns and their turn counters per tile."""
    if resident_bwd(nq, nk, dh) or few_query_bwd(nq, nk, dh) or wide_bwd(dh):
        return 0
    return _BWD_CHAINS * B * H * -(-nq // _BWD_TILE) * (_BWD_TILE * head_cols(dh) + 1)


def _masked_scores(q, k, valid_len, scale=None):
    """fp32 scaled scores (B, H, Nq, Nk), keys >= valid_len at -inf; the
    scale dh ** -0.5 of q's width unless given."""
    s = q.float() @ k.float().transpose(-1, -2) * (q.shape[-1] ** -0.5 if scale is None
                                                   else scale)
    if valid_len < k.shape[-2]:
        s[..., valid_len:] = float("-inf")
    return s


def _inv_keep(rate):
    return 1.0 / (1.0 - rate)


def flash_attention_reference(q, k, v, valid_len: int | None = None, keep=None,
                              rate: float = 0.0, scale: float | None = None):
    """Plain forward: -> (o (B, H, Nq, dh) in q.dtype, lse (B, H, Nq)
    float32). In float32 nothing is rounded. With ``keep`` (a (B, H, Nq, Nk)
    bool mask), dropout at ``rate`` on the probabilities: lse and the sum
    are the undropped softmax's, o = keep(P) V / l / (1 - rate). ``scale``:
    the softmax scale, dh ** -0.5 of q's width unless given (a padded head
    takes its true width's: ``padded_attention_reference``)."""
    vl = k.shape[-2] if valid_len is None else int(valid_len)
    s = _masked_scores(q, k, vl, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    lse = (m + torch.log(l)).squeeze(-1)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    o = (p.to(q.dtype).float() @ v.float()) / l
    if keep is not None:
        o = o * _inv_keep(rate)
    return o.to(q.dtype), lse


def flash_attention_bwd_reference(q, k, v, o, lse, do, valid_len: int | None = None,
                                  keep=None, rate: float = 0.0, scale: float | None = None):
    """Plain backward from the forward's o and lse: P = exp(s - lse) on keys
    and query rows < valid_len (0 elsewhere), delta = rowsum(dO . O),
    dS = P (dP - delta) / sqrt(dh); P and dS rounded to q.dtype before their
    products. -> (dq, dk, dv) in q.dtype. With ``keep``: dV = P~^T dO with
    P~ = keep(P) / (1 - rate), dP = keep(dO V^T) / (1 - rate); o must be the
    dropped output. ``scale`` as the forward's."""
    vl = k.shape[-2] if valid_len is None else int(valid_len)
    dt = q.dtype
    sc = q.shape[-1] ** -0.5 if scale is None else scale
    p = torch.exp(_masked_scores(q, k, vl, sc) - lse[..., None])
    p[..., vl:, :] = 0.0
    dof = do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    dp = dof @ v.float().transpose(-1, -2)
    pv = p
    if keep is not None:
        pv = torch.where(keep, p * _inv_keep(rate), 0.0)
        dp = torch.where(keep, dp * _inv_keep(rate), 0.0)
    dv = pv.to(dt).float().transpose(-1, -2) @ dof
    ds = (p * (dp - delta) * sc).to(dt).float()
    return ((ds @ k.float()).to(dt), (ds.transpose(-1, -2) @ q.float()).to(dt),
            dv.to(dt))


# -- dropout bits ------------------------------------------------------------------
#
# The kernels draw the keep bit of score (b, h, row, col) as word col & 3 of
# Philox4x32-10 at counter {row, col // 4, 0, 0} under key {seed, b * H + h}
# (csrc/common.cuh), kept when >= round(rate * 2^32). The same generator in
# plain torch integer arithmetic follows, so a CPU run and the card draw the
# same masks. Its bits are not the TPU's (the Mosaic PRNG): tests against the
# JAX package feed its host mask (``_keep_mask_host``) to the plain versions.

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(m: int, a):
    """(hi, lo) 32-bit halves of m * a for uint32 values held in int64: the
    product is formed from 16-bit pieces, so nothing exceeds 2^49."""
    x, y = m * (a >> 16), m * (a & 0xFFFF)
    z = x + (y >> 16)
    return z >> 16, ((z & 0xFFFF) << 16) | (y & 0xFFFF)


def philox4x32(c0, c1, k0, k1):
    """Philox4x32-10 of counters {c0, c1, 0, 0} under keys {k0, k1}: int64
    tensors (broadcast together) holding uint32 values -> four int64
    tensors of uint32 words."""
    c0, c1, k0, k1 = (torch.as_tensor(t, dtype=torch.int64) for t in (c0, c1, k0, k1))
    c2 = c3 = torch.zeros((), dtype=torch.int64, device=c0.device)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    """The keep threshold on a uint32 word (the JAX package's
    ``_dropout_consts``)."""
    return min(int(round(rate * 2**32)), 2**32 - 1)


def _seed32(seed) -> int:
    return int(seed) & _U32


def dropout_keep_mask(seed, B: int, H: int, nq: int, nk: int, rate: float,
                      device="cpu") -> torch.Tensor:
    """(B, H, nq, nk) bool: the keep mask the dropout kernels draw for
    ``seed`` at ``rate``, built in chunks of (sample, head) pairs."""
    thr, groups = dropout_threshold(rate), (nk + 3) // 4
    rows = torch.arange(nq, device=device).view(1, nq, 1)
    cols = torch.arange(groups, device=device).view(1, 1, groups)
    key0 = torch.tensor(_seed32(seed), dtype=torch.int64, device=device)
    out = torch.empty((B * H, nq, nk), dtype=torch.bool, device=device)
    chunk = max(1, 2**22 // (nq * groups))
    for s in range(0, B * H, chunk):
        bh = torch.arange(s, min(s + chunk, B * H), device=device).view(-1, 1, 1)
        words = torch.stack(philox4x32(rows, cols, key0, bh), -1)
        out[s:s + chunk] = words.reshape(bh.shape[0], nq, 4 * groups)[..., :nk] >= thr
    return out.view(B, H, nq, nk)


# -- kernel wrappers -------------------------------------------------------------


def _aligned(t):
    """t, or a contiguous copy where its rows would not start on 16 bytes
    (the kernel loads rows in 16-byte pieces). The caller keeps the result
    alive until the launch is enqueued."""
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        return t.contiguous()
    return t


def _operand(t):
    """[pointer, batch, head and row strides] of an ``_aligned`` operand."""
    return [t.data_ptr(), *t.stride()[:3]]


def _heads_last_empty(like, n):
    """An empty (B, H, n, dh) view of (B, n, H, dh) storage."""
    B, H, _, dh = like.shape
    return like.new_empty((B, n, H, dh)).transpose(1, 2)


def check_dim_head(dh: int) -> None:
    """Raise ``ValueError`` on a head dim that is no width: the kernels take
    every dh >= 1, with or without dropout (laid out in ``head_cols(dh)``
    columns; past ``MAX_DIM_HEAD`` on the wide kernels)."""
    if dh < 1:
        raise ValueError(f"dim_head must be >= 1, got {dh}")


def pad_heads(t, dp: int):
    """(B, H, N, dh) -> a contiguous (B, H, N, dp) copy, zeros past dh: the
    kernels' layout of a head (``head_cols``)."""
    return F.pad(t, (0, dp - t.shape[-1]))


def padded_attention_reference(q, k, v, valid_len: int | None = None, do=None):
    """The padded route's host transform around the plain versions: q, k, v
    (and the cotangent do) padded to ``head_cols(dh)`` columns
    (``pad_heads``), the plain forward (and backward) at that width with
    the softmax scale of dh, the outputs cropped to dh. -> (o, lse) or,
    with ``do``, (o, lse, dq, dk, dv): equal to the plain versions at dh."""
    dh = q.shape[-1]
    dp, sc = head_cols(dh), dh ** -0.5
    qp, kp, vp = (pad_heads(t, dp) for t in (q, k, v))
    o, lse = flash_attention_reference(qp, kp, vp, valid_len, scale=sc)
    if do is None:
        return o[..., :dh], lse
    grads = flash_attention_bwd_reference(qp, kp, vp, o, lse, pad_heads(do, dp), valid_len,
                                          scale=sc)
    return (o[..., :dh], lse, *(g[..., :dh] for g in grads))


def _check_cuda(q, k, v, valid_len, *extra):
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.dtype != torch.bfloat16 or t.dim() != 4 or t.device != q.device:
            raise ValueError(f"{name} must be a bfloat16 (B, H, N, dh) tensor on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    B, H, _, dh = q.shape
    check_dim_head(dh)
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[-1] != dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if not 1 <= valid_len <= k.shape[2]:
        raise ValueError(f"valid_len {valid_len} outside [1, {k.shape[2]}]")


def _dispatch(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not {t.device}")
    return t.device.type


def _drop_args(rate, seed):
    """The C entries' dropout arguments (seed, threshold, 1/(1-rate), on)."""
    if not rate:
        return 0, 0, 1.0, 0
    return _seed32(seed), dropout_threshold(rate), _inv_keep(rate), 1


def _fwd(q, k, v, vl, rate=0.0, seed=0):
    """The forward on either device (no launch count): the kernel on CUDA
    (on zero-padded copies where dh is no multiple of 8, the output
    cropped), the plain version (with the kernel's dropout mask) on the
    CPU."""
    if _dispatch(q) == "cpu":
        keep = None if not rate else dropout_keep_mask(seed, *q.shape[:3], k.shape[2], rate)
        return flash_attention_reference(q, k, v, vl, keep, rate)
    _check_cuda(q, k, v, vl)
    B, H, nq, dh = q.shape
    dp = head_cols(dh)
    if dp != dh:
        q, k, v = (pad_heads(t, dp) for t in (q, k, v))
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = _heads_last_empty(q, nq)
    lse = torch.empty((B, H, nq), dtype=torch.float32, device=q.device)
    _native.check(_native.library().svt_flash_attention_fwd(
        *_operand(q), *_operand(k), *_operand(v), *_operand(o), lse.data_ptr(),
        B, H, nq, k.shape[2], vl, dh, *_drop_args(rate, seed), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream))
    count_few_query_fwd(nq, k.shape[2], dh, bool(rate))
    wide_fwd.launches += wide_fwd(dh)
    return o[..., :dh], lse


def _bwd(q, k, v, o, lse, do, vl, rate=0.0, seed=0, out=None):
    """The backward on either device (no launch count), into ``out`` (three
    (B, H, N, dh) views) when given; on CUDA on zero-padded copies where dh
    is no multiple of 8, the gradients cropped."""
    if _dispatch(q) == "cpu":
        keep = None if not rate else dropout_keep_mask(seed, *q.shape[:3], k.shape[2], rate)
        grads = flash_attention_bwd_reference(q, k, v, o, lse, do, vl, keep, rate)
        if out is None:
            return grads
        for dst, g in zip(out, grads):
            dst.copy_(g)
        return out
    _check_cuda(q, k, v, vl, ("o", o), ("do", do))
    B, H, nq, dh = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("o and do must have q's shape")
    if lse.shape != (B, H, nq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(B, H, nq)} tensor")
    dp, dest = head_cols(dh), out
    if dp != dh:
        q, k, v, o, do = (pad_heads(t, dp) for t in (q, k, v, o, do))
        out = None
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    nk = k.shape[2]
    if out is None:
        out = _heads_last_empty(q, nq), _heads_last_empty(k, nk), _heads_last_empty(k, nk)
    lib = _native.library()
    delta = torch.empty_like(lse)
    ws = torch.empty(lib.svt_flash_attention_bwd_workspace(B, H, nq, nk, dh),
                     dtype=torch.float32, device=q.device)
    _native.check(lib.svt_flash_attention_bwd(
        *_operand(q), *_operand(k), *_operand(v), *_operand(o), *_operand(do),
        lse.data_ptr(), delta.data_ptr(), ws.data_ptr(), *(x for t in out for x in _operand(t)),
        B, H, nq, nk, vl, dh, *_drop_args(rate, seed), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream))
    count_few_query(nq, nk, dh, bool(rate))
    wide_bwd.launches += wide_bwd(dh)
    if dp == dh:
        return out
    grads = tuple(g[..., :dh] for g in out)
    if dest is None:
        return grads
    for dst, g in zip(dest, grads):
        dst.copy_(g)
    return dest


def _counted(fn):
    """Count ``fn``'s kernel launches (calls on CUDA tensors) in
    ``fn.launches``."""
    def wrapper(t, *args, **kw):
        out = fn(t, *args, **kw)
        if t.device.type == "cuda":
            wrapper.launches += 1
        return out
    wrapper.launches = 0
    wrapper.__name__, wrapper.__qualname__, wrapper.__doc__ = fn.__name__, fn.__qualname__, fn.__doc__
    return wrapper


def _vl(k, valid_len):
    return k.shape[-2] if valid_len is None else int(valid_len)


@_counted
def flash_attention_fwd(q, k, v, valid_len: int | None = None):
    """The forward: -> (o (B, H, Nq, dh), lse (B, H, Nq) float32). CPU
    tensors run ``flash_attention_reference``; CUDA tensors the kernel."""
    return _fwd(q, k, v, _vl(k, valid_len))


@_counted
def flash_attention_bwd(q, k, v, o, lse, do, valid_len: int | None = None):
    """The backward from the forward's o and lse and the output cotangent
    do: -> (dq, dk, dv). CPU tensors run ``flash_attention_bwd_reference``;
    CUDA tensors the kernel (the resident one where ``resident_bwd``, else
    a delta pre-pass, one main pass, a dq pass)."""
    return _bwd(q, k, v, o, lse, do, _vl(k, valid_len))


@_counted
def flash_attention_tiled_fwd(q, k, v, valid_len: int | None = None):
    """``flash_attention_fwd`` as the long-sequence entry counts it."""
    return _fwd(q, k, v, _vl(k, valid_len))


@_counted
def flash_attention_tiled_bwd(q, k, v, o, lse, do, valid_len: int | None = None):
    """``flash_attention_bwd`` as the long-sequence entry counts it."""
    return _bwd(q, k, v, o, lse, do, _vl(k, valid_len))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, valid_len, fwd, bwd):
        o, lse = fwd(q, k, v, valid_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.valid_len, ctx.bwd = valid_len, bwd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, o, lse, do.to(o.dtype), ctx.valid_len)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, valid_len: int | None = None):
    """Differentiable attention (the JAX package's ``flash_attention``):
    q (B, H, Nq, dh), k and v (B, H, Nk, dh) -> (B, H, Nq, dh); keys >=
    ``valid_len`` (default Nk) masked. Forward ``flash_attention_fwd``,
    backward ``flash_attention_bwd``, which keeps o and the row LSE."""
    return _FlashAttention.apply(q, k, v, valid_len, flash_attention_fwd,
                                 flash_attention_bwd)


def flash_attention_tiled(q, k, v, valid_len: int | None = None):
    """The JAX package's ``flash_attention_tiled``, its entry for N > 1536:
    the same function as ``flash_attention`` (the streamed kernels take any
    N; the TPU needed a second kernel only because a whole (N, N) score tile
    no longer fits VMEM), counted apart in ``flash_attention_tiled_fwd`` /
    ``_bwd``. The backward keeps the forward's o where the TPU recomputes
    it."""
    return _FlashAttention.apply(q, k, v, valid_len, flash_attention_tiled_fwd,
                                 flash_attention_tiled_bwd)


# -- packed qkv: flash_attention_qkv, flash_attention_qkv_dropout ------------------


def split_qkv(qkv, heads: int):
    """(B, N, 3*H*dh) packed [q | k | v] -> q, k, v as (B, H, N, dh) views."""
    B, N, F = qkv.shape
    if F % (3 * heads):
        raise ValueError(f"feature dim {F} not divisible by 3*heads")
    t = qkv.view(B, N, 3, heads, F // (3 * heads))
    return [t[:, :, i].transpose(1, 2) for i in range(3)]


def merge_heads(t):
    """(B, H, N, dh) -> (B, N, H*dh); free when t is a heads-last view."""
    B, H, N, dh = t.shape
    return t.transpose(1, 2).reshape(B, N, H * dh)


def _heads_of(t, heads):
    """(B, N, H*dh) -> (B, H, N, dh), a view where the strides allow."""
    B, N, F = t.shape
    return t.reshape(B, N, heads, F // heads).transpose(1, 2)


def flash_attention_qkv_reference(qkv, heads: int, valid_len: int | None = None,
                                  keep=None, rate: float = 0.0):
    """Plain packed forward: qkv (B, N, 3*H*dh) -> (o (B, N, H*dh), lse
    (B, H, N) float32); dropout with an explicit ``keep`` mask as
    ``flash_attention_reference``."""
    q, k, v = split_qkv(qkv, heads)
    o, lse = flash_attention_reference(q, k, v, valid_len, keep, rate)
    return merge_heads(o), lse


def flash_attention_qkv_bwd_reference(qkv, o, lse, do, heads: int,
                                      valid_len: int | None = None, keep=None,
                                      rate: float = 0.0):
    """Plain packed backward -> dqkv (B, N, 3*H*dh) in the [dq | dk | dv]
    layout of qkv."""
    q, k, v = split_qkv(qkv, heads)
    grads = flash_attention_bwd_reference(q, k, v, _heads_of(o, heads), lse,
                                          _heads_of(do, heads), valid_len, keep, rate)
    return torch.cat([merge_heads(g) for g in grads], -1)


def _qkv_fwd(qkv, heads, valid_len, rate=0.0, seed=0):
    q, k, v = split_qkv(qkv, heads)
    o, lse = _fwd(q, k, v, _vl(k, valid_len), rate, seed)
    return merge_heads(o), lse


def _qkv_bwd(qkv, o, lse, do, heads, valid_len, rate=0.0, seed=0):
    """dqkv, written by the kernel straight into one (B, N, 3*H*dh) tensor
    through the strides of its dq, dk and dv views."""
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    q, k, v = split_qkv(qkv, heads)
    _bwd(q, k, v, _heads_of(o, heads), lse, _heads_of(do.to(o.dtype), heads),
         _vl(k, valid_len), rate, seed, out=split_qkv(dqkv, heads))
    return dqkv


@_counted
def flash_attention_qkv_fwd(qkv, heads: int, valid_len: int | None = None):
    """Packed forward: qkv (B, N, 3*H*dh) -> (o (B, N, H*dh), lse (B, H, N)
    float32). CUDA tensors launch the kernel on q, k and v read through the
    strides of qkv; CPU tensors run the plain version."""
    return _qkv_fwd(qkv, heads, valid_len)


@_counted
def flash_attention_qkv_bwd(qkv, o, lse, do, heads: int, valid_len: int | None = None):
    """Packed backward -> dqkv (B, N, 3*H*dh), [dq | dk | dv]."""
    return _qkv_bwd(qkv, o, lse, do, heads, valid_len)


@_counted
def flash_attention_qkv_dropout_fwd(qkv, heads: int, valid_len, rate: float, seed):
    """``flash_attention_qkv_fwd`` with dropout at ``rate`` on the
    probabilities, the mask drawn from ``seed`` (``dropout_keep_mask``)."""
    return _qkv_fwd(qkv, heads, valid_len, rate, seed)


@_counted
def flash_attention_qkv_dropout_bwd(qkv, o, lse, do, heads: int, valid_len, rate: float,
                                    seed):
    """The dropout backward, the mask regenerated from ``seed``; o is the
    forward's (dropped) output."""
    return _qkv_bwd(qkv, o, lse, do, heads, valid_len, rate, seed)


class _FlashAttentionQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, valid_len, rate, seed):
        if rate:
            o, lse = flash_attention_qkv_dropout_fwd(qkv, heads, valid_len, rate, seed)
        else:
            o, lse = flash_attention_qkv_fwd(qkv, heads, valid_len)
        ctx.save_for_backward(qkv, o, lse)
        ctx.args = heads, valid_len, rate, seed
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        heads, valid_len, rate, seed = ctx.args
        if rate:
            dqkv = flash_attention_qkv_dropout_bwd(qkv, o, lse, do, heads, valid_len, rate,
                                                   seed)
        else:
            dqkv = flash_attention_qkv_bwd(qkv, o, lse, do, heads, valid_len)
        return dqkv, None, None, None, None


def flash_attention_qkv(qkv, heads: int, valid_len: int | None = None):
    """Differentiable packed attention (the JAX package's
    ``flash_attention_qkv``): qkv (B, N, 3*H*dh) in [q | k | v] order ->
    (B, N, H*dh); keys >= ``valid_len`` masked, query rows >= valid_len get
    P = 0 in the backward; dqkv comes back in the [dq | dk | dv] layout.
    Any N: the TPU kernel's N % 128 == 0 is not needed."""
    return _FlashAttentionQKV.apply(qkv, heads, valid_len, 0.0, 0)


def flash_attention_qkv_dropout(qkv, heads: int, valid_len: int | None, rate: float,
                                seed):
    """``flash_attention_qkv`` with dropout on the softmax probabilities
    (the JAX package's ``flash_attention_qkv_dropout``): 0 < rate < 1,
    inverted scaling 1 / (1 - rate); ``seed`` (an int, or an integer tensor
    read on the host) keys the mask, which the backward regenerates."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must be in (0, 1), got {rate}")
    return _FlashAttentionQKV.apply(qkv, heads, valid_len, float(rate), _seed32(seed))
