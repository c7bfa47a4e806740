"""SiT -- Surface Vision Transformer, eager PyTorch: the modular path.

Counterpart of ``surface_vision_transformers_tpu.models.sit.SiT`` with the
reference (vit-pytorch) module tree, so reference ``.pth`` files and
``state_dict_from_jax`` output load with ``strict=True``: a linear patch
embedding of (v c)-flattened patches, CLS token and learned positions, a
pre-norm encoder (fused no-bias QKV, dh^-0.5, biased out-projection,
exact-erf GELU MLP, LayerNorm eps 1e-5), cls or mean pooling, then a float32
LayerNorm + Linear head.

Inputs are pre-patched (B, C, L, V) or, with ``patch_table`` set, raw
(B, C, G) vertex arrays patchified (and, with ``norm_means``/``norm_stds``,
normalised) on the fly: with ``attn_backend="auto"`` on CUDA in bfloat16 by
the gather-fused ``patch_embed`` kernel (``ops.patch_embed``), else by the
plain gather and contraction. ``dtype`` is the compute dtype: LayerNorm, scores
and softmax run in float32, the matmuls in ``dtype``, as the JAX model does.

Attention (``Attention``, after the JAX ``Attention``): with
``attn_backend="auto"`` CUDA bfloat16 activations take the kernels --
``flash_attention_qkv`` on the packed qkv, ``flash_attention_qkv_dropout``
when dropout is on, ``multi_head_attention`` (the tiled entry) beyond
``MAX_PACKED_SEQ`` tokens; ``"plain"``, float32 compute and CPU tensors take
``plain_attention``. The sequence is not padded (the kernels mask ragged
edges), so there is no ``seq_pad``. Under tensor parallelism
(``parallel.tp``: ``Attention.tp`` / ``FeedForward.tp`` set) each rank
computes its whole heads (uneven where the axis does not divide them) --
through ``flash_attention_qkv[_dropout]``, the kernels on CUDA bfloat16 and
their plain versions on the CPU -- and its share of the MLP's hidden
units, and each branch's partial products are summed over the 'model' axis
before the bias (a rank that holds no head adds nothing there but joins
every collective of the branch). Under sequence sharding (``parallel.seq``:
``SiT.sp`` and
``Attention.sp`` set) each rank computes its rows of the padded sequence
and attends with its local queries to the all-gathered keys through
``flash_attention`` (the kernel on CUDA bfloat16, its plain version on the
CPU; the plain softmax under dropout, as the JAX route rule takes the
explicit path there).

Dropout (``dropout``, ``emb_dropout``) sits where the reference has it: on
the attention probabilities, after the out-projection, after the GELU,
after fc2, and after the positions. It is on only when a forward gets a
``DropoutRNG`` (the JAX ``deterministic=False`` with a dropout rng), which
draws every mask and kernel seed from explicit generators. Under a mesh
(``DropoutRNG.rows`` set) each mask is drawn at the global batch's shape
and the rank keeps its rows, so the masks are the single process's (under
sequence sharding drawn at the padded sequence's shape and cut to the
rank's rows, so they differ from the single process's where the padding
does); the attention kernel's seed is offset by the rank's shard
(``salt``), as the JAX package offsets it, so its masks differ from the
single process's and between ranks. Serving and the fused training path run ``models.fused``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from surface_vision_transformers_tpu_torch.ops.attention import (
    MAX_PACKED_SEQ,
    kernel_route,
    multi_head_attention,
    plain_attention,
)
from surface_vision_transformers_tpu_torch.ops.flash_attention import (
    dropout_keep_mask,
    flash_attention,
    flash_attention_qkv,
    flash_attention_qkv_dropout,
    merge_heads,
    split_qkv,
)
from surface_vision_transformers_tpu_torch.ops.patch_embed import (
    patch_embed_train,
    table_tensor,
)
from surface_vision_transformers_tpu_torch.ops.patchify import (
    fused_patch_embed,
    rearrange_patched,
)
from surface_vision_transformers_tpu_torch.parallel.seq import (
    gather_tokens,
    local_rows,
    pool,
    zero_pad_rows,
)
from surface_vision_transformers_tpu_torch.parallel.tp import branch_in, reduce_from


class DropoutRNG:
    """The randomness of a training forward with dropout: keep masks drawn
    on ``device`` from a generator there, attention-kernel seeds from a host
    generator (so no seed waits on the device), both seeded by ``seed``. Two
    instances with one seed draw the same masks and seeds in the same
    order."""

    def __init__(self, seed: int, device, salt: int = 0):
        self.device = torch.device(device)
        self.masks = torch.Generator(device=self.device).manual_seed(seed)
        self.seeds = torch.Generator().manual_seed(seed)
        self.salt = salt
        self.rows = None  # a ``parallel.Rows``: this rank's rows of the batch
        # (start, stop, padded length): this rank's tokens under sequence sharding
        self.tokens = None

    def kernel_seed(self) -> int:
        s = int(torch.randint(0, 2**31 - 1, (), generator=self.seeds))
        return (s + self.salt) & 0x7FFFFFFF

    def keep(self, shape, rate: float, cols=None) -> torch.Tensor:
        """A keep mask of ``shape`` at ``rate``: True with probability 1 -
        rate. With ``rows`` set, drawn at the global batch's shape and cut to
        the rank's rows; ``cols`` (start, stop, total) the same on the last
        dim (a tensor-parallel slice); with ``tokens`` set, a (B, n, F)
        mask the same on dim 1 (the rank's tokens)."""
        full = tuple(shape) if cols is None else (*shape[:-1], cols[2])
        tok = self.tokens if len(full) == 3 else None
        if tok is not None:
            full = (full[0], tok[2], full[2])

        def draw(s):
            return torch.rand(s, generator=self.masks, device=self.device)

        u = draw(full) if self.rows is None else self.rows.draw(draw, full)
        if tok is not None:
            u = u[:, tok[0]:tok[1]]
        return (u >= rate) if cols is None else (u >= rate)[..., cols[0]:cols[1]]

    def drop(self, x, rate: float, cols=None):
        """Inverted dropout of ``x`` at ``rate`` (a no-op at rate 0)."""
        if not rate:
            return x
        keep = self.keep(x.shape, rate, cols)
        return torch.where(keep, x * (1.0 / (1.0 - rate)), 0.0).to(x.dtype)


def _linear(x, lin: nn.Linear):
    dt = x.dtype
    b = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x, lin.weight.to(dt), b)


def _layer_norm(x, ln: nn.LayerNorm):
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps)


def embed_raw(model, lin: nn.Linear, x, backend: str):
    """Raw (B, C, G) vertex input -> (B, L, dim) embedded patches in
    ``model.dtype`` through the linear embedding ``lin`` ((dim, V*C)): the
    ``patch_embed`` kernel where ``backend`` routes to the kernels, else the
    plain gather and contraction. ``model`` holds ``patch_table``,
    ``patch_index``, ``norm_means``, ``norm_stds`` and ``dtype``."""
    if model.patch_table is None:
        raise ValueError("raw (B, C, G) input requires patch_table to be set")
    stats = dict(means=model.norm_means, stds=model.norm_stds, compute_dtype=model.dtype)
    if kernel_route(backend, x, model.dtype):
        return patch_embed_train(x, model.patch_index, lin.weight.t(), lin.bias, **stats)
    return fused_patch_embed(x, model.patch_table, lin.weight.t(), lin.bias, **stats)


class _PatchFlatten(nn.Module):
    def forward(self, x):
        return rearrange_patched(x)


class _PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x, **kw):
        return self.fn(_layer_norm(x, self.norm).to(x.dtype), **kw)


class Attention(nn.Module):
    def __init__(self, dim, heads, dim_head, dropout=0.0, attn_backend="auto"):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.dropout, self.attn_backend = dropout, attn_backend
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        # index 1 is the reference's (weightless) dropout slot
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim), nn.Identity())
        self.tp = None  # a ``parallel.tp.TPGroup`` under tensor parallelism
        self.sp = None  # a ``parallel.seq.SeqGroup`` under sequence sharding

    def forward(self, h, *, valid_len=None, rng: DropoutRNG | None = None):
        """``h`` (B, N, dim); under sequence sharding the rank's rows, and
        ``valid_len`` the sequence's length."""
        N = h.shape[1]
        tp = self.tp
        heads = self.heads if tp is None else tp.head_count(self.heads)
        qkv = _linear(h, self.to_qkv) if tp is None else branch_in(h, self.to_qkv, tp)
        drop = self.dropout if rng is not None else 0.0
        # under TP or SP the kernel's entry is taken on the CPU too (its plain version)
        wrapper = kernel_route(self.attn_backend, qkv) or (
            (tp is not None or self.sp is not None) and self.attn_backend == "auto"
            and not qkv.is_cuda)
        if self.sp is not None:
            out = self._seq_attention(qkv, valid_len, rng, drop, wrapper)
        elif not heads:  # a TP rank without a head: nothing to attend, the graph kept
            if drop:
                rng.kernel_seed()  # the seed stream stays in step with the other ranks'
            out = qkv[..., :0]
        elif wrapper and (drop or N <= MAX_PACKED_SEQ):
            if drop:
                out = flash_attention_qkv_dropout(qkv, heads, valid_len, drop,
                                                  rng.kernel_seed())
            else:
                out = flash_attention_qkv(qkv, heads, valid_len)
        else:
            q, k, v = split_qkv(qkv, heads)
            if drop:  # the mask the dropout kernel would draw for this seed
                keep = dropout_keep_mask(rng.kernel_seed(), *q.shape[:3], N, drop,
                                         device=q.device)
                o = plain_attention(q, k, v, valid_len, keep, drop)
            else:
                o = multi_head_attention(q, k, v, valid_len, backend=self.attn_backend)
            out = merge_heads(o)
        if tp is None:
            out = _linear(out, self.to_out[0])
        else:
            out = _tp_out(out, self.to_out[0], tp)
        return rng.drop(out, drop) if drop else out

    def _seq_attention(self, qkv, n, rng, drop, wrapper):
        """The rank's queries (its rows of qkv) against every rank's keys
        and values (all-gathered), the keys past ``n`` masked, the pad rows'
        outputs zeroed -> (B, n_local, H*dh)."""
        B, nl, _ = qkv.shape
        H, dh = self.heads, self.dim_head
        inner = H * dh
        kv = gather_tokens(qkv[..., inner:], self.sp)
        q = qkv[..., :inner].reshape(B, nl, H, dh).transpose(1, 2)
        k, v = (t.transpose(1, 2) for t in kv.view(B, kv.shape[1], 2, H, dh).unbind(2))
        if drop:  # the plain softmax, as the JAX explicit path; rows of the whole mask
            start = self.sp.rank * nl
            keep = rng.keep((B, H, k.shape[2], k.shape[2]), drop)[:, :, start:start + nl]
            o = plain_attention(q, k, v, n, keep, drop)
        elif wrapper:
            o = (multi_head_attention(q, k, v, n, backend=self.attn_backend) if qkv.is_cuda
                 else flash_attention(q, k, v, n))
        else:
            o = plain_attention(q, k, v, n)
        return zero_pad_rows(merge_heads(o), n, self.sp)


def _tp_out(x, lin: nn.Linear, tp):
    """A TP branch's last product: the rank's input columns of ``lin``
    (rounded to x's dtype, as ``_linear`` rounds them) times its slice of
    ``x``, accumulated in float32, summed over the axis, plus the bias
    (rounded alike), rounded once to x's dtype: the single process's one
    product but for the order of the float32 sums."""
    dt = x.dtype
    part = F.linear(x.float(), lin.weight.to(dt).float())
    return (reduce_from(part, tp) + lin.bias.to(dt).float()).to(dt)


class FeedForward(nn.Module):
    def __init__(self, dim, hidden_dim, dropout=0.0):
        super().__init__()
        self.dropout = dropout
        # indices 0 and 3 hold the reference checkpoint's weights; 2 and 4 are
        # its (weightless) dropout slots
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim), nn.GELU(),
                                 nn.Identity(), nn.Linear(hidden_dim, dim),
                                 nn.Identity())
        self.tp = None  # a ``parallel.tp.TPGroup`` under tensor parallelism

    def forward(self, h, *, rng: DropoutRNG | None = None):
        drop = self.dropout if rng is not None else 0.0
        tp = self.tp
        f = _linear(h, self.net[0]) if tp is None else branch_in(h, self.net[0], tp)
        f = F.gelu(f.float()).to(h.dtype)
        if drop:
            f = rng.drop(f, drop, None if tp is None else tp.cols(f.shape[-1] * tp.size))
        f = _linear(f, self.net[3]) if tp is None else _tp_out(f, self.net[3], tp)
        return rng.drop(f, drop) if drop else f


class _Transformer(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp_dim, dropout=0.0,
                 attn_backend="auto"):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([_PreNorm(dim, Attention(dim, heads, dim_head, dropout,
                                                   attn_backend)),
                           _PreNorm(dim, FeedForward(dim, mlp_dim, dropout))])
            for _ in range(depth)
        )

    def forward(self, x, *, valid_len=None, rng: DropoutRNG | None = None):
        for attn, ff in self.layers:
            x = x + attn(x, valid_len=valid_len, rng=rng)
            x = x + ff(x, rng=rng)
        return x


class SiT(nn.Module):
    """Surface Vision Transformer with the reference state-dict layout."""

    def __init__(
        self, *, dim=192, depth=12, heads=3, mlp_dim=768, pool="cls",
        num_patches=320, num_classes=1, num_channels=4, num_vertices=153,
        dim_head=64, dropout=0.0, emb_dropout=0.0, attn_backend="auto",
        patch_table=None, norm_means=None, norm_stds=None, dtype=torch.bfloat16,
    ):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        self.dim, self.depth, self.heads = dim, depth, heads
        self.dim_head, self.mlp_dim, self.pool = dim_head, mlp_dim, pool
        self.num_patches, self.num_vertices = num_patches, num_vertices
        self.num_channels, self.num_classes = num_channels, num_classes
        self.patch_table = None if patch_table is None else np.asarray(patch_table)
        # the table on the model's device, for the kernels (not in the state dict)
        self.register_buffer("patch_index", None if patch_table is None else table_tensor(
            patch_table, "cpu"), persistent=False)
        self.norm_means, self.norm_stds = norm_means, norm_stds
        self.dtype = dtype
        self.dropout, self.emb_dropout, self.attn_backend = dropout, emb_dropout, attn_backend
        self.to_patch_embedding = nn.Sequential(
            _PatchFlatten(), nn.Linear(num_channels * num_vertices, dim))
        self.pos_embedding = nn.Parameter(torch.randn(1, num_patches + 1, dim))
        self.cls_token = nn.Parameter(torch.randn(1, 1, dim))
        self.transformer = _Transformer(dim, depth, heads, dim_head, mlp_dim, dropout,
                                        attn_backend)
        self.mlp_head = nn.Sequential(nn.LayerNorm(dim, eps=1e-5),
                                      nn.Linear(dim, num_classes))
        self.sp = None  # a ``parallel.seq.SeqGroup`` under sequence sharding

    @property
    def patch_dim(self) -> int:
        return self.num_channels * self.num_vertices

    def embed_patches(self, x, *, backend: str | None = None):
        """Input -> (B, L, dim) embedded patches in the compute dtype; raw
        input on the ``patch_embed`` kernel where ``backend`` (default
        ``attn_backend``) routes to the kernels."""
        lin = self.to_patch_embedding[1]
        if x.dim() == 3:
            return embed_raw(self, lin, x, backend or self.attn_backend)
        if x.dim() == 4:
            return _linear(rearrange_patched(x).to(self.dtype), lin)
        raise ValueError(f"expected 3D raw or 4D pre-patched input, got {tuple(x.shape)}")

    def embed_tokens(self, tokens, *, rng: DropoutRNG | None = None):
        """(B, L, dim) embedded patches -> (B, L+1, dim) with CLS, pos and
        (given ``rng``) embedding dropout."""
        B, n, _ = tokens.shape
        cls = self.cls_token.to(tokens.dtype).expand(B, -1, -1)
        h = torch.cat([cls, tokens], dim=1)
        h = h + self.pos_embedding[:, : n + 1].to(tokens.dtype)
        return rng.drop(h, self.emb_dropout) if rng is not None else h

    def embed(self, x, *, rng: DropoutRNG | None = None):
        """Input -> (B, L+1, dim) tokens in the compute dtype (CLS + pos)."""
        return self.embed_tokens(self.embed_patches(x), rng=rng)

    def encode(self, x, *, rng: DropoutRNG | None = None):
        """Input -> (B, L+1, dim) encoded sequence; under sequence sharding
        the rank's rows of it, padded (``parallel.seq.local_rows``)."""
        return self.encode_tokens(self.embed(x, rng=rng), rng=rng)

    def encode_tokens(self, h, *, rng: DropoutRNG | None = None):
        """(B, L+1, dim) embedded sequence -> the encoded sequence; under
        sequence sharding the rank's rows of it, padded."""
        if self.sp is None:
            return self.transformer(h, rng=rng)
        n = h.shape[1]
        if rng is not None:
            rng.tokens = self.sp.rows(n)
        try:
            return self.transformer(local_rows(h, self.sp), valid_len=n, rng=rng)
        finally:
            if rng is not None:
                rng.tokens = None

    def pool_head(self, h):
        """Encoded sequence (the rank's rows under sequence sharding) ->
        (B, num_classes) float32: cls or mean pooling, float32 LayerNorm,
        Linear."""
        if self.sp is not None:
            pooled = pool(h, self.num_patches + 1, self.pool, self.sp)
        else:
            pooled = h.mean(dim=1) if self.pool == "mean" else h[:, 0]
        return _linear(_layer_norm(pooled, self.mlp_head[0]), self.mlp_head[1])

    def forward(self, x, *, rng: DropoutRNG | None = None):
        """-> (B, num_classes) float32; dropout on only with ``rng``."""
        return self.pool_head(self.encode(x, rng=rng))

    @classmethod
    def from_config(cls, cfg, **overrides) -> "SiT":
        """Build from a ``utils.config.Experiment`` (or a ModelConfig)."""
        m = getattr(cfg, "model", cfg)
        if m.model != "SiT":
            raise ValueError(f"SiT.from_config on a {m.model} config (MS-SiT: "
                             "models.mssit.MSSiT.from_config)")
        kw = dict(dim=m.dim, depth=m.depth, heads=m.heads, mlp_dim=m.mlp_dim,
                  pool=m.pool, num_patches=m.num_patches,
                  num_classes=m.num_classes, num_channels=m.num_channels,
                  num_vertices=m.num_vertices, dim_head=m.dim_head,
                  dropout=m.dropout, emb_dropout=m.emb_dropout)
        if hasattr(cfg, "compute_dtype"):
            kw["dtype"] = getattr(torch, cfg.compute_dtype)
        kw.update(overrides)
        return cls(**kw)
