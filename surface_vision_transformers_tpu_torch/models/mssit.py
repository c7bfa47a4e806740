"""MS-SiT -- the multiscale Surface Vision Transformer, eager PyTorch: the
modular path.

Counterpart of ``surface_vision_transformers_tpu.models.mssit`` (``MSSiT``,
``WindowAttention``, ``PatchMerge`` and the plain functions
``window_size_for_stage``, ``stage_plan``, ``fold_tokens``,
``unfold_tokens``). Four stages of pre-norm blocks over the icosphere's
patches, the embedding width doubling from stage to stage (96, 192, 384,
768 at ``mssit_scan_age.yml``): the canonical face order lists the four
children of a face next to each other, so a window of patches under one
ancestor face is a contiguous range of tokens, a window partition is a
reshape, and the 4-to-1 merge between stages is a reshape to (B, T/4, 4
dim) followed by LayerNorm and a bias-free Linear to 2 dim. Even blocks
attend within windows; odd blocks of a windowed stage mix across them
(``cross_mix``: ``axial``, across windows at a matching index, or
``parent``, within the 4x coarser window); stages of at most
``global_max`` tokens attend globally. Mean pooling, then a float32
LayerNorm and Linear head.

Inputs: raw (B, C, G) vertex arrays with ``patch_table`` set (the port's
embed, as ``SiT``'s: the ``patch_embed`` kernel on CUDA in bfloat16, else
the plain gather), pre-patched (B, C, T, V) or flattened (B, T, C*V) tokens.
The patch order must be the canonical one of the generated tables. LayerNorm,
scores and softmax run in float32, the matmuls in ``dtype``, as the JAX
model does. ``WindowAttention`` folds the windows into the batch
(``fold_tokens``) and follows the attention route rule
(``ops.attention.kernel_route``): CUDA bfloat16 with ``attn_backend="auto"``
runs ``flash_attention_qkv`` on the folded packed qkv (head dim 32 at every
shipped stage, forward and backward); float32, ``"plain"`` and CPU tensors
run ``plain_attention``. Under dropout the weights take the plain softmax
and their dropout there, whatever the route, as the JAX ``WindowAttention``
(``_use_packed_kernel`` is off under dropout), so MS-SiT needs no dropout
kernel. Dropout (``dropout``, ``emb_dropout``) sits where the JAX model has
it: on the attention weights, after the out-projection, after the GELU and
after fc2 (the SiT ``FeedForward``), after the positions; it is on only when
a forward gets a ``DropoutRNG``. ``forward(x, features=True)`` returns the
final stage's tokens before the head, the MPP decoder's input
(``models.mpp_mssit``). Serving runs ``models.fused_mssit``, and so does
bfloat16 training without dropout (``fused_mssit_train_forward``); this
module is the float32 and the dropout path.

The state dict is the port's own (the reference ships SiT only, so no
``.pth`` exists to match): ``patch_embedding``, ``pos_embedding``,
``stages.{s}.blocks.{i}.{0,1}`` (the attention and MLP halves, each a
``norm`` and its ``fn``), ``stages.{s}.merge``, ``head_norm``, ``head``;
``checkpoints.convert.mssit_state_dict_from_jax`` maps JAX trees onto it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from surface_vision_transformers_tpu_torch.models.sit import (
    DropoutRNG,
    FeedForward,
    _layer_norm,
    _linear,
    _PreNorm,
    _tp_out,
    embed_raw,
)
from surface_vision_transformers_tpu_torch.ops.attention import kernel_route, plain_attention
from surface_vision_transformers_tpu_torch.ops.flash_attention import (
    flash_attention_qkv,
    merge_heads,
    split_qkv,
)
from surface_vision_transformers_tpu_torch.ops.patch_embed import table_tensor
from surface_vision_transformers_tpu_torch.ops.patchify import rearrange_patched
from surface_vision_transformers_tpu_torch.parallel.tp import branch_in

CROSS_MIXES = ("axial", "parent", "none")


def window_size_for_stage(window: int, tokens: int, level: int, global_max: int) -> int:
    """Tokens per attention group at a stage: ``window`` clamped to
    ``4**level`` (a window never spans patches of unrelated top-level
    faces), the whole sequence at or below ``global_max`` tokens or at
    level 0."""
    if tokens <= global_max:
        return tokens
    w = min(window, 4**level, tokens)
    if w < 4:  # level 0: the only coarser grouping is the whole sphere
        return tokens
    if tokens % w:
        raise ValueError(f"window {w} does not divide {tokens} tokens")
    return w


def stage_plan(model) -> list[dict]:
    """Per stage: dims, heads, depth, token count, effective window and the
    per-block mix (even blocks 'window', odd blocks the model's cross_mix
    where the stage is windowed), for the modular model and
    ``fused_mssit_forward`` alike. ``model`` holds ``num_patches``,
    ``patch_level``, ``depths``, ``heads``, ``window``, ``global_max``,
    ``cross_mix`` and ``stage_dims()``."""
    plan, tokens = [], model.num_patches
    for s, (depth, heads, dim) in enumerate(zip(model.depths, model.heads,
                                                model.stage_dims())):
        w = window_size_for_stage(model.window, tokens, model.patch_level - s,
                                  model.global_max)
        mixes = [model.cross_mix if w < tokens and i % 2 == 1 and model.cross_mix != "none"
                 else "window" for i in range(depth)]
        plan.append(dict(stage=s, dim=dim, heads=heads, depth=depth, tokens=tokens,
                         window=w, mixes=mixes))
        tokens //= 4
    return plan


def fold_tokens(t: torch.Tensor, window: int, mix: str) -> torch.Tensor:
    """(B, T, F) -> (B', W', F) groups per ``mix``: 'window' contiguous
    windows, 'axial' across windows at a matching index within them,
    'parent' the 4x coarser contiguous windows; ``t`` itself where the
    window spans the sequence. Inverse: ``unfold_tokens``."""
    B, T, F = t.shape
    W = min(window, T)
    if W >= T:
        return t
    nW = T // W
    if mix == "axial":
        return t.reshape(B, nW, W, F).transpose(1, 2).reshape(B * W, nW, F)
    Wp = min(4 * W, T) if mix == "parent" else W
    return t.reshape(B * (T // Wp), Wp, F)


def unfold_tokens(y: torch.Tensor, B: int, T: int, window: int, mix: str) -> torch.Tensor:
    """The inverse of ``fold_tokens`` for a batch of B sequences of T tokens
    (the feature width may differ from the folded input's)."""
    F = y.shape[-1]
    W = min(window, T)
    if W >= T:
        return y
    if mix == "axial":
        return y.reshape(B, W, T // W, F).transpose(1, 2).reshape(B, T, F)
    return y.reshape(B, T, F)


class WindowAttention(nn.Module):
    """Multi-head attention within the token groups ``fold_tokens`` makes
    for ``mix`` (the pre-norm is the enclosing ``_PreNorm``'s): a bias-free
    fused qkv projection, attention per group, a biased out-projection.
    With ``rng`` and ``dropout`` > 0: the plain softmax, dropout on its
    weights and after the out-projection (the JAX route rule takes no
    kernel then). Under tensor parallelism (``tp`` set, ``parallel.tp``)
    the rank computes its whole heads (uneven where the axis does not
    divide them; their dropout masks cut from the whole heads' mask) and its
    share of the out-projection, summed over the axis before the bias."""

    def __init__(self, dim, heads, dim_head, window, mix="window", attn_backend="auto",
                 dropout=0.0):
        super().__init__()
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        self.window, self.mix, self.attn_backend = window, mix, attn_backend
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Linear(heads * dim_head, dim)
        self.tp = None  # a ``parallel.tp.TPGroup`` under tensor parallelism

    def forward(self, h, *, rng: DropoutRNG | None = None):
        B, T, _ = h.shape
        drop = self.dropout if rng is not None else 0.0
        tp = self.tp
        heads = self.heads if tp is None else tp.head_count(self.heads)
        qkv = _linear(h, self.to_qkv) if tp is None else branch_in(h, self.to_qkv, tp)
        folded = fold_tokens(qkv, self.window, self.mix)
        if not heads:  # a TP rank without a head: nothing to attend, the graph kept
            if drop:
                n = folded.shape[1]  # the mask stream stays in step with the other ranks'
                rng.keep((folded.shape[0], self.heads, n, n), drop)
            out = folded[..., :0]
        elif drop:
            q, k, v = split_qkv(folded, heads)
            if tp is None:
                keep = rng.keep(q.shape[:3] + (k.shape[2],), drop)
            else:
                lo, hi = tp.heads(self.heads)
                keep = rng.keep((q.shape[0], self.heads, *q.shape[2:3], k.shape[2]),
                                drop)[:, lo:hi]
            out = merge_heads(plain_attention(q, k, v, None, keep, drop))
        elif kernel_route(self.attn_backend, folded) or (
                tp is not None and self.attn_backend == "auto" and not folded.is_cuda):
            # under TP the kernel's entry is taken on the CPU too (its plain version)
            out = flash_attention_qkv(folded, heads)
        else:
            out = merge_heads(plain_attention(*split_qkv(folded, heads)))
        if folded is not qkv:
            out = unfold_tokens(out, B, T, self.window, self.mix)
        out = _linear(out, self.to_out) if tp is None else _tp_out(out, self.to_out, tp)
        return rng.drop(out, drop) if drop else out


class PatchMerge(nn.Module):
    """4-to-1 token merge between stages: the four children of a face side
    by side on the channels (a reshape), float32 LayerNorm, then a bias-free
    Linear 4 dim -> 2 dim in the compute dtype."""

    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduce = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        B, T, D = x.shape
        y = x.reshape(B, T // 4, 4 * D)
        return _linear(_layer_norm(y, self.norm).to(x.dtype), self.reduce)


class _Stage(nn.Module):
    def __init__(self, st: dict, mlp_ratio: float, attn_backend: str, merge: bool,
                 dropout: float = 0.0):
        super().__init__()
        dim, heads = st["dim"], st["heads"]
        self.blocks = nn.ModuleList(
            nn.ModuleList([
                _PreNorm(dim, WindowAttention(dim, heads, dim // heads, st["window"], mix,
                                              attn_backend, dropout)),
                _PreNorm(dim, FeedForward(dim, int(dim * mlp_ratio), dropout))])
            for mix in st["mixes"])
        self.merge = PatchMerge(dim) if merge else None

    def forward(self, x, *, rng: DropoutRNG | None = None):
        for attn, ff in self.blocks:
            x = x + attn(x, rng=rng)
            x = x + ff(x, rng=rng)
        return x if self.merge is None else self.merge(x)


class MSSiT(nn.Module):
    """Multiscale Surface Vision Transformer."""

    def __init__(
        self, *, ico=6, patch_level=5, num_channels=4, num_vertices=6, embed_dim=96,
        depths=(2, 2, 6, 2), heads=(3, 6, 12, 24), window=64, global_max=512,
        cross_mix="axial", mlp_ratio=4.0, num_classes=1, dropout=0.0, emb_dropout=0.0,
        attn_backend="auto", patch_table=None, norm_means=None, norm_stds=None,
        dtype=torch.bfloat16,
    ):
        super().__init__()
        self.ico, self.patch_level = ico, patch_level
        self.num_channels, self.num_vertices = num_channels, num_vertices
        self.embed_dim, self.depths, self.heads = embed_dim, tuple(depths), tuple(heads)
        self.window, self.global_max, self.cross_mix = window, global_max, cross_mix
        self.mlp_ratio, self.num_classes = mlp_ratio, num_classes
        self.dropout, self.emb_dropout = dropout, emb_dropout
        self.attn_backend, self.dtype = attn_backend, dtype
        self.patch_table = None if patch_table is None else np.asarray(patch_table)
        self.norm_means, self.norm_stds = norm_means, norm_stds
        self._validate()
        # the table on the model's device, for the kernels (not in the state dict)
        self.register_buffer("patch_index", None if patch_table is None else table_tensor(
            patch_table, "cpu"), persistent=False)
        self.patch_embedding = nn.Linear(self.patch_dim, embed_dim)
        self.pos_embedding = nn.Parameter(0.02 * torch.randn(1, self.num_patches, embed_dim))
        plan = stage_plan(self)
        self.stages = nn.ModuleList(
            _Stage(st, mlp_ratio, attn_backend, merge=st["stage"] < len(plan) - 1,
                   dropout=dropout)
            for st in plan)
        last = self.stage_dims()[-1]
        self.head_norm = nn.LayerNorm(last, eps=1e-5)
        self.head = nn.Linear(last, num_classes)

    @property
    def num_patches(self) -> int:
        return 20 * 4**self.patch_level

    @property
    def patch_dim(self) -> int:
        return self.num_channels * self.num_vertices

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    def stage_dims(self) -> list[int]:
        return [self.embed_dim * 2**s for s in range(self.num_stages)]

    def _validate(self):
        """The JAX model's checks (``MSSiT._validate``)."""
        if len(self.heads) != self.num_stages:
            raise ValueError("depths and heads must have equal length")
        if (self.window & (self.window - 1) or self.window % 4) and self.window != 1:
            # powers of 4 keep windows aligned with the face hierarchy
            raise ValueError(f"window must be a power of 4, got {self.window}")
        if self.num_patches % 4 ** (self.num_stages - 1):
            raise ValueError(f"{self.num_stages} stages need {4 ** (self.num_stages - 1)} | "
                             f"{self.num_patches} tokens")
        for s, (d, h) in enumerate(zip(self.stage_dims(), self.heads)):
            if d % h:
                raise ValueError(f"stage {s}: dim {d} not divisible by heads {h}")
        if self.cross_mix not in CROSS_MIXES:
            raise ValueError(f"unknown cross_mix {self.cross_mix!r}")
        if self.patch_table is not None and int(self.patch_table.max()) + 1 == self.patch_dim:
            # raw (B, C, G) and flattened (B, T, C*V) input are told apart by
            # the last dim: refuse a geometry where they coincide
            raise ValueError(f"ambiguous input dispatch: raw vertex count equals patch_dim "
                             f"C*V={self.patch_dim}; feed pre-patched input or drop patch_table")

    def embed_patches(self, x, *, backend: str | None = None):
        """Input -> (B, T0, embed_dim) embedded patches in the compute dtype:
        raw (B, C, G) through ``embed_raw``; pre-patched (B, C, T0, V) or
        flattened (B, T0, C*V) tokens through the linear embedding."""
        if x.dim() == 3 and x.shape[-1] != self.patch_dim:
            return embed_raw(self, self.patch_embedding, x, backend or self.attn_backend)
        if x.dim() == 4 or (x.dim() == 3 and x.shape[-1] == self.patch_dim):
            t = rearrange_patched(x) if x.dim() == 4 else x
            return _linear(t.to(self.dtype), self.patch_embedding)
        raise ValueError(f"expected 3D raw or 4D pre-patched input, got {tuple(x.shape)}")

    def embed(self, x, *, rng: DropoutRNG | None = None, backend: str | None = None):
        """Input -> (B, T0, embed_dim) tokens with positions (and, given
        ``rng``, embedding dropout) in the compute dtype; ``backend`` as
        ``embed_patches``."""
        tokens = self.embed_patches(x, backend=backend)
        if tokens.shape[1] != self.num_patches:
            raise ValueError(f"input has {tokens.shape[1]} patches, model expects "
                             f"{self.num_patches}")
        h = tokens + self.pos_embedding.to(tokens.dtype)
        return rng.drop(h, self.emb_dropout) if rng is not None else h

    def head_forward(self, h):
        """Final-stage tokens -> (B, num_classes) float32: float32
        LayerNorm, mean over the tokens, Linear."""
        return _linear(_layer_norm(h, self.head_norm).mean(dim=1), self.head)

    def forward(self, x, *, rng: DropoutRNG | None = None, features: bool = False):
        """-> (B, num_classes) float32; with ``features`` the final stage's
        tokens (B, T_last, dim_last) before the head. Dropout on only with
        ``rng``."""
        h = self.embed(x, rng=rng)
        for stage in self.stages:
            h = stage(h, rng=rng)
        return h if features else self.head_forward(h)

    @classmethod
    def from_config(cls, cfg, **overrides) -> "MSSiT":
        """Build from a ``utils.config.Experiment`` (``transformer.model:
        MS-SiT`` and its ``mssit:`` block); ``resolution.sub_ico`` is the
        finest patch level."""
        m, ms = cfg.model, cfg.mssit
        if m.model != "MS-SiT":
            raise ValueError(f"MSSiT.from_config on a {m.model} config")
        kw = dict(ico=cfg.ico, patch_level=cfg.sub_ico, num_channels=m.num_channels,
                  num_vertices=m.num_vertices, num_classes=m.num_classes,
                  dropout=m.dropout, emb_dropout=m.emb_dropout, embed_dim=ms.embed_dim,
                  depths=ms.depths, heads=ms.heads, window=ms.window,
                  global_max=ms.global_max, cross_mix=ms.cross_mix,
                  mlp_ratio=ms.mlp_ratio, dtype=getattr(torch, cfg.compute_dtype))
        kw.update(overrides)
        return cls(**kw)
