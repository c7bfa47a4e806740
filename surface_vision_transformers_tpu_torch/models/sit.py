"""SiT -- Surface Vision Transformer, eager PyTorch.

Counterpart of ``surface_vision_transformers_tpu.models.sit.SiT`` with the
reference (vit-pytorch) module tree, so reference ``.pth`` files and
``state_dict_from_jax`` output load with ``strict=True``: a linear patch
embedding of (v c)-flattened patches, CLS token and learned positions, a
pre-norm encoder (fused no-bias QKV, dh^-0.5, biased out-projection,
exact-erf GELU MLP, LayerNorm eps 1e-5), cls or mean pooling, then a float32
LayerNorm + Linear head.

Inputs are pre-patched (B, C, L, V) or, with ``patch_table`` set, raw
(B, C, G) vertex arrays patchified (and, with ``norm_means``/``norm_stds``,
normalised) on the fly. ``dtype`` is the compute dtype: LayerNorm, scores
and softmax run in float32, the matmuls in ``dtype``, as the JAX model does.
This is the plain path; serving runs ``models.fused.fused_forward``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from surface_vision_transformers_tpu_torch.ops.patchify import (
    fused_patch_embed,
    rearrange_patched,
)


def _linear(x, lin: nn.Linear):
    dt = x.dtype
    b = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x, lin.weight.to(dt), b)


def _layer_norm(x, ln: nn.LayerNorm):
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps)


class _PatchFlatten(nn.Module):
    def forward(self, x):
        return rearrange_patched(x)


class _PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x):
        return self.fn(_layer_norm(x, self.norm).to(x.dtype))


class Attention(nn.Module):
    def __init__(self, dim, heads, dim_head):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, h):
        B, N, _ = h.shape
        q, k, v = (
            t.reshape(B, N, self.heads, self.dim_head).transpose(1, 2)
            for t in _linear(h, self.to_qkv).chunk(3, dim=-1)
        )
        s = (q.float() @ k.float().transpose(-1, -2)) * self.dim_head ** -0.5
        o = s.softmax(-1).to(v.dtype) @ v
        return _linear(o.transpose(1, 2).reshape(B, N, -1), self.to_out[0])


class FeedForward(nn.Module):
    def __init__(self, dim, hidden_dim):
        super().__init__()
        # indices 0 and 3 hold the reference checkpoint's weights
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim), nn.GELU(),
                                 nn.Identity(), nn.Linear(hidden_dim, dim),
                                 nn.Identity())

    def forward(self, h):
        f = F.gelu(_linear(h, self.net[0]).float()).to(h.dtype)
        return _linear(f, self.net[3])


class _Transformer(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp_dim):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([_PreNorm(dim, Attention(dim, heads, dim_head)),
                           _PreNorm(dim, FeedForward(dim, mlp_dim))])
            for _ in range(depth)
        )

    def forward(self, x):
        for attn, ff in self.layers:
            x = x + attn(x)
            x = x + ff(x)
        return x


class SiT(nn.Module):
    """Surface Vision Transformer with the reference state-dict layout."""

    def __init__(
        self, *, dim=192, depth=12, heads=3, mlp_dim=768, pool="cls",
        num_patches=320, num_classes=1, num_channels=4, num_vertices=153,
        dim_head=64, patch_table=None, norm_means=None, norm_stds=None,
        dtype=torch.bfloat16,
    ):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        self.dim, self.depth, self.heads = dim, depth, heads
        self.dim_head, self.mlp_dim, self.pool = dim_head, mlp_dim, pool
        self.num_patches, self.num_vertices = num_patches, num_vertices
        self.num_channels, self.num_classes = num_channels, num_classes
        self.patch_table = None if patch_table is None else np.asarray(patch_table)
        self.norm_means, self.norm_stds = norm_means, norm_stds
        self.dtype = dtype
        self.to_patch_embedding = nn.Sequential(
            _PatchFlatten(), nn.Linear(num_channels * num_vertices, dim))
        self.pos_embedding = nn.Parameter(torch.randn(1, num_patches + 1, dim))
        self.cls_token = nn.Parameter(torch.randn(1, 1, dim))
        self.transformer = _Transformer(dim, depth, heads, dim_head, mlp_dim)
        self.mlp_head = nn.Sequential(nn.LayerNorm(dim, eps=1e-5),
                                      nn.Linear(dim, num_classes))

    def embed(self, x):
        """Input -> (B, L+1, dim) tokens in the compute dtype (CLS + pos)."""
        lin = self.to_patch_embedding[1]
        if x.dim() == 3:
            if self.patch_table is None:
                raise ValueError("raw (B, C, G) input requires patch_table to be set")
            tokens = fused_patch_embed(
                x, self.patch_table, lin.weight.t(), lin.bias,
                means=self.norm_means, stds=self.norm_stds,
                compute_dtype=self.dtype)
        elif x.dim() == 4:
            tokens = _linear(rearrange_patched(x).to(self.dtype), lin)
        else:
            raise ValueError(
                f"expected 3D raw or 4D pre-patched input, got {tuple(x.shape)}")
        return self.embed_tokens(tokens)

    def embed_tokens(self, tokens):
        """(B, L, dim) embedded patches -> (B, L+1, dim) with CLS and pos."""
        B, n, _ = tokens.shape
        cls = self.cls_token.to(tokens.dtype).expand(B, -1, -1)
        h = torch.cat([cls, tokens], dim=1)
        return h + self.pos_embedding[:, : n + 1].to(tokens.dtype)

    def encode(self, x):
        """Input -> (B, L+1, dim) encoded sequence."""
        return self.transformer(self.embed(x))

    def forward(self, x):
        h = self.encode(x)
        pooled = h.mean(dim=1) if self.pool == "mean" else h[:, 0]
        return _linear(_layer_norm(pooled, self.mlp_head[0]), self.mlp_head[1])

    @classmethod
    def from_config(cls, cfg, **overrides) -> "SiT":
        """Build from a ``utils.config.Experiment`` (or a ModelConfig)."""
        m = getattr(cfg, "model", cfg)
        if m.model != "SiT":
            raise NotImplementedError(f"{m.model} is not ported yet")
        kw = dict(dim=m.dim, depth=m.depth, heads=m.heads, mlp_dim=m.mlp_dim,
                  pool=m.pool, num_patches=m.num_patches,
                  num_classes=m.num_classes, num_channels=m.num_channels,
                  num_vertices=m.num_vertices, dim_head=m.dim_head)
        if hasattr(cfg, "compute_dtype"):
            kw["dtype"] = getattr(torch, cfg.compute_dtype)
        kw.update(overrides)
        return cls(**kw)
