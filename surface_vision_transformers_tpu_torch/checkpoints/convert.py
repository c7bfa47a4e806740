"""Weights between the port and the JAX package: JAX param trees and files
<-> reference state dicts.

The port's ``SiT`` uses the reference (vit-pytorch) state-dict layout, so a
reference ``.pth`` loads as it is. A JAX param tree -- e.g. read from the
flat npz that ``surface_vision_transformers_tpu.checkpoints.orbax_io.
save_params_npz`` writes, keys joined with ``/`` -- maps onto it here, the
same mapping as the JAX package's ``checkpoints.torch_import.
sit_params_to_torch``: flax Dense kernels (in, out) transpose to torch
Linear weights (out, in), LayerNorm scale/bias become weight/bias.
``jax_params_from_state_dict`` and ``save_params_npz`` are the inverse, so
the JAX package's ``run_testing`` reads the port's ``best_params.npz`` and
the port reads the JAX package's.

MS-SiT: the reference ships no MS-SiT, so the port's ``models.mssit.MSSiT``
state dict is the port's own layout. ``mssit_state_dict_from_jax`` maps the
JAX ``MSSiT`` tree onto it and ``jax_params_from_mssit_state_dict`` back:

JAX tree -> port state dict:

- ``patch_embedding_kernel`` (C*V, dim), ``patch_embedding_bias`` ->
  ``patch_embedding.weight`` (dim, C*V), ``patch_embedding.bias``;
- ``pos_embedding`` (1, T0, dim) -> ``pos_embedding``;
- ``stage_{s}_block_{i}_attn/{norm,to_qkv,to_out}`` ->
  ``stages.{s}.blocks.{i}.0.norm``, ``.0.fn.to_qkv``, ``.0.fn.to_out``;
- ``stage_{s}_block_{i}_mlp/{norm,fc1,fc2}`` ->
  ``stages.{s}.blocks.{i}.1.norm``, ``.1.fn.net.0``, ``.1.fn.net.3``;
- ``stage_{s}_merge/{norm,reduce}`` -> ``stages.{s}.merge.norm``,
  ``.merge.reduce`` (no bias);
- ``head_norm``, ``head`` -> ``head_norm``, ``head``.

LayerNorm ``scale``/``bias`` become ``weight``/``bias``; flax Dense kernels
(in, out) transpose to torch (out, in) weights. A tree without
``head_norm`` / ``head`` (an MPP encoder's, or the ``encoder_*.npz`` an MPP
run writes for finetuning) maps onto the state dict without those keys.

MPP: the JAX tree ``{"encoder": SiT tree, "mask_token", "to_original"}``
maps onto the reference MPP state dict (``transformer.*`` for the encoder,
``mask_token``, ``to_original.{weight,bias}``), as the JAX package's
``checkpoints.torch_import.mpp_params_from_torch`` maps it;
``encoder_state`` and ``mpp_state`` move a state dict between the two
layouts.

MPP of an MS-SiT: the JAX ``MPPMSSiT`` tree ``{"encoder": MSSiT tree
without the head, "mask_token", "to_original"}`` maps onto the port's
``models.mpp_mssit.MPPMSSiT`` state dict (``encoder.*`` in the MS-SiT
layout above, ``mask_token``, ``to_original.{weight,bias}``) by
``mpp_mssit_state_dict_from_jax``, and back by
``jax_params_from_mpp_mssit_state_dict``.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch


def load_params_npz(path: str | os.PathLike) -> dict:
    """Nested dict of numpy arrays from a ``/``-keyed flat npz."""
    out: dict = {}
    with np.load(path) as z:
        for name in z.files:
            *parents, leaf = name.split("/")
            cur = out
            for p in parents:
                cur = cur.setdefault(p, {})
            cur[leaf] = z[name]
    return out


def load_torch_state_dict(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """A reference ``.pt``/``.pth`` file: a bare state dict or one under
    ``model_state_dict``. Read with ``weights_only=True``: tensors and plain
    containers only, no arbitrary unpickling."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return dict(obj)


def state_dict_from_jax(
    params: Mapping[str, Any], depth: int
) -> dict[str, torch.Tensor]:
    """A JAX SiT param tree (nested dict of arrays, optionally under
    ``params``) -> reference-layout state dict of float tensors."""
    p = params["params"] if "params" in params else params

    def t(a):  # flax (in, out) kernel -> torch (out, in) weight
        return torch.from_numpy(np.array(np.asarray(a).T, order="C"))

    def c(a):
        return torch.from_numpy(np.array(a))

    out = {
        "to_patch_embedding.1.weight": t(p["patch_embedding_kernel"]),
        "to_patch_embedding.1.bias": c(p["patch_embedding_bias"]),
        "pos_embedding": c(p["pos_embedding"]),
        "cls_token": c(p["cls_token"]),
    }
    enc = p["encoder"]
    for i in range(depth):
        a, m = enc[f"layers_{i}_attn"], enc[f"layers_{i}_mlp"]
        pre = f"transformer.layers.{i}"
        out[f"{pre}.0.norm.weight"] = c(a["norm"]["scale"])
        out[f"{pre}.0.norm.bias"] = c(a["norm"]["bias"])
        out[f"{pre}.0.fn.to_qkv.weight"] = t(a["to_qkv"]["kernel"])
        out[f"{pre}.0.fn.to_out.0.weight"] = t(a["to_out"]["kernel"])
        out[f"{pre}.0.fn.to_out.0.bias"] = c(a["to_out"]["bias"])
        out[f"{pre}.1.norm.weight"] = c(m["norm"]["scale"])
        out[f"{pre}.1.norm.bias"] = c(m["norm"]["bias"])
        out[f"{pre}.1.fn.net.0.weight"] = t(m["fc1"]["kernel"])
        out[f"{pre}.1.fn.net.0.bias"] = c(m["fc1"]["bias"])
        out[f"{pre}.1.fn.net.3.weight"] = t(m["fc2"]["kernel"])
        out[f"{pre}.1.fn.net.3.bias"] = c(m["fc2"]["bias"])
    if "head" in p:  # an MPP's encoder tree has no head
        out["mlp_head.0.weight"] = c(p["head_norm"]["scale"])
        out["mlp_head.0.bias"] = c(p["head_norm"]["bias"])
        out["mlp_head.1.weight"] = t(p["head"]["kernel"])
        out["mlp_head.1.bias"] = c(p["head"]["bias"])
    return out


def jax_params_from_state_dict(
    state: Mapping[str, torch.Tensor], depth: int
) -> dict[str, Any]:
    """Inverse of ``state_dict_from_jax``: reference-layout state dict ->
    JAX SiT param tree of float32 numpy arrays (flax (in, out) kernels);
    ``head_norm`` / ``head`` when the state has ``mlp_head``."""

    def c(k):
        return state[k].detach().cpu().float().numpy().copy()

    def t(k):  # torch (out, in) weight -> flax (in, out) kernel
        return np.ascontiguousarray(c(k).T)

    enc = {}
    for i in range(depth):
        pre = f"transformer.layers.{i}"
        enc[f"layers_{i}_attn"] = {
            "norm": {"scale": c(f"{pre}.0.norm.weight"), "bias": c(f"{pre}.0.norm.bias")},
            "to_qkv": {"kernel": t(f"{pre}.0.fn.to_qkv.weight")},
            "to_out": {"kernel": t(f"{pre}.0.fn.to_out.0.weight"),
                       "bias": c(f"{pre}.0.fn.to_out.0.bias")},
        }
        enc[f"layers_{i}_mlp"] = {
            "norm": {"scale": c(f"{pre}.1.norm.weight"), "bias": c(f"{pre}.1.norm.bias")},
            "fc1": {"kernel": t(f"{pre}.1.fn.net.0.weight"), "bias": c(f"{pre}.1.fn.net.0.bias")},
            "fc2": {"kernel": t(f"{pre}.1.fn.net.3.weight"), "bias": c(f"{pre}.1.fn.net.3.bias")},
        }
    out = {
        "patch_embedding_kernel": t("to_patch_embedding.1.weight"),
        "patch_embedding_bias": c("to_patch_embedding.1.bias"),
        "pos_embedding": c("pos_embedding"),
        "cls_token": c("cls_token"),
        "encoder": enc,
    }
    if "mlp_head.1.weight" in state:
        out["head_norm"] = {"scale": c("mlp_head.0.weight"), "bias": c("mlp_head.0.bias")}
        out["head"] = {"kernel": t("mlp_head.1.weight"), "bias": c("mlp_head.1.bias")}
    return out


# timm ViT key -> reference-layout key suffix, per block (``blocks.{i}.`` ->
# ``transformer.layers.{i}.``); both in the torch (out, in) layout
_TIMM_BLOCK = (("norm1.weight", "0.norm.weight"), ("norm1.bias", "0.norm.bias"),
               ("attn.qkv.weight", "0.fn.to_qkv.weight"),
               ("attn.proj.weight", "0.fn.to_out.0.weight"),
               ("attn.proj.bias", "0.fn.to_out.0.bias"),
               ("norm2.weight", "1.norm.weight"), ("norm2.bias", "1.norm.bias"),
               ("mlp.fc1.weight", "1.fn.net.0.weight"), ("mlp.fc1.bias", "1.fn.net.0.bias"),
               ("mlp.fc2.weight", "1.fn.net.3.weight"), ("mlp.fc2.bias", "1.fn.net.3.bias"))


def imagenet_state_from_timm(state: Mapping[str, torch.Tensor],
                             timm_state: Mapping[str, Any], depth: int) -> dict:
    """A SiT's reference-layout state dict with timm ImageNet ViT weights
    laid over it (the JAX package's ``checkpoints.torch_import.
    imagenet_params_from_timm``, the reference's ``utils/utils.py:11-35``):
    every block's norms, fused qkv, out-projection and MLP, and timm's final
    ``norm`` as the head's LayerNorm. The patch and positional embeddings,
    the CLS token and the head's Linear keep ``state``'s values. Tensors
    come back float32, on the CPU."""
    out = {k: v.detach().cpu().float().clone() for k, v in state.items()}

    def put(key, src):
        out[key] = torch.as_tensor(np.asarray(timm_state[src], np.float32)).clone()

    for i in range(depth):
        for src, dst in _TIMM_BLOCK:
            put(f"transformer.layers.{i}.{dst}", f"blocks.{i}.{src}")
    put("mlp_head.0.weight", "norm.weight")
    put("mlp_head.0.bias", "norm.bias")
    return out


# (JAX leaf path, port key suffix, transpose) of one MS-SiT block's halves
_MSSIT_BLOCK = (
    ("attn/norm/scale", "0.norm.weight", False), ("attn/norm/bias", "0.norm.bias", False),
    ("attn/to_qkv/kernel", "0.fn.to_qkv.weight", True),
    ("attn/to_out/kernel", "0.fn.to_out.weight", True),
    ("attn/to_out/bias", "0.fn.to_out.bias", False),
    ("mlp/norm/scale", "1.norm.weight", False), ("mlp/norm/bias", "1.norm.bias", False),
    ("mlp/fc1/kernel", "1.fn.net.0.weight", True), ("mlp/fc1/bias", "1.fn.net.0.bias", False),
    ("mlp/fc2/kernel", "1.fn.net.3.weight", True), ("mlp/fc2/bias", "1.fn.net.3.bias", False),
)
_MSSIT_MERGE = (("norm/scale", "norm.weight", False), ("norm/bias", "norm.bias", False),
                ("reduce/kernel", "reduce.weight", True))
_MSSIT_TOP = (("patch_embedding_kernel", "patch_embedding.weight", True),
              ("patch_embedding_bias", "patch_embedding.bias", False),
              ("pos_embedding", "pos_embedding", False),
              ("head_norm/scale", "head_norm.weight", False),
              ("head_norm/bias", "head_norm.bias", False),
              ("head/kernel", "head.weight", True), ("head/bias", "head.bias", False))


def _mssit_pairs(depths, head: bool = True) -> list[tuple[str, str, bool]]:
    """(JAX leaf path, port key, transpose) of every MS-SiT parameter, for
    stages of ``depths`` blocks; without ``head_norm`` / ``head`` unless
    ``head``."""
    pairs = [t for t in _MSSIT_TOP if head or not t[0].startswith("head")]
    for s, depth in enumerate(depths):
        for i in range(depth):
            pairs += [(f"stage_{s}_block_{i}_{j}",
                       f"stages.{s}.blocks.{i}.{k}", t) for j, k, t in _MSSIT_BLOCK]
        if s < len(depths) - 1:
            pairs += [(f"stage_{s}_merge/{j}", f"stages.{s}.merge.{k}", t)
                      for j, k, t in _MSSIT_MERGE]
    return pairs


def is_mssit_tree(params: Mapping[str, Any]) -> bool:
    """Whether a JAX param tree (optionally under ``params``) is an MS-SiT's."""
    p = params.get("params", params)
    return "stage_0_block_0_attn" in p


def _mssit_depths(p: Mapping[str, Any]) -> list[int]:
    """Blocks per stage of a JAX MS-SiT tree, read off its keys."""
    depths = []
    while f"stage_{len(depths)}_block_0_attn" in p:
        s = len(depths)
        depths.append(sum(1 for k in p if k.startswith(f"stage_{s}_block_")
                          and k.endswith("_attn")))
    return depths


def mssit_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A JAX ``MSSiT`` param tree (nested dict of arrays, optionally under
    ``params``) -> the port's ``MSSiT`` state dict (the table above)."""
    p = params["params"] if "params" in params else params
    out = {}
    for path, key, transpose in _mssit_pairs(_mssit_depths(p), "head" in p):
        node = p
        for part in path.split("/"):
            node = node[part]
        a = np.asarray(node)
        out[key] = torch.from_numpy(np.array(a.T if transpose else a, order="C"))
    return out


def jax_params_from_mssit_state_dict(state: Mapping[str, torch.Tensor],
                                     model, head: bool = True) -> dict[str, Any]:
    """Inverse of ``mssit_state_dict_from_jax``: the port's ``MSSiT`` state
    dict (of ``model``'s depths) -> JAX tree of float32 numpy arrays, the
    head left out unless ``head``."""
    out: dict = {}
    for path, key, transpose in _mssit_pairs(model.depths, head):
        a = state[key].detach().cpu().float().numpy()
        *parents, leaf = path.split("/")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a.T) if transpose else a.copy()
    return out


def mpp_state_dict_from_jax(params: Mapping[str, Any], depth: int) -> dict[str, torch.Tensor]:
    """A JAX MPP param tree (optionally under ``params``) -> reference MPP
    state dict, without the encoder's head (the tree has none;
    ``train.runner.load_model_state`` keeps the model's own)."""
    p = params["params"] if "params" in params else params
    out = mpp_state(state_dict_from_jax(p["encoder"], depth))
    out["mask_token"] = torch.from_numpy(np.array(p["mask_token"]))
    out["to_original.weight"] = torch.from_numpy(
        np.array(np.asarray(p["to_original"]["kernel"]).T, order="C"))
    out["to_original.bias"] = torch.from_numpy(np.array(p["to_original"]["bias"]))
    return out


def jax_params_from_mpp_state_dict(state: Mapping[str, torch.Tensor],
                                   depth: int) -> dict[str, Any]:
    """Inverse of ``mpp_state_dict_from_jax``. The encoder's head, which MPP
    never runs (a reference state dict carries it), is left out, as the JAX
    MPP tree has none."""
    def c(k):
        return state[k].detach().cpu().float().numpy().copy()

    enc = {k: v for k, v in encoder_state(state).items() if not k.startswith("mlp_head.")}
    return {"encoder": jax_params_from_state_dict(enc, depth),
            "mask_token": c("mask_token"),
            "to_original": {"kernel": np.ascontiguousarray(c("to_original.weight").T),
                            "bias": c("to_original.bias")}}


def mpp_mssit_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A JAX ``MPPMSSiT`` param tree (optionally under ``params``) -> the
    port's ``MPPMSSiT`` state dict, without the encoder's head (the tree has
    none; ``train.runner.load_model_state`` keeps the model's own)."""
    p = params["params"] if "params" in params else params
    out = mpp_state(mssit_state_dict_from_jax(p["encoder"]), MSSIT_ENCODER)
    out["mask_token"] = torch.from_numpy(np.array(p["mask_token"]))
    out["to_original.weight"] = torch.from_numpy(
        np.array(np.asarray(p["to_original"]["kernel"]).T, order="C"))
    out["to_original.bias"] = torch.from_numpy(np.array(p["to_original"]["bias"]))
    return out


def jax_params_from_mpp_mssit_state_dict(state: Mapping[str, torch.Tensor],
                                         encoder) -> dict[str, Any]:
    """Inverse of ``mpp_mssit_state_dict_from_jax`` (``encoder``: the MS-SiT
    whose depths the state holds); the encoder's head is left out, as the
    JAX tree has none."""
    def c(k):
        return state[k].detach().cpu().float().numpy().copy()

    return {"encoder": jax_params_from_mssit_state_dict(encoder_state(state), encoder,
                                                        head=False),
            "mask_token": c("mask_token"),
            "to_original": {"kernel": np.ascontiguousarray(c("to_original.weight").T),
                            "bias": c("to_original.bias")}}


def is_mpp_mssit_tree(params: Mapping[str, Any]) -> bool:
    """Whether a JAX param tree (optionally under ``params``) is an
    ``MPPMSSiT``'s."""
    p = params.get("params", params)
    return "mask_token" in p and is_mssit_tree(p["encoder"])


# The prefix of the encoder's keys in an MPP state dict: ``transformer.``
# (the reference MPP of a SiT) or ``encoder.`` (the port's MPPMSSiT).
SIT_ENCODER, MSSIT_ENCODER = "transformer.", "encoder."


def is_mpp_state(state: Mapping[str, Any]) -> bool:
    """Whether a state dict is in an MPP layout (a SiT encoder under
    ``transformer.``, an MS-SiT one under ``encoder.``)."""
    return "mask_token" in state or any(
        k.startswith(("transformer.transformer.", MSSIT_ENCODER)) for k in state)


def encoder_state(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The encoder's state dict inside an MPP one (an encoder's is returned
    as is)."""
    if not is_mpp_state(state):
        return dict(state)
    prefix = MSSIT_ENCODER if any(k.startswith(MSSIT_ENCODER) for k in state) else SIT_ENCODER
    n = len(prefix)
    return {k[n:]: v for k, v in state.items() if k.startswith(prefix)}


def mpp_state(state: Mapping[str, torch.Tensor],
              prefix: str = SIT_ENCODER) -> dict[str, torch.Tensor]:
    """An encoder's state dict nested as an MPP's (``prefix``: SiT's
    ``transformer.`` or MS-SiT's ``encoder.``)."""
    return {f"{prefix}{k}": v for k, v in state.items()}


def save_params_npz(path: str | os.PathLike, tree: Mapping[str, Any]) -> None:
    """A nested dict of arrays -> flat npz with ``/``-joined keys (the JAX
    package's ``save_params_npz`` format; read back by ``load_params_npz``)."""
    flat: dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(tree, "")
    np.savez(path, **flat)
