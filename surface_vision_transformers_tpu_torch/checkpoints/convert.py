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

MPP: the JAX tree ``{"encoder": SiT tree, "mask_token", "to_original"}``
maps onto the reference MPP state dict (``transformer.*`` for the encoder,
``mask_token``, ``to_original.{weight,bias}``), as the JAX package's
``checkpoints.torch_import.mpp_params_from_torch`` maps it;
``encoder_state`` and ``mpp_state`` move a state dict between the two
layouts.
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


def is_mpp_state(state: Mapping[str, Any]) -> bool:
    """Whether a state dict is in the MPP layout (encoder under
    ``transformer.``)."""
    return "mask_token" in state or any(k.startswith("transformer.transformer.")
                                        for k in state)


def encoder_state(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The SiT state dict inside an MPP one (a SiT one is returned as is)."""
    if not is_mpp_state(state):
        return dict(state)
    n = len("transformer.")
    return {k[n:]: v for k, v in state.items() if k.startswith("transformer.")}


def mpp_state(sit_state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A SiT state dict nested as an MPP encoder's."""
    return {f"transformer.{k}": v for k, v in sit_state.items()}


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
