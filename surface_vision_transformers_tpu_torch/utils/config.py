"""Typed configuration for the serving path, over the JAX package's YAML
schema (``surface_vision_transformers_tpu.utils.config``), so its config
files load unmodified.

Only the keys serving reads are parsed: ``resolution``, ``transformer``
(architecture), ``data`` (location and split), ``testing.path_to_ckpt``,
``training.bs`` / ``bs_val``, ``pretraining_mpp`` / ``SSL`` (to refuse MPP
configs) and, under ``tpu``, ``compute_dtype`` and ``quant``. ``tpu.scan_blocks`` is a TPU compile-time knob that leaves the
outputs bitwise unchanged; eager PyTorch has nothing to compile, so it is
not read. A ``.json`` file is read with the standard library; anything else
with PyYAML, imported only when needed.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

from surface_vision_transformers_tpu_torch.geometry import patch_grid


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """SiT architecture (``transformer:`` block)."""

    dim: int = 192
    depth: int = 12
    heads: int = 3
    mlp_dim: int = 768
    pool: str = "cls"
    num_classes: int = 1
    num_channels: int = 4
    dim_head: int = 64
    num_patches: int = 320
    num_vertices: int = 153
    model: str = "SiT"

    def __post_init__(self):
        if self.pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {self.pool!r}")
        if self.model not in ("SiT", "MS-SiT"):
            raise ValueError(f"unknown model {self.model!r}")


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """The batch sizes serving reads (``training:`` block)."""

    bs: int = 256
    bs_val: int = 0  # 0 -> bs


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset location (``data:`` block); ``{}`` in data_path is filled
    with (task, configuration)."""

    data_path: str = ""
    task: str = "scan_age"
    configuration: str = "template"
    split: str = "train"

    def resolved_data_path(self) -> str:
        if "{}" in self.data_path:
            return self.data_path.format(self.task, self.configuration)
        return self.data_path


@dataclasses.dataclass(frozen=True)
class Experiment:
    """Resolved serving configuration."""

    model: ModelConfig
    training: TrainingConfig
    data: DataConfig
    compute_dtype: str = "bfloat16"
    quant: str = "none"
    is_pretraining: bool = False  # an MPP (``pretraining_mpp``) config
    ico: int = 6
    sub_ico: int = 2
    ckpt_path: str = ""


def _get(d: dict, path: str, default):
    cur = d
    for key in path.split("."):
        if not isinstance(cur, dict) or key not in cur:
            return default
        cur = cur[key]
    return cur


def _resolve_geometry(raw: dict) -> tuple[int, int, int, int]:
    ico = int(_get(raw, "resolution.ico", 6))
    sub_ico = int(_get(raw, "resolution.sub_ico", 2))
    num_patches, num_vertices = patch_grid(ico, sub_ico)
    block = raw.get(f"sub_ico_{sub_ico}")
    if block and (int(block["num_patches"]), int(block["num_vertices"])) != (
        num_patches, num_vertices
    ):
        raise ValueError(
            f"sub_ico_{sub_ico} YAML block {block} disagrees with geometry "
            f"formula {(num_patches, num_vertices)}"
        )
    return ico, sub_ico, num_patches, num_vertices


def from_dict(raw: dict) -> Experiment:
    """Build an Experiment from a config dict of the JAX package's schema."""
    ico, sub_ico, num_patches, num_vertices = _resolve_geometry(raw)
    t = raw.get("transformer", {})
    model = ModelConfig(
        dim=int(t.get("dim", 192)),
        depth=int(t.get("depth", 12)),
        heads=int(t.get("heads", 3)),
        mlp_dim=int(t.get("mlp_dim", 768)),
        pool=t.get("pool", "cls"),
        num_classes=int(t.get("num_classes", 1)),
        num_channels=int(t.get("num_channels", 4)),
        dim_head=int(t.get("dim_head", 64)),
        num_patches=num_patches,
        num_vertices=num_vertices,
        model=t.get("model", "SiT"),
    )
    tr = raw.get("training", {})
    training = TrainingConfig(bs=int(tr.get("bs", 256)),
                              bs_val=int(tr.get("bs_val", 0)))
    d = raw.get("data", {})
    data = DataConfig(
        data_path=d.get("data_path", ""),
        task=d.get("task", "scan_age"),
        configuration=d.get("configuration", "template"),
        split=d.get("split", "train"),
    )
    tp = raw.get("tpu", {})
    quant = str(tp.get("quant", "none"))
    if quant not in ("none", "int8"):
        raise ValueError(f"tpu.quant must be 'none' or 'int8', got {quant!r}")
    return Experiment(
        model=model,
        training=training,
        data=data,
        compute_dtype=str(tp.get("compute_dtype", "bfloat16")),
        quant=quant,
        is_pretraining="pretraining_mpp" in raw or raw.get("SSL") == "mpp",
        ico=ico,
        sub_ico=sub_ico,
        ckpt_path=str(_get(raw, "testing.path_to_ckpt", "")),
    )


def read_config_file(path: str | os.PathLike) -> dict:
    """The raw dict of a ``.json`` or YAML config file."""
    text = Path(path).read_text()
    if Path(path).suffix == ".json":
        return json.loads(text)
    import yaml

    return yaml.safe_load(text)


def load_config(path: str | os.PathLike) -> Experiment:
    return from_dict(read_config_file(path))
