"""Typed configuration for serving and supervised training, over the JAX
package's YAML schema (``surface_vision_transformers_tpu.utils.config``), so
its config files load unmodified.

Only the keys the port reads are parsed, with the JAX package's validation:
``resolution``, ``transformer`` (architecture, dropout), ``mssit`` (the
MS-SiT hierarchy, read when ``transformer.model: MS-SiT``), ``data`` (location,
split, streaming and its budget), ``training`` (batch sizes, epochs,
validation cadence, loss, EMA, gradient accumulation, checkpoints and
``ckpt_every``, initialisation, seed), ``optimisation`` / ``SGD`` / ``Adam`` /
``AdamW`` / ``StepLR`` / ``CosineDecay`` (optimizer and schedule),
``logging.folder_to_save_model``, ``weights``, ``testing.path_to_ckpt``, the
whole ``augmentation`` block, ``pretraining_mpp`` / ``SSL`` (masked-patch pretraining: the corruption
rates and ``optimize_decoder``) and, under ``tpu``, ``compute_dtype``,
``fused_train``, ``quant``, the mesh axes ``mesh_data`` / ``mesh_fsdp`` /
``mesh_model`` / ``mesh_pipe`` (``parallel.mesh_from_config``),
``pipe_microbatches``, ``seq_sharding``, ``profile_epoch`` and
``debug_nans``. ``tpu.scan_blocks`` is a TPU compile-time knob that leaves
the outputs bitwise unchanged; eager PyTorch has nothing to compile, so it
is not read. A ``.json`` file is read with the standard
library; anything else with PyYAML, imported only when needed.
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
    dropout: float = 0.0
    emb_dropout: float = 0.0

    def __post_init__(self):
        if self.pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {self.pool!r}")
        if self.model not in ("SiT", "MS-SiT"):
            raise ValueError(f"unknown model {self.model!r}")

    @property
    def size_name(self) -> str:
        return {192: "tiny", 384: "small", 768: "base"}.get(self.dim, f"d{self.dim}")


@dataclasses.dataclass(frozen=True)
class MSSiTConfig:
    """MS-SiT hierarchy (``mssit:`` block; read when ``transformer.model:
    MS-SiT``). ``resolution.sub_ico`` is the finest patch level of this
    family (ico 6 / sub_ico 5: 20,480 tokens)."""

    embed_dim: int = 96
    depths: tuple = (2, 2, 6, 2)
    heads: tuple = (3, 6, 12, 24)
    window: int = 64  # tokens per attention window (a power of 4)
    global_max: int = 512  # stages at or below this many tokens attend globally
    cross_mix: str = "axial"  # 'axial' | 'parent' | 'none'
    mlp_ratio: float = 4.0

    def __post_init__(self):
        if len(self.depths) != len(self.heads):
            raise ValueError("mssit.depths and mssit.heads lengths differ")
        if self.cross_mix not in ("axial", "parent", "none"):
            raise ValueError(f"unknown mssit.cross_mix {self.cross_mix!r}")


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Optimizer and schedule (``optimisation:`` and the optimizer's block)."""

    name: str = "SGD"
    lr: float = 1e-5
    weight_decay: float = 0.0
    momentum: float = 0.9
    nesterov: bool = False
    schedule: str = "constant"  # 'constant' | 'step' | 'cosine' | 'warmup_cosine'
    step_size: int = 1000
    step_decay: float = 0.5
    cosine_t_max: int = 5000
    cosine_eta_min: float = 1e-4
    warmup_steps: int = 0
    grad_clip: float = 0.0  # global-norm clip before the update; 0 = off

    def __post_init__(self):
        if self.name not in ("SGD", "Adam", "AdamW"):
            raise ValueError(f"unknown optimiser {self.name!r}")
        if self.grad_clip < 0:
            raise ValueError("optimisation.grad_clip must be >= 0")
        if self.schedule not in ("constant", "step", "cosine", "warmup_cosine"):
            raise ValueError(f"unknown schedule {self.schedule!r}")


@dataclasses.dataclass(frozen=True)
class MPPConfig:
    """Masked-patch-pretraining corruption (``pretraining_mpp:`` block), with
    the JAX package's validation. ``optimize_decoder: false`` freezes the
    reconstruction head and the mask token (the reference's optimizer never
    saw them)."""

    mask_prob: float = 0.75
    replace_prob: float = 0.8
    swap_prob: float = 0.02
    optimize_decoder: bool = True

    def __post_init__(self):
        for k in ("mask_prob", "replace_prob", "swap_prob"):
            if not 0.0 <= getattr(self, k) <= 1.0:
                raise ValueError(f"pretraining_mpp.{k} must be in [0, 1]")
        if self.swap_prob > 0 and self.replace_prob >= 1.0:
            # the swap rate swap_prob / (1 - replace_prob) is undefined at 1
            raise ValueError("pretraining_mpp.swap_prob > 0 requires replace_prob < 1")


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """Run hyperparameters (``training:`` block)."""

    bs: int = 256
    bs_val: int = 0  # 0 -> bs
    grad_accum: int = 1  # microbatches per step, weight-sum scaled
    ema: float = 0.0  # EMA decay of the weights for evaluation; 0 = off
    # rolling full-state checkpoint ``last/`` every this many epochs (0 =
    # off), which ``run_training(resume_from=...)`` / ``--resume`` continues
    ckpt_every: int = 0
    epochs: int = 100
    val_epoch: int = 10
    l1loss: bool = False
    testing: bool = False
    save_ckpt: bool = True
    finetuning: bool = True
    load_weights_ssl: bool = False
    load_weights_imagenet: bool = False
    dataset_ssl: str = "dhcp"
    seed: int = 0

    def __post_init__(self):
        if self.grad_accum < 1:
            raise ValueError("training.grad_accum must be >= 1")
        if not 0.0 <= self.ema < 1.0:
            raise ValueError("training.ema must be in [0, 1)")
        if self.bs % self.grad_accum:
            raise ValueError(
                f"training.bs ({self.bs}) must be divisible by "
                f"training.grad_accum ({self.grad_accum})")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset location (``data:`` block); ``{}`` in data_path is filled
    with (task, configuration)."""

    data_path: str = ""
    task: str = "scan_age"
    configuration: str = "template"
    split: str = "train"
    # 'on': train and validate from host-resident (memmapped) splits through
    # ``data.pipeline.StreamingLoader``; 'auto': stream when twice the
    # float32 training split exceeds ``streaming_budget_gb``; 'off': resident
    streaming: str = "auto"
    streaming_budget_gb: float = 8.0

    def __post_init__(self):
        if self.streaming not in ("auto", "on", "off"):
            raise ValueError(
                f"data.streaming must be 'auto'|'on'|'off', got {self.streaming!r}")

    def resolved_data_path(self) -> str:
        if "{}" in self.data_path:
            return self.data_path.format(self.task, self.configuration)
        return self.data_path


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Rotation / warp augmentation of training batches (``augmentation:``
    block, as the JAX package's ``AugmentConfig``): the 60 exact icosahedral
    rotations, ``num_warps`` barycentric tables of random rotations up to
    ``max_warp_deg``, applied to ``warp_prob`` of the samples by the
    ``warp_assign`` law ('quota' or 'multinomial') or one table a batch
    (``warp_per_batch``). ``seed`` draws the warp tables; ``sphere_path``
    (a sphere .surf.gii in the data's vertex order) is required with an
    atlas-ordered patch table."""

    enabled: bool = False
    exact_rotations: bool = True
    num_warps: int = 8
    max_warp_deg: float = 15.0
    warp_prob: float = 0.5
    warp_per_batch: bool = False
    warp_assign: str = "quota"
    seed: int = 0
    sphere_path: str = ""


@dataclasses.dataclass(frozen=True)
class Experiment:
    """Resolved configuration."""

    model: ModelConfig
    training: TrainingConfig
    data: DataConfig
    optim: OptimConfig = OptimConfig()
    mssit: MSSiTConfig = MSSiTConfig()
    compute_dtype: str = "bfloat16"
    quant: str = "none"
    mpp: MPPConfig | None = None  # an MPP (``pretraining_mpp`` or ``SSL: mpp``) config
    fused_train: bool = True  # ``tpu.fused_train``: the fused-block training route
    # ``tpu.mesh_*``: the ('data', 'fsdp', 'model'[, 'pipe']) mesh; -1 on data
    # takes the rest
    mesh_data: int = -1
    mesh_fsdp: int = 1
    mesh_model: int = 1
    mesh_pipe: int = 1  # GPipe stages (``parallel.pipeline``)
    pipe_microbatches: int = 0  # 0: one microbatch a stage
    seq_sharding: bool = False  # the 'model' axis splits the tokens (``parallel.seq``)
    profile_epoch: int = -1  # ``tpu.profile_epoch``: the epoch ``profile_trace`` records
    debug_nans: bool = False  # ``tpu.debug_nans``: raise at the first step or batch with a NaN
    augment: AugmentConfig = AugmentConfig()
    ico: int = 6
    sub_ico: int = 2
    ckpt_path: str = ""
    logging_folder: str = "logs/SiT"
    ssl_weights_path: str = ""
    imagenet_weights: str = ""
    raw: dict = dataclasses.field(default_factory=dict, hash=False, compare=False)

    @property
    def is_pretraining(self) -> bool:
        return self.mpp is not None


def _get(d: dict, path: str, default=...):
    """The value at dotted ``path``, else ``default``; a KeyError where
    there is no default."""
    cur = d
    for key in path.split("."):
        if not isinstance(cur, dict) or key not in cur:
            if default is ...:
                raise KeyError(f"missing config key: {path}")
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
        dropout=float(t.get("dropout", 0.0)),
        emb_dropout=float(t.get("emb_dropout", 0.0)),
    )
    opt_name = _get(raw, "optimisation.optimiser", "SGD")
    opt_block = raw.get(opt_name, {})
    optim = OptimConfig(
        name=opt_name,
        lr=float(_get(raw, "training.LR", 1e-5)),
        weight_decay=float(opt_block.get("weight_decay", 0.0)),
        momentum=float(opt_block.get("momentum", 0.9)),
        nesterov=bool(opt_block.get("nesterov", False)),
        schedule=_get(raw, "optimisation.schedule", "constant"),
        step_size=int(_get(raw, "StepLR.stepsize", 1000)),
        step_decay=float(_get(raw, "StepLR.decay", 0.5)),
        cosine_t_max=int(_get(raw, "CosineDecay.T_max", 5000)),
        cosine_eta_min=float(_get(raw, "CosineDecay.eta_min", 1e-4)),
        warmup_steps=int(_get(raw, "optimisation.warmup_steps", 0)),
        grad_clip=float(_get(raw, "optimisation.grad_clip", 0.0)),
    )
    tr = raw.get("training", {})
    training = TrainingConfig(
        bs=int(tr.get("bs", 256)),
        bs_val=int(tr.get("bs_val", 0)),
        grad_accum=int(tr.get("grad_accum", 1)),
        ema=float(tr.get("ema", 0.0)),
        ckpt_every=int(tr.get("ckpt_every", 0)),
        epochs=int(tr.get("epochs", 100)),
        val_epoch=int(tr.get("val_epoch", 10)),
        l1loss=bool(tr.get("l1loss", False)),
        testing=bool(tr.get("testing", False)),
        save_ckpt=bool(tr.get("save_ckpt", True)),
        finetuning=bool(tr.get("finetuning", True)),
        load_weights_ssl=bool(tr.get("load_weights_ssl", False)),
        load_weights_imagenet=bool(tr.get("load_weights_imagenet", False)),
        dataset_ssl=tr.get("dataset_ssl", "dhcp"),
        seed=int(tr.get("seed", 0)),
    )
    d = raw.get("data", {})
    streaming = d.get("streaming", "auto")
    if isinstance(streaming, bool):  # YAML `streaming: true`
        streaming = "on" if streaming else "off"
    data = DataConfig(
        data_path=d.get("data_path", ""),
        task=d.get("task", "scan_age"),
        configuration=d.get("configuration", "template"),
        split=d.get("split", "train"),
        streaming=str(streaming),
        streaming_budget_gb=float(d.get("streaming_budget_gb", 8.0)),
    )
    tp = raw.get("tpu", {})
    quant = str(tp.get("quant", "none"))
    if quant not in ("none", "int8"):
        raise ValueError(f"tpu.quant must be 'none' or 'int8', got {quant!r}")
    mpp = None
    if "pretraining_mpp" in raw or raw.get("SSL") == "mpp":
        m = raw.get("pretraining_mpp") or {}
        mpp = MPPConfig(
            mask_prob=float(m.get("mask_prob", 0.75)),
            replace_prob=float(m.get("replace_prob", 0.8)),
            swap_prob=float(m.get("swap_prob", 0.02)),
            optimize_decoder=bool(m.get("optimize_decoder", True)),
        )
    ms = raw.get("mssit", {})
    mssit = MSSiTConfig(
        embed_dim=int(ms.get("embed_dim", 96)),
        depths=tuple(int(d) for d in ms.get("depths", (2, 2, 6, 2))),
        heads=tuple(int(h) for h in ms.get("heads", (3, 6, 12, 24))),
        window=int(ms.get("window", 64)),
        global_max=int(ms.get("global_max", 512)),
        cross_mix=str(ms.get("cross_mix", "axial")),
        mlp_ratio=float(ms.get("mlp_ratio", 4.0)),
    )
    aug = raw.get("augmentation") or {}
    return Experiment(
        model=model,
        training=training,
        data=data,
        optim=optim,
        mssit=mssit,
        compute_dtype=str(tp.get("compute_dtype", "bfloat16")),
        quant=quant,
        mpp=mpp,
        fused_train=bool(tp.get("fused_train", True)),
        mesh_data=int(tp.get("mesh_data", -1)),
        mesh_fsdp=int(tp.get("mesh_fsdp", 1)),
        mesh_model=int(tp.get("mesh_model", 1)),
        mesh_pipe=int(tp.get("mesh_pipe", 1)),
        pipe_microbatches=int(tp.get("pipe_microbatches", 0)),
        seq_sharding=bool(tp.get("seq_sharding", False)),
        profile_epoch=int(tp.get("profile_epoch", -1)),
        debug_nans=bool(tp.get("debug_nans", False)),
        augment=AugmentConfig(
            enabled=bool(aug.get("enabled", False)),
            exact_rotations=bool(aug.get("exact_rotations", True)),
            num_warps=int(aug.get("num_warps", 8)),
            max_warp_deg=float(aug.get("max_warp_deg", 15.0)),
            warp_prob=float(aug.get("warp_prob", 0.5)),
            warp_per_batch=bool(aug.get("warp_per_batch", False)),
            warp_assign=str(aug.get("warp_assign", "quota")),
            seed=int(aug.get("seed", 0)),
            sphere_path=str(aug.get("sphere_path", "")),
        ),
        ico=ico,
        sub_ico=sub_ico,
        ckpt_path=str(_get(raw, "testing.path_to_ckpt", "")),
        logging_folder=str(_get(raw, "logging.folder_to_save_model", "logs/SiT")),
        ssl_weights_path=str(_get(raw, "weights.ssl_mpp", "")),
        imagenet_weights=str(_get(raw, "weights.imagenet", "")),
        raw=raw,
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


def dump_config_with_results(exp: Experiment, results: dict,
                             path: str | os.PathLike) -> None:
    """The run's config with a ``results`` block, as YAML (the JAX
    package's ``hparams_results.yml``)."""
    import yaml

    out = dict(exp.raw)
    out["results"] = results
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(out, f, sort_keys=False)
