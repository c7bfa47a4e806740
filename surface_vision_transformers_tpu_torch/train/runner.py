"""Training and test-time workflows for regression and MPP configs
(counterparts of ``surface_vision_transformers_tpu.train.runner.
run_training`` and ``run_testing``).

``run_training``: load the splits, build the model (seeded init, or the
``weights.ssl_mpp`` npz / .pth under ``training.load_weights_ssl``; an MPP
run initialised from a SiT checkpoint nests it as its encoder), train epoch
by epoch with ``train.trainer.Trainer``, validate every
``training.val_epoch`` epochs and at the last, and keep the best by the val
MAE (regression) or the val loss (MPP). Under ``training.save_ckpt`` each
improvement writes at once ``best/`` (the full training state,
``checkpoints.state``), ``best_params.npz`` (the weights evaluation used, in
the JAX package's params-npz format) and, for MPP, ``encoder_best_params.npz``
(the encoder alone, for finetuning); regression also writes ``preds.csv``.
``training.ckpt_every`` writes the rolling ``last/`` every that many epochs;
the end of the run writes ``final/``, ``final_params.npz`` (and
``encoder_final_params.npz``), ``hparams_results.yml`` (the config plus
results and ``phases_s``) and, under ``training.testing``, the test metric
(regression also ``test_preds.csv``) from ``best/`` where it exists, else
from the final state. ``resume_from`` (``--resume RUN_DIR``) continues a run
in its folder from the checkpoint with the highest epoch, its best-so-far
restored, on the same trajectory. ``augmentation.enabled`` augments the
training batches (``data.augment.SurfaceAugment``; an atlas-ordered patch
table needs ``augmentation.sphere_path``); ``data.streaming`` trains and
validates from memmapped splits through ``data.pipeline.StreamingLoader``.
An MS-SiT config (``transformer.model: MS-SiT``) trains an ``MSSiT``, or
under MPP an ``MPPMSSiT`` around one; its npz files are JAX ``MSSiT`` /
``MPPMSSiT`` trees. ``training.load_weights_imagenet`` with
``weights.imagenet`` set lays a local timm ViT state dict over a SiT's
blocks (with the flag alone, the seeded init, as in the JAX package).
``tpu.mesh_{data,fsdp,model,pipe}`` (or more than one process) train under
a mesh (``parallel.mesh_from_config``; ``train.trainer`` says how; with
``tpu.seq_sharding`` the 'model' axis splits the tokens): every rank
computes, rank 0 alone writes files and prints (full-state checkpoints
gathered whole), and the results gain ``mesh``; FSDP composes with each
other axis. ``tpu.profile_epoch`` records that epoch's training with
``obs.logging.profile_trace`` (a Chrome trace a process under
``profile/``); ``tpu.debug_nans`` makes the trainer raise
``FloatingPointError`` at the first step or evaluation batch with a NaN
(``train.trainer``); the metrics also go to TensorBoard where it imports.
Not ported (it raises, as the JAX transfer fails there): ImageNet
initialisation of an MS-SiT or MPP model.

``run_testing``: load a split and a checkpoint (a params npz, a reference
.pth, or a run folder, whose ``best/`` it takes, as the JAX package does);
regression serves it
through ``predict`` (bfloat16: the fused blocks, ``tpu.quant`` under the
crossover rule, ``serving_quant``; float32: the modular model; an MS-SiT
config the same way, its stages gating int8 by width), reports the
MAE and writes ``results.csv`` of (pred, target) rows in split order; MPP
reports the loss under the evaluation's fixed corruption and writes
nothing. In a process group with ``tpu.mesh_pipe > 1`` it evaluates
through the pipeline's schedule (``Trainer.evaluate`` under the mesh)
instead.
"""

from __future__ import annotations

import csv
import math
import time
from pathlib import Path

import numpy as np
import torch

from surface_vision_transformers_tpu_torch.checkpoints.convert import (
    MSSIT_ENCODER,
    encoder_state,
    imagenet_state_from_timm,
    is_mpp_mssit_tree,
    is_mpp_state,
    is_mssit_tree,
    jax_params_from_mpp_mssit_state_dict,
    jax_params_from_mpp_state_dict,
    jax_params_from_mssit_state_dict,
    jax_params_from_state_dict,
    load_params_npz,
    load_torch_state_dict,
    mpp_mssit_state_dict_from_jax,
    mpp_state,
    mpp_state_dict_from_jax,
    mssit_state_dict_from_jax,
    save_params_npz,
    state_dict_from_jax,
)
from surface_vision_transformers_tpu_torch.checkpoints import state as ckpt
from surface_vision_transformers_tpu_torch.data import gifti
from surface_vision_transformers_tpu_torch.data import npy as npy_io
from surface_vision_transformers_tpu_torch.data.augment import SurfaceAugment
from surface_vision_transformers_tpu_torch.data.pipeline import StreamingLoader
from surface_vision_transformers_tpu_torch.geometry import load_patch_table
from surface_vision_transformers_tpu_torch.models.fused import _device, predict, serving_quant
from surface_vision_transformers_tpu_torch.models.mpp import MPP
from surface_vision_transformers_tpu_torch.models.mpp_mssit import MPPMSSiT
from surface_vision_transformers_tpu_torch.models.mssit import MSSiT
from surface_vision_transformers_tpu_torch.models.sit import SiT
from surface_vision_transformers_tpu_torch.obs.logging import (
    MetricLogger,
    profile_trace,
    run_folder_name,
)
from surface_vision_transformers_tpu_torch.parallel.mesh import mesh_from_config, mesh_shape
from surface_vision_transformers_tpu_torch.parallel.multihost import is_primary
from surface_vision_transformers_tpu_torch.train.trainer import Trainer, evaluate_mpp
from surface_vision_transformers_tpu_torch.utils.config import (
    Experiment,
    dump_config_with_results,
)


def load_state_dict_any(path: str, depth: int) -> dict:
    """Reference-layout state dict (SiT, or MPP when the file holds one; the
    port's MS-SiT / MPP-MS-SiT layout for such a tree) from a JAX params
    ``.npz`` or a ``.pt``/``.pth`` file. Orbax checkpoint directories need
    JAX to read and are refused."""
    p = Path(path)
    if p.is_dir():
        raise ValueError(
            f"{p} is a directory (an Orbax checkpoint?); the PyTorch port reads "
            "params .npz files (e.g. best_params.npz in the run folder) or "
            "reference .pt/.pth state dicts")
    if p.suffix == ".npz":
        tree = load_params_npz(p)
        tree = tree.get("params", tree)
        if is_mpp_mssit_tree(tree):
            return mpp_mssit_state_dict_from_jax(tree)
        if "mask_token" in tree:
            return mpp_state_dict_from_jax(tree, depth)
        if is_mssit_tree(tree):
            return mssit_state_dict_from_jax(tree)
        return state_dict_from_jax(tree, depth)
    return load_torch_state_dict(p)


def checkpoint_weights(path: str, depth: int) -> dict:
    """The weights at ``testing.path_to_ckpt``: a run folder or one of its
    checkpoint directories (``best/`` first where there is one, as the JAX
    ``run_testing`` restores it) gives its evaluation weights, the EMA
    shadow where the run kept one; a file goes to ``load_state_dict_any``."""
    p = Path(path)
    for d in (p / "best", p):
        if (d / "state.pt").exists():
            state = ckpt.load_state(d)[0]
            return state["ema"] or state["model"]
    return load_state_dict_any(path, depth)


def build_model(exp: Experiment, table=None) -> SiT | MSSiT | MPP | MPPMSSiT:
    """The config's model with float32 parameters: a SiT (an MSSiT under
    ``transformer.model: MS-SiT``), wrapped in an MPP (an MPPMSSiT) for an
    MPP config."""
    mssit = exp.model.model == "MS-SiT"
    model = (MSSiT if mssit else SiT).from_config(exp, patch_table=table)
    if exp.is_pretraining:
        m = exp.mpp
        model = (MPPMSSiT if mssit else MPP)(model, mask_prob=m.mask_prob,
                                             replace_prob=m.replace_prob,
                                             swap_prob=m.swap_prob)
    return model


# The keys of an MPP's encoder head, which MPP never runs and the JAX MPP
# trees do not hold.
_MPP_ENCODER_HEAD = ("transformer.mlp_head.", "encoder.head_norm.", "encoder.head.")


def load_model_state(model, state: dict) -> None:
    """Load ``state`` strictly; an MPP's encoder head keeps the model's
    values where the state lacks it."""
    if isinstance(model, (MPP, MPPMSSiT)):
        own = {k: v for k, v in model.state_dict().items() if k.startswith(_MPP_ENCODER_HEAD)}
        state = {**own, **state}
    model.load_state_dict(state, strict=True)


def _as_layout(state: dict, model) -> dict:
    """``state`` in ``model``'s layout: an MPP checkpoint's encoder for a
    SiT or an MS-SiT, an encoder's checkpoint nested in an MPP."""
    if isinstance(model, MPP):
        return state if is_mpp_state(state) else mpp_state(state)
    if isinstance(model, MPPMSSiT):
        return state if is_mpp_state(state) else mpp_state(state, MSSIT_ENCODER)
    return encoder_state(state)


def write_preds_csv(path, preds, targets) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["pred", "target"])
        for p, t in zip(np.asarray(preds).ravel(), np.asarray(targets).ravel()):
            w.writerow([float(p), float(t)])


def run_testing(exp: Experiment, *, device) -> dict:
    """Evaluate on ``exp.data.split`` (default 'validation') at
    ``training.bs_val`` (0 -> ``training.bs``) on ``device``, with the
    weights at ``testing.path_to_ckpt`` (loaded strictly). MPP configs
    report the reconstruction loss (``loss``) and write no results.csv.
    ``testing.path_to_ckpt`` names a params npz, a reference .pth, or a run
    folder (``checkpoint_weights``), beside which results.csv goes."""
    if not exp.is_pretraining and exp.model.num_classes != 1:
        raise NotImplementedError("run_testing covers scalar regression and MPP configs")
    if not exp.ckpt_path:
        raise ValueError(
            "run_testing needs weights: set testing.path_to_ckpt (a params "
            ".npz or a reference .pth)")
    split = exp.data.split or "validation"
    data, labels = npy_io.load_split(exp.data.resolved_data_path(), split)

    table = None
    if data.ndim == 3:
        table = load_patch_table(exp.ico, exp.sub_ico).indices
    model = build_model(exp, table)
    load_model_state(model, _as_layout(checkpoint_weights(exp.ckpt_path, exp.model.depth),
                                       model))
    model.eval()
    bs = exp.training.bs_val or exp.training.bs
    if exp.mesh_pipe > 1 and torch.distributed.is_initialized() and not exp.is_pretraining:
        return _pipe_testing(exp, model, data, labels, split, device)
    if exp.is_pretraining:
        dev = _device(device)
        model.to(dev)
        tokens = model.target(torch.from_numpy(data).to(dev))
        return {"n": int(data.shape[0]), "split": split,
                "loss": evaluate_mpp(model, tokens, bs)}

    preds = predict(model, data, device=device, batch_size=bs,
                    quant=serving_quant(model, exp.quant)).reshape(-1)

    out_dir = Path(exp.ckpt_path)
    if out_dir.is_file() or out_dir.suffix in (".npz", ".pt", ".pth"):
        out_dir = out_dir.parent
    if is_primary():
        out_dir.mkdir(parents=True, exist_ok=True)
        write_preds_csv(out_dir / "results.csv", preds, labels)
    return {"n": int(data.shape[0]), "split": split,
            "mae": float(np.mean(np.abs(preds - labels.reshape(-1))))}


def _pipe_testing(exp: Experiment, model, data, labels, split: str, device) -> dict:
    """``run_testing`` in a pipeline: the model laid out on the config's
    mesh (each stage its blocks) and the split evaluated through the
    schedule's forward; rank 0 writes results.csv."""
    dev = _device(device)
    trainer = Trainer(exp, model.to(dev), mesh=_resolve_mesh(exp, dev))
    put = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    metrics, preds = trainer.evaluate(put(data), put(labels))
    out_dir = Path(exp.ckpt_path)
    if out_dir.is_file() or out_dir.suffix in (".npz", ".pt", ".pth"):
        out_dir = out_dir.parent
    if is_primary():
        out_dir.mkdir(parents=True, exist_ok=True)
        write_preds_csv(out_dir / "results.csv", preds, labels)
    return {"n": int(data.shape[0]), "split": split,
            "mae": float(np.mean(np.abs(preds - labels.reshape(-1))))}


def load_datasets(exp: Experiment, splits=None) -> dict:
    """{split: (data, labels)} from the configured data path: train and
    validation, and test under ``training.testing``. Under
    ``data.streaming`` 'on' or 'auto' the data come back as read-only
    memmaps, read only as batches are taken (or whole, where 'auto' keeps
    them on the device)."""
    if splits is None:
        splits = ("train", "validation") + (("test",) if exp.training.testing else ())
    path = exp.data.resolved_data_path()
    mmap = exp.data.streaming != "off"
    return {s: npy_io.load_split(path, s, mmap=mmap) for s in splits}


def use_streaming(exp: Experiment, train_data) -> bool:
    """``data.streaming``: 'on' / 'off' as said; 'auto' streams when the
    device-resident epoch, the split and its permuted copy in float32,
    exceeds ``data.streaming_budget_gb``."""
    mode = exp.data.streaming
    if mode != "auto":
        return mode == "on"
    bytes_f32 = int(np.prod(np.shape(train_data))) * 4
    return 2 * bytes_f32 > exp.data.streaming_budget_gb * 2**30


def build_augment(exp: Experiment, table_obj) -> SurfaceAugment | None:
    """The config's ``SurfaceAugment`` (None when augmentation is off). A
    given ``augmentation.sphere_path`` supplies the sphere's coordinates and
    triangles in the data's vertex order; an atlas-ordered patch table
    without one is refused, as in the JAX package."""
    a = exp.augment
    if not a.enabled:
        return None
    verts = faces = None
    if a.sphere_path:
        img = gifti.load(a.sphere_path)
        verts = np.asarray(img.darrays[0].data, np.float64)
        verts /= np.linalg.norm(verts, axis=1, keepdims=True)
        faces = np.asarray(img.darrays[1].data, np.int64)
    elif table_obj.ordering != "canonical":
        raise ValueError(
            "augmentation with an atlas-ordered patch table (e.g. the "
            "shipped dHCP tables) needs the matching sphere coordinates: "
            "set augmentation.sphere_path to the atlas sphere .surf.gii "
            "(for dHCP data that's the ico-6 sphere shipped with every "
            "dHCP download, e.g. "
            "week-40_hemi-left_space-dhcpSym_dens-ico6_sphere.surf.gii). "
            "The atlas numbering is not recoverable from the patch "
            "tables (see assets/README.md); rotation tables built from "
            "the canonical icosphere would scramble atlas-ordered data.")
    return SurfaceAugment(
        ico=exp.ico, patch_table=table_obj.indices, exact_rotations=a.exact_rotations,
        num_warps=a.num_warps, max_warp_deg=a.max_warp_deg, warp_prob=a.warp_prob,
        warp_per_batch=a.warp_per_batch, warp_assign=a.warp_assign, seed=a.seed,
        mesh_verts=verts, mesh_faces=faces)


def _refuse_unported(exp: Experiment) -> None:
    """Raise on what the config asks that the port does not do: ImageNet
    initialisation of anything but a SiT regression model (the JAX transfer
    maps a SiT's blocks only, and fails on the others)."""
    if (_imagenet_path(exp) and (exp.model.model == "MS-SiT" or exp.is_pretraining)):
        raise NotImplementedError(
            "ImageNet initialisation maps timm ViT blocks onto a SiT regression model only "
            "(the JAX transfer has no mapping for an MS-SiT or an MPP model)")


def _imagenet_path(exp: Experiment) -> str:
    """The timm state-dict file to initialise from: ``weights.imagenet``
    under ``training.load_weights_imagenet``, else '' (the seeded init, as
    in the JAX package)."""
    return exp.imagenet_weights if exp.training.load_weights_imagenet else ""


def _load_initial_weights(exp: Experiment, model) -> None:
    """``training.load_weights_ssl``: the parameters that ``weights.ssl_mpp``
    (a params npz or a reference .pth, SiT or MPP) shares with the model;
    then ``training.load_weights_imagenet`` with ``weights.imagenet`` set:
    the timm ViT blocks and final norm of that local state-dict file laid
    over them (``imagenet_state_from_timm``), as the JAX runner does."""
    if exp.training.load_weights_ssl and exp.ssl_weights_path not in ("", ".."):
        state = _as_layout(load_state_dict_any(exp.ssl_weights_path, exp.model.depth), model)
        own = model.state_dict()
        shared = {k: v for k, v in state.items() if k in own}
        if not shared:
            raise ValueError(
                f"SSL checkpoint {exp.ssl_weights_path!r} shares no parameter with "
                "the model (wrong depth/format?)")
        model.load_state_dict(shared, strict=False)
    if _imagenet_path(exp):
        timm = load_torch_state_dict(_imagenet_path(exp))
        model.load_state_dict(imagenet_state_from_timm(model.state_dict(), timm,
                                                       exp.model.depth))


def _save_npz(path: Path, model, depth: int, state: dict | None = None) -> None:
    """``model``'s params npz (of ``state``, its state dict, where given),
    a JAX tree of its kind; an MPP's (an MPPMSSiT's) encoder alone (without
    the head MPP never runs, as the JAX package writes it) also goes to
    ``encoder_<name>`` beside it, for finetuning."""
    state = model.state_dict() if state is None else state
    if isinstance(model, MSSiT):
        tree = jax_params_from_mssit_state_dict(state, model)
    elif isinstance(model, SiT):
        tree = jax_params_from_state_dict(state, depth)
    elif isinstance(model, MPPMSSiT):
        tree = jax_params_from_mpp_mssit_state_dict(state, model.encoder)
    else:
        tree = jax_params_from_mpp_state_dict(state, depth)
    save_params_npz(path, {"params": tree})
    if "encoder" in tree:
        save_params_npz(path.with_name("encoder_" + path.name), {"params": tree["encoder"]})


def _write_best(run_dir: Path, trainer: Trainer, meta: dict, depth: int) -> None:
    """The best-val set: ``best/`` (full state), ``best_params.npz`` of the
    weights evaluation used (and an MPP's encoder npz). Every rank gathers
    the state; rank 0 writes it."""
    state = trainer.state_dict()
    eval_state = trainer.model_state(trainer.eval_model())
    if is_primary():
        ckpt.save_state(run_dir / "best", state, meta)
        _save_npz(run_dir / "best_params.npz", trainer.eval_model(), depth, eval_state)


def _resolve_mesh(exp: Experiment, dev: torch.device):
    """The run's mesh from ``tpu.mesh_{data,fsdp,model,pipe}`` over the
    world's ranks (None for one process asking for none)."""
    return mesh_from_config(exp, device_type=dev.type)


def _barrier(mesh) -> None:
    if mesh is not None:
        torch.distributed.barrier()


def run_training(exp: Experiment, *, device, datasets: dict | None = None,
                 progress: bool = True, resume_from: str | None = None) -> dict:
    """Supervised regression or MPP training per ``exp`` on ``device`` (a
    CUDA request without CUDA raises). ``resume_from``: an existing run
    folder, continued in place from its newest checkpoint. Returns the
    results dict that also lands in ``hparams_results.yml``."""
    _refuse_unported(exp)
    dev = _device(device)
    mesh = _resolve_mesh(exp, dev)
    primary = is_primary()
    progress = progress and primary
    t_start = time.time()
    phases = {k: 0.0 for k in ("setup", "data_upload", "first_epoch", "train",
                               "val", "ckpt", "test")}
    datasets = datasets or load_datasets(exp)
    for name, (d, lab) in datasets.items():
        if d.shape[0] != np.shape(lab)[0]:
            raise ValueError(f"{name}: {d.shape[0]} samples vs {np.shape(lab)[0]} labels")
    train_data, train_labels = datasets["train"]
    val_data, val_labels = datasets.get("validation", (None, None))

    if resume_from is not None:
        run_dir = Path(resume_from)
        if not run_dir.is_dir():
            raise FileNotFoundError(f"resume_from {run_dir} is not an existing run directory")
    else:
        name = [run_folder_name(exp)]
        if mesh is not None:  # rank 0's clock names the run
            torch.distributed.broadcast_object_list(name, src=0)
        run_dir = Path(exp.logging_folder) / name[0]
        if primary:
            run_dir.mkdir(parents=True, exist_ok=True)
    logger = MetricLogger(run_dir, enabled=primary)
    loaders: list[StreamingLoader] = []
    try:
        table_obj = load_patch_table(exp.ico, exp.sub_ico)
        augment = build_augment(exp, table_obj)
        table = table_obj.indices if train_data.ndim == 3 else None
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(exp.training.seed)
            model = build_model(exp, table)
        _load_initial_weights(exp, model)
        model.to(dev)
        trainer = Trainer(exp, model, augment=augment, mesh=mesh)
        bs_val = exp.training.bs_val or exp.training.bs

        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

        def loader(data, labels, shuffle):
            loaders.append(StreamingLoader(
                data, labels, shuffle=shuffle, seed=exp.training.seed, device=dev,
                batch_size=exp.training.bs if shuffle else bs_val, layout=trainer.layout,
                accum=exp.training.grad_accum if shuffle else 1))
            return loaders[-1]

        streaming = use_streaming(exp, train_data)
        if streaming:
            train_loader = loader(train_data, train_labels, True)
            val_loader = None if val_data is None else loader(val_data, val_labels, False)
        else:
            t_up = time.time()
            d_train, l_train = put(train_data), put(train_labels)
            d_val = l_val = None
            if val_data is not None:
                d_val, l_val = put(val_data), put(val_labels)
            phases["data_upload"] = time.time() - t_up

        depth, epochs = exp.model.depth, exp.training.epochs
        is_mpp = exp.is_pretraining
        metric = "loss" if is_mpp else "mae"
        best, best_epoch, start_epoch = math.inf, -1, 0
        if resume_from is not None:
            name, epoch_at, meta = ckpt.newest(run_dir)
            trainer.load_state_dict(ckpt.load_state(run_dir / name)[0])
            start_epoch = epoch_at + 1
            best = float(meta.get("best", meta.get(metric, math.inf)))
            if math.isnan(best):
                best = math.inf
            # ``best``'s own epoch is its best epoch where the key is missing
            best_epoch = int(meta.get("best_epoch", epoch_at if name == "best" else -1))
            if streaming:
                train_loader.set_epoch(start_epoch)
            if progress:
                print(f"resuming from {run_dir / name} at epoch {start_epoch} "
                      f"(best {metric} {best:.5f})", flush=True)
        phases["setup"] = time.time() - t_start - phases["data_upload"]

        save = exp.training.save_ckpt
        for epoch in range(start_epoch, epochs):
            t_ep = time.time()
            with profile_trace(run_dir / "profile", enabled=epoch == exp.profile_epoch,
                               device=dev):
                m = (trainer.train_epoch_streaming(train_loader) if streaming
                     else trainer.train_epoch(d_train, l_train))
            phases["first_epoch" if epoch == start_epoch else "train"] += time.time() - t_ep
            if not math.isfinite(m.loss):
                raise FloatingPointError(
                    f"non-finite training loss at epoch {epoch}: {m.loss} "
                    "(check data/labels and LR)")
            logger.log(epoch, m.as_dict(), prefix="train/")
            if progress and (epoch % 5 == 0 or epoch == epochs - 1):
                print(f"epoch {epoch}: train loss {m.loss:.5f} {metric} "
                      f"{getattr(m, metric):.5f}", flush=True)
            if val_data is not None and ((epoch + 1) % exp.training.val_epoch == 0
                                         or epoch == epochs - 1):
                t_val = time.time()
                vm, preds = (trainer.evaluate_streaming(val_loader) if streaming
                             else trainer.evaluate(d_val, l_val))
                phases["val"] += time.time() - t_val
                logger.log(epoch, vm.as_dict(), prefix="val/")
                score = getattr(vm, metric)
                if progress:
                    print(f"epoch {epoch}: val {metric} {score:.5f}", flush=True)
                if score < best:
                    best, best_epoch = score, epoch
                    t_ck = time.time()
                    if save:
                        _write_best(run_dir, trainer, {"epoch": epoch, metric: float(score),
                                                       "best": float(score),
                                                       "best_epoch": epoch}, depth)
                    if not is_mpp and primary:
                        write_preds_csv(run_dir / "preds.csv", preds, val_labels)
                    phases["ckpt"] += time.time() - t_ck
            if save and exp.training.ckpt_every and (epoch + 1) % exp.training.ckpt_every == 0:
                t_ck = time.time()
                state = trainer.state_dict()
                if primary:
                    ckpt.save_state(run_dir / "last", state,
                                    {"epoch": epoch, "best": float(best),
                                     "best_epoch": int(best_epoch)})
                phases["ckpt"] += time.time() - t_ck

        t_ck = time.time()
        if save:
            state = trainer.state_dict()
            if primary:
                ckpt.save_state(run_dir / "final", state,
                                {"epoch": epochs - 1, metric: float(best), "best": float(best),
                                 "best_epoch": int(best_epoch)})
                _save_npz(run_dir / "final_params.npz", model, depth, state["model"])
                if best_epoch < 0 and not (run_dir / "best").exists():
                    ckpt.save_state(run_dir / "best", state,
                                    {"epoch": epochs - 1, metric: float("nan"),
                                     "best_epoch": -1})
        phases["ckpt"] += time.time() - t_ck
        results = {f"best_{metric}": float(best), "best_epoch": int(best_epoch),
                   "epochs": int(epochs), "run_dir": str(run_dir),
                   "wall_s": round(time.time() - t_start, 2),
                   "training_finished": True, "streaming": bool(streaming)}
        if mesh is not None:
            results["mesh"] = mesh_shape(mesh)
        if torch.distributed.is_initialized():
            results["process_group"] = {"backend": str(torch.distributed.get_backend()),
                                        "world_size": torch.distributed.get_world_size()}

        if exp.training.testing and "test" in datasets:
            t_test = time.time()
            _barrier(mesh)  # rank 0's files are written
            # the best weights where they were saved, else the final ones (a
            # resumed run whose earlier part never wrote best/ included)
            if save and best_epoch >= 0 and (run_dir / "best" / "state.pt").exists():
                best_state = ckpt.load_state(run_dir / "best")[0]
                trainer.load_model_state(best_state["ema"] or best_state["model"],
                                         trainer.eval_model())
            test_data, test_labels = datasets["test"]
            tm, preds = (trainer.evaluate_streaming(loader(test_data, test_labels, False))
                         if streaming else trainer.evaluate(put(test_data), put(test_labels)))
            if not is_mpp and primary:
                write_preds_csv(run_dir / "test_preds.csv", preds, test_labels)
            results[f"test_{metric}"] = float(getattr(tm, metric))
            phases["test"] = time.time() - t_test

        results["phases_s"] = {k: round(v, 2) for k, v in phases.items()}
        if primary:
            dump_config_with_results(exp, results, run_dir / "hparams_results.yml")
        return results
    finally:
        for ld in loaders:
            ld.close()
        logger.close()
