"""The last training keys of the JAX package in the port, on the CPU against
the JAX package: ``tpu.profile_epoch`` (``obs.logging.profile_trace``: one
epoch's ``torch.profiler`` trace where JAX writes its ``jax.profiler`` one),
``tpu.debug_nans`` (``FloatingPointError`` at the first step or evaluation
batch with a NaN, as ``jax_debug_nans`` raises), the TensorBoard scalars of
``MetricLogger``, and the mesh's CUDA default.

Size: SiT at dim 32, depth 2, 2 heads (``make_regression_dataset(14,
seed=3)``: 8 training samples, one step an epoch, and 6 validation ones), 2
epochs in float32; MS-SiT at ICO 2 / LEVEL 1, embed 32, heads (1, 2), one
block a stage (dh 32), 4 + 2 raw surfaces. The two packages draw their own
initial weights, so the runs are compared by what they write and raise,
not by their numbers; within each package a clean run with
``tpu.debug_nans`` is held to the run without it bit for bit. The JAX
MS-SiT run profiles epoch 1 only: JAX's trace of a first epoch records its
compilation (about 12 s here), and its epoch rule is the SiT run's, which
both epochs check; the port's MS-SiT is checked at both.
"""

import json
import socket
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from surface_vision_transformers_tpu.obs.logging import MetricLogger as JaxMetricLogger
from surface_vision_transformers_tpu.train import runner as jax_runner
from surface_vision_transformers_tpu.utils.config import from_dict as jax_from_dict
from surface_vision_transformers_tpu_torch import parallel
from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
from surface_vision_transformers_tpu_torch.obs.logging import MetricLogger, profile_trace
from surface_vision_transformers_tpu_torch.train import runner
from surface_vision_transformers_tpu_torch.train.trainer import nan_anomaly
from surface_vision_transformers_tpu_torch.utils.config import from_dict

REPO = Path(__file__).resolve().parent.parent
TRANSFORMER = dict(dim=32, depth=2, heads=2, mlp_dim=64, dim_head=16)
MSSIT = {"resolution": {"ico": 2, "sub_ico": 1},
         "mssit": {"embed_dim": 32, "depths": [1, 1], "heads": [1, 2], "window": 4,
                   "global_max": 2}}


def _cfg(root, profile_epoch=-1, debug_nans=False, save_ckpt=False):
    return {"resolution": {"ico": 6, "sub_ico": 2}, "transformer": dict(TRANSFORMER),
            "training": {"bs": 8, "bs_val": 4, "epochs": 2, "val_epoch": 1, "LR": 2e-3,
                         "seed": 0, "save_ckpt": save_ckpt},
            "optimisation": {"optimiser": "SGD"}, "SGD": {"momentum": 0.9},
            "logging": {"folder_to_save_model": str(root)}, "data": {"streaming": "off"},
            "tpu": {"compute_dtype": "float32", "profile_epoch": profile_epoch,
                    "debug_nans": debug_nans}}


def _mssit_cfg(root, profile_epoch):
    raw = yaml.safe_load((REPO / "configs/training/mssit_scan_age.yml").read_text())
    raw.update(MSSIT)
    raw["training"].update(bs=4, bs_val=2, epochs=2, val_epoch=1, save_ckpt=False)
    raw["logging"] = {"folder_to_save_model": str(root)}
    raw["data"] = {"streaming": "off"}
    raw["tpu"] = {"compute_dtype": "float32", "profile_epoch": profile_epoch}
    return raw


def _data(nan_in=None):
    """8 training and 6 validation samples; a NaN in training sample 2 or
    validation sample 1 where asked."""
    d, lab = make_regression_dataset(14, seed=3)
    if nan_in == "train":
        d[2, 0, 0, 0] = np.nan
    if nan_in == "validation":
        d[9, 1, 5, 7] = np.nan
    return {"train": (d[:8], lab[:8]), "validation": (d[8:], lab[8:])}


def _mssit_data():
    r = np.random.default_rng(4)
    d = r.standard_normal((6, 4, 162)).astype(np.float32)
    lab = r.uniform(30, 45, 6).astype(np.float32)
    return {"train": (d[:4], lab[:4]), "validation": (d[4:], lab[4:])}


def _both(raw, datasets, packages=("jax", "torch")):
    """{package: run_training's results, or the exception it raised}; the
    JAX NaN sanitizer is switched off again after (JAX's runner leaves it
    on for the process)."""
    out = {}
    for name, run in (("jax", lambda: jax_runner.run_training(
            jax_from_dict(_in(raw, "jax")), datasets=datasets, progress=False)),
                      ("torch", lambda: runner.run_training(
            from_dict(_in(raw, "torch")), datasets=datasets, device="cpu", progress=False))):
        if name not in packages:
            continue
        try:
            out[name] = run()
        except Exception as e:  # noqa: BLE001 -- compared by the tests
            out[name] = e
        finally:
            jax.config.update("jax_debug_nans", False)
    return out


def _in(raw, package):
    """``raw`` logging into a folder of the package's own."""
    root = Path(raw["logging"]["folder_to_save_model"]) / package
    return {**raw, "logging": {"folder_to_save_model": str(root)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs: 'clean' (no key), 'debug' (tpu.debug_nans on a
    clean split, tpu.profile_epoch 1), 'val_nan' (a NaN validation sample,
    key off, tpu.profile_epoch 0), 'train_nan_debug' / 'val_nan_debug' (a
    NaN with the key on), and MS-SiT at tpu.profile_epoch 1 (and 0, the
    port alone). The clean pair saves checkpoints, for its final
    parameters."""
    tmp = tmp_path_factory.mktemp("tail")
    with pytest.MonkeyPatch.context() as mp:  # no events: these runs are read otherwise
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        return _runs(tmp)


def _runs(tmp):
    specs = {"clean": (_cfg(tmp / "clean", save_ckpt=True), _data()),
             "debug": (_cfg(tmp / "debug", 1, True, save_ckpt=True), _data()),
             "val_nan": (_cfg(tmp / "val_nan", 0), _data("validation")),
             "train_nan_debug": (_cfg(tmp / "tnd", -1, True), _data("train")),
             "val_nan_debug": (_cfg(tmp / "vnd", -1, True), _data("validation")),
             "mssit_1": (_mssit_cfg(tmp / "ms1", 1), _mssit_data()),
             "mssit_0": (_mssit_cfg(tmp / "ms0", 0), _mssit_data(), ("torch",))}
    return {k: _both(*spec) for k, spec in specs.items()}


def _profile_files(result) -> list:
    return sorted(p for p in (Path(result["run_dir"]) / "profile").rglob("*") if p.is_file())


@pytest.mark.parametrize("model,epoch", [("sit", 0), ("sit", 1), ("mssit", 0), ("mssit", 1)])
def test_profile_epoch_traces_that_epoch_only(runs, model, epoch):
    """Both packages write ``profile/`` for the asked epoch of two (the
    MS-SiT run at epoch 0: the port alone): JAX its xplane and trace under
    ``plugins/profile/<date>/``, the port one Chrome trace for the process,
    which parses and holds that one epoch's ops (one permutation, one
    optimizer step)."""
    key = {("sit", 0): "val_nan", ("sit", 1): "debug"}.get((model, epoch), f"mssit_{epoch}")
    got = runs[key]
    if "jax" in got:
        jax_files = _profile_files(got["jax"])
        assert any(p.name.endswith(".xplane.pb") for p in jax_files), jax_files
    torch_files = _profile_files(got["torch"])
    assert [p.name for p in torch_files] == [f"{socket.gethostname()}.rank0.pt.trace.json"]
    events = json.loads(torch_files[0].read_text())["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert sum(n.startswith("Optimizer.step#") for n in names) == 1  # n == bs: one step
    assert any(n.startswith("aten::randperm") for n in names)
    assert any(n.startswith("aten::linear") or n.startswith("aten::addmm") for n in names)


def test_no_profile_without_the_key(runs):
    for package in ("jax", "torch"):
        assert not (Path(runs["clean"][package]["run_dir"]) / "profile").exists(), package


def test_profile_trace_off_does_nothing(tmp_path):
    with profile_trace(tmp_path / "p", enabled=False):
        torch.ones(3).sum()
    assert not (tmp_path / "p").exists()


def test_debug_nans_raises_on_a_nan_training_sample(runs):
    """With the key on both packages raise ``FloatingPointError`` within the
    first step, not the end-of-epoch check's 'non-finite training loss'."""
    for package, err in runs["train_nan_debug"].items():
        assert isinstance(err, FloatingPointError), (package, err)
        assert "non-finite training loss" not in str(err), (package, err)
    assert "step 0" in str(runs["train_nan_debug"]["torch"])


def test_debug_nans_on_a_nan_validation_sample(runs):
    """A NaN validation sample: with the key both packages raise at the
    first validation; without it both finish, their best MAE inf."""
    for package, err in runs["val_nan_debug"].items():
        assert isinstance(err, FloatingPointError), (package, err)
    assert "evaluation batch 0" in str(runs["val_nan_debug"]["torch"])
    for package, res in runs["val_nan"].items():
        assert res["best_mae"] == float("inf") and res["training_finished"], (package, res)


def test_debug_nans_leaves_a_clean_run_bitwise_unchanged(runs):
    """On clean data each package's run with the key (and a profiled
    epoch) ends on the parameters of its run without it, bit for bit."""
    for package in ("jax", "torch"):
        a = np.load(Path(runs["clean"][package]["run_dir"]) / "final_params.npz")
        b = np.load(Path(runs["debug"][package]["run_dir"]) / "final_params.npz")
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{package} {k}")
        assert runs["clean"][package]["best_mae"] == runs["debug"][package]["best_mae"]


def test_nan_anomaly_names_the_node_and_raises_floating_point_error():
    """A backward whose NaN arises in a node (sqrt at 0, times 0: a finite
    loss) raises ``FloatingPointError`` naming that node; off, it runs."""
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(FloatingPointError, match="step 4.*SqrtBackward0"):
        with nan_anomaly(True, "the backward of step 4"):
            (x.sqrt() * 0).sum().backward()
    with nan_anomaly(False, "unused"):
        (x.sqrt() * 0).sum().backward()
    assert torch.isnan(x.grad).all()


def _records():
    return [(0, {"loss": 1.5, "mae": 2, "note": "text", "flag": True}, "train/"),
            (0, {"mae": 2.25}, "val/"), (1, {"loss": 0.75, "mae": 1.0}, "train/"),
            (1, {"mae": 1.5, "n": 6}, "val/")]


@pytest.fixture
def no_tensorflow(monkeypatch):
    """TensorBoard writes its events with its own stub where TensorFlow is
    not imported yet (importing it takes seconds here; nothing reads it)."""
    if "tensorflow" not in sys.modules:
        monkeypatch.setitem(sys.modules, "tensorflow", None)


def _triples(run_dir: Path) -> set:
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(run_dir))
    acc.Reload()
    return {(tag, e.step, e.value) for tag in acc.Tags()["scalars"] for e in acc.Scalars(tag)}


def test_tensorboard_scalars_match_jax(tmp_path, no_tensorflow):
    """Fed the same records, both loggers write the same (tag, step, value)
    triples: int and float (and bool) scalars only, tag ``prefix + key``."""
    for name, cls in (("jax", JaxMetricLogger), ("torch", MetricLogger)):
        log = cls(tmp_path / name)
        for step, scalars, prefix in _records():
            log.log(step, scalars, prefix=prefix)
        log.close()
    got, want = _triples(tmp_path / "torch"), _triples(tmp_path / "jax")
    assert got == want and len(got) == 8
    assert ("train/flag", 0, 1.0) in got and not any(t[0] == "train/note" for t in got)


def test_no_events_when_disabled_or_without_tensorboard(tmp_path, monkeypatch):
    """A disabled logger (a rank other than 0) writes nothing; without
    ``torch.utils.tensorboard`` both packages write their CSV and JSONL and
    no event file."""
    off = MetricLogger(tmp_path / "off", enabled=False)
    off.log(0, {"loss": 1.0}, prefix="train/")
    off.close()
    assert not (tmp_path / "off").exists()
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    for name, cls in (("jax", JaxMetricLogger), ("torch", MetricLogger)):
        log = cls(tmp_path / name)
        log.log(0, {"loss": 1.0}, prefix="train/")
        log.close()
        files = sorted(p.name for p in (tmp_path / name).iterdir())
        assert files == ["metrics.jsonl", "metrics_train.csv"], (name, files)


def test_a_mesh_asks_for_cuda_by_default(monkeypatch):
    """``make_mesh`` without a device type makes a CUDA mesh and, without
    CUDA, raises as a CUDA device request does (no silent CPU mesh); a CPU
    mesh is asked for by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA mesh"):
        parallel.make_mesh(1, 1, 1, devices=1)
    with pytest.raises(RuntimeError, match="CUDA mesh"):
        parallel.mesh_from_config({"mesh_data": -1}, devices=2)
