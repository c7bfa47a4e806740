"""The port's training slice on the CPU against the JAX package: losses,
optimizers and schedules against optax, the trainer's steps against
``SiT.apply`` + optax, ``run_training`` against the JAX ``run_training``,
checkpoints in both directions, config parsing, and ``cli.train`` without
JAX.

Tolerances, float32 throughout (both sides run exact-erf GELU and the
shifted softmax here: the JAX trainer takes its modular path on the CPU):
* optimizer updates: rtol 2e-5, atol 1e-6 (the existing optax-vs-torch
  parity bound of tests/test_optim_parity.py; measured <= 3e-7);
* schedules: rtol 1e-6 (optax evaluates in float32);
* trajectories: losses rtol 1e-4, parameters atol 5e-5 (as
  tests/test_train_trajectory_parity.py; measured <= 4e-7);
* ``run_training``: best val MAE 1e-4 absolute, preds.csv 1e-4 (measured
  3.8e-6 on labels ~35), final parameters 1e-5 (measured 2.4e-7).
"""

import csv
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from surface_vision_transformers_tpu.checkpoints import orbax_io
from surface_vision_transformers_tpu.data.synthetic import (
    make_regression_dataset as jax_make_regression_dataset,
)
from surface_vision_transformers_tpu.models import SiT as JaxSiT
from surface_vision_transformers_tpu.obs.logging import run_folder_name as jax_run_folder_name
from surface_vision_transformers_tpu.train import build_optimizer
from surface_vision_transformers_tpu.train import losses as jax_losses
from surface_vision_transformers_tpu.train import runner as jax_runner
from surface_vision_transformers_tpu.train.optim import build_schedule as jax_build_schedule
from surface_vision_transformers_tpu.train.trainer import _batch_weights
from surface_vision_transformers_tpu.utils import config as jax_config
from surface_vision_transformers_tpu_torch.checkpoints.convert import state_dict_from_jax
from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
from surface_vision_transformers_tpu_torch.models.sit import SiT
from surface_vision_transformers_tpu_torch.obs.logging import MetricLogger, run_folder_name
from surface_vision_transformers_tpu_torch.train import losses, runner
from surface_vision_transformers_tpu_torch.train.optim import Optimizer, build_schedule
from surface_vision_transformers_tpu_torch.train.trainer import Trainer, batch_weights
from surface_vision_transformers_tpu_torch.utils import config

REPO = Path(__file__).resolve().parent.parent
TRANSFORMER = dict(dim=32, depth=2, heads=2, mlp_dim=64, dim_head=16)


# -- losses, batching, data -------------------------------------------------------


@pytest.mark.parametrize("l1", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(l1, weighted):
    r = np.random.default_rng(0)
    p, t = r.standard_normal(9).astype(np.float32), r.standard_normal(9).astype(np.float32)
    w = (r.uniform(size=9) > 0.3).astype(np.float32) if weighted else None
    want = jax_losses.get_loss_fn(l1)(jnp.asarray(p), jnp.asarray(t),
                                      None if w is None else jnp.asarray(w))
    got = losses.get_loss_fn(l1)(torch.from_numpy(p), torch.from_numpy(t),
                                 None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("n,bs", [(10, 4), (8, 8), (9, 3), (5, 7)])
def test_batch_weights_match_jax(n, bs):
    bs = min(bs, n)
    np.testing.assert_array_equal(batch_weights(n, bs), np.asarray(_batch_weights(n, bs)))


def test_synthetic_dataset_is_the_jax_generator():
    for kw in (dict(seed=4), dict(seed=5, raw_vertices=50, noise=0.3)):
        a, b = make_regression_dataset(6, **kw), jax_make_regression_dataset(6, **kw)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


# -- optimizers and schedules -----------------------------------------------------

OPTIMS = {
    "sgd_momentum_wd": dict(name="SGD", lr=0.1, momentum=0.9, weight_decay=1e-2),
    "sgd_nesterov": dict(name="SGD", lr=0.05, momentum=0.9, nesterov=True),
    "sgd_plain": dict(name="SGD", lr=0.05, momentum=0.0),
    "adam_l2": dict(name="Adam", lr=1e-3, weight_decay=1e-2),
    "adamw": dict(name="AdamW", lr=1e-3, weight_decay=5e-2),
    "sgd_clip_step": dict(name="SGD", lr=0.1, momentum=0.9, grad_clip=0.5,
                          schedule="step", step_size=2, step_decay=0.5),
    "adamw_clip_cosine": dict(name="AdamW", lr=1e-2, weight_decay=1e-2, grad_clip=1.0,
                              schedule="cosine", cosine_t_max=4, cosine_eta_min=1e-3),
    "sgd_warmup_cosine": dict(name="SGD", lr=0.1, momentum=0.9, schedule="warmup_cosine",
                              warmup_steps=2, cosine_t_max=5, cosine_eta_min=1e-3),
}


@pytest.mark.parametrize("name", sorted(OPTIMS))
def test_optimizer_matches_optax(name):
    """Six updates of two parameters with seeded gradients, against the JAX
    package's optax chain (weight decay, clipping and schedule included)."""
    kw = OPTIMS[name]
    r = np.random.default_rng(1)
    w0 = {"a": r.standard_normal((4, 5)).astype(np.float32),
          "b": r.standard_normal(3).astype(np.float32)}
    grads = [{k: (2.0 * r.standard_normal(v.shape)).astype(np.float32) for k, v in w0.items()}
             for _ in range(6)]

    tx = build_optimizer(jax_config.OptimConfig(**kw))
    params = {k: jnp.asarray(v) for k, v in w0.items()}
    state = tx.init(params)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, upd)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in w0.items()}
    opt = Optimizer(config.OptimConfig(**kw), tparams.values())
    for g in grads:
        opt.zero_grad()
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in w0:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(params[k]),
                                   rtol=2e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(schedule="constant", lr=0.3),
    dict(schedule="step", lr=0.3, step_size=3, step_decay=0.7),
    dict(schedule="cosine", lr=0.3, cosine_t_max=7, cosine_eta_min=0.01),
    dict(schedule="warmup_cosine", lr=0.3, warmup_steps=3, cosine_t_max=9, cosine_eta_min=0.01),
    dict(schedule="warmup_cosine", lr=0.3, warmup_steps=0, cosine_t_max=6, cosine_eta_min=0.0),
], ids=["constant", "step", "cosine", "warmup_cosine", "warmup_cosine_no_warmup"])
def test_schedules_match_optax(kw):
    want = jax_build_schedule(jax_config.OptimConfig(**kw))
    got = build_schedule(config.OptimConfig(**kw))
    for step in range(12):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-9)


# -- trainer steps ----------------------------------------------------------------

CFG = dict(dim=16, depth=2, heads=2, mlp_dim=32, dim_head=8, num_patches=20,
           num_vertices=15)


def _small_setup(optim=None, **training):
    jmodel = JaxSiT(dtype=jnp.float32, **CFG)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 20, 15))))["params"]
    model = SiT(dtype=torch.float32, **CFG)
    model.load_state_dict(state_dict_from_jax(params, CFG["depth"]), strict=True)
    exp = config.Experiment(
        model=config.ModelConfig(**{k: v for k, v in CFG.items()}),
        training=config.TrainingConfig(**training), data=config.DataConfig(),
        optim=config.OptimConfig(**(optim or dict(name="SGD", lr=1e-3, momentum=0.9))),
        compute_dtype="float32")
    return jmodel, params, model, exp


def test_trainer_steps_match_jax_trajectory():
    """Six SGD-momentum steps of ``Trainer.optimizer_step`` (fp32, CPU)
    against ``SiT.apply`` + the JAX package's optax optimizer from the same
    weights and batches."""
    jmodel, params, model, exp = _small_setup()
    r = np.random.default_rng(0)
    data = r.standard_normal((32, 4, 20, 15)).astype(np.float32)
    labels = r.standard_normal(32).astype(np.float32)
    batches = [(data[:16], labels[:16]), (data[16:], labels[16:])] * 3

    tx = build_optimizer(jax_config.OptimConfig(name="SGD", lr=1e-3, momentum=0.9))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)

    @jax.jit
    def step(p, s, xb, yb):
        def loss_fn(p):
            return jnp.mean((jmodel.apply({"params": p}, xb).squeeze(-1) - yb) ** 2)
        loss, g = jax.value_and_grad(loss_fn)(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    trainer = Trainer(exp, model)
    j_losses, t_losses = [], []
    for xb, yb in batches:
        jp, state, loss = step(jp, state, jnp.asarray(xb), jnp.asarray(yb))
        j_losses.append(float(loss))
        tl, _ = trainer.optimizer_step(torch.from_numpy(xb), torch.from_numpy(yb),
                                       torch.ones(16))
        t_losses.append(float(tl))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4, atol=1e-5)
    assert abs(t_losses[-1] - t_losses[0]) > 1e-3, t_losses
    want = state_dict_from_jax(jax.tree.map(np.asarray, jp), CFG["depth"])
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=5e-5, rtol=1e-4, err_msg=k)


def test_grad_accum_and_ema():
    """Microbatches scaled by their weight sums give the full batch's step
    (weight-0 rows included); the EMA shadow follows e*d + p*(1-d)."""
    r = np.random.default_rng(2)
    xb = torch.from_numpy(r.standard_normal((8, 4, 20, 15)).astype(np.float32))
    yb = torch.from_numpy(r.standard_normal(8).astype(np.float32))
    w = torch.tensor([1, 1, 1, 0, 1, 1, 0, 0], dtype=torch.float32)
    out = {}
    for accum in (1, 2, 4):
        _, _, model, exp = _small_setup(grad_accum=accum, ema=0.9)
        before = [p.detach().clone() for p in model.parameters()]
        tr = Trainer(exp, model)
        loss, mae_sum = tr.optimizer_step(xb, yb, w)
        out[accum] = (float(loss), float(mae_sum), [p.detach().clone() for p in model.parameters()])
        for e, p0, p in zip(tr.ema_model.parameters(), before, model.parameters()):
            torch.testing.assert_close(e, p0 * 0.9 + p.detach() * (1 - 0.9), rtol=0, atol=1e-7)
    for accum in (2, 4):
        np.testing.assert_allclose(out[accum][:2], out[1][:2], rtol=1e-5)
        for a, b in zip(out[accum][2], out[1][2]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("change,match", [
    (dict(mpp=config.MPPConfig()), "MPP"),
    (dict(model=config.ModelConfig(dim=16, depth=2, heads=2, mlp_dim=32, dim_head=8,
                                   num_patches=20, num_vertices=15, num_classes=2)),
     "scalar regression"),
])
def test_unported_training_modes_raise(change, match):
    """Classification heads are not ported; an MPP config trains an MPP,
    not a bare SiT."""
    _, _, model, exp = _small_setup()
    if "model" in change:
        model = SiT(dtype=torch.float32, **{**CFG, "num_classes": 2})
    with pytest.raises((NotImplementedError, TypeError), match=match):
        Trainer(dataclasses.replace(exp, **change), model)


# -- run_training end to end ----------------------------------------------------------


def _train_cfg(root, init_npz, epochs=4):
    return {"resolution": {"ico": 6, "sub_ico": 2}, "transformer": dict(TRANSFORMER),
            "training": {"bs": 8, "bs_val": 4, "epochs": epochs, "val_epoch": 2,
                         "LR": 2e-3, "seed": 0, "load_weights_ssl": True},
            "weights": {"ssl_mpp": str(init_npz)},
            "optimisation": {"optimiser": "SGD"}, "SGD": {"momentum": 0.9},
            "logging": {"folder_to_save_model": str(root)},
            "data": {"streaming": "off", "split": "validation"},
            "tpu": {"compute_dtype": "float32"}}


def _csv(path):
    with open(path) as f:
        return np.array([(float(r["pred"]), float(r["target"])) for r in csv.DictReader(f)])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages' ``run_training`` on n == bs = 8 pre-patched samples
    (one step per epoch, so the shuffles do not matter), 6 validation
    samples at bs_val 4 (a ragged last batch), from the same params npz."""
    tmp = tmp_path_factory.mktemp("train")
    m = JaxSiT(dtype=jnp.float32, num_patches=320, num_vertices=153, **TRANSFORMER)
    init = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 320, 153))))
    orbax_io.save_params_npz(tmp / "init.npz", init)
    d, lab = make_regression_dataset(14, seed=3)
    ds = {"train": (d[:8], lab[:8]), "validation": (d[8:], lab[8:])}
    want = jax_runner.run_training(jax_config.from_dict(_train_cfg(tmp / "jax", tmp / "init.npz")),
                                   datasets=ds, progress=False)
    got = runner.run_training(config.from_dict(_train_cfg(tmp / "torch", tmp / "init.npz")),
                              datasets=ds, device="cpu", progress=False)
    return tmp, ds, init, want, got


def test_run_training_matches_jax(trained):
    tmp, ds, init, want, got = trained
    assert got["best_epoch"] == want["best_epoch"] == 3
    assert abs(got["best_mae"] - want["best_mae"]) < 1e-4
    jdir, tdir = Path(want["run_dir"]), Path(got["run_dir"])
    assert jdir.name == tdir.name or jdir.name[19:] == tdir.name[19:]  # date prefix
    for f in ("best_params.npz", "final_params.npz", "preds.csv", "hparams_results.yml",
              "metrics.jsonl", "metrics_train.csv", "metrics_val.csv"):
        assert (tdir / f).exists(), f
    np.testing.assert_allclose(_csv(tdir / "preds.csv"), _csv(jdir / "preds.csv"), atol=1e-4)
    a = jax.tree_util.tree_flatten_with_path(orbax_io.load_params_npz(tdir / "final_params.npz"))[0]
    b = jax.tree_util.tree_flatten_with_path(orbax_io.load_params_npz(jdir / "final_params.npz"))[0]
    c = jax.tree_util.tree_flatten_with_path({"params": init["params"]})[0]
    assert [k for k, _ in a] == [k for k, _ in b] == [k for k, _ in c]
    moved = max(float(np.abs(x - z).max()) for (_, x), (_, z) in zip(a, c))
    assert moved > 1e-3  # training moved the weights
    for (k, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(x, y, atol=1e-5, err_msg=str(k))
    res = yaml.safe_load((tdir / "hparams_results.yml").read_text())["results"]
    assert res["best_epoch"] == 3 and set(res["phases_s"]) == set(want["phases_s"])


def test_jax_run_testing_reads_the_ports_checkpoint(trained):
    """The port's best_params.npz serves through the JAX package's
    ``run_testing`` (and the port's) at the best epoch's validation MAE."""
    tmp, ds, _, _, got = trained
    cfg = _train_cfg(tmp / "unused", tmp / "init.npz")
    cfg["testing"] = {"path_to_ckpt": str(Path(got["run_dir"]) / "best_params.npz")}
    jres = jax_runner.run_testing(jax_config.from_dict(cfg), datasets={"validation": ds["validation"]})
    assert abs(jres["mae"] - got["best_mae"]) < 1e-4
    data_dir = tmp / "val_split"
    data_dir.mkdir()
    np.save(data_dir / "validation_data.npy", ds["validation"][0])
    np.save(data_dir / "validation_labels.npy", ds["validation"][1])
    cfg["data"]["data_path"] = str(data_dir)
    tres = runner.run_testing(config.from_dict(cfg), device="cpu")
    assert abs(tres["mae"] - got["best_mae"]) < 1e-4


def test_run_training_without_checkpoints_tests_the_final_state(tmp_path):
    """Under ``training.save_ckpt: false`` the end-of-run test scores the
    final weights, as the JAX ``run_training`` does (it restores the best
    only when ``save_ckpt`` and ``best_epoch >= 0``). Validation every
    epoch; the learning rate is raised so that the best epoch (1) is not the
    last (3), where the final and the best weights score far apart."""
    m = JaxSiT(dtype=jnp.float32, num_patches=320, num_vertices=153, **TRANSFORMER)
    init = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 320, 153))))
    orbax_io.save_params_npz(tmp_path / "init.npz", init)
    d, lab = make_regression_dataset(18, seed=3)
    ds = {"train": (d[:8], lab[:8]), "validation": (d[8:14], lab[8:14]),
          "test": (d[14:], lab[14:])}

    def cfg(root):
        c = _train_cfg(root, tmp_path / "init.npz")
        c["training"].update(val_epoch=1, LR=6e-3, save_ckpt=False, testing=True)
        return c

    want = jax_runner.run_training(jax_config.from_dict(cfg(tmp_path / "jax")), datasets=ds,
                                   progress=False)
    got = runner.run_training(config.from_dict(cfg(tmp_path / "torch")), datasets=ds,
                              device="cpu", progress=False)
    assert got["best_epoch"] == want["best_epoch"] == 1 < got["epochs"] - 1
    assert not (Path(got["run_dir"]) / "best_params.npz").exists()
    assert abs(got["test_mae"] - want["test_mae"]) < 1e-4
    np.testing.assert_allclose(_csv(Path(got["run_dir"]) / "test_preds.csv"),
                               _csv(Path(want["run_dir"]) / "test_preds.csv"), atol=1e-4)


def test_run_training_refuses_unported_modes(tmp_path):
    """Nothing of a SiT regression config is refused now (every mesh axis
    runs: ``tests/test_torch_parallel.py``, ``test_torch_pipeline.py``,
    ``test_torch_seq_sharding.py``; the NaN sanitizer and the profiler:
    ``tests/test_torch_tail.py``). ImageNet initialisation follows the JAX
    rule: the flag with an empty ``weights.imagenet`` trains from the
    seeded init, so it is not refused (``tests/test_torch_imagenet.py``
    runs both cases)."""
    raw = _train_cfg(tmp_path, tmp_path / "none.npz")
    raw["training"]["load_weights_imagenet"] = True
    raw["tpu"].update(debug_nans=True, profile_epoch=1)
    assert raw.get("weights", {}).get("imagenet", "") == ""
    runner._refuse_unported(config.from_dict(raw))


# -- config and logging -----------------------------------------------------------


@pytest.mark.parametrize("path", sorted((REPO / "configs").glob("*/*.yml")),
                         ids=lambda p: p.stem)
def test_shipped_configs_parse_as_in_jax(path):
    raw = yaml.safe_load(path.read_text())
    want, got = jax_config.from_dict(raw), config.from_dict(raw)
    assert dataclasses.asdict(got.optim) == dataclasses.asdict(want.optim)
    for f in dataclasses.fields(got.training):
        assert getattr(got.training, f.name) == getattr(want.training, f.name), f.name
    assert (got.model.dropout, got.model.size_name) == (want.model.dropout, want.model.size_name)
    assert (got.logging_folder, got.ssl_weights_path) == (want.logging_folder, want.ssl_weights_path)
    assert run_folder_name(got, "D") == jax_run_folder_name(want, "D")


@pytest.mark.parametrize("block,key,val", [
    ("training", "grad_accum", 0), ("training", "ema", 1.0), ("training", "bs", 30),
    ("optimisation", "optimiser", "RMSprop"), ("optimisation", "grad_clip", -1.0),
    ("optimisation", "schedule", "linear"), ("data", "streaming", "maybe"),
])
def test_config_validation_matches_jax(block, key, val):
    raw = {"training": {"bs": 32, "grad_accum": 4}}
    raw.setdefault(block, {})[key] = val
    with pytest.raises(ValueError):
        jax_config.from_dict(raw)
    with pytest.raises(ValueError):
        config.from_dict(raw)


def test_metric_logger_writes_jsonl_and_csv(tmp_path):
    log = MetricLogger(tmp_path)
    log.log(0, {"loss": 1.5, "mae": 1.0}, prefix="train/")
    log.log(0, {"mae": 2.0}, prefix="val/")
    log.close()
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and '"train/loss": 1.5' in lines[0]
    rows = list(csv.DictReader(open(tmp_path / "metrics_val.csv")))
    assert rows[0]["val/mae"] == "2.0"


# -- the CLI without JAX ----------------------------------------------------------------

_NO_JAX = ("import sys\n"
           "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
           "'orbax.checkpoint', 'surface_vision_transformers_tpu'):\n"
           "    sys.modules[m] = None\n")


def test_cli_train_runs_without_jax(tmp_path):
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    d, lab = make_regression_dataset(7, raw_vertices=40962, seed=6)
    for split, sl in (("train", slice(0, 4)), ("validation", slice(4, 7))):
        np.save(data_dir / f"{split}_data.npy", d[sl])
        np.save(data_dir / f"{split}_labels.npy", lab[sl])
    cfg = {"resolution": {"ico": 6, "sub_ico": 2}, "transformer": dict(TRANSFORMER),
           "training": {"bs": 4, "bs_val": 2, "epochs": 2, "val_epoch": 1, "LR": 1e-3},
           "data": {"data_path": str(data_dir)},
           "logging": {"folder_to_save_model": "set by --set"}}
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(cfg))
    code = _NO_JAX + (
        "import runpy\n"
        f"sys.argv = ['train', {str(tmp_path / 'cfg.yml')!r}, '--device', 'cpu',\n"
        f"            '--set', 'logging.folder_to_save_model={tmp_path / 'runs'}']\n"
        "runpy.run_module('surface_vision_transformers_tpu_torch.cli.train',\n"
        "                 run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert "'best_mae'" in out.stdout
    (run_dir,) = (tmp_path / "runs").iterdir()
    for f in ("best_params.npz", "final_params.npz", "preds.csv", "hparams_results.yml"):
        assert (run_dir / f).exists(), f
    assert len(_csv(run_dir / "preds.csv")) == 3


# -- --set overrides: parsed as the JAX CLI parses them --------------------------------


@pytest.mark.parametrize("key,text", [
    ("training.testing", "False"), ("tpu.fused_train", "no"), ("training.save_ckpt", "off"),
    ("training.l1loss", "True"), ("weights.ssl_mpp", "~"), ("training.LR", "1e-5"),
])
def test_set_overrides_parse_as_yaml(key, text):
    """``--set key=value`` gives the value ``yaml.safe_load`` gives it, as
    the JAX CLI parses it (``cli/_common.py``): YAML's false words read as
    False, not as the true string "False"; ``~`` as None; ``1e-5`` (no
    dot: not a YAML float) as the string, which ``from_dict`` casts. The
    two configs build the same ``Experiment``."""
    from surface_vision_transformers_tpu_torch.cli._common import parse_config

    path = REPO / "configs/training/sit_tiny_scan_age.yml"
    raw, device = parse_config("t", [str(path), "--set", f"{key}={text}", "--device", "cpu"])
    want = yaml.safe_load(path.read_text())
    block, leaf = key.split(".")
    want.setdefault(block, {})[leaf] = yaml.safe_load(text)
    assert device == "cpu" and raw == want
    got, ref = config.from_dict(raw), config.from_dict(want)
    assert got == ref
    if text in ("False", "no", "off"):
        assert not (got.training.testing and got.fused_train and got.training.save_ckpt)


def test_cli_train_set_testing_false_runs_no_test(tmp_path, capsys):
    """``cli.train --set training.testing=False`` on a config that tests at
    the end of the run: no test metric, no test_preds.csv (the string
    "False" read as true would test)."""
    from surface_vision_transformers_tpu_torch.cli import train as cli_train

    data_dir = tmp_path / "data"
    data_dir.mkdir()
    d, lab = make_regression_dataset(9, raw_vertices=40962, seed=7)
    for split, sl in (("train", slice(0, 4)), ("validation", slice(4, 6)),
                      ("test", slice(6, 9))):
        np.save(data_dir / f"{split}_data.npy", d[sl])
        np.save(data_dir / f"{split}_labels.npy", lab[sl])
    cfg = {"resolution": {"ico": 6, "sub_ico": 2}, "transformer": dict(TRANSFORMER),
           "training": {"bs": 4, "bs_val": 2, "epochs": 1, "val_epoch": 1, "LR": 1e-3,
                        "testing": True},
           "data": {"data_path": str(data_dir)},
           "logging": {"folder_to_save_model": str(tmp_path / "runs")},
           "tpu": {"compute_dtype": "float32"}}
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(cfg))
    cli_train.main([str(tmp_path / "cfg.yml"), "--device", "cpu",
                    "--set", "training.testing=False"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert "'best_mae'" in out and "test_mae" not in out
    (run_dir,) = (tmp_path / "runs").iterdir()
    assert (run_dir / "preds.csv").exists() and not (run_dir / "test_preds.csv").exists()
