"""The port's host-streaming input (``data.pipeline.StreamingLoader``,
``data.npy.load_split(mmap=True)``, the trainer's streamed epoch and
evaluation, ``run_training`` under ``data.streaming``) on the CPU against
the JAX package's.

* The loader's batches (rows, padding, weights) equal JAX's
  ``StreamingLoader``'s for several epochs and after ``set_epoch``, exactly.
* The 'auto' rule is JAX's ``_use_streaming``.
* Streamed evaluation equals device-resident evaluation within 1e-6 (the
  JAX package's own bound; float32 here, and bfloat16 through the fused
  forward's plain versions).
* Streamed training runs from memmapped files for SiT, MPP and MS-SiT, and
  ``run_training`` with ``data.streaming: on`` matches the JAX runner's on
  the same data from one params npz with several steps an epoch: best MAE
  1e-4, preds.csv 1e-4, final parameters 1e-5 (the bounds of
  ``tests/test_torch_training.py``'s run against JAX, float32 both sides).
  A second case resumes the port's run in the middle and matches the same
  uninterrupted JAX run.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu.checkpoints import orbax_io
from surface_vision_transformers_tpu.data.pipeline import StreamingLoader as JaxLoader
from surface_vision_transformers_tpu.models import SiT as JaxSiT
from surface_vision_transformers_tpu.train import runner as jax_runner
from surface_vision_transformers_tpu.utils import config as jax_config
from surface_vision_transformers_tpu_torch.data import npy
from surface_vision_transformers_tpu_torch.data.pipeline import StreamingLoader, gather_rows
from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
from surface_vision_transformers_tpu_torch.train import runner
from surface_vision_transformers_tpu_torch.train.trainer import Trainer
from surface_vision_transformers_tpu_torch.utils.config import from_dict

L, V = 20, 15  # ico 2 / sub-ico 0


def base_raw(root, **training):
    return {"resolution": {"ico": 2, "sub_ico": 0},
            "transformer": {"dim": 16, "depth": 1, "heads": 2, "mlp_dim": 32, "dim_head": 8},
            "training": {"LR": 1e-3, "bs": 16, "epochs": 2, "val_epoch": 1, "seed": 0,
                         **training},
            "optimisation": {"optimiser": "Adam"}, "tpu": {"compute_dtype": "float32"},
            "logging": {"folder_to_save_model": str(root)}}


def _write_split_files(tmp_path, data, labels):
    ddir = tmp_path / "data"
    ddir.mkdir()
    cut = int(data.shape[0] * 0.75)
    for split, sl in (("train", slice(0, cut)), ("validation", slice(cut, None))):
        np.save(ddir / f"{split}_data.npy", data[sl])
        np.save(ddir / f"{split}_labels.npy", labels[sl])
    return ddir


def _train_records(run_dir):
    lines = (Path(run_dir) / "metrics.jsonl").read_text().splitlines()
    return [json.loads(x) for x in lines if "train/loss" in x]


# -- the loader --------------------------------------------------------------------


@pytest.mark.parametrize("n,bs,shuffle", [(23, 8, True), (16, 8, True), (11, 4, False)])
def test_loader_matches_jax(n, bs, shuffle):
    """Same rows, padding and weights as JAX's loader, epoch after epoch and
    after ``set_epoch`` (rows identified by their values)."""
    data = np.arange(n, dtype=np.float32)[:, None, None] * np.ones((1, 2, 3), np.float32)
    targets = np.arange(n, dtype=np.float32) + 100
    port = StreamingLoader(data, targets, batch_size=bs, shuffle=shuffle, seed=7)
    ref = JaxLoader(data, targets, batch_size=bs, shuffle=shuffle, seed=7)

    def epoch(loader):
        return [tuple(np.asarray(t) for t in b) for b in loader]

    for e in range(4):
        if e == 2:
            port.set_epoch(5)
            ref.set_epoch(5)
        got, want = epoch(port), epoch(ref)
        assert len(got) == len(want) == port.steps_per_epoch()
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    assert port.plan(0)[0][0].shape == (bs,)


def test_loader_casts_each_batch_of_a_memmap(tmp_path):
    data = np.random.default_rng(0).standard_normal((9, 4, 5))
    np.save(tmp_path / "train_data.npy", data)
    np.save(tmp_path / "train_labels.npy", np.arange(9.0))
    mm, labels = npy.load_split(tmp_path, "train", mmap=True)
    assert isinstance(mm, np.memmap) and mm.dtype == np.float64 and labels.dtype == np.float32
    idx = np.array([3, 0, 8])
    np.testing.assert_array_equal(gather_rows(mm, idx, np.empty((3, 4, 5), np.float32)),
                                  data[idx].astype(np.float32))
    loader = StreamingLoader(mm, labels, batch_size=4, shuffle=False)
    x, t, w = next(iter(loader))
    loader.close()
    assert x.dtype == torch.float32 and x.shape == (4, 4, 5)
    np.testing.assert_array_equal(t.numpy(), [0, 1, 2, 3])
    eager, _ = npy.load_split(tmp_path, "train")
    assert not isinstance(eager, np.memmap) and eager.dtype == np.float32


def test_gather_rows_on_many_threads():
    """The threaded row gather (chunks written by a pool larger than the
    machine's cores, the interpreter switching threads often) equals the
    plain gather on every draw."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(3)
    source = rng.standard_normal((64, 3, 50)).astype(np.float32)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(32) as pool:
            for _ in range(50):
                idx = rng.integers(0, 64, int(rng.integers(1, 40)))
                out = np.full((idx.size, 3, 50), np.nan, np.float32)
                np.testing.assert_array_equal(gather_rows(source, idx, out, pool), source[idx])
    finally:
        sys.setswitchinterval(switch)


def test_streaming_auto_thresholds(tmp_path):
    """'auto' compares 2x the float32 dataset bytes against the budget."""
    data = np.zeros((4, 4, L, V), np.float32)
    small = from_dict({**base_raw(tmp_path), "data": {"streaming_budget_gb": 1.0}})
    assert runner.use_streaming(small, data) is False
    tiny = from_dict({**base_raw(tmp_path), "data": {"streaming_budget_gb": data.nbytes / 2**30}})
    assert runner.use_streaming(tiny, data) is True
    off = from_dict({**base_raw(tmp_path), "data": {"streaming": False,
                                                   "streaming_budget_gb": 1e-9}})
    assert runner.use_streaming(off, data) is False
    assert runner.use_streaming(from_dict({**base_raw(tmp_path), "data": {"streaming": True}}),
                                data) is True
    for exp in (small, tiny, off):
        want = jax_runner._use_streaming(jax_config.from_dict(exp.raw), data)
        assert runner.use_streaming(exp, data) is want


# -- the trainer -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_matches_deviceresident_eval(tmp_path, dtype):
    """Same weights, same split: streamed evaluation equals the resident one
    (23 rows at batch 16: the last batch padded, or re-read)."""
    data, labels = make_regression_dataset(23, num_patches=L, num_vertices=V,
                                           label_range=(-1, 1), seed=1)
    raw = base_raw(tmp_path)
    raw["tpu"]["compute_dtype"] = dtype
    exp = from_dict(raw)
    torch.manual_seed(0)
    t = Trainer(exp, runner.build_model(exp))
    m_dev, p_dev = t.evaluate(torch.from_numpy(data), torch.from_numpy(labels))
    loader = StreamingLoader(data, labels, batch_size=16, shuffle=False)
    m_st, p_st = t.evaluate_streaming(loader)
    assert abs(m_dev.mae - m_st.mae) < 1e-6 and abs(m_dev.loss - m_st.loss) < 1e-6
    np.testing.assert_allclose(p_dev, p_st, atol=1e-6)
    with pytest.raises(ValueError, match="shuffle=False"):
        t.evaluate_streaming(StreamingLoader(data, labels, batch_size=16))


def test_streaming_on_trains_from_files(tmp_path):
    """data.streaming: on -> memmapped float64 splits, streamed epochs and
    validation with preds.csv; the loss falls on learnable data."""
    data, labels = make_regression_dataset(48, num_patches=L, num_vertices=V,
                                           label_range=(-1, 1), seed=0)
    ddir = _write_split_files(tmp_path, data.astype(np.float64), labels)
    raw = base_raw(tmp_path / "logs", epochs=3)
    raw["data"] = {"data_path": str(ddir), "streaming": True}
    ds = runner.load_datasets(from_dict(raw))
    assert isinstance(ds["train"][0], np.memmap) and ds["train"][0].dtype == np.float64
    res = runner.run_training(from_dict(raw), device="cpu", progress=False)
    assert res["streaming"] is True and np.isfinite(res["best_mae"])
    assert (Path(res["run_dir"]) / "preds.csv").exists()
    tr = _train_records(res["run_dir"])
    assert tr[-1]["train/loss"] < tr[0]["train/loss"]


def test_streaming_mpp_pretrain(tmp_path):
    """MPP pretraining streams too, from memmapped files (the encoder's best
    npz written)."""
    data, labels = make_regression_dataset(32, num_patches=L, num_vertices=V,
                                           label_range=(-1, 1), seed=0)
    raw = base_raw(tmp_path / "logs")
    raw["SSL"] = "mpp"
    raw["pretraining_mpp"] = {"mask_prob": 0.5, "replace_prob": 0.8, "swap_prob": 0.02}
    raw["data"] = {"data_path": str(_write_split_files(tmp_path, data, labels)),
                   "streaming": True}
    assert isinstance(runner.load_datasets(from_dict(raw))["train"][0], np.memmap)
    res = runner.run_training(from_dict(raw), device="cpu", progress=False)
    assert res["streaming"] is True and np.isfinite(res["best_loss"])
    assert (Path(res["run_dir"]) / "encoder_best_params.npz").exists()


def test_streaming_composes_with_mssit(tmp_path):
    """The multiscale family streams raw (n, C, G) vertex batches from
    memmapped files through the same path, augmented."""
    rng = np.random.default_rng(0)
    data = rng.standard_normal((24, 4, 642))
    labels = data[:, 0].mean(axis=1).astype(np.float32)
    ddir = _write_split_files(tmp_path, data, labels)
    raw = {"resolution": {"ico": 3, "sub_ico": 1},
           "transformer": {"model": "MS-SiT", "num_channels": 4},
           "mssit": {"embed_dim": 64, "depths": [2, 2], "heads": [2, 4], "window": 16,
                     "global_max": 8},
           "training": {"LR": 1e-3, "bs": 8, "epochs": 2, "seed": 0, "val_epoch": 1,
                        "save_ckpt": False},
           "optimisation": {"optimiser": "AdamW"}, "AdamW": {"weight_decay": 0.01},
           "tpu": {"compute_dtype": "float32"},
           "data": {"data_path": str(ddir), "streaming": True},
           "augmentation": {"enabled": True, "num_warps": 2},
           "logging": {"folder_to_save_model": str(tmp_path / "logs")}}
    assert isinstance(runner.load_datasets(from_dict(raw))["train"][0], np.memmap)
    res = runner.run_training(from_dict(raw), device="cpu", progress=False)
    assert res["streaming"] is True and np.isfinite(res["best_mae"])


# -- the slice against the JAX runner ----------------------------------------------

TRANSFORMER = dict(dim=32, depth=2, heads=2, mlp_dim=64, dim_head=16)


def _slice_cfg(root, init_npz, epochs=4, **training):
    return {"resolution": {"ico": 2, "sub_ico": 0}, "transformer": dict(TRANSFORMER),
            "training": {"bs": 8, "bs_val": 4, "epochs": epochs, "val_epoch": 1, "LR": 2e-3,
                         "seed": 3, "load_weights_ssl": True, **training},
            "weights": {"ssl_mpp": str(init_npz)},
            "optimisation": {"optimiser": "SGD"}, "SGD": {"momentum": 0.9},
            "logging": {"folder_to_save_model": str(root)},
            "data": {"streaming": "on"}, "tpu": {"compute_dtype": "float32"}}


def _csv(path):
    import csv

    with open(path) as f:
        return np.array([(float(r["pred"]), float(r["target"])) for r in csv.DictReader(f)])


@pytest.fixture(scope="module")
def jax_streamed(tmp_path_factory):
    """The JAX runner streaming 20 pre-patched training samples at bs 8
    (three steps an epoch, the last padded), 6 validation samples at bs_val
    4, from one params npz."""
    tmp = tmp_path_factory.mktemp("stream")
    m = JaxSiT(dtype=jnp.float32, num_patches=L, num_vertices=V, **TRANSFORMER)
    init = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, L, V))))
    orbax_io.save_params_npz(tmp / "init.npz", init)
    d, lab = make_regression_dataset(26, num_patches=L, num_vertices=V, seed=3)
    ds = {"train": (d[:20], lab[:20]), "validation": (d[20:], lab[20:])}
    want = jax_runner.run_training(jax_config.from_dict(_slice_cfg(tmp / "jax", tmp / "init.npz")),
                                   datasets=ds, progress=False)
    return tmp, ds, want


def _same_run(got, want):
    assert got["streaming"] is want["streaming"] is True
    assert got["best_epoch"] == want["best_epoch"]
    assert abs(got["best_mae"] - want["best_mae"]) < 1e-4
    tdir, jdir = Path(got["run_dir"]), Path(want["run_dir"])
    np.testing.assert_allclose(_csv(tdir / "preds.csv"), _csv(jdir / "preds.csv"), atol=1e-4)
    a = orbax_io.load_params_npz(tdir / "final_params.npz")
    b = orbax_io.load_params_npz(jdir / "final_params.npz")
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        np.testing.assert_allclose(x, y, atol=1e-5, err_msg=str(k))


def test_streamed_run_training_matches_jax(jax_streamed):
    tmp, ds, want = jax_streamed
    got = runner.run_training(from_dict(_slice_cfg(tmp / "torch", tmp / "init.npz")),
                              datasets=ds, device="cpu", progress=False)
    _same_run(got, want)


def test_streamed_resume_matches_uninterrupted_jax(jax_streamed):
    """The port runs 2 epochs with a rolling checkpoint, then resumes to 4:
    the same run as JAX's uninterrupted one."""
    tmp, ds, want = jax_streamed
    first = runner.run_training(
        from_dict(_slice_cfg(tmp / "resumed", tmp / "init.npz", epochs=2, ckpt_every=1)),
        datasets=ds, device="cpu", progress=False)
    got = runner.run_training(
        from_dict(_slice_cfg(tmp / "resumed", tmp / "init.npz", ckpt_every=1)),
        datasets=ds, device="cpu", progress=False, resume_from=first["run_dir"])
    assert got["run_dir"] == first["run_dir"]
    _same_run(got, want)
