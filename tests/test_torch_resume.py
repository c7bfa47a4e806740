"""Interrupted-run resume in the port (``run_training(resume_from=...)``,
``--resume RUN_DIR``) with the rolling ``training.ckpt_every`` checkpoint,
the six cases of ``tests/test_resume_run.py`` and three more: an augmented
run (the augmentation generator restored), an MPP run, and a resume whose
earlier part never wrote ``best/`` (the end-of-run test then scores the
final state). On the CPU a resumed run equals the uninterrupted one bit for
bit: the best metric, its epoch and every final parameter. Also the
trainer's augmentation (train batches only) and the checkpoint format.
"""

import ast
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu_torch.checkpoints import state as ckpt
from surface_vision_transformers_tpu_torch.cli import _common
from surface_vision_transformers_tpu_torch.cli import pretrain as cli_pretrain
from surface_vision_transformers_tpu_torch.cli import train as cli_train
from surface_vision_transformers_tpu_torch.data.augment import SurfaceAugment
from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
from surface_vision_transformers_tpu_torch.geometry import load_patch_table
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


@pytest.fixture(scope="module")
def ds():
    data, labels = make_regression_dataset(48, num_patches=L, num_vertices=V,
                                           label_range=(-1, 1), seed=1)
    return {"train": (data[:32], labels[:32]), "validation": (data[32:], labels[32:])}


def _params(run_dir, name="final_params.npz"):
    return dict(np.load(Path(run_dir) / name))


def _same(a: dict, b: dict):
    assert a["best_epoch"] == b["best_epoch"]
    assert a["best_mae" if "best_mae" in a else "best_loss"] == \
        b["best_mae" if "best_mae" in b else "best_loss"]
    pa, pb = _params(a["run_dir"]), _params(b["run_dir"])
    assert pa.keys() == pb.keys()
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


def _train_records(run_dir):
    return sum(1 for x in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()
               if "train/loss" in x)


def _full_short_resumed(tmp_path, ds, make_raw, epochs=4, cut=2):
    full = runner.run_training(from_dict(make_raw(tmp_path / "full", epochs)), datasets=ds,
                               device="cpu", progress=False)
    short = runner.run_training(from_dict(make_raw(tmp_path / "parts", cut)), datasets=ds,
                                device="cpu", progress=False)
    resumed = runner.run_training(from_dict(make_raw(tmp_path / "parts", epochs)),
                                  datasets=ds, device="cpu", progress=False,
                                  resume_from=short["run_dir"])
    assert resumed["run_dir"] == short["run_dir"]  # continues in place
    return full, short, resumed


def test_resume_reproduces_uninterrupted_run(tmp_path, ds):
    full, short, resumed = _full_short_resumed(
        tmp_path, ds, lambda root, e: base_raw(root, epochs=e, val_epoch=2, ckpt_every=1))
    _same(resumed, full)
    assert _train_records(resumed["run_dir"]) == 4
    meta = json.loads((Path(short["run_dir"]) / "last" / "metadata.json").read_text())
    assert meta["epoch"] == 3 and set(meta) == {"epoch", "best", "best_epoch"}


def test_resume_completed_run_is_noop(tmp_path, ds):
    first = runner.run_training(from_dict(base_raw(tmp_path)), datasets=ds, device="cpu",
                                progress=False)
    again = runner.run_training(from_dict(base_raw(tmp_path)), datasets=ds, device="cpu",
                                progress=False, resume_from=first["run_dir"])
    assert again["best_mae"] == first["best_mae"] and again["best_epoch"] == first["best_epoch"]
    assert _train_records(first["run_dir"]) == 2


def test_resume_missing_checkpoint_errors(tmp_path, ds):
    raw = base_raw(tmp_path, epochs=1, save_ckpt=False)
    res = runner.run_training(from_dict(raw), datasets=ds, device="cpu", progress=False)
    with pytest.raises(FileNotFoundError, match="last/final/best"):
        runner.run_training(from_dict(raw), datasets=ds, device="cpu", progress=False,
                            resume_from=res["run_dir"])
    with pytest.raises(FileNotFoundError, match="run directory"):
        runner.run_training(from_dict(raw), datasets=ds, device="cpu", progress=False,
                            resume_from=str(tmp_path / "nope"))


def test_cli_parses_resume_flag(tmp_path):
    cfg = tmp_path / "c.yml"
    cfg.write_text("training:\n  bs: 8\n")
    raw, device, resume_dir = _common.parse_config(
        "t", [str(cfg), "--resume", "/some/run", "--device", "cpu"], with_resume=True)
    assert raw["training"]["bs"] == 8 and resume_dir == "/some/run" and device == "cpu"
    raw, _, resume_dir = _common.parse_config("t", [str(cfg)], with_resume=True)
    assert resume_dir is None
    assert len(_common.parse_config("t", [str(cfg)])) == 2


def test_resume_reproduces_uninterrupted_streaming_run(tmp_path, ds):
    def make_raw(root, epochs):
        raw = base_raw(root, epochs=epochs, val_epoch=2, ckpt_every=1)
        raw["data"] = {"streaming": "on"}
        return raw

    full, _, resumed = _full_short_resumed(tmp_path, ds, make_raw)
    assert full["streaming"] is resumed["streaming"] is True
    _same(resumed, full)


def test_resume_picks_newest_checkpoint_not_last(tmp_path, ds):
    """epochs 3 with ckpt_every 2 leaves ``last`` at epoch 1 and ``final``
    at epoch 2: resume takes ``final`` and trains nothing more."""
    raw = base_raw(tmp_path, epochs=3, val_epoch=1, ckpt_every=2)
    first = runner.run_training(from_dict(raw), datasets=ds, device="cpu", progress=False)
    run_dir = Path(first["run_dir"])
    assert json.loads((run_dir / "last" / "metadata.json").read_text())["epoch"] == 1
    assert json.loads((run_dir / "final" / "metadata.json").read_text())["epoch"] == 2
    n = _train_records(run_dir)
    again = runner.run_training(from_dict(raw), datasets=ds, device="cpu", progress=False,
                                resume_from=str(run_dir))
    assert _train_records(run_dir) == n
    assert again["best_mae"] == first["best_mae"] and again["best_epoch"] == first["best_epoch"]


def test_resume_augmented_run(tmp_path, ds):
    """Augmentation on (exact rotations and quota warps of the pre-patched
    batches): the checkpoint carries the augmentation generator, so the
    resumed run draws what the uninterrupted one drew."""
    def make_raw(root, epochs):
        raw = base_raw(root, epochs=epochs, val_epoch=1, ckpt_every=1)
        raw["augmentation"] = {"enabled": True, "num_warps": 2, "warp_prob": 0.5}
        return raw

    full, short, resumed = _full_short_resumed(tmp_path, ds, make_raw)
    _same(resumed, full)
    state, _ = ckpt.load_state(Path(short["run_dir"]) / "final")
    fresh = torch.Generator().manual_seed((0 << 32) + 7).get_state()
    assert not torch.equal(state["augment"], fresh)  # the generator moved
    plain = runner.run_training(from_dict(base_raw(tmp_path / "plain", epochs=4, val_epoch=1)),
                                datasets=ds, device="cpu", progress=False)
    pp, pf = _params(plain["run_dir"]), _params(full["run_dir"])
    assert any(not np.array_equal(pp[k], pf[k]) for k in pf)  # augmentation moved the run


def test_resume_mpp_run(tmp_path, ds):
    """MPP pretraining (the corruption generator restored), through the
    resident path, with EMA."""
    def make_raw(root, epochs):
        raw = base_raw(root, epochs=epochs, val_epoch=1, ckpt_every=1, ema=0.9)
        raw["SSL"] = "mpp"
        raw["pretraining_mpp"] = {"mask_prob": 0.5, "replace_prob": 0.8, "swap_prob": 0.02}
        return raw

    full, _, resumed = _full_short_resumed(tmp_path, ds, make_raw, epochs=3)
    _same(resumed, full)
    for name in ("encoder_final_params.npz", "encoder_best_params.npz"):
        a, b = _params(full["run_dir"], name), _params(resumed["run_dir"], name)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_resume_without_best_tests_the_final_state(tmp_path):
    """The resumed part never improves and ``best/`` is gone: the end-of-run
    test must not fail and scores the final state."""
    data, labels = make_regression_dataset(56, num_patches=L, num_vertices=V,
                                           label_range=(-1, 1), seed=2)
    ds3 = {"train": (data[:32], labels[:32]), "validation": (data[32:44], labels[32:44]),
           "test": (data[44:], labels[44:])}

    def raw(epochs):
        return base_raw(tmp_path, epochs=epochs, val_epoch=1, ckpt_every=1, testing=True)

    first = runner.run_training(from_dict(raw(2)), datasets=ds3, device="cpu", progress=False)
    run_dir = Path(first["run_dir"])
    for name in ("best", "final"):
        shutil.rmtree(run_dir / name)
    meta_file = run_dir / "last" / "metadata.json"
    meta = json.loads(meta_file.read_text())
    meta.update(best=0.0, best_epoch=0)  # a best no later epoch can beat
    meta_file.write_text(json.dumps(meta))
    res = runner.run_training(from_dict(raw(3)), datasets=ds3, device="cpu", progress=False,
                              resume_from=str(run_dir))
    assert res["best_epoch"] == 0 and not (run_dir / "best").exists()
    exp = from_dict(raw(3))
    model = runner.build_model(exp)
    model.load_state_dict(ckpt.load_state(run_dir / "final")[0]["model"])
    tm, _ = Trainer(exp, model).evaluate(torch.from_numpy(ds3["test"][0]),
                                         torch.from_numpy(ds3["test"][1]))
    assert res["test_mae"] == tm.mae


@pytest.mark.parametrize("tool", ["train", "pretrain"])
def test_cli_resume_reproduces_the_run(tmp_path, ds, capsys, tool):
    """``cli.train`` / ``cli.pretrain --resume RUN_DIR`` continues a run of
    the same CLI to the uninterrupted run's end, from split files."""
    main = cli_train.main if tool == "train" else cli_pretrain.main
    ddir = tmp_path / "data"
    ddir.mkdir()
    for split, (d, lab) in ds.items():
        np.save(ddir / f"{split}_data.npy", d)
        np.save(ddir / f"{split}_labels.npy", lab)

    def cfg(root):
        raw = base_raw(root, val_epoch=1, ckpt_every=1)
        raw["data"] = {"data_path": str(ddir), "streaming": "on"}
        path = tmp_path / f"{root.name}.json"
        path.write_text(json.dumps(raw))
        return str(path)

    def run(*argv):
        main(list(argv) + ["--device", "cpu"])
        return ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])

    full = run(cfg(tmp_path / "full"), "--set", "training.epochs=3")
    short = run(cfg(tmp_path / "parts"), "--set", "training.epochs=1")
    resumed = run(cfg(tmp_path / "parts"), "--set", "training.epochs=3", "--resume",
                  short["run_dir"])
    assert ("best_loss" in full) == (tool == "pretrain")
    _same(resumed, full)


# -- the trainer and the checkpoint format ------------------------------------------


def test_augmented_step_is_the_plain_step_on_the_augmented_batch(tmp_path):
    """One augmented optimizer step equals the un-augmented step on the batch
    the augmentation produced, and evaluation is never augmented."""
    raw = base_raw(tmp_path, bs=8)
    exp = from_dict(raw)
    data, labels = make_regression_dataset(8, num_patches=L, num_vertices=V,
                                           label_range=(-1, 1), seed=4)
    x, y, w = torch.from_numpy(data), torch.from_numpy(labels), torch.ones(8)
    aug = SurfaceAugment(ico=2, patch_table=load_patch_table(2, 0).indices, num_warps=2,
                         warp_prob=0.5)
    torch.manual_seed(0)
    model = runner.build_model(exp)
    twin = runner.build_model(exp)
    twin.load_state_dict(model.state_dict())
    a, b = Trainer(exp, model, augment=aug), Trainer(exp, twin)
    xa = aug(x, torch.Generator().set_state(a.augment_rng.get_state()))
    assert not torch.equal(xa, x)
    m_a = a.evaluate(x, y)[0]
    assert m_a == b.evaluate(x, y)[0]  # evaluation sees x itself
    loss_a, mae_a = a.optimizer_step(x, y, w)
    loss_b, mae_b = b.optimizer_step(xa, y, w)
    assert torch.equal(loss_a, loss_b) and torch.equal(mae_a, mae_b)
    for (k, p), q in zip(model.state_dict().items(), twin.state_dict().values()):
        assert torch.equal(p, q), k


def test_checkpoint_is_a_weights_only_torch_file(tmp_path, ds):
    res = runner.run_training(from_dict(base_raw(tmp_path, ckpt_every=1)), datasets=ds,
                              device="cpu", progress=False)
    run_dir = Path(res["run_dir"])
    for name in ckpt.NAMES:
        state = torch.load(run_dir / name / "state.pt", weights_only=True)
        assert set(state) == {"model", "optimizer", "ema", "generator", "corruption",
                              "dropout", "augment"}
        if name != "best":
            assert state["optimizer"]["count"] == 4  # 2 epochs of 2 steps
    meta = json.loads((run_dir / "final" / "metadata.json").read_text())
    assert set(meta) == {"epoch", "mae", "best", "best_epoch"} and meta["epoch"] == 1
    assert ckpt.newest(run_dir)[0] in ("last", "final")
