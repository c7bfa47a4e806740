"""The port's recipe record (``scripts/run_recipe_torch.py``) on the CPU
against the JAX package's (``scripts/run_recipe_r05.py``, loaded by path
here, never by the port): the same data byte for byte and the same config
key for key; the test driver pointed at a run folder, as the JAX
``run_testing`` takes one; and the committed ``RECIPE_torch.json`` (six
100-epoch runs on the card) against the gate constants of
``chip_smoke.py``'s recipe phase. The data at a few subjects (the recipe's
846 + 106 surfaces are 750 MB); the run folder of a SiT at dim 32, depth 2.
"""

import copy
import csv
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

import surface_vision_transformers_tpu.train.runner as jax_runner
import surface_vision_transformers_tpu.utils.config as jax_config
from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
from surface_vision_transformers_tpu_torch.train import runner
from surface_vision_transformers_tpu_torch.utils.config import from_dict

REPO = Path(__file__).resolve().parent.parent


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    """(the JAX record's script, the port's)."""
    return (_load("run_recipe_r05", REPO / "scripts/run_recipe_r05.py"),
            _load("run_recipe_torch", REPO / "scripts/run_recipe_torch.py"))


def test_synth_split_is_byte_equal_to_jax(scripts):
    """The same generator sequence (pattern, then two splits) gives the
    same bytes in both scripts."""
    jax_script, torch_script = scripts
    out = []
    for script in scripts:
        rng = np.random.default_rng(0)
        pattern = (rng.standard_normal((4, 320, 153)) * 0.5).astype(np.float32)
        out.append([script.synth_split(rng, n, pattern) for n in (3, 2)])
    for (jd, jl), (td, tl) in zip(*out):
        assert jd.dtype == td.dtype == np.float32 and jd.shape == td.shape
        assert jd.tobytes() == td.tobytes() and jl.tobytes() == tl.tobytes()
    assert torch_script.N_TRAIN_SUBJ == jax_script.N_TRAIN_SUBJ == 423
    assert torch_script.N_VAL_SUBJ == jax_script.N_VAL_SUBJ == 53


def test_make_data_writes_the_jax_files(scripts, tmp_path, monkeypatch):
    jax_script, torch_script = scripts
    monkeypatch.setattr(jax_script, "WORK", tmp_path / "jax")
    monkeypatch.setattr(jax_script, "N_TRAIN_SUBJ", 3)
    monkeypatch.setattr(jax_script, "N_VAL_SUBJ", 2)
    jax_script.make_data()
    got = torch_script.make_data(tmp_path / "torch", 3, 2)
    want = tmp_path / "jax" / "scan_age" / "template"
    assert got == tmp_path / "torch" / "scan_age" / "template"
    names = sorted(p.name for p in want.iterdir())
    assert names == sorted(p.name for p in got.iterdir()) and len(names) == 4
    for n in names:
        assert (got / n).read_bytes() == (want / n).read_bytes(), n


class _Caught(Exception):
    pass


def _jax_configs(jax_script, work, dtype, monkeypatch) -> tuple:
    """The training and test configs ``one_run`` builds, caught before they
    run."""
    seen = []
    real = jax_config.from_dict

    def catch(raw):
        seen.append(copy.deepcopy(raw))
        if len(seen) == 2:
            raise _Caught
        return real(raw)

    monkeypatch.setattr(jax_script, "REPO", REPO)
    monkeypatch.setattr(jax_script, "WORK", work)
    monkeypatch.setattr(jax_config, "from_dict", catch)
    monkeypatch.setattr(jax_runner, "run_training",
                        lambda exp, **k: {"run_dir": "RUN", "best_mae": 0.0, "best_epoch": 0,
                                          "epochs": 1})
    with pytest.raises(_Caught):
        jax_script.one_run("tag", dtype)
    return tuple(seen)


def _paths_out(raw: dict) -> dict:
    raw = copy.deepcopy(raw)
    raw["data"]["data_path"] = raw["logging"]["folder_to_save_model"] = "PATH"
    return raw


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_recipe_config_matches_one_run(scripts, tmp_path, monkeypatch, dtype):
    """The port's run config equals JAX ``one_run``'s key for key (seed 0)
    apart from the data and log paths, and so does the test driver's."""
    jax_script, torch_script = scripts
    j_train, j_test = _jax_configs(jax_script, tmp_path, dtype, monkeypatch)
    t_train = torch_script.recipe_config(tmp_path, "tag", dtype, seed=0)
    assert _paths_out(t_train) == _paths_out(j_train)
    assert t_train["data"]["data_path"] == j_train["data"]["data_path"]
    assert _paths_out(torch_script.test_config(t_train, "RUN")) == _paths_out(j_test)
    assert j_test["testing"] == {"path_to_ckpt": "RUN"}


def test_run_testing_takes_a_run_folder(tmp_path, monkeypatch):
    """``testing.path_to_ckpt`` at a run folder (or its ``best/``) serves the
    best checkpoint's weights, as the JAX package does: the MAE and
    results.csv of ``best_params.npz``, equal to the run's best val MAE.
    The run writes no TensorBoard events (importing it costs seconds here,
    and this test reads none)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    d, lab = make_regression_dataset(14, seed=3)
    split = tmp_path / "split"
    split.mkdir()
    np.save(split / "validation_data.npy", d[8:])
    np.save(split / "validation_labels.npy", lab[8:])
    raw = {"resolution": {"ico": 6, "sub_ico": 2},
           "transformer": dict(dim=32, depth=2, heads=2, mlp_dim=64, dim_head=16),
           "training": {"bs": 8, "bs_val": 4, "epochs": 3, "val_epoch": 1, "LR": 2e-3},
           "logging": {"folder_to_save_model": str(tmp_path / "logs")},
           "data": {"streaming": "off", "data_path": str(split), "split": "validation"},
           "tpu": {"compute_dtype": "float32"}}
    res = runner.run_training(from_dict(raw), device="cpu", progress=False,
                              datasets={"train": (d[:8], lab[:8]),
                                        "validation": (d[8:], lab[8:])})
    run_dir = Path(res["run_dir"])
    got = {}
    for name, path in (("npz", run_dir / "best_params.npz"), ("run", run_dir),
                       ("best", run_dir / "best")):
        got[name] = runner.run_testing(from_dict({**raw, "testing": {"path_to_ckpt": str(path)}}),
                                       device="cpu")
        with open((path if path.is_dir() else path.parent) / "results.csv") as f:
            got[name]["rows"] = list(csv.reader(f))
    assert got["run"] == got["npz"] == got["best"]
    assert abs(got["run"]["mae"] - res["best_mae"]) < 1e-5
    with pytest.raises(ValueError, match="directory"):
        runner.run_testing(from_dict({**raw, "testing": {"path_to_ckpt": str(split)}}),
                           device="cpu")


def test_the_recorded_recipe_and_the_phase_constants(scripts):
    """``RECIPE_torch.json``: six 100-epoch runs (bf16 and fp32 at seeds 0,
    1, 2) on the named card, each test driver within 1e-6 of its best val
    MAE; its JAX reference is ``RECIPE_r05.json``'s; ``chip_smoke.py``'s
    recipe gate takes the tolerance the record derives, never over 0.10,
    and its dtype gate at most 0.05."""
    _, torch_script = scripts
    rec = json.loads((REPO / "RECIPE_torch.json").read_text())
    jax_rec = json.loads((REPO / "RECIPE_r05.json").read_text())
    assert rec["card"]["name"] and rec["card"]["power.limit"].endswith("W")
    runs = {(r["compute_dtype"], r["seed"]): r for r in rec["runs"]}
    assert set(runs) == {(d, s) for d in ("bfloat16", "float32") for s in (0, 1, 2)}
    for r in runs.values():
        assert r["epochs"] == 100 and r["steps"] == 400 and r["test_n"] == 106
        assert abs(r["test_driver_mae"] - r["best_val_mae"]) <= 1e-6
        assert math.isfinite(r["step_ms_median"]) and r["step_ms_median"] > 0
    for dtype, key in (("bfloat16", "bf16"), ("float32", "fp32")):
        assert torch_script.JAX_BEST[dtype] == jax_rec[key]["best_val_mae"]
        assert rec["jax_record"]["best_val_mae"][dtype] == jax_rec[key]["best_val_mae"]
    assert torch_script.JAX_EPOCH9_BF16 == jax_rec["bf16_pin"]["best_val_mae"]
    spread = rec["seed_spread"]
    assert rec["tolerance"] == torch_script.recipe_tolerance(spread)
    smoke = _load("chip_smoke", REPO / "chip_smoke.py")
    assert smoke.RECIPE_TOL == rec["tolerance"]["recipe_tol"] <= 0.10
    assert smoke.RECIPE_DTYPE_TOL <= 0.05 and smoke.RECIPE_TEST_TOL == 1e-6
    assert smoke.RECIPE_SCRIPT == REPO / "scripts/run_recipe_torch.py"
