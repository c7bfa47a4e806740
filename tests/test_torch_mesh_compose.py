"""FSDP beside tensor parallelism, sequence sharding and a pipeline, on the
CPU: four gloo ranks (``tests/torch_parallel_worker.py``, importing only
the port; one spawn for every four-rank job of the module) against the JAX
``Trainer`` under a ``make_mesh`` of the same shape (conftest's eight CPU
devices) and against the port's own single-process runs, at the JAX
dryrun's size (dim 64, depth 2, ico 2 / sub-ico 0):

* one SGD step of FSDP x TP (1, 2, 2), FSDP x SP (1, 2, 2) with
  ``seq_sharding`` and FSDP x PP (1, 2, 1, 2) with two microbatches, each
  unclipped (every matrix moved) and clipped, from the same parameters as
  the JAX step, on a batch whose zero-weight rows all fall on the first
  batch shard, within the golden 2e-5;
* ``run_training`` under each of those meshes (and FSDP x TP with
  ``grad_accum`` 2 and EMA): best MAE within 1e-6 of the single process,
  the results naming the mesh;
* checkpoints across meshes: a run saved under FSDP x TP resumes with no
  mesh and under TP (1, 1, 2) (a second, two-rank spawn), and a
  single-process file loads under FSDP x TP and FSDP x PP;
* ``run_testing`` under FSDP x PP (the schedule's forward) and
  ``cli.train --multihost`` under FSDP x TP from the config's keys, each
  equal to the single process within 1e-6;
* the groups ``Layout`` gives a rank where 'fsdp' meets 'model' or 'pipe';
* DP x FSDP x TP (2, 2, 2) from the config alone on eight ranks (marked
  slow).
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu.checkpoints.torch_import import sit_params_to_torch
from surface_vision_transformers_tpu.parallel import make_mesh as jax_make_mesh
from surface_vision_transformers_tpu.parallel import shard_batch, shard_params
from surface_vision_transformers_tpu.train import Trainer as JaxTrainer
from surface_vision_transformers_tpu.utils.config import from_dict as jax_from_dict
from surface_vision_transformers_tpu_torch.checkpoints import state as ckpt
from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
from surface_vision_transformers_tpu_torch.train import runner
from surface_vision_transformers_tpu_torch.utils.config import from_dict
from tests.test_torch_parallel import run_ranks

MESH_KEYS = ("mesh_data", "mesh_fsdp", "mesh_model", "mesh_pipe")
FSDP_TP, FSDP_SP, FSDP_PP = (1, 2, 2), (1, 2, 2), (1, 2, 1, 2)
# case: (mesh shape, sequence sharding, clip)
STEP_CASES = {"fsdp_tp": (FSDP_TP, False, 0.0), "fsdp_tp_clip": (FSDP_TP, False, 0.05),
              "fsdp_sp": (FSDP_SP, True, 0.0), "fsdp_sp_clip": (FSDP_SP, True, 0.05),
              "fsdp_pp": (FSDP_PP, False, 0.0), "fsdp_pp_clip": (FSDP_PP, False, 0.05)}
# case: (mesh shape, sequence sharding, training keys)
TRAIN_CASES = {"fsdp_tp": (FSDP_TP, False, {}), "fsdp_sp": (FSDP_SP, True, {}),
               "fsdp_pp": (FSDP_PP, False, {}),
               "fsdp_tp_accum_ema": (FSDP_TP, False, dict(grad_accum=2, ema=0.9))}
GROUP_SHAPES = [(1, 2, 2), (1, 2, 1, 2), (2, 2, 1)]


def raw_cfg(root=None, mesh=(), sp=False, clip=0.0, **training):
    raw = {
        "resolution": {"ico": 2, "sub_ico": 0},
        "transformer": {"dim": 64, "depth": 2, "heads": 2, "mlp_dim": 128, "dim_head": 32},
        "training": {"LR": 5e-3, "bs": 16, "bs_val": 8, "epochs": 2, "seed": 0,
                     "val_epoch": 1, "save_ckpt": False, **training},
        "optimisation": {"optimiser": "SGD", "grad_clip": clip},
        "SGD": {"momentum": 0.9},
        "tpu": {"compute_dtype": "float32", **dict(zip(MESH_KEYS, mesh))},
    }
    if len(mesh) == 4:
        raw["tpu"]["pipe_microbatches"] = 2
    if sp:
        raw["tpu"].update(seq_sharding=True, kernel_backend="pallas")
    if root is not None:
        raw["logging"] = {"folder_to_save_model": str(root)}
    return raw


@pytest.fixture(scope="module")
def data():
    d, lab = make_regression_dataset(40, num_patches=20, num_vertices=15, seed=4,
                                     label_range=(-1, 1))
    return {"train": (d[:28], lab[:28]), "validation": (d[28:], lab[28:])}


def _save_sets(tmp, data):
    sets = {}
    for name, (d, lab) in data.items():
        np.save(tmp / f"{name}_d.npy", d)
        np.save(tmp / f"{name}_l.npy", lab)
        sets[name] = [str(tmp / f"{name}_d.npy"), str(tmp / f"{name}_l.npy")]
    return sets


def _resume_job(tmp, name, mesh, saved: Path, sets):
    return dict(kind="resume", cfg=raw_cfg(tmp / name, mesh, save_ckpt=True), datasets=sets,
                copy=str(tmp / f"{name}_run"), out=str(tmp / f"{name}.json"),
                **{"from": str(saved)})


@pytest.fixture(scope="module")
def single_saved(tmp_path_factory, data):
    """One epoch of the single process, saved (the file the four ranks
    load), -> the path of its results."""
    tmp = tmp_path_factory.mktemp("saved_one")
    res = runner.run_training(from_dict(raw_cfg(tmp / "run", epochs=1, save_ckpt=True)),
                              device="cpu", datasets=copy.deepcopy(data), progress=False)
    (tmp / "one.json").write_text(json.dumps(res))
    return tmp / "one.json"


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory, data, single_saved):
    """Every four-rank job of the module, in one spawn."""
    tmp = tmp_path_factory.mktemp("compose4")
    x, y = data["train"][0][:16], data["train"][1][:16]
    w = np.ones(16, np.float32)
    w[:4] = 0.0  # the re-read rows of a last batch: all in the first batch shard
    for k, v in dict(x=x, y=y, w=w).items():
        np.save(tmp / f"{k}.npy", v)
    params = JaxTrainer(jax_from_dict(raw_cfg())).init_state(x[:1]).params
    init = {k: torch.from_numpy(np.array(v))
            for k, v in sit_params_to_torch(jax.device_get(params), 2).items()}
    torch.save(init, tmp / "init.pt")
    files = {k: str(tmp / f"{k}.npy") for k in "xyw"} | {"init": str(tmp / "init.pt")}
    sets = _save_sets(tmp, data)
    import shutil

    shutil.copy(Path(json.loads(single_saved.read_text())["run_dir"]) / "final_params.npz",
                tmp / "params.npz")
    jobs = [dict(kind="groups", shapes=GROUP_SHAPES, out=str(tmp / "groups.json"))]
    for case, (shape, sp, clip) in STEP_CASES.items():
        jobs.append(dict(kind="step", shape=shape, cfg=raw_cfg(sp=sp, clip=clip),
                         out=str(tmp / f"step_{case}.pt"), **files))
    for case, (shape, sp, training) in TRAIN_CASES.items():
        jobs.append(dict(kind="train", cfg=raw_cfg(tmp / case, shape, sp, **training),
                         datasets=sets, out=str(tmp / f"train_{case}.json")))
    jobs.append(dict(kind="train", cfg=raw_cfg(tmp / "saved", FSDP_TP, epochs=1, save_ckpt=True),
                     datasets=sets, out=str(tmp / "saved_fsdp_tp.json")))
    for name, mesh in (("load_fsdp_tp", FSDP_TP), ("load_fsdp_pp", FSDP_PP)):
        jobs.append(_resume_job(tmp, name, mesh, single_saved, sets))
    (tmp / "split").mkdir()
    for name, (d, lab) in data.items():
        np.save(tmp / "split" / f"{name}_data.npy", d)
        np.save(tmp / "split" / f"{name}_labels.npy", lab)
    jobs.append(dict(kind="testing", cfg=_testing_cfg(tmp, FSDP_PP), out=str(tmp / "testing.json")))
    cli = raw_cfg(tmp / "cli", FSDP_TP)
    cli["data"] = {"data_path": str(tmp / "split")}
    (tmp / "cli.json").write_text(json.dumps(cli))
    jobs.append(dict(kind="cli", config=str(tmp / "cli.json"), out=str(tmp / "cli_out")))
    return run_ranks(tmp, jobs, 4)


def _testing_cfg(tmp, mesh=()):
    """``run_testing`` of the single-process run's final parameters on the
    validation split (under ``mesh``)."""
    raw = raw_cfg(tmp / "testing_out", mesh)
    raw["data"] = {"data_path": str(tmp / "split"), "split": "validation"}
    raw["testing"] = {"path_to_ckpt": str(tmp / "params.npz")}
    return raw


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory, data, ranks4):
    """The run saved under FSDP x TP resumed under TP (1, 1, 2)."""
    tmp = tmp_path_factory.mktemp("compose2")
    sets = _save_sets(tmp, data)
    jobs = [_resume_job(tmp, "resume_tp", (1, 1, 2), ranks4 / "saved_fsdp_tp.json", sets)]
    return run_ranks(tmp, jobs, 2)


def _jax_step(raw, shape, x, y, w):
    exp = jax_from_dict(raw)
    mesh = jax_make_mesh(*shape)
    tr = JaxTrainer(exp, mesh=mesh)
    state = tr.init_state(x[:1])
    step = tr._build_step_fn()
    with mesh:
        state = state.replace(params=shard_params(state.params, mesh))
        state, loss, _ = step(state, shard_batch(jax.numpy.asarray(x), mesh),
                              shard_batch(jax.numpy.asarray(y), mesh), jax.numpy.asarray(w))
    return sit_params_to_torch(jax.device_get(state.params), 2), float(loss)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_step_matches_jax_under_the_composed_mesh(ranks4, data, case):
    """The port's step on four gloo ranks (FSDP2 over 'fsdp' beside TP's
    whole heads, the sequence's rows or the pipeline's stages) equals the
    JAX Trainer's step under the same mesh shape (fp32, 2e-5), from the
    same parameters, on a batch with zero-weight rows; unclipped, every
    matrix moved; clipped, the step is lr * clip over the whole model."""
    x, y = data["train"][0][:16], data["train"][1][:16]
    w = np.load(ranks4 / "w.npy")
    shape, sp, clip = STEP_CASES[case]
    raw = raw_cfg(sp=sp, clip=clip)
    want, want_loss = _jax_step(raw, shape, x, y, w)
    got = torch.load(ranks4 / f"step_{case}.pt", weights_only=True)
    assert abs(got["loss"] - want_loss) < 1e-5, (got["loss"], want_loss)
    init = torch.load(ranks4 / "init.pt", weights_only=True)
    assert set(got["state"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got["state"][k].numpy(), v, atol=2e-5, rtol=0, err_msg=k)
        if v.ndim == 2 and not clip:
            assert np.abs(v - init[k].numpy()).max() > 1e-5, k
    if clip:  # the first SGD step is lr * the clipped gradient
        moved = np.sqrt(sum(np.square(got["state"][k].numpy() - init[k].numpy()).sum()
                            for k in want))
        np.testing.assert_allclose(moved, raw["training"]["LR"] * clip, rtol=1e-3)


@pytest.fixture(scope="module")
def single(tmp_path_factory, data):
    """The single process's runs of the train cases' configs."""
    tmp = tmp_path_factory.mktemp("compose_one")
    out = {}
    for training in ({}, dict(grad_accum=2, ema=0.9)):
        key = json.dumps(training, sort_keys=True)
        out[key] = runner.run_training(from_dict(raw_cfg(tmp / key, **training)), device="cpu",
                                       datasets=copy.deepcopy(data), progress=False)
    return out


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_composed_training_matches_the_single_process(ranks4, single, case):
    """Two epochs of ``run_training`` under FSDP x TP, FSDP x SP, FSDP x PP
    (two microbatches) and FSDP x TP with ``grad_accum`` 2 and EMA (the
    shadow sharded as the weights are), each laid out from the config's
    ``tpu.mesh_*`` keys alone: best MAE within 1e-6 of the single process's,
    the results naming the mesh; the attention through the kernels' entries
    (their plain versions on the CPU) under TP (``flash_attention_qkv``) and
    SP (``flash_attention`` on local queries)."""
    shape, sp, training = TRAIN_CASES[case]
    got = json.loads((ranks4 / f"train_{case}.json").read_text())
    want = single[json.dumps(training, sort_keys=True)]
    assert got["mesh"] == dict(zip(("data", "fsdp", "model", "pipe"), shape))
    assert got["best_epoch"] == want["best_epoch"]
    assert abs(got["best_mae"] - want["best_mae"]) < 1e-6, (got["best_mae"], want["best_mae"])
    assert (got["qkv_calls"] > 0) == (shape[2] > 1 and not sp), got["qkv_calls"]
    assert (got["fa_calls"] > 0) == sp, got["fa_calls"]


@pytest.mark.parametrize("target", ["no mesh", "tp", "load_fsdp_tp", "load_fsdp_pp"])
def test_checkpoints_cross_composed_meshes(request, ranks4, data, single, single_saved,
                                           tmp_path, target):
    """A run saved under FSDP x TP writes the single-process files (every
    tensor whole, the single process's keys and shapes, values within
    1e-6), and a second epoch resumed from them with no mesh or under TP
    (1, 1, 2) ends where the single process's two epochs end; so does a
    single-process file resumed under FSDP x TP and under FSDP x PP."""
    two = single[json.dumps({})]  # the single process's two epochs
    saved = Path(json.loads((ranks4 / "saved_fsdp_tp.json").read_text())["run_dir"])
    if target == "no mesh":
        state, meta = ckpt.load_state(saved / "final")
        ref, _ = ckpt.load_state(Path(json.loads(single_saved.read_text())["run_dir"]) / "final")
        assert meta["epoch"] == 0
        for part in ("model", "optimizer"):
            a, b = ref[part], state[part]
            if part == "optimizer":
                a, b = a["opt"]["state"], b["opt"]["state"]
                a = {f"{i}.{k}": v for i, s in a.items() for k, v in s.items()}
                b = {f"{i}.{k}": v for i, s in b.items() for k, v in s.items()}
            assert set(a) == set(b), part
            for k in a:
                assert not hasattr(b[k], "placements") and a[k].shape == b[k].shape, k
                torch.testing.assert_close(b[k], a[k], atol=1e-6, rtol=0)
        got = runner.run_training(from_dict(raw_cfg(tmp_path / "r", save_ckpt=True)),
                                  device="cpu", datasets=copy.deepcopy(data), progress=False,
                                  resume_from=str(saved))
    elif target == "tp":
        got = json.loads((request.getfixturevalue("ranks2") / "resume_tp.json").read_text())
        assert got["mesh"] == {"data": 1, "fsdp": 1, "model": 2}
    else:
        got = json.loads((ranks4 / f"{target}.json").read_text())
        mesh = FSDP_TP if target == "load_fsdp_tp" else FSDP_PP
        assert got["mesh"] == dict(zip(("data", "fsdp", "model", "pipe"), mesh))
    assert two["best_epoch"] == got["best_epoch"] == 1  # the resumed epoch decides
    assert abs(got["best_mae"] - two["best_mae"]) < 1e-6, (got["best_mae"], two["best_mae"])


def test_run_testing_and_the_cli_under_composed_meshes(ranks4, single):
    """``run_testing`` under FSDP x PP (each stage sharded over its FSDP
    ranks, the split through the schedule's forward) equals the single
    process's within 1e-6; ``cli.train --multihost`` under FSDP x TP from
    the config's keys prints on rank 0 alone, its best MAE the single
    process's within 1e-6 and its mesh named."""
    import ast

    got = json.loads((ranks4 / "testing.json").read_text())
    want = runner.run_testing(from_dict(_testing_cfg(ranks4)), device="cpu")
    assert got["n"] == want["n"] and abs(got["mae"] - want["mae"]) < 1e-6, (got, want)
    outs = [(ranks4 / f"cli_out.rank{r}").read_text() for r in range(4)]
    assert outs[1:] == ["", "", ""]
    res = ast.literal_eval(outs[0].strip().splitlines()[-1])
    assert res["mesh"] == {"data": 1, "fsdp": 2, "model": 2}
    assert res["process_group"] == {"backend": "gloo", "world_size": 4}
    assert abs(res["best_mae"] - single[json.dumps({})]["best_mae"]) < 1e-6


@pytest.mark.parametrize("shape", GROUP_SHAPES, ids=str)
def test_layout_groups_where_fsdp_meets_another_axis(ranks4, shape):
    """Where 'fsdp' > 1 meets 'model' or 'pipe', a rank's batch group is
    ('data', 'fsdp') at its 'model' / 'pipe' coordinate (and FSDP2 shards
    over it), its 'model' and 'pipe' groups lie at its batch coordinate, and
    its seed salt and rows are those of its batch coordinate alone."""
    got = [json.loads((ranks4 / f"groups.json.rank{r}").read_text())[str(tuple(shape))]
           for r in range(4)]
    coords = np.arange(4).reshape(shape)
    for r, g in enumerate(got):
        c = [int(i) for i in np.argwhere(coords == r)[0]]
        d, f = c[0], c[1]
        rest = tuple(c[2:])
        batch = sorted(int(coords[(i, j, *rest)]) for i in range(shape[0])
                       for j in range(shape[1]))
        assert (g["batch"] or [r]) == batch, (r, g)
        assert g["fsdp"] == sorted(int(coords[(d, j, *rest)]) for j in range(shape[1]))
        if shape[2] > 1:
            assert g["model"] == [int(coords[d, f, m]) for m in range(shape[2])]
        if len(shape) == 4:
            assert g["pipe"] == [int(coords[d, f, 0, s]) for s in range(shape[3])]
        assert g["salt"] == d * 2_654_435 + f * 40_503 + (c[2] * 7_919 if len(c) > 2 else 0)
        b = d * shape[1] + f
        per = 16 // (shape[0] * shape[1])
        assert g["rows"] == list(range(b * per, (b + 1) * per))


@pytest.mark.slow
def test_dp_fsdp_tp_from_the_config_alone_on_eight_ranks(tmp_path, data, single):
    """The JAX multichip dry run's first case, DP x FSDP x TP (2, 2, 2) from
    the config alone: ``run_training`` on eight gloo ranks, best MAE within
    1e-6 of the single process's, the results naming the mesh."""
    sets = _save_sets(tmp_path, data)
    jobs = [dict(kind="train", cfg=raw_cfg(tmp_path / "run", (2, 2, 2)), datasets=sets,
                 out=str(tmp_path / "train.json"))]
    got = json.loads((run_ranks(tmp_path, jobs, 8) / "train.json").read_text())
    want = single[json.dumps({})]
    assert got["mesh"] == {"data": 2, "fsdp": 2, "model": 2}
    assert abs(got["best_mae"] - want["best_mae"]) < 1e-6, (got["best_mae"], want["best_mae"])
