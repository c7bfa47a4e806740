"""The port's GPipe schedule (``parallel/pipeline.py``) on the CPU: gloo
ranks (``tests/torch_parallel_worker.py``, importing only the port) against
the JAX ``Trainer`` under ``make_mesh(pipe=2)`` and against the port's own
single-process runs, at the JAX dryrun's size (dim 64, depth 2, ico 2 /
sub-ico 0; depth 4 where two blocks a stage are wanted):

* one SGD step of PP (1, 1, 1, 2) and of DP x PP (2, 1, 1, 2), from the
  same parameters as the JAX step, within the golden 2e-5 (the DP x PP step
  clipped: the norm over the stages' blocks and the shared parameters);
* ``run_training`` under PP and DP x PP: best MAE within 1e-6 of the single
  process (evaluation through the schedule's forward); ``cli.train
  --multihost`` under PP;
* ``run_testing`` in the pipe group equal to the single process's;
* a run saved under PP resumes with no mesh, one saved under TP under PP;
* JAX's refusals of a pipelined run, with JAX's messages.
"""

from __future__ import annotations

import copy
import json
import types
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
from surface_vision_transformers_tpu_torch.models.sit import SiT
from surface_vision_transformers_tpu_torch.parallel import pipeline
from surface_vision_transformers_tpu_torch.train import runner
from surface_vision_transformers_tpu_torch.utils.config import from_dict
from tests.test_torch_parallel import run_ranks

MESH_KEYS = ("mesh_data", "mesh_fsdp", "mesh_model", "mesh_pipe")
DEPTH = 4  # two blocks a stage
# (mesh shape, clip, world)
STEP_CASES = {"pp": ((1, 1, 1, 2), 0.0, 2), "dp_pp_clip": ((2, 1, 1, 2), 0.05, 4)}
TRAIN_CASES = {"pp": ((1, 1, 1, 2), 2), "dp_pp": ((2, 1, 1, 2), 4)}


def raw_cfg(root=None, mesh=(), depth=DEPTH, **training):
    raw = {
        "resolution": {"ico": 2, "sub_ico": 0},
        "transformer": {"dim": 64, "depth": depth, "heads": 2, "mlp_dim": 128,
                        "dim_head": 32},
        "training": {"LR": 5e-3, "bs": 16, "bs_val": 8, "epochs": 2, "seed": 0,
                     "val_epoch": 1, "save_ckpt": False, **training},
        "optimisation": {"optimiser": "SGD"},
        "SGD": {"momentum": 0.9},
        "tpu": {"compute_dtype": "float32", **dict(zip(MESH_KEYS, mesh))},
    }
    if root is not None:
        raw["logging"] = {"folder_to_save_model": str(root)}
    return raw


def train_cfg(case, root=None, single=False):
    return raw_cfg(root, () if single else TRAIN_CASES[case][0])


@pytest.fixture(scope="module")
def data():
    d, lab = make_regression_dataset(40, num_patches=20, num_vertices=15, seed=1,
                                     label_range=(-1, 1))
    return {"train": (d[:28], lab[:28]), "validation": (d[28:], lab[28:])}


def _save_sets(tmp, data):
    sets = {}
    for name, (d, lab) in data.items():
        np.save(tmp / f"{name}_d.npy", d)
        np.save(tmp / f"{name}_l.npy", lab)
        sets[name] = [str(tmp / f"{name}_d.npy"), str(tmp / f"{name}_l.npy")]
    return sets


@pytest.fixture(scope="module")
def init(data):
    """The JAX Trainer's seeded parameters in the port's layout."""
    params = JaxTrainer(jax_from_dict(raw_cfg())).init_state(data["train"][0][:1]).params
    return {k: torch.from_numpy(np.array(v))
            for k, v in sit_params_to_torch(jax.device_get(params), DEPTH).items()}


def _step_inputs(tmp, data, init):
    x, y = data["train"][0][:16], data["train"][1][:16]
    w = np.ones(16, np.float32)
    w[:4] = 0.0  # a last batch's re-read rows, all in the first data shard
    for k, v in dict(x=x, y=y, w=w).items():
        np.save(tmp / f"{k}.npy", v)
    torch.save(init, tmp / "init.pt")
    return {k: str(tmp / f"{k}.npy") for k in "xyw"} | {"init": str(tmp / "init.pt")}


def _step_job(tmp, case, files):
    shape, clip, _ = STEP_CASES[case]
    cfg = raw_cfg()
    cfg["optimisation"]["grad_clip"] = clip
    return dict(kind="step", shape=shape, cfg=cfg, out=str(tmp / f"step_{case}.pt"), **files)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, data, init):
    """The two-rank jobs: PP steps, PP runs, run_testing, the CLI, resume."""
    tmp = tmp_path_factory.mktemp("pipe2")
    files = _step_inputs(tmp, data, init)
    sets = _save_sets(tmp, data)
    jobs = [_step_job(tmp, c, files) for c, v in STEP_CASES.items() if v[2] == 2]
    for case, (_, world) in TRAIN_CASES.items():
        if world == 2:
            jobs.append(dict(kind="train", cfg=train_cfg(case, tmp / case), datasets=sets,
                             out=str(tmp / f"train_{case}.json")))
    # run_testing of a params npz in the pipe group
    test_cfg = raw_cfg(mesh=(1, 1, 1, 2))
    test_cfg["data"] = {"data_path": str(tmp / "split"), "split": "validation"}
    test_cfg["testing"] = {"path_to_ckpt": str(tmp / "testing" / "params.npz")}
    (tmp / "split").mkdir()
    (tmp / "testing").mkdir()
    for name, (d, lab) in data.items():
        np.save(tmp / "split" / f"{name}_data.npy", d)
        np.save(tmp / "split" / f"{name}_labels.npy", lab)
    model = SiT.from_config(from_dict(test_cfg))
    runner._save_npz(tmp / "testing" / "params.npz", model, DEPTH)
    jobs.append(dict(kind="testing", cfg=test_cfg, out=str(tmp / "testing.json")))
    cli = raw_cfg(tmp / "cli", (1, 1, 1, 2))
    cli["data"] = {"data_path": str(tmp / "split")}
    cli["tpu"]["pipe_microbatches"] = 4
    (tmp / "cli.json").write_text(json.dumps(cli))
    jobs.append(dict(kind="cli", config=str(tmp / "cli.json"), out=str(tmp / "cli_out")))
    # saved under PP (for a resume without a mesh) and under TP, then resumed under PP
    for name, mesh in (("saved_pp", (1, 1, 1, 2)), ("saved_tp", (1, 1, 2))):
        jobs.append(dict(kind="train", cfg=raw_cfg(tmp / name, mesh, epochs=1, save_ckpt=True),
                         datasets=sets, out=str(tmp / f"{name}.json")))
    jobs.append(dict(kind="resume", cfg=raw_cfg(tmp / "resume_pp", (1, 1, 1, 2), save_ckpt=True),
                     datasets=sets, copy=str(tmp / "resume_pp_run"),
                     out=str(tmp / "resume_pp.json"), **{"from": str(tmp / "saved_tp.json")}))
    refused = raw_cfg(tmp / "refused", (1, 1, 1, 2), depth=2)
    refused["transformer"]["dropout"] = 0.1
    jobs.append(dict(kind="train", cfg=refused, datasets=sets, refusal=True,
                     out=str(tmp / "refused.json")))
    return run_ranks(tmp, jobs, 2)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory, data, init):
    """The four-rank jobs: DP x PP."""
    tmp = tmp_path_factory.mktemp("pipe4")
    files = _step_inputs(tmp, data, init)
    sets = _save_sets(tmp, data)
    jobs = [_step_job(tmp, c, files) for c, v in STEP_CASES.items() if v[2] == 4]
    jobs += [dict(kind="train", cfg=train_cfg(case, tmp / case), datasets=sets,
                  out=str(tmp / f"train_{case}.json"))
             for case, (_, world) in TRAIN_CASES.items() if world == 4]
    return run_ranks(tmp, jobs, 4)


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
    return sit_params_to_torch(jax.device_get(state.params), DEPTH), float(loss)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_step_matches_jax_under_the_same_mesh(request, data, case):
    """The port's GPipe step on the gloo ranks equals the JAX Trainer's
    ``pipeline_loss`` step under the same mesh (fp32, 2e-5) from the same
    parameters, on a batch with zero-weight rows; every matrix moved (the
    clipped step by lr * clip over the whole model)."""
    root = request.getfixturevalue("ranks4" if STEP_CASES[case][2] == 4 else "ranks")
    x, y = data["train"][0][:16], data["train"][1][:16]
    w = np.load(root / "w.npy")
    shape, clip, _ = STEP_CASES[case]
    raw = raw_cfg()
    raw["optimisation"]["grad_clip"] = clip
    want, want_loss = _jax_step(raw, shape, x, y, w)
    got = torch.load(root / f"step_{case}.pt", weights_only=True)
    assert abs(got["loss"] - want_loss) < 1e-5, (got["loss"], want_loss)
    init = torch.load(root / "init.pt", weights_only=True)
    assert set(got["state"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got["state"][k].numpy(), v, atol=2e-5, rtol=0, err_msg=k)
        if v.ndim == 2 and not clip:
            assert np.abs(v - init[k].numpy()).max() > 1e-5, k
    if clip:
        moved = np.sqrt(sum(np.square(got["state"][k].numpy() - init[k].numpy()).sum()
                            for k in want))
        np.testing.assert_allclose(moved, raw["training"]["LR"] * clip, rtol=1e-3)


@pytest.fixture(scope="module")
def single(tmp_path_factory, data):
    tmp = tmp_path_factory.mktemp("single")
    return runner.run_training(from_dict(raw_cfg(tmp)), device="cpu",
                               datasets=copy.deepcopy(data), progress=False)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_pipelined_training_matches_the_single_process(request, single, case):
    """Two epochs of ``run_training`` under PP and DP x PP: best MAE within 1e-6 of the single process's, validated
    through the schedule's forward; the results name the four-axis mesh."""
    root = request.getfixturevalue("ranks4" if TRAIN_CASES[case][1] == 4 else "ranks")
    got = json.loads((root / f"train_{case}.json").read_text())
    assert got["mesh"] == dict(zip(("data", "fsdp", "model", "pipe"), TRAIN_CASES[case][0]))
    assert got["best_epoch"] == single["best_epoch"]
    assert abs(got["best_mae"] - single["best_mae"]) < 1e-6, (got, single)


def test_run_testing_through_the_schedule(ranks, data, tmp_path):
    """``run_testing`` in a pipe group (the schedule's forward, the last
    stage's predictions) equals the single process's: MAE within 1e-6."""
    got = json.loads((ranks / "testing.json").read_text())
    raw = raw_cfg()
    raw["data"] = {"data_path": str(ranks / "split"), "split": "validation"}
    raw["testing"] = {"path_to_ckpt": str(ranks / "testing" / "params.npz")}
    raw["logging"] = {"folder_to_save_model": str(tmp_path)}
    want = runner.run_testing(from_dict(raw), device="cpu")
    assert got["n"] == want["n"] == len(data["validation"][1])
    assert abs(got["mae"] - want["mae"]) < 1e-6, (got, want)


def test_cli_train_multihost_under_a_pipeline(ranks, single):
    """``cli.train --multihost`` with ``tpu.mesh_pipe: 2`` and four
    microbatches on the two ranks (gloo: the CPU's backend) trains through
    the schedule; rank 0 alone prints, its best MAE the single process's
    within 1e-6."""
    import ast

    outs = [(ranks / f"cli_out.rank{r}").read_text() for r in range(2)]
    assert outs[1] == ""
    got = ast.literal_eval(outs[0].strip().splitlines()[-1])
    assert got["mesh"] == {"data": 1, "fsdp": 1, "model": 1, "pipe": 2}
    assert got["process_group"] == {"backend": "gloo", "world_size": 2}
    assert abs(got["best_mae"] - single["best_mae"]) < 1e-6


def test_checkpoints_cross_meshes(ranks, data, tmp_path):
    """A run saved under PP writes the single-process files (the stages'
    blocks gathered whole, the optimizer's moments in the single process's
    order) and a second epoch resumed from them with no mesh ends where the
    single process's two epochs end; so does one saved under TP (uneven
    files: none, heads 2 over 2) and resumed under PP."""
    saved = json.loads((ranks / "saved_pp.json").read_text())
    run_dir = Path(saved["run_dir"])
    state, meta = ckpt.load_state(run_dir / "final")
    assert meta["epoch"] == 0
    ref = runner.run_training(from_dict(raw_cfg(tmp_path / "one", epochs=1, save_ckpt=True)),
                              device="cpu", datasets=copy.deepcopy(data), progress=False)
    ref_state, _ = ckpt.load_state(Path(ref["run_dir"]) / "final")
    for part in ("model", "optimizer"):
        a, b = ref_state[part], state[part]
        if part == "optimizer":
            assert a["count"] == b["count"]
            a, b = a["opt"]["state"], b["opt"]["state"]
            a = {f"{i}.{k}": v for i, s in a.items() for k, v in s.items()}
            b = {f"{i}.{k}": v for i, s in b.items() for k, v in s.items()}
        assert set(a) == set(b), part
        for k in a:
            assert a[k].shape == b[k].shape, k
            torch.testing.assert_close(b[k], a[k], atol=1e-6, rtol=0)
    resumed = runner.run_training(from_dict(raw_cfg(tmp_path / "r", epochs=2, save_ckpt=True)),
                                  device="cpu", datasets=copy.deepcopy(data), progress=False,
                                  resume_from=str(run_dir))
    two = runner.run_training(from_dict(raw_cfg(tmp_path / "two", epochs=2)), device="cpu",
                              datasets=copy.deepcopy(data), progress=False)
    assert two["best_epoch"] == resumed["best_epoch"] == 1
    assert abs(resumed["best_mae"] - two["best_mae"]) < 1e-6, (resumed, two)
    other = json.loads((ranks / "resume_pp.json").read_text())
    assert other["mesh"]["pipe"] == 2 and other["best_epoch"] == 1
    assert abs(other["best_mae"] - two["best_mae"]) < 1e-6, (other, two)


def _jax_message(raw, shape, bs=None):
    """JAX's ValueError for a pipelined config: the Trainer's checks at its
    construction, then ``pipeline_loss``'s at a batch of ``bs`` (raised
    before the parameters are read)."""
    from surface_vision_transformers_tpu.parallel.pipeline import pipeline_loss

    exp = jax_from_dict(raw)
    mesh = jax_make_mesh(*shape)
    with pytest.raises(ValueError) as e:
        tr = JaxTrainer(exp, mesh=mesh)
        pipeline_loss(tr.model, mesh, None, np.zeros((bs or exp.training.bs, 1)), None, None,
                      n_microbatches=raw["tpu"].get("pipe_microbatches") or None)
    return str(e.value)


def _layout(pipe=2, model=1, batch=1):
    return types.SimpleNamespace(pipe_size=pipe, model_size=model, batch_count=batch)


REFUSALS = {
    "mpp": lambda r: r.update(SSL="mpp", pretraining_mpp={"mask_prob": 0.5}),
    "mssit": lambda r: r.update(
        transformer={"model": "MS-SiT", "num_channels": 4},
        resolution={"ico": 2, "sub_ico": 1},
        mssit={"embed_dim": 16, "depths": [1, 1], "heads": [2, 4], "window": 4,
               "global_max": 8}),
    "dropout": lambda r: r["transformer"].update(dropout=0.1),
    "depth": lambda r: r["transformer"].update(depth=3),
    "grad_accum": lambda r: r["training"].update(grad_accum=2),
    "tp": None,
    "batch": None,
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_jax_refusals_and_messages(case):
    """Each of JAX's refusals of a pipelined run (MPP, MS-SiT, dropout,
    depth % stages, grad_accum > 1, TP with PP, a batch the data shards
    and microbatches do not divide) is raised by the port as a ValueError
    with JAX's message."""
    from surface_vision_transformers_tpu_torch.models.mssit import MSSiT

    raw = raw_cfg(mesh=(1, 1, 1, 2), depth=2)
    if REFUSALS[case] is not None:
        REFUSALS[case](raw)
    exp = from_dict(raw)
    shape = (1, 1, 2, 2) if case == "tp" else (1, 1, 1, 2)
    if case == "mssit":  # JAX refuses at construction, before it reads a table
        with pytest.raises(ValueError) as e:
            JaxTrainer(jax_from_dict(raw), mesh=jax_make_mesh(*shape))
        want = str(e.value)
    else:
        want = _jax_message(raw, shape, bs=5 if case == "batch" else None)
    with pytest.raises(ValueError) as got:
        if case == "batch":
            pipeline.check_batch(5, _layout(), pipeline.microbatches(exp))
        else:
            encoder = (MSSiT if case == "mssit" else SiT).from_config(exp)
            pipeline.check_pipeline(exp, encoder, "mpp" if case == "mpp" else "regression",
                                    _layout(model=shape[2]))
    assert str(got.value) == want


def test_a_pipelined_run_refuses_through_the_runner(ranks, data):
    """``run_training`` of a pipelined config with dropout, on the two
    ranks, raises JAX's message from the trainer's construction."""
    got = json.loads((ranks / "refused.json").read_text())
    raw = raw_cfg(depth=2)
    raw["transformer"]["dropout"] = 0.1
    assert got["error"] == "ValueError: " + _jax_message(raw, (1, 1, 1, 2))
