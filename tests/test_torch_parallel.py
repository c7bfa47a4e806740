"""The port under a mesh, on the CPU: two gloo ranks (``tests/
torch_parallel_worker.py``, spawned once for the module, importing only
the port) against the JAX ``Trainer`` under a ``make_mesh`` of the same
shape and against the port's own single-process runs.

At dim 64, depth 2, ico 2 / sub-ico 0 (the JAX dryrun's size):
* one SGD step of DP (2,1,1), FSDP (1,2,1) and TP (1,1,2) -- on a batch
  whose zero-weight rows all fall on rank 0, where averaging the ranks'
  gradients would be wrong, and with the clip on under FSDP and TP --
  against the JAX step from the same parameters, within the golden 2e-5;
* ``run_training`` under each mesh, under DP with ``grad_accum`` 2 and
  EMA, MPP, augmentation, streamed input and the fused route (bfloat16)
  under DP, and ``cli.train --multihost`` on both ranks: best metric
  within 1e-6 of the single process (the fused route within its bf16
  step), and under TP the attention through ``flash_attention_qkv``;
* a run saved under FSDP resumes with no mesh and under TP, one saved
  under TP under FSDP, from single-process files;
* DP x FSDP and DP x TP on four ranks against the single process;
* dropout under DP and TP trains;
* FSDP beside TP trains (FSDP2 on the size-1 'fsdp' axis); the refusals
  (the fused paths under FSDP / TP, a second initialisation, MLP and MPP
  decoder widths the 'model' axis does not divide, as JAX's placement
  refuses them), uneven heads and fewer heads than ranks taken, the
  pipeline and sequence keys read on one process, and the rules that need
  no process group (placements, the rows a rank holds,
  ``mesh_from_config``).

FSDP beside TP, sequence sharding and a pipeline on four ranks:
``tests/test_torch_mesh_compose.py``.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
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
from surface_vision_transformers_tpu_torch import parallel
from surface_vision_transformers_tpu_torch.checkpoints import state as ckpt
from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
from surface_vision_transformers_tpu_torch.parallel.mesh import Layout, even_split
from surface_vision_transformers_tpu_torch.train import runner
from surface_vision_transformers_tpu_torch.utils.config import from_dict

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_parallel_worker.py"
SHAPES = {"dp": (2, 1, 1), "fsdp": (1, 2, 1), "tp": (1, 1, 2)}
# (mesh shape, clip): TP has no batch split, so its step is checked clipped
# (the norm over the ranks' slices); DP and FSDP also unclipped, where a
# gradient averaged over ranks instead of summed would show
STEP_CASES = {"dp": ((2, 1, 1), 0.0), "fsdp": ((1, 2, 1), 0.0),
              "fsdp_clip": ((1, 2, 1), 0.05), "tp": ((1, 1, 2), 0.05)}


def raw_cfg(root=None, mesh=(), **training):
    """The JAX dryrun's SiT (ico 2 / sub-ico 0: 20 patches of 15 vertices)."""
    raw = {
        "resolution": {"ico": 2, "sub_ico": 0},
        "transformer": {"dim": 64, "depth": 2, "heads": 2, "mlp_dim": 128, "dim_head": 32},
        "training": {"LR": 5e-3, "bs": 16, "bs_val": 8, "epochs": 2, "seed": 0,
                     "val_epoch": 1, "save_ckpt": False, **training},
        "optimisation": {"optimiser": "SGD"},
        "SGD": {"momentum": 0.9},
        "tpu": {"compute_dtype": "float32", **dict(zip(("mesh_data", "mesh_fsdp",
                                                        "mesh_model"), mesh))},
    }
    if root is not None:
        raw["logging"] = {"folder_to_save_model": str(root)}
    return raw


TRAIN_CASES = {
    "dp": dict(mesh=(2, 1, 1)),
    "fsdp": dict(mesh=(1, 2, 1)),
    "tp": dict(mesh=(1, 1, 2)),
    "dp_accum_ema": dict(mesh=(2, 1, 1), grad_accum=2, ema=0.9),
}


def _mpp(raw):
    raw["SSL"] = "mpp"
    raw["pretraining_mpp"] = {"mask_prob": 0.5, "replace_prob": 0.8, "swap_prob": 0.1}
    return raw


def _bf16(raw):
    raw["tpu"]["compute_dtype"] = "bfloat16"
    return raw


def _aug(raw):
    raw["augmentation"] = {"enabled": True, "num_warps": 2, "warp_prob": 0.5}
    return raw


def _stream(raw):
    raw["data"] = {"streaming": "on"}
    return raw


def _dropout(raw):
    raw["transformer"].update(dropout=0.1, emb_dropout=0.1)
    return raw


# dropout under DP and TP: every mask but the attention kernel's is the single
# process's (test_rank_draws_are_the_single_process_rows), so these runs are
# checked for running, not for equality
DROPOUT_CASES = {"dropout_dp": (2, 1, 1), "dropout_tp": (1, 1, 2)}


EXTRA_CASES = {"mpp_dp": _mpp, "fused_dp": _bf16, "aug_dp": _aug,  # each under (2, 1, 1)
               "stream_dp": _stream}


def train_cfg(case, root=None, single=False):
    kw = dict(TRAIN_CASES.get(case, dict(mesh=(2, 1, 1))))
    mesh = () if single else kw.pop("mesh")
    kw.pop("mesh", None)
    raw = raw_cfg(root, mesh, **kw)
    return EXTRA_CASES.get(case, lambda r: r)(raw)


@pytest.fixture(scope="module")
def data():
    d, lab = make_regression_dataset(40, num_patches=20, num_vertices=15, seed=0,
                                     label_range=(-1, 1))
    return {"train": (d[:28], lab[:28]), "validation": (d[28:], lab[28:])}


def _jax_params(x):
    exp = jax_from_dict(raw_cfg())
    return jax.device_get(JaxTrainer(exp).init_state(x[:1]).params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, data):
    """Every job of the module on one pair of gloo ranks; -> the folder of
    their results."""
    tmp = tmp_path_factory.mktemp("ranks")
    x, y = data["train"][0][:16], data["train"][1][:16]
    w = np.ones(16, np.float32)
    w[:4] = 0.0  # the re-read rows of a last batch: all on rank 0
    for k, v in dict(x=x, y=y, w=w).items():
        np.save(tmp / f"{k}.npy", v)
    init = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sit_params_to_torch(_jax_params(x), 2).items()}
    torch.save(init, tmp / "init.pt")
    sets = {}
    for name, (d, lab) in data.items():
        np.save(tmp / f"{name}_d.npy", d)
        np.save(tmp / f"{name}_l.npy", lab)
        sets[name] = [str(tmp / f"{name}_d.npy"), str(tmp / f"{name}_l.npy")]
    jobs = []
    for case, (shape, clip) in STEP_CASES.items():
        cfg = raw_cfg()
        cfg["optimisation"]["grad_clip"] = clip  # below the step's norm, so it acts
        jobs.append(dict(kind="step", shape=shape, cfg=cfg, init=str(tmp / "init.pt"),
                         x=str(tmp / "x.npy"), y=str(tmp / "y.npy"), w=str(tmp / "w.npy"),
                         out=str(tmp / f"step_{case}.pt")))
    for case in (*TRAIN_CASES, *EXTRA_CASES):
        jobs.append(dict(kind="train", cfg=train_cfg(case, tmp / case), datasets=sets,
                         out=str(tmp / f"train_{case}.json")))
    for case, shape in DROPOUT_CASES.items():
        jobs.append(dict(kind="train", cfg=_dropout(raw_cfg(tmp / case, shape)), datasets=sets,
                         out=str(tmp / f"train_{case}.json")))
    cli = raw_cfg(tmp / "cli")
    cli["data"] = {"data_path": str(tmp / "split")}
    (tmp / "split").mkdir()
    for name, (d, lab) in data.items():
        np.save(tmp / "split" / f"{name}_data.npy", d)
        np.save(tmp / "split" / f"{name}_labels.npy", lab)
    (tmp / "cli.json").write_text(json.dumps(cli))
    jobs.append(dict(kind="cli", config=str(tmp / "cli.json"), out=str(tmp / "cli_out")))
    resume = raw_cfg(tmp / "resume", (1, 2, 1), epochs=1, save_ckpt=True)
    jobs.append(dict(kind="train", cfg=resume, datasets=sets, out=str(tmp / "train_resume.json")))
    saved_tp = raw_cfg(tmp / "saved_tp", (1, 1, 2), epochs=1, save_ckpt=True)
    jobs.append(dict(kind="train", cfg=saved_tp, datasets=sets, out=str(tmp / "saved_tp.json")))
    for name, mesh, saved in (("tp", (1, 1, 2), "train_resume"), ("fsdp", (1, 2, 1), "saved_tp")):
        jobs.append(dict(kind="resume", cfg=raw_cfg(tmp / f"resume_{name}", mesh, save_ckpt=True),
                         datasets=sets, copy=str(tmp / f"resume_{name}_run"),
                         out=str(tmp / f"resume_{name}.json"),
                         **{"from": str(tmp / f"{saved}.json")}))
    jobs.append(dict(kind="refusals", cfg=raw_cfg(), out=str(tmp / "refusals.json")))
    return run_ranks(tmp, jobs, 2)


def run_ranks(tmp: Path, jobs: list, world: int) -> Path:
    """``jobs`` on ``world`` gloo ranks (worker processes); -> ``tmp``."""
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK", "LOCAL_RANK"))}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(tmp / "rdv"), str(r),
                               str(world), str(tmp / "jobs.json")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    t0 = time.time()
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(1, 300 - (time.time() - t0)))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    errors = sorted(tmp.glob("*.error*"))
    assert not errors and all(p.returncode == 0 for p in procs), (
        "\n".join(e.read_text() for e in errors) or "\n".join(o[-3000:] for o in outs))
    return tmp


# two axes at once on four ranks: DP x FSDP (FSDP2's hybrid sharding, the
# batch group across both axes) and DP x TP
FOUR_RANK_CASES = {"dp_fsdp": (2, 2, 1), "dp_tp": (2, 1, 2)}


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory, data):
    tmp = tmp_path_factory.mktemp("ranks4")
    sets = {}
    for name, (d, lab) in data.items():
        np.save(tmp / f"{name}_d.npy", d)
        np.save(tmp / f"{name}_l.npy", lab)
        sets[name] = [str(tmp / f"{name}_d.npy"), str(tmp / f"{name}_l.npy")]
    jobs = [dict(kind="train", cfg=raw_cfg(tmp / case, shape, grad_accum=2), datasets=sets,
                 out=str(tmp / f"train_{case}.json")) for case, shape in FOUR_RANK_CASES.items()]
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
    return sit_params_to_torch(jax.device_get(state.params), 2), float(loss)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_step_matches_jax_under_the_same_mesh(ranks, data, case):
    """The port's step on 2 gloo ranks equals the JAX Trainer's step under
    the same mesh shape (fp32, 2e-5), from the same parameters, on a batch
    with zero-weight rows; the step moved every matrix."""
    x, y = data["train"][0][:16], data["train"][1][:16]
    w = np.load(ranks / "w.npy")
    raw = raw_cfg()
    shape, clip = STEP_CASES[case]
    raw["optimisation"]["grad_clip"] = clip
    want, want_loss = _jax_step(raw, shape, x, y, w)
    got = torch.load(ranks / f"step_{case}.pt", weights_only=True)
    assert abs(got["loss"] - want_loss) < 1e-5, (got["loss"], want_loss)
    init = torch.load(ranks / "init.pt", weights_only=True)
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
    """The port's single-process runs of the train cases."""
    tmp = tmp_path_factory.mktemp("single")
    out = {}
    for case in ("dp", "dp_accum_ema", *EXTRA_CASES):
        out[case] = runner.run_training(from_dict(train_cfg(case, tmp / case, single=True)),
                                        device="cpu", datasets=copy.deepcopy(data),
                                        progress=False)
    return out


@pytest.mark.parametrize("case", [*TRAIN_CASES, *EXTRA_CASES])
def test_mesh_training_matches_the_single_process(ranks, single, case):
    """Two epochs of ``run_training`` under each mesh (MPP, the bfloat16
    fused route and augmentation under DP): the best metric is the single
    process's within 1e-6 (the fused route within a bf16 step of the loss's
    scale), the results name the mesh, and under TP the attention ran
    through ``flash_attention_qkv`` (its plain version on the CPU), as the
    JAX dryrun's case 3b asserts with its counter."""
    got = json.loads((ranks / f"train_{case}.json").read_text())
    want = single[case if case in single else "dp"]
    metric = "best_loss" if case == "mpp_dp" else "best_mae"
    tol = 4e-3 * abs(want[metric]) if case == "fused_dp" else 1e-6
    assert abs(got[metric] - want[metric]) <= tol, (got[metric], want[metric])
    assert got["best_epoch"] == want["best_epoch"]
    shape = TRAIN_CASES.get(case, dict(mesh=(2, 1, 1)))["mesh"]
    assert got["mesh"] == dict(zip(parallel.AXES, shape))
    assert (got["qkv_calls"] > 0) == (case == "tp"), got["qkv_calls"]


@pytest.fixture(scope="module")
def single_accum(tmp_path_factory, data):
    return runner.run_training(from_dict(raw_cfg(tmp_path_factory.mktemp("accum"),
                                                 grad_accum=2)),
                               device="cpu", datasets=copy.deepcopy(data), progress=False)


@pytest.mark.parametrize("case", list(FOUR_RANK_CASES))
def test_two_axes_on_four_ranks_match_the_single_process(ranks4, single_accum, case):
    """DP x FSDP and DP x TP on four gloo ranks, ``grad_accum`` 2: two
    epochs' best MAE within 1e-6 of the single process's."""
    got = json.loads((ranks4 / f"train_{case}.json").read_text())
    want = single_accum
    assert got["mesh"] == dict(zip(parallel.AXES, FOUR_RANK_CASES[case]))
    assert got["best_epoch"] == want["best_epoch"]
    assert abs(got["best_mae"] - want["best_mae"]) < 1e-6, (got, want)


@pytest.mark.parametrize("case", list(DROPOUT_CASES))
def test_dropout_trains_under_a_mesh(ranks, case):
    """Dropout 0.1 under DP and TP (the masks drawn at the global batch's
    shape, a TP rank's GELU mask its columns, the attention kernel through
    ``flash_attention_qkv_dropout`` under TP) trains to finite metrics."""
    got = json.loads((ranks / f"train_{case}.json").read_text())
    assert np.isfinite(got["best_mae"]) and got["best_epoch"] >= 0
    assert got["mesh"] == dict(zip(parallel.AXES, DROPOUT_CASES[case]))


def test_fsdp_checkpoint_resumes_without_a_mesh(ranks, data, tmp_path):
    """A run saved under FSDP (1,2,1) writes the single-process files (every
    tensor whole, the same keys and shapes), and a second epoch resumed
    from it in one process, or under TP (1,1,2) on the two ranks, ends
    where the single process's two epochs end; so does one saved under TP
    and resumed under FSDP."""
    got = json.loads((ranks / "train_resume.json").read_text())
    run_dir = Path(got["run_dir"])
    state, meta = ckpt.load_state(run_dir / "final")
    assert meta["epoch"] == 0
    ref = runner.run_training(from_dict(raw_cfg(tmp_path / "one", epochs=1, save_ckpt=True)),
                              device="cpu", datasets=copy.deepcopy(data), progress=False)
    ref_state, _ = ckpt.load_state(Path(ref["run_dir"]) / "final")
    for part in ("model", "optimizer"):
        a, b = ref_state[part], state[part]
        if part == "optimizer":
            a, b = a["opt"]["state"], b["opt"]["state"]
            a = {f"{i}.{k}": v for i, s in a.items() for k, v in s.items()}
            b = {f"{i}.{k}": v for i, s in b.items() for k, v in s.items()}
        assert set(a) == set(b), part
        for k in a:
            assert not hasattr(b[k], "placements") and a[k].shape == b[k].shape, k
            torch.testing.assert_close(b[k], a[k], atol=1e-6, rtol=0)
    assert (run_dir / "final_params.npz").exists()
    resumed = runner.run_training(from_dict(raw_cfg(tmp_path / "r", epochs=2, save_ckpt=True)),
                                  device="cpu", datasets=copy.deepcopy(data), progress=False,
                                  resume_from=str(run_dir))
    two = runner.run_training(from_dict(raw_cfg(tmp_path / "two", epochs=2)), device="cpu",
                              datasets=copy.deepcopy(data), progress=False)
    assert two["best_epoch"] == resumed["best_epoch"] == 1  # the resumed epoch decides
    assert abs(resumed["best_mae"] - two["best_mae"]) < 1e-6, (resumed, two)
    for name, shape in (("tp", (1, 1, 2)), ("fsdp", (1, 2, 1))):
        other = json.loads((ranks / f"resume_{name}.json").read_text())
        assert other["mesh"] == dict(zip(parallel.AXES, shape)) and other["best_epoch"] == 1
        assert abs(other["best_mae"] - two["best_mae"]) < 1e-6, (name, other, two)


def test_refusals_under_a_mesh(ranks):
    """The fused paths under FSDP and TP (whose trainers take the modular
    route) and a second, different initialisation are refused with a
    message; pure DP runs fused. FSDP with TP is no longer refused: a step
    of FSDP2 on the size-1 'fsdp' axis beside TP trains to a finite loss.
    Heads the model axis does not divide are taken (3 heads over 2 ranks
    split 1 / 2), and so are fewer heads than ranks (1 head over 2: none on
    rank 0); their steps against JAX: ``tests/test_torch_mssit_tp.py``."""
    out = json.loads((ranks / "refusals.json").read_text())
    assert out["heads"] is None and out["heads_1"] is None
    assert out["fsdp_tp"] is None and np.isfinite(out["fsdp_tp_loss"])
    for name in ("fused_fsdp", "fused_tp"):
        assert out[name].startswith("NotImplementedError") and "pure DP" in out[name]
        assert out[name + "_route"] is False
    assert out["fused_dp"] is None
    assert out["init_again"].startswith("RuntimeError") and "already initialised" in (
        out["init_again"])
    assert out["init_same"] == 0


# widths the 'model' axis does not divide: fc1's 129 hidden units; the MPP
# decoder's 45 outputs (3 channels of 15 vertices)
WIDTH_CASES = {"mlp": lambda r: r["transformer"].update(mlp_dim=129),
               "mpp_decoder": lambda r: _mpp(r)["transformer"].update(num_channels=3)}


@pytest.mark.parametrize("case", list(WIDTH_CASES))
def test_widths_the_model_axis_does_not_divide_are_refused_as_jax_refuses_them(case):
    """An MLP or MPP-decoder width that 'model' = 2 does not divide: the
    JAX ``shard_params`` on ``make_mesh(1, 1, 2)`` (``jax.device_put``)
    refuses it with a ValueError, and so does the port's
    ``apply_tensor_parallel``, with a message that says JAX refuses the
    same."""
    from surface_vision_transformers_tpu_torch.parallel.tp import TPGroup, apply_tensor_parallel

    raw = raw_cfg()
    WIDTH_CASES[case](raw)
    x = np.zeros((1, raw["transformer"].get("num_channels", 4), 20, 15), np.float32)
    params = JaxTrainer(jax_from_dict(raw)).init_state(x).params
    with pytest.raises(ValueError, match="divisible"):
        shard_params(params, jax_make_mesh(1, 1, 2))
    model = runner.build_model(from_dict(raw), None)
    with pytest.raises(ValueError, match="does not divide|do not divide") as e:
        apply_tensor_parallel(model, TPGroup(None, 2, 0))
    assert "refuses the same" in str(e.value)


@pytest.mark.parametrize("key,val", [("tpu.seq_sharding", True), ("tpu.mesh_pipe", 1),
                                     ("tpu.mesh_pipe", 2)])
def test_pipeline_and_sequence_keys_train_on_one_process(tmp_path, data, single, key, val):
    """The pipeline and sequence-sharding keys are read, no longer refused:
    on one process ``tpu.seq_sharding`` (no 'model' axis to split the
    tokens over) and ``tpu.mesh_pipe: 1`` (with four microbatches asked for)
    train the single process's run; ``tpu.mesh_pipe: 2`` asks for two
    devices and is refused for want of them, as the JAX ``make_mesh``
    refuses it. Their meshes run in ``tests/test_torch_pipeline.py`` and
    ``tests/test_torch_seq_sharding.py``."""
    raw = raw_cfg(tmp_path)
    block, leaf = key.split(".")
    raw[block][leaf] = val
    raw["tpu"]["pipe_microbatches"] = 4
    if val == 2:
        with pytest.raises(ValueError, match=r"not divisible by fsdp\*model\*pipe=2"):
            runner.run_training(from_dict(raw), device="cpu", datasets={})
        return
    got = runner.run_training(from_dict(raw), device="cpu", datasets=copy.deepcopy(data),
                              progress=False)
    assert "mesh" not in got
    assert got["best_mae"] == single["dp"]["best_mae"]


def test_one_process_needs_no_process_group():
    """With one process and no sharding asked for there is no mesh and
    ``initialize_multihost`` does nothing; a mesh wider than the world is
    refused as JAX refuses it."""
    env = {k: os.environ.pop(k) for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")
           if k in os.environ}
    try:
        assert parallel.initialize_multihost() == 0
        assert not torch.distributed.is_initialized()
        assert parallel.mesh_from_config({"mesh_data": -1}) is None
        assert parallel.mesh_from_config(from_dict(raw_cfg())) is None
        with pytest.raises(ValueError, match="devices"):
            parallel.mesh_from_config({"mesh_model": 2})
        with pytest.raises(ValueError, match="not divisible"):
            parallel.make_mesh(-1, 1, 3, devices=4)
    finally:
        os.environ.update(env)


def test_param_placement_rules():
    """JAX ``_TP_RULES`` by module name, FSDP2 on dim 0."""
    p = parallel.param_placement
    pre = "transformer.layers.0."
    assert p(pre + "0.fn.to_qkv.weight", (192, 64), tp=True, fsdp_size=1) == ("model", None)
    assert p(pre + "0.fn.to_out.0.weight", (64, 64), tp=True, fsdp_size=1) == (None, "model")
    assert p(pre + "0.fn.to_out.0.bias", (64,), tp=True, fsdp_size=1) == (None,)
    assert p(pre + "1.fn.net.0.weight", (128, 64), tp=True, fsdp_size=1) == ("model", None)
    assert p(pre + "1.fn.net.0.bias", (128,), tp=True, fsdp_size=1) == ("model",)
    assert p(pre + "1.fn.net.3.weight", (64, 128), tp=True, fsdp_size=1) == (None, "model")
    assert p("to_original.weight", (60, 64), tp=True, fsdp_size=1) == ("model", None)
    assert p(pre + "0.norm.weight", (64,), tp=True, fsdp_size=2) == ("fsdp",)
    assert p(pre + "1.fn.net.3.weight", (64, 128), tp=False, fsdp_size=2) == ("fsdp", None)


class _FakeLayout(Layout):
    def __init__(self, index, count):
        self.batch_index, self.batch_count = index, count


@pytest.mark.parametrize("B,accum,count", [(16, 1, 2), (16, 2, 2), (10, 1, 4), (12, 2, 4),
                                           (9, 2, 2)])
def test_rank_rows_cover_the_batch_once(B, accum, count):
    """The rows every rank holds cover the global batch once, microbatch by
    microbatch (padding at weight 0 where the shards do not divide it), and
    a rank's share of a microbatch is what ``micro_rows`` draws for."""
    seen = []
    for r in range(count):
        lay = _FakeLayout(r, count)
        rows, valid = lay.batch_index_of(B, accum)
        k = lay.accum_steps(B, accum)
        per = len(rows) // k
        for j in range(k):
            part = rows[j * per:(j + 1) * per] - j * (B // k)
            np.testing.assert_array_equal(part[valid[j * per:(j + 1) * per]],
                                          lay.micro_rows(B // k).index.numpy()[
                                              valid[j * per:(j + 1) * per]])
        seen.extend(rows[valid].tolist())
    assert sorted(seen) == list(range(B))
    assert [a.tolist() for a in even_split(5, 1, 2)] == [[3, 4, 0], [True, True, False]]


def test_rank_draws_are_the_single_process_rows():
    """A rank's draws are the single process's at the rows it holds:
    dropout masks (a TP rank's columns too, and two rows a sample as
    MS-SiT's folds draw them), MPP's corruption, augmentation; the
    attention kernel's seed moves with the rank's shard and only then."""
    from surface_vision_transformers_tpu_torch.data.augment import Draws
    from surface_vision_transformers_tpu_torch.models.mpp import corrupt_sequence
    from surface_vision_transformers_tpu_torch.models.sit import DropoutRNG

    rows = parallel.Rows(torch.tensor([4, 5, 6, 7]), 8)
    one, rank = DropoutRNG(3, "cpu"), DropoutRNG(3, "cpu")
    rank.rows = rows
    assert torch.equal(rank.keep((4, 5, 6), 0.3), one.keep((8, 5, 6), 0.3)[4:])
    full = one.keep((16, 5, 6), 0.3).view(8, 2, 5, 6)[4:].reshape(8, 5, 6)[..., 2:4]
    assert torch.equal(rank.keep((8, 5, 2), 0.3, cols=(2, 4, 6)), full)
    tokens, token = torch.randn(8, 10, 3), torch.zeros(1, 1, 3)
    kw = dict(mask_prob=0.5, replace_prob=0.8, swap_prob=0.3)
    whole = corrupt_sequence(tokens, token, generator=torch.Generator().manual_seed(0), **kw)
    part = corrupt_sequence(tokens[4:], token, generator=torch.Generator().manual_seed(0),
                            rows=rows, **kw)
    assert torch.equal(part[0], whole[0][4:]) and torch.equal(part[1], whole[1][4:])
    d = Draws(rot=torch.arange(8), on=torch.arange(8) % 2 == 0, table=torch.arange(8) % 3)
    taken = d.take(rows.index)
    assert taken.rot.tolist() == [4, 5, 6, 7] and taken.table.tolist() == [1, 2, 0, 1]
    seeds = [DropoutRNG(3, "cpu", salt).kernel_seed() for salt in (0, 0, 1)]
    assert seeds[0] == seeds[1] == DropoutRNG(3, "cpu").kernel_seed() != seeds[2]


def test_cli_train_multihost_lays_the_run_over_the_group(ranks, single):
    """``cli.train --multihost`` in a process that has joined a group of two
    trains under the (2, 1, 1) mesh the runner builds; rank 0 alone prints
    its results, which equal the single process's within 1e-6."""
    import ast

    outs = [(ranks / f"cli_out.rank{r}").read_text() for r in range(2)]
    assert outs[1] == ""
    got = ast.literal_eval(outs[0].strip().splitlines()[-1])
    assert got["mesh"] == {"data": 2, "fsdp": 1, "model": 1}
    assert got["process_group"] == {"backend": "gloo", "world_size": 2}
    assert abs(got["best_mae"] - single["dp"]["best_mae"]) < 1e-6
