"""Tensor parallelism with whole heads split unevenly, and MS-SiT (and its
MPP) under it, on the CPU: two gloo ranks (``tests/torch_parallel_worker.py``,
importing only the port) against the JAX ``Trainer`` under ``make_mesh(1,
1, 2)`` (GSPMD's contiguous column split of the same parameters) and
against the port's single process:

* one unclipped SGD step (lr times the gradient) of MS-SiT at heads (2, 4)
  and at heads (3, 6) (stage 0: one head on rank 0, two on rank 1), of
  MPP-MS-SiT (the decoder's outputs split; a window corruption that is a
  function of the data, built alike in both packages), and of SiT at 3
  heads, each within the golden 2e-5 of the JAX step from the same
  parameters;
* ``run_training`` of MS-SiT at heads (3, 6) and of MPP-MS-SiT under TP:
  best metric within 1e-6 of the single process, the attention through
  ``flash_attention_qkv`` on each rank's own heads;
* the uneven split itself: slices, gather, every rank holding a head.

Size: the JAX dryrun's MS-SiT (ico 2 / sub-ico 1: 80 patches of 6
vertices, two stages of one block, window 4, global_max 8), embed 16 at
heads (2, 4) and 24 at heads (3, 6) (dim_head 8).
"""

from __future__ import annotations

import copy
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu import geometry as G
from surface_vision_transformers_tpu.checkpoints.torch_import import sit_params_to_torch
from surface_vision_transformers_tpu.models import mpp_mssit as jmpp
from surface_vision_transformers_tpu.parallel import make_mesh as jax_make_mesh
from surface_vision_transformers_tpu.parallel import shard_batch, shard_params
from surface_vision_transformers_tpu.train import Trainer as JaxTrainer
from surface_vision_transformers_tpu.utils.config import from_dict as jax_from_dict
from surface_vision_transformers_tpu_torch.checkpoints.convert import (
    mpp_mssit_state_dict_from_jax,
    mssit_state_dict_from_jax,
)
from surface_vision_transformers_tpu_torch.parallel import tp as tpm
from surface_vision_transformers_tpu_torch.train import runner
from surface_vision_transformers_tpu_torch.utils.config import from_dict
from tests.test_torch_parallel import run_ranks

# case: (model kind, heads, embed_dim or SiT dim_head)
STEP_CASES = {"mssit_even": ("mssit", (2, 4), 16), "mssit_uneven": ("mssit", (3, 6), 24),
              "mpp_mssit": ("mpp", (3, 6), 24), "sit_3_heads": ("sit", 3, 16)}
TRAIN_CASES = {"mssit_uneven": ("mssit", (3, 6), 24), "mpp_mssit": ("mpp", (3, 6), 24)}


def raw_cfg(kind, heads, width, root=None, mesh=True, step=False):
    """The config of a case: a run trains with AdamW (clip 1.0, as the
    dryrun), a ``step`` case takes SGD unclipped, whose first step is lr
    times the gradient (AdamW's first step is about lr times its sign)."""
    train = {"LR": 1e-3, "bs": 8, "bs_val": 8, "epochs": 2, "seed": 0, "val_epoch": 1,
             "save_ckpt": False}
    raw = {"training": train, "optimisation": {"optimiser": "AdamW", "grad_clip": 1.0},
           "AdamW": {"weight_decay": 0.01}, "tpu": {"compute_dtype": "float32"}}
    if step:
        train["LR"] = 5e-3
        raw["optimisation"] = {"optimiser": "SGD"}
        raw["SGD"] = {"momentum": 0.9}
    if kind == "sit":
        raw["resolution"] = {"ico": 2, "sub_ico": 0}
        raw["transformer"] = {"dim": 64, "depth": 2, "heads": heads, "mlp_dim": 128,
                              "dim_head": width}
    else:
        raw["resolution"] = {"ico": 2, "sub_ico": 1}
        raw["transformer"] = {"model": "MS-SiT", "num_channels": 4}
        raw["mssit"] = {"embed_dim": width, "depths": [1, 1], "heads": list(heads),
                        "window": 4, "global_max": 8}
    if kind == "mpp":
        raw["SSL"] = "mpp"
        raw["pretraining_mpp"] = {"mask_prob": 0.5, "replace_prob": 0.8, "swap_prob": 0.02}
    if mesh:
        raw["tpu"]["mesh_model"] = 2
    if root is not None:
        raw["logging"] = {"folder_to_save_model": str(root)}
    return raw


def _fixed_corruption_jax(key, target, mask_token, *, window, mask_prob, replace_prob,
                          swap_prob):
    """``torch_parallel_worker.fixed_window_corruption`` in JAX."""
    B, T, P = target.shape
    nW, n = T // window, math.ceil(mask_prob * (T // window))
    wins = target.reshape(B, nW, window * P)
    w = jnp.arange(nW)
    wmask = (w[None, :] + (wins[:, 0] > 0).sum(-1)[:, None]) % nW < n
    repl = wmask & (w[None, :] % 2 == 0)
    token = jnp.tile(mask_token.reshape(1, 1, P).astype(wins.dtype), (1, 1, window))
    return (jnp.where(repl[:, :, None], token, wins).reshape(B, T, P),
            jnp.repeat(wmask, window, axis=1), n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    ms = rng.standard_normal((24, 4, 162)).astype(np.float32)
    sit = rng.standard_normal((8, 4, 20, 15)).astype(np.float32)
    labels = rng.uniform(-1, 1, 24).astype(np.float32)
    return {"mssit": ms, "sit": sit, "labels": labels}


def _inputs(kind, data):
    x = data["sit" if kind == "sit" else "mssit"][:8]
    return x, data["labels"][:8]


def _state_dict(kind, params):
    conv = {"sit": lambda p: sit_params_to_torch(p, 2), "mssit": mssit_state_dict_from_jax,
            "mpp": mpp_mssit_state_dict_from_jax}[kind]
    return {k: torch.as_tensor(np.array(v)) for k, v in conv(jax.device_get(params)).items()}


@pytest.fixture(scope="module")
def jax_sides(data):
    """{case: (JAX Trainer under make_mesh(1, 1, 2), mesh, its seeded state)}."""
    out = {}
    for case, (kind, heads, width) in STEP_CASES.items():
        mesh = jax_make_mesh(1, 1, 2)
        table = None if kind == "sit" else G.load_patch_table(2, 1).indices
        tr = JaxTrainer(jax_from_dict(raw_cfg(kind, heads, width, step=True)), mesh=mesh,
                        patch_table=table)
        out[case] = tr, mesh, tr.init_state(_inputs(kind, data)[0][:1])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, data, jax_sides):
    tmp = tmp_path_factory.mktemp("tp_heads")
    jobs = []
    w = np.ones(8, np.float32)
    w[:2] = 0.0
    np.save(tmp / "w.npy", w)
    for case, (kind, heads, width) in STEP_CASES.items():
        x, y = _inputs(kind, data)
        np.save(tmp / f"x_{case}.npy", x)
        np.save(tmp / f"y_{case}.npy", y)
        init = _state_dict(kind, jax_sides[case][2].params)
        if kind == "mpp":  # the encoder's head, which MPP never runs: any values
            init.update({k: v for k, v in runner.build_model(from_dict(raw_cfg(
                kind, heads, width)), G.load_patch_table(2, 1).indices).state_dict().items()
                if k.startswith("encoder.head")})
        torch.save(init, tmp / f"init_{case}.pt")
        jobs.append(dict(kind="step", shape=(1, 1, 2),
                         cfg=raw_cfg(kind, heads, width, step=True),
                         init=str(tmp / f"init_{case}.pt"), x=str(tmp / f"x_{case}.npy"),
                         y="" if kind == "mpp" else str(tmp / f"y_{case}.npy"),
                         w=str(tmp / "w.npy"), fixed_corruption=kind == "mpp",
                         out=str(tmp / f"step_{case}.pt")))
    sets = {}
    for name, sl in (("train", slice(0, 16)), ("validation", slice(16, 24))):
        np.save(tmp / f"{name}_d.npy", data["mssit"][sl])
        np.save(tmp / f"{name}_l.npy", data["labels"][sl])
        sets[name] = [str(tmp / f"{name}_d.npy"), str(tmp / f"{name}_l.npy")]
    for case, (kind, heads, width) in TRAIN_CASES.items():
        jobs.append(dict(kind="train", cfg=raw_cfg(kind, heads, width, tmp / case),
                         datasets=sets, all_ranks=True, out=str(tmp / f"train_{case}.json")))
    return run_ranks(tmp, jobs, 2)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_step_matches_jax_under_tp(ranks, data, jax_sides, case, monkeypatch):
    """The port's TP step on two gloo ranks (whole heads a rank, uneven
    where the axis does not divide them) equals the JAX Trainer's under the
    same mesh (fp32, 2e-5) from the same parameters, on a batch with
    zero-weight rows; the step moved every matrix."""
    kind, heads, width = STEP_CASES[case]
    monkeypatch.setattr(jmpp, "corrupt_window_sequence", _fixed_corruption_jax)
    x, y = _inputs(kind, data)
    w = np.load(ranks / "w.npy")
    tr, mesh, state = jax_sides[case]
    batch = tr._mpp_tokens(jnp.asarray(x)) if kind == "mpp" else jnp.asarray(x)
    with mesh:
        state = state.replace(params=shard_params(state.params, mesh))
        tgt = None if kind == "mpp" else shard_batch(jnp.asarray(y), mesh)
        state, loss, _ = tr._build_step_fn()(state, shard_batch(batch, mesh), tgt,
                                             jnp.asarray(w))
    want, want_loss = _state_dict(kind, state.params), float(loss)
    got = torch.load(ranks / f"step_{case}.pt", weights_only=True)
    init = torch.load(ranks / f"init_{case}.pt", weights_only=True)
    assert abs(got["loss"] - want_loss) < 1e-5, (got["loss"], want_loss)
    for k, v in want.items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), atol=2e-5, rtol=0,
                                   err_msg=k)
        if v.dim() == 2:
            assert (got["state"][k] - init[k]).abs().max() > 1e-5, k


@pytest.fixture(scope="module")
def single(tmp_path_factory, data, ranks):
    tmp = tmp_path_factory.mktemp("tp_single")
    sets = {"train": (data["mssit"][:16], data["labels"][:16]),
            "validation": (data["mssit"][16:24], data["labels"][16:24])}
    return {case: runner.run_training(from_dict(raw_cfg(kind, heads, width, tmp / case,
                                                        mesh=False)),
                                      device="cpu", datasets=copy.deepcopy(sets),
                                      progress=False)
            for case, (kind, heads, width) in TRAIN_CASES.items()}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_mssit_training_under_tp_matches_the_single_process(ranks, single, case):
    """Two epochs of ``run_training`` of MS-SiT at heads (3, 6) and of
    MPP-MS-SiT under (1, 1, 2): best metric within 1e-6 of the single
    process's; each rank's attention ran through ``flash_attention_qkv`` on
    its own heads (rank 0: 1 of stage 0's 3, rank 1: 2; 3 of stage 1's 6
    each)."""
    metric = "best_loss" if case == "mpp_mssit" else "best_mae"
    outs = [json.loads((ranks / f"train_{case}.json.rank{r}").read_text()) for r in range(2)]
    want = single[case]
    for got in outs:
        assert got["mesh"] == {"data": 1, "fsdp": 1, "model": 2}
        assert got["best_epoch"] == want["best_epoch"]
        assert abs(got[metric] - want[metric]) < 1e-6, (got[metric], want[metric])
        assert got["mssit_qkv_calls"] > 0
    assert [o["mssit_heads"] for o in outs] == [[1, 3], [2, 3]]


@pytest.mark.parametrize("heads,size", [(3, 2), (6, 4), (12, 2), (24, 5), (2, 2)])
def test_uneven_heads_split_and_gather(heads, size):
    """Every rank holds at least one whole head, the ranks' heads cover the
    attention once in order, and the slices of the packed qkv and of the
    out-projection put back together give the full values."""
    dh, dim = 8, 20
    qkv = torch.randn(3 * heads * dh, dim)
    out = torch.randn(dim, heads * dh)
    b = tpm.head_bounds(heads, size)
    assert b[0] == 0 and b[-1] == heads and all(hi > lo for lo, hi in zip(b, b[1:]))
    for name, full in (("x.to_qkv.weight", qkv), ("x.to_out.0.weight", out),
                       ("x.to_out.weight", out)):
        parts = [tpm.shard_param(full, name, size, r, heads) for r in range(size)]
        for r, p in enumerate(parts):
            n = b[r + 1] - b[r]
            assert p.shape == ((3 * n * dh, dim) if "qkv" in name else (dim, n * dh))
        assert torch.equal(tpm.unshard_param(parts, name, heads), full), name
    q = qkv.reshape(3, heads, dh, dim)
    r0 = tpm.shard_param(qkv, "to_qkv.weight", size, 0, heads).reshape(3, -1, dh, dim)
    assert torch.equal(r0, q[:, :b[1]])
