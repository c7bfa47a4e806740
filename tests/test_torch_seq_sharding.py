"""Sequence-parallel SiT training (``tpu.seq_sharding``, ``parallel/seq.py``)
on the CPU: two gloo ranks (``tests/torch_parallel_worker.py``, importing
only the port) against the JAX ``Trainer`` with ``seq_sharding: true`` and
``kernel_backend: pallas`` under ``make_mesh(1, 1, 2)`` (its
``_seq_parallel_attention``: the Pallas flash kernel in interpret mode, as
the JAX dryrun's case 2 runs it) and against the port's single process, at
the dryrun's size (dim 64, depth 2, ico 2 / sub-ico 0: 21 tokens, padded to
22 over two ranks, where JAX pads to 128):

* one SGD step, CLS and mean pooling (and a clipped one), within the
  golden 2e-5;
* ``run_training``: best MAE within 1e-6 of the single process, the
  attention through ``flash_attention`` (its plain version on the CPU) on
  11 local queries against 22 keys;
* MPP around the sequence-sharded SiT (the JAX ``MPP`` wraps the JAX
  sequence-sharded encoder): one unclipped SGD step on a corruption that
  is a function of the data, built alike in both packages, within 2e-5 of
  the JAX step (each rank decodes its own token rows; the masked squared
  errors are summed over 'model' and divided by JAX's denominator), and
  ``run_training``: best loss within 1e-6 of the single process;
* dropout under sequence sharding trains (the explicit path);
* the rows, padding and pooling helpers alone.

FSDP beside sequence sharding: ``tests/test_torch_mesh_compose.py``.
"""

from __future__ import annotations

import copy
import json

import jax
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu.checkpoints.torch_import import sit_params_to_torch
from surface_vision_transformers_tpu.models import mpp as jmpp
from surface_vision_transformers_tpu.parallel import make_mesh as jax_make_mesh
from surface_vision_transformers_tpu.parallel import shard_batch, shard_params
from surface_vision_transformers_tpu.train import Trainer as JaxTrainer
from surface_vision_transformers_tpu.utils.config import from_dict as jax_from_dict
from surface_vision_transformers_tpu_torch.checkpoints.convert import mpp_state_dict_from_jax
from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
from surface_vision_transformers_tpu_torch.parallel import seq
from surface_vision_transformers_tpu_torch.train import runner
from surface_vision_transformers_tpu_torch.utils.config import from_dict
from tests.test_torch_parallel import run_ranks

# case: (pool, clip); unclipped, the first SGD step is lr times the gradient,
# so a wrong term of it shows; clipped, the norm over the ranks' gradients
STEP_CASES = {"sp_cls": ("cls", 0.0), "sp_mean": ("mean", 0.0), "sp_cls_clip": ("cls", 0.05)}


def _mpp(raw):
    raw["SSL"] = "mpp"
    raw["pretraining_mpp"] = {"mask_prob": 0.5, "replace_prob": 0.8, "swap_prob": 0.1}
    return raw


def _fixed_corruption_jax(key, tokens, mask_token, *, mask_prob, replace_prob, swap_prob):
    """``torch_parallel_worker.fixed_token_corruption`` in JAX."""
    import math

    B, L, D = tokens.shape
    n = math.ceil(mask_prob * L)
    pos = jax.numpy.arange(L)
    mask = (pos[None, :] + (tokens[:, 0] > 0).sum(-1)[:, None]) % L < n
    repl = mask & (pos[None, :] % 2 == 0)
    return jax.numpy.where(repl[:, :, None], mask_token.astype(tokens.dtype), tokens), mask, n


def raw_cfg(root=None, sp=True, pool="cls", clip=0.05, **training):
    raw = {
        "resolution": {"ico": 2, "sub_ico": 0},
        "transformer": {"dim": 64, "depth": 2, "heads": 2, "mlp_dim": 128, "dim_head": 32,
                        "pool": pool},
        "training": {"LR": 5e-3, "bs": 16, "bs_val": 8, "epochs": 2, "seed": 0,
                     "val_epoch": 1, "save_ckpt": False, **training},
        "optimisation": {"optimiser": "SGD", "grad_clip": clip},
        "SGD": {"momentum": 0.9},
        "tpu": {"compute_dtype": "float32"},
    }
    if sp:
        raw["tpu"].update(mesh_model=2, seq_sharding=True, kernel_backend="pallas")
    if root is not None:
        raw["logging"] = {"folder_to_save_model": str(root)}
    return raw


@pytest.fixture(scope="module")
def data():
    d, lab = make_regression_dataset(40, num_patches=20, num_vertices=15, seed=2,
                                     label_range=(-1, 1))
    return {"train": (d[:28], lab[:28]), "validation": (d[28:], lab[28:])}


def _jax_trainer(raw, x):
    exp = jax_from_dict(raw)
    mesh = jax_make_mesh(1, 1, 2)
    tr = JaxTrainer(exp, mesh=mesh)
    return tr, mesh, tr.init_state(x[:1])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, data):
    tmp = tmp_path_factory.mktemp("seq")
    x, y = data["train"][0][:16], data["train"][1][:16]
    w = np.ones(16, np.float32)
    w[:4] = 0.0
    for k, v in dict(x=x, y=y, w=w).items():
        np.save(tmp / f"{k}.npy", v)
    jobs = []
    for case, (pool, clip) in STEP_CASES.items():
        raw = raw_cfg(pool=pool, clip=clip)
        _, _, state = _jax_trainer(raw, x)
        init = {k: torch.from_numpy(np.array(v))
                for k, v in sit_params_to_torch(jax.device_get(state.params), 2).items()}
        torch.save(init, tmp / f"init_{case}.pt")
        jobs.append(dict(kind="step", shape=(1, 1, 2), cfg=raw, init=str(tmp / f"init_{case}.pt"),
                         x=str(tmp / "x.npy"), y=str(tmp / "y.npy"), w=str(tmp / "w.npy"),
                         out=str(tmp / f"step_{case}.pt")))
    sets = {}
    for name, (d, lab) in data.items():
        np.save(tmp / f"{name}_d.npy", d)
        np.save(tmp / f"{name}_l.npy", lab)
        sets[name] = [str(tmp / f"{name}_d.npy"), str(tmp / f"{name}_l.npy")]
    jobs.append(dict(kind="train", cfg=raw_cfg(tmp / "train"), datasets=sets,
                     out=str(tmp / "train.json")))
    # MPP around the sequence-sharded encoder: a step on a fixed corruption, a run
    _, _, state = _jax_trainer(_mpp(raw_cfg(clip=0.0)), x)
    init = {k: torch.from_numpy(np.array(v)) for k, v in mpp_state_dict_from_jax(
        jax.device_get(state.params), 2).items()}
    init.update({k: v for k, v in runner.build_model(from_dict(_mpp(raw_cfg())), None)
                 .state_dict().items() if k.startswith("transformer.mlp_head")})
    torch.save(init, tmp / "init_mpp.pt")
    jobs.append(dict(kind="step", shape=(1, 1, 2), cfg=_mpp(raw_cfg(clip=0.0)),
                     init=str(tmp / "init_mpp.pt"), x=str(tmp / "x.npy"), y="",
                     w=str(tmp / "w.npy"), fixed_corruption=True, out=str(tmp / "step_mpp.pt")))
    jobs.append(dict(kind="train", cfg=_mpp(raw_cfg(tmp / "mpp")), datasets=sets,
                     out=str(tmp / "mpp.json")))
    drop = raw_cfg(tmp / "dropout")
    drop["transformer"].update(dropout=0.1, emb_dropout=0.1)
    jobs.append(dict(kind="train", cfg=drop, datasets=sets, out=str(tmp / "dropout.json")))
    return run_ranks(tmp, jobs, 2)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_step_matches_jax_sequence_parallel(ranks, data, case):
    """The port's sequence-parallel step (local queries against the
    all-gathered keys, the pad row masked, the pool summed over the ranks,
    the gradients of the token-side parameters summed over 'model'; CLS and
    mean pooling, and a clipped step) equals the JAX Trainer's under the
    same mesh (fp32, 2e-5), from the same parameters, on a batch with
    zero-weight rows; unclipped, every matrix moved."""
    x, y = data["train"][0][:16], data["train"][1][:16]
    w = np.load(ranks / "w.npy")
    pool, clip = STEP_CASES[case]
    raw = raw_cfg(pool=pool, clip=clip)
    tr, mesh, state = _jax_trainer(raw, x)
    assert tr.model.seq_shard_axis == "model"
    step = tr._build_step_fn()
    with mesh:
        state = state.replace(params=shard_params(state.params, mesh))
        state, loss, _ = step(state, shard_batch(jax.numpy.asarray(x), mesh),
                              shard_batch(jax.numpy.asarray(y), mesh), jax.numpy.asarray(w))
    want = sit_params_to_torch(jax.device_get(state.params), 2)
    got = torch.load(ranks / f"step_{case}.pt", weights_only=True)
    assert abs(got["loss"] - float(loss)) < 1e-5, (got["loss"], float(loss))
    init = torch.load(ranks / f"init_{case}.pt", weights_only=True)
    for k, v in want.items():
        np.testing.assert_allclose(got["state"][k].numpy(), v, atol=2e-5, rtol=0, err_msg=k)
        if v.ndim == 2 and not clip:
            assert np.abs(v - init[k].numpy()).max() > 1e-5, k
    if clip:  # the first SGD step is lr * the clipped gradient
        moved = np.sqrt(sum(np.square(got["state"][k].numpy() - init[k].numpy()).sum()
                            for k in want))
        np.testing.assert_allclose(moved, raw["training"]["LR"] * clip, rtol=1e-3)


def test_mpp_step_matches_jax_sequence_parallel(ranks, data, monkeypatch):
    """MPP around the sequence-sharded SiT: the port's unclipped SGD step on
    two gloo ranks (each rank embeds the corrupted sequence, encodes and
    decodes its own rows; the masked squared errors, pad rows and CLS left
    out, summed over 'model' over JAX's denominator, so every rank holds the
    same loss) equals the JAX Trainer's under the same mesh (fp32, 2e-5),
    from the same parameters, on one corruption built alike in both
    packages and a batch with zero-weight rows; every matrix moved."""
    monkeypatch.setattr(jmpp, "corrupt_sequence", _fixed_corruption_jax)
    x = data["train"][0][:16]
    w = np.load(ranks / "w.npy")
    tr, mesh, state = _jax_trainer(_mpp(raw_cfg(clip=0.0)), x)
    assert tr.model.seq_shard_axis == "model" and tr.mpp.encoder is tr.model
    batch = tr._mpp_tokens(jax.numpy.asarray(x))
    with mesh:
        state = state.replace(params=shard_params(state.params, mesh))
        state, loss, _ = tr._build_step_fn()(state, shard_batch(batch, mesh), None,
                                             jax.numpy.asarray(w))
    want = mpp_state_dict_from_jax(jax.device_get(state.params), 2)
    got = torch.load(ranks / "step_mpp.pt", weights_only=True)
    init = torch.load(ranks / "init_mpp.pt", weights_only=True)
    assert abs(got["loss"] - float(loss)) < 1e-5, (got["loss"], float(loss))
    for k, v in want.items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), atol=2e-5, rtol=0,
                                   err_msg=k)
        if v.dim() == 2:
            assert (got["state"][k] - init[k]).abs().max() > 1e-5, k


@pytest.fixture(scope="module")
def single(tmp_path_factory, data):
    return runner.run_training(from_dict(raw_cfg(tmp_path_factory.mktemp("one"), sp=False)),
                               device="cpu", datasets=copy.deepcopy(data), progress=False)


def test_mpp_training_under_sequence_sharding_matches_the_single_process(
        ranks, data, tmp_path):
    """Two epochs of MPP ``run_training`` under (1, 1, 2) with sequence
    sharding: best loss within 1e-6 of the single process's, the attention
    through ``flash_attention`` on local queries."""
    got = json.loads((ranks / "mpp.json").read_text())
    want = runner.run_training(from_dict(_mpp(raw_cfg(tmp_path, sp=False))), device="cpu",
                               datasets=copy.deepcopy(data), progress=False)
    assert got["mesh"] == {"data": 1, "fsdp": 1, "model": 2}
    assert got["best_epoch"] == want["best_epoch"]
    assert abs(got["best_loss"] - want["best_loss"]) < 1e-6, (got, want)
    assert got["fa_calls"] > 0 and got["qkv_calls"] == 0


def test_sequence_parallel_training_matches_the_single_process(ranks, single):
    """Two epochs of ``run_training`` under (1, 1, 2) with sequence sharding:
    best MAE within 1e-6 of the single process's; every attention call
    went through ``flash_attention`` (local queries, all keys), none
    through the packed entry."""
    got = json.loads((ranks / "train.json").read_text())
    assert got["mesh"] == {"data": 1, "fsdp": 1, "model": 2}
    assert got["best_epoch"] == single["best_epoch"]
    assert abs(got["best_mae"] - single["best_mae"]) < 1e-6, (got, single)
    assert got["fa_calls"] > 0 and got["qkv_calls"] == 0


def test_dropout_trains_under_sequence_sharding(ranks):
    """Dropout 0.1 under sequence sharding (the plain softmax on the local
    queries, every mask cut from the padded sequence's) trains to finite
    metrics."""
    got = json.loads((ranks / "dropout.json").read_text())
    assert np.isfinite(got["best_mae"]) and got["best_epoch"] >= 0


class _Sum(torch.autograd.Function):  # seq_sum over one rank
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g


@pytest.mark.parametrize("n,size", [(21, 2), (321, 2), (320, 4), (5, 4)])
def test_rows_cover_the_padded_sequence(n, size):
    """Each rank's rows of n tokens are ceil(n / size) long, cover the
    padded sequence once, and zero_pad_rows clears exactly the pad rows."""
    h = torch.arange(n, dtype=torch.float32).reshape(1, n, 1) + 1
    seen = []
    for r in range(size):
        sp = seq.SeqGroup(None, size, r)
        start, stop, padded = sp.rows(n)
        assert padded % size == 0 and padded - n < size and stop - start == padded // size
        part = seq.local_rows(h, sp)
        assert part.shape[1] == stop - start
        seen += part.reshape(-1).tolist()
        zeroed = seq.zero_pad_rows(torch.ones_like(part), n, sp).reshape(-1)
        assert zeroed.tolist() == [float(start + i < n) for i in range(part.shape[1])]
    assert seen == list(range(1, n + 1)) + [0.0] * (len(seen) - n)


def test_pooling_adds_up_over_the_ranks(monkeypatch):
    """CLS pooling takes row 0 from rank 0 alone, mean pooling the valid
    rows of every rank over n: the ranks' shares add up to the single
    process's pool."""
    monkeypatch.setattr(seq, "seq_sum", lambda x, sp: _Sum.apply(x))
    n, size = 21, 2
    h = torch.randn(3, n, 5)
    for mode, want in (("cls", h[:, 0]), ("mean", h.mean(1))):
        got = sum(seq.pool(seq.local_rows(h, seq.SeqGroup(None, size, r)), n, mode,
                           seq.SeqGroup(None, size, r)) for r in range(size))
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
