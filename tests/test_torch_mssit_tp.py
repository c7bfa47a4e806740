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
* MS-SiT and MPP-MS-SiT under ``tpu.seq_sharding`` on (1, 1, 2): the JAX
  ``Trainer`` hands the MS-SiT the sequence fields, which it uses nowhere,
  and lays the TP rules over its parameters, so the port takes its TP
  layout there; their steps within 2e-5 of the JAX ones, and bit for bit
  the port's TP steps from the same parameters;
* SiT with one head on ``mesh_model`` 2 (rank 0 holds no head: empty qkv
  and out-projection slices, every collective of the block joined), a
  clipped step within 2e-5 of the JAX step;
* ``run_training`` of MS-SiT at heads (3, 6) and of MPP-MS-SiT under TP and
  under sequence sharding, and of the one-head SiT: best metric within
  1e-6 of the single process, the attention through
  ``flash_attention_qkv`` on each rank's own heads;
* the config's AdamW in bfloat16 under TP (MS-SiT at heads (3, 6), four
  steps): every tensor's update within 5% of the one-process bfloat16
  run's, or, where that run is itself farther than 5% from a float32 run,
  within 1.25 times its distance to it (``chip_smoke.py``'s phase-31
  rule, ``mssit_update_gate``);
* the uneven split itself: slices, gather, a rank with no head where the
  heads are fewer than the ranks.

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
from surface_vision_transformers_tpu_torch.train.trainer import Trainer
from surface_vision_transformers_tpu_torch.utils.config import from_dict
from tests.test_torch_parallel import run_ranks

# case: (model kind, heads, embed_dim or SiT dim_head, extra: "sp" sequence
# sharding, "clip" a clipped step)
STEP_CASES = {"mssit_even": ("mssit", (2, 4), 16, ""), "mssit_uneven": ("mssit", (3, 6), 24, ""),
              "mpp_mssit": ("mpp", (3, 6), 24, ""), "sit_3_heads": ("sit", 3, 16, ""),
              "mssit_sp": ("mssit", (3, 6), 24, "sp"), "mpp_mssit_sp": ("mpp", (3, 6), 24, "sp"),
              "sit_1_head": ("sit", 1, 64, "clip")}
TRAIN_CASES = {"mssit_uneven": ("mssit", (3, 6), 24, ""), "mpp_mssit": ("mpp", (3, 6), 24, ""),
               "mssit_sp": ("mssit", (3, 6), 24, "sp"), "mpp_mssit_sp": ("mpp", (3, 6), 24, "sp"),
               "sit_1_head": ("sit", 1, 64, "")}
# the TP case whose step a sequence-sharded one equals bit for bit
SP_AS_TP = {"mssit_sp": "mssit_uneven", "mpp_mssit_sp": "mpp_mssit"}
CLIP = 0.05
# bf16 AdamW under TP: the MS-SiT of "mssit_uneven", four steps; the phase-31 rule's
# tolerance on a tensor's update and its margin over bf16's own distance to float32
ADAMW_CASE, ADAMW_STEPS = ("mssit", (3, 6), 24), 4
UPD_TOL, FP32_MARGIN = 0.05, 1.25


def _adamw_bf16(raw):
    raw["tpu"]["compute_dtype"] = "bfloat16"
    return raw


def raw_cfg(kind, heads, width, root=None, mesh=True, step=False, extra=""):
    """The config of a case: a run trains with AdamW (clip 1.0, as the
    dryrun), a ``step`` case takes SGD unclipped (``extra`` "clip": clipped
    at CLIP), whose first step is lr times the gradient (AdamW's first step
    is about lr times its sign); ``extra`` "sp" sets ``tpu.seq_sharding``."""
    train = {"LR": 1e-3, "bs": 8, "bs_val": 8, "epochs": 2, "seed": 0, "val_epoch": 1,
             "save_ckpt": False}
    raw = {"training": train, "optimisation": {"optimiser": "AdamW", "grad_clip": 1.0},
           "AdamW": {"weight_decay": 0.01}, "tpu": {"compute_dtype": "float32"}}
    if step:
        train["LR"] = 5e-3
        raw["optimisation"] = {"optimiser": "SGD", "grad_clip": CLIP if extra == "clip" else 0.0}
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
        raw["tpu"]["seq_sharding"] = extra == "sp"
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
    sit_run = rng.standard_normal((24, 4, 20, 15)).astype(np.float32)
    return {"mssit": ms, "sit": sit, "labels": labels, "sit_run": sit_run}


def _run_sets(kind, data):
    """{split: (data, labels)} of a run of ``kind``."""
    x = data["sit_run" if kind == "sit" else "mssit"]
    return {"train": (x[:16], data["labels"][:16]),
            "validation": (x[16:24], data["labels"][16:24])}


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
    for case, (kind, heads, width, extra) in STEP_CASES.items():
        mesh = jax_make_mesh(1, 1, 2)
        table = None if kind == "sit" else G.load_patch_table(2, 1).indices
        tr = JaxTrainer(jax_from_dict(raw_cfg(kind, heads, width, step=True, extra=extra)),
                        mesh=mesh, patch_table=table)
        out[case] = tr, mesh, tr.init_state(_inputs(kind, data)[0][:1])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, data, jax_sides):
    tmp = tmp_path_factory.mktemp("tp_heads")
    jobs = []
    w = np.ones(8, np.float32)
    w[:2] = 0.0
    np.save(tmp / "w.npy", w)
    for case, (kind, heads, width, extra) in STEP_CASES.items():
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
                         cfg=raw_cfg(kind, heads, width, step=True, extra=extra),
                         init=str(tmp / f"init_{case}.pt"), x=str(tmp / f"x_{case}.npy"),
                         y="" if kind == "mpp" else str(tmp / f"y_{case}.npy"),
                         w=str(tmp / "w.npy"), fixed_corruption=kind == "mpp",
                         out=str(tmp / f"step_{case}.pt")))
    jobs.append(dict(kind="step", shape=(1, 1, 2), cfg=_adamw_bf16(raw_cfg(*ADAMW_CASE)),
                     init=str(tmp / "init_mssit_uneven.pt"), x=str(tmp / "x_mssit_uneven.npy"),
                     y=str(tmp / "y_mssit_uneven.npy"), w=str(tmp / "w.npy"),
                     steps=ADAMW_STEPS, out=str(tmp / "adamw_bf16.pt")))
    sets = {}
    for kind in ("mssit", "sit"):
        sets[kind] = {}
        for name, (d, lab) in _run_sets(kind, data).items():
            np.save(tmp / f"{kind}_{name}_d.npy", d)
            np.save(tmp / f"{kind}_{name}_l.npy", lab)
            sets[kind][name] = [str(tmp / f"{kind}_{name}_d.npy"),
                                str(tmp / f"{kind}_{name}_l.npy")]
    for case, (kind, heads, width, extra) in TRAIN_CASES.items():
        jobs.append(dict(kind="train", cfg=raw_cfg(kind, heads, width, tmp / case, extra=extra),
                         datasets=sets["sit" if kind == "sit" else "mssit"], all_ranks=True,
                         out=str(tmp / f"train_{case}.json")))
    return run_ranks(tmp, jobs, 2)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_step_matches_jax_under_tp(ranks, data, jax_sides, case, monkeypatch):
    """The port's TP step on two gloo ranks (whole heads a rank, uneven
    where the axis does not divide them, none on rank 0 for one head over
    two; an MS-SiT under sequence sharding in the same layout) equals the
    JAX Trainer's under the same mesh (fp32, 2e-5) from the same
    parameters, on a batch with zero-weight rows; unclipped, the step moved
    every matrix; clipped, by lr * clip over the whole model."""
    kind, heads, width, extra = STEP_CASES[case]
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
        if v.dim() == 2 and extra != "clip":
            assert (got["state"][k] - init[k]).abs().max() > 1e-5, k
    if extra == "clip":  # the first SGD step is lr * the clipped gradient
        moved = math.sqrt(sum(float((got["state"][k] - init[k]).square().sum()) for k in want))
        np.testing.assert_allclose(moved, 5e-3 * CLIP, rtol=1e-3)


@pytest.mark.parametrize("case", list(SP_AS_TP))
def test_mssit_under_seq_sharding_is_its_tp_layout(ranks, jax_sides, case):
    """JAX's MS-SiT under ``tpu.seq_sharding`` on (1, 1, 2): the model gets
    the sequence fields, and ``shard_params`` lays the TP rules over its
    parameters ('model' on qkv's and fc1's output features). The port takes
    its TP layout there: the sequence-sharded step equals its TP step from
    the same parameters bit for bit."""
    from surface_vision_transformers_tpu.parallel.mesh import params_pspecs

    tr, mesh, state = jax_sides[case]
    enc = tr.model
    assert enc.seq_shard_axis == "model" and enc.seq_mesh is mesh
    specs = jax.tree_util.tree_leaves_with_path(params_pspecs(state.params, mesh))
    split = {jax.tree_util.keystr(k) for k, spec in specs if "model" in tuple(spec)}
    assert any("to_qkv" in k for k in split) and any("fc1" in k for k in split), split
    sp = torch.load(ranks / f"step_{case}.pt", weights_only=True)
    tp = torch.load(ranks / f"step_{SP_AS_TP[case]}.pt", weights_only=True)
    assert sp["loss"] == tp["loss"]
    for k, v in tp["state"].items():
        if not k.startswith("encoder.head"):  # MPP's unused head: each case's own init
            assert torch.equal(sp["state"][k], v), k


def _upd_ratios(upd: dict, ref: dict) -> dict:
    """max |upd - ref| / max |ref| of each tensor's update."""
    return {k: float((upd[k] - ref[k]).abs().max() / ref[k].abs().max().clamp(min=1e-30))
            for k in ref}


def test_bf16_adamw_under_tp_stays_within_bf16s_own_distance_to_fp32(ranks, data):
    """The config's AdamW in bfloat16 under TP, four steps of the uneven
    MS-SiT: each tensor's update is within UPD_TOL of the one-process
    bfloat16 run's, or, for a tensor that bfloat16 itself updates farther
    than that from float32, within FP32_MARGIN of bfloat16's distance to
    the float32 update (phase 31's fp32 rule, run in phase 37 (c) on the
    card)."""
    init = torch.load(ranks / "init_mssit_uneven.pt", weights_only=True)
    x, y = (torch.from_numpy(a) for a in _inputs("mssit", data))
    w = torch.from_numpy(np.load(ranks / "w.npy"))
    table = G.load_patch_table(2, 1).indices
    updates = {}
    for dtype in ("bfloat16", "float32"):
        raw = raw_cfg(*ADAMW_CASE, mesh=False)
        raw["tpu"]["compute_dtype"] = dtype
        exp = from_dict(raw)
        model = runner.build_model(exp, table)
        model.load_state_dict(init)
        tr = Trainer(exp, model)
        for _ in range(ADAMW_STEPS):
            tr.optimizer_step(x, y, w)
        updates[dtype] = {k: v - init[k] for k, v in model.state_dict().items()}
    got = torch.load(ranks / "adamw_bf16.pt", weights_only=True)["state"]
    tp = {k: v - init[k] for k, v in got.items()}
    to_bf = _upd_ratios(tp, updates["bfloat16"])
    to_32 = _upd_ratios(tp, updates["float32"])
    bf_32 = _upd_ratios(updates["bfloat16"], updates["float32"])
    bad = {k: (v, to_32[k], bf_32[k]) for k, v in to_bf.items() if v > UPD_TOL and not (
        bf_32[k] > UPD_TOL and to_32[k] <= FP32_MARGIN * bf_32[k])}
    assert not bad, bad


@pytest.fixture(scope="module")
def single(tmp_path_factory, data, ranks):
    tmp = tmp_path_factory.mktemp("tp_single")
    runs = {}  # one run a single-process config (a case under SP shares its TP case's)
    for kind, heads, width, _ in TRAIN_CASES.values():
        if (kind, heads, width) not in runs:
            runs[kind, heads, width] = runner.run_training(
                from_dict(raw_cfg(kind, heads, width, tmp / f"{kind}_{width}", mesh=False)),
                device="cpu", datasets=copy.deepcopy(_run_sets(kind, data)), progress=False)
    return {case: runs[v[:3]] for case, v in TRAIN_CASES.items()}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_mssit_training_under_tp_matches_the_single_process(ranks, single, case):
    """Two epochs of ``run_training`` of MS-SiT at heads (3, 6) and of
    MPP-MS-SiT under (1, 1, 2), under TP and under sequence sharding (their
    TP layout), and of a SiT with one head: best metric within 1e-6 of the
    single process's; each rank's attention ran through
    ``flash_attention_qkv`` on its own heads (MS-SiT, rank 0: 1 of stage
    0's 3, rank 1: 2; 3 of stage 1's 6 each; the one-head SiT: rank 1
    alone)."""
    kind = TRAIN_CASES[case][0]
    metric = "best_loss" if kind == "mpp" else "best_mae"
    outs = [json.loads((ranks / f"train_{case}.json.rank{r}").read_text()) for r in range(2)]
    want = single[case]
    for got in outs:
        assert got["mesh"] == {"data": 1, "fsdp": 1, "model": 2}
        assert got["best_epoch"] == want["best_epoch"]
        assert abs(got[metric] - want[metric]) < 1e-6, (got[metric], want[metric])
    if kind == "sit":
        assert [o["qkv_calls"] > 0 for o in outs] == [False, True]
        return
    assert all(o["mssit_qkv_calls"] > 0 for o in outs)
    assert [o["mssit_heads"] for o in outs] == [[1, 3], [2, 3]]


@pytest.mark.parametrize("heads,size", [(3, 2), (6, 4), (12, 2), (24, 5), (2, 2), (1, 2),
                                        (3, 4)])
def test_uneven_heads_split_and_gather(heads, size):
    """Every rank holds whole heads (at least one where the heads are as
    many as the ranks, else some hold none), the ranks' heads cover the
    attention once in order, and the slices of the packed qkv and of the
    out-projection put back together give the full values."""
    dh, dim = 8, 20
    qkv = torch.randn(3 * heads * dh, dim)
    out = torch.randn(dim, heads * dh)
    b = tpm.head_bounds(heads, size)
    assert b[0] == 0 and b[-1] == heads and all(hi >= lo for lo, hi in zip(b, b[1:]))
    assert all(hi > lo for lo, hi in zip(b, b[1:])) == (heads >= size)
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


def test_tp_branch_products_match_the_single_process_in_bf16(monkeypatch):
    """A TP branch's first and last products in bfloat16, on one rank (the
    sums over the axis made identities): their outputs and gradients are
    the single process's products (``_linear``: bf16 weights, float32
    accumulation, one rounding) within one bf16 step. The exit multiplies
    the weights rounded to bf16, not the float32 masters, which read a
    different product (an exit on the masters moved MS-SiT's bf16 AdamW
    updates up to 4.8x the one-process run's distance to float32 on an
    NVIDIA H100 80GB HBM3 at 700 W)."""
    import torch.nn.functional as F

    from surface_vision_transformers_tpu_torch.models import sit

    monkeypatch.setattr(sit, "reduce_from", lambda x, tp: x)
    monkeypatch.setattr(tpm.dist, "all_reduce", lambda t, group=None: t)
    one = tpm.TPGroup(None, 1, 0)
    torch.manual_seed(0)
    x = torch.randn(4, 20, 96).bfloat16().requires_grad_()
    g = torch.randn(4, 20, 64).bfloat16()

    def run(fn, lin):
        lin.zero_grad()
        x.grad = None
        y = fn(x, lin)
        y.backward(g)
        return y.float(), x.grad.float(), lin.weight.grad.clone(), lin.bias.grad.clone()

    def step(t):  # a bf16 step at each element's magnitude
        return 2.0 ** (torch.floor(torch.log2(t.abs().clamp(min=1e-30))) - 7)

    for name, tp_fn in (("exit", lambda x, lin: sit._tp_out(x, lin, one)),
                        ("entry", lambda x, lin: tpm.branch_in(x, lin, one))):
        lin = torch.nn.Linear(96, 64)
        want = run(sit._linear, lin)
        got = run(tp_fn, lin)
        for w, a in zip(want, got):
            assert ((a - w).abs() <= step(w)).all(), name
    lin = torch.nn.Linear(96, 64)
    masters = F.linear(x.float(), lin.weight, lin.bias).bfloat16().float()
    assert (masters != sit._linear(x, lin).float()).float().mean() > 0.05
