"""The port's MS-SiT serving slice on the CPU against the JAX package:
``models.mssit`` (the plain functions and the modular ``MSSiT``),
``checkpoints.convert``'s MS-SiT mapping, ``models.fused_mssit`` (bf16 and
int8, the block kernels' plain versions here; the JAX ``fused_mssit_forward``
runs its Pallas kernels in interpret mode, as ``tests/test_fused_mssit.py``
does), the attention forward at head dim 32, the wrappers' head-dim checks,
``run_testing`` and the CLIs on an MS-SiT config.

Size: ICO 2, LEVEL 1 (80 patches x 6 vertices), embed_dim 64, heads (2, 4),
depths (2, 2), window 4, global_max 2: both stages run dh 32, stage 0 folds
into windows of 4 and axially into groups of 20, stage 1 (20 tokens, level
0) attends globally. Inputs from numpy seeds.

Tolerances, of the largest |reference| output: the modular model in float32
against ``MSSiT.apply`` 1e-4 (the same algorithm, sums in another order);
bf16 ``fused_mssit_forward`` against the JAX one 5e-3 (the bound
``tests/test_fused_mssit.py`` sets between the JAX fused and modular paths:
tanh- against erf-GELU, the unshifted clamped softmax, padded folds); int8
0.08 (``tests/test_fused_mssit.py``'s int8 bound); the attention forward at
dh 32, float32 2e-5 and bf16 two bf16 steps, as ``tests/test_torch_attention.py``;
``run_testing`` float32 1e-4 (MAE and results.csv, as
``tests/test_torch_serving.py``), bfloat16 5e-3 (the port serves through the
fused blocks, the JAX package on the CPU through ``MSSiT.apply``).
"""

import csv
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from surface_vision_transformers_tpu import geometry as G
from surface_vision_transformers_tpu.checkpoints import orbax_io
from surface_vision_transformers_tpu.models import MSSiT as JaxMSSiT
from surface_vision_transformers_tpu.models import fused_mssit as jfm
from surface_vision_transformers_tpu.models import mssit as jms
from surface_vision_transformers_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from surface_vision_transformers_tpu.train import runner as jax_runner
from surface_vision_transformers_tpu.utils.config import from_dict as jax_from_dict
from surface_vision_transformers_tpu_torch.checkpoints.convert import (
    jax_params_from_mssit_state_dict,
    mssit_state_dict_from_jax,
)
from surface_vision_transformers_tpu_torch.models import fused as tfused
from surface_vision_transformers_tpu_torch.models import fused_mssit as tfm
from surface_vision_transformers_tpu_torch.models import mssit as tms
from surface_vision_transformers_tpu_torch.ops import flash_attention as tfa
from surface_vision_transformers_tpu_torch.ops import fused_block as tfb
from surface_vision_transformers_tpu_torch.ops import fused_block_int8 as tq8
from surface_vision_transformers_tpu_torch.train import runner as trunner
from surface_vision_transformers_tpu_torch.utils.config import from_dict, load_config

REPO = Path(__file__).resolve().parent.parent
ICO, LEVEL = 2, 1  # 162 vertices, 80 patches x 6
ARCH = dict(embed_dim=64, depths=(2, 2), heads=(2, 4), window=4, global_max=2)
KW = dict(ico=ICO, patch_level=LEVEL, num_vertices=6, **ARCH)


@pytest.fixture(scope="module")
def setup():
    """(table, JAX float32 params, raw input (4, 4, 162))."""
    table = G.load_patch_table(ICO, LEVEL).indices
    x = np.random.default_rng(0).standard_normal((4, 4, 162)).astype(np.float32)
    model = JaxMSSiT(**KW, dtype=jnp.float32, patch_table=table)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    return table, params, x


def _port(setup, dtype):
    table, params, _ = setup
    m = tms.MSSiT(**KW, dtype=dtype, patch_table=table)
    m.load_state_dict(mssit_state_dict_from_jax(params), strict=True)
    return m.eval()


def _jax_model(setup, dtype):
    return JaxMSSiT(**KW, dtype=dtype, patch_table=setup[0])


# -- the plain functions ------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(KW), dict(KW, cross_mix="parent"), dict(KW, cross_mix="none"),
    dict(ico=6, patch_level=5, num_vertices=6),  # mssit_scan_age.yml's defaults
    dict(ico=6, patch_level=5, num_vertices=6, window=16, global_max=64),
])
def test_stage_plan_matches_jax(cfg):
    """``stage_plan`` (and ``window_size_for_stage`` through it) equals the
    JAX plan, per stage and mix."""
    want = jms.stage_plan(JaxMSSiT(**cfg))
    got = tms.stage_plan(tms.MSSiT(**cfg))
    assert got == want


@pytest.mark.parametrize("window,tokens,level,global_max", [
    (64, 20480, 5, 512), (64, 5120, 4, 512), (64, 1280, 3, 512), (64, 320, 2, 512),
    (4, 80, 1, 2), (4, 20, 0, 2), (16, 64, 1, 8), (64, 100, 2, 8),
])
def test_window_size_for_stage_matches_jax(window, tokens, level, global_max):
    args = (window, tokens, level, global_max)
    try:
        want = jms.window_size_for_stage(*args)
    except ValueError:
        with pytest.raises(ValueError):
            tms.window_size_for_stage(*args)
        return
    assert tms.window_size_for_stage(*args) == want


@pytest.mark.parametrize("mix", ["window", "axial", "parent"])
@pytest.mark.parametrize("B,T,F,window", [(3, 80, 5, 4), (2, 256, 7, 16), (2, 64, 3, 64)])
def test_fold_unfold_match_jax(mix, B, T, F, window):
    """``fold_tokens`` / ``unfold_tokens`` equal JAX's exactly, and unfold
    inverts fold."""
    t = np.random.default_rng(T + F).standard_normal((B, T, F)).astype(np.float32)
    want = np.asarray(jms.fold_tokens(jnp.asarray(t), window, mix))
    got = tms.fold_tokens(torch.from_numpy(t), window, mix)
    np.testing.assert_array_equal(got.numpy(), want)
    y = np.random.default_rng(1).standard_normal((*want.shape[:2], 2 * F)).astype(np.float32)
    np.testing.assert_array_equal(
        tms.unfold_tokens(torch.from_numpy(y), B, T, window, mix).numpy(),
        np.asarray(jms.unfold_tokens(jnp.asarray(y), B, T, window, mix)))
    np.testing.assert_array_equal(tms.unfold_tokens(got, B, T, window, mix).numpy(), t)


# -- the modular model and the weights ------------------------------------------------


@pytest.mark.parametrize("layout", ["raw", "patched", "flattened"])
def test_modular_float32_matches_jax(setup, layout):
    """The modular MSSiT in float32 against ``MSSiT.apply`` from the same
    params, on raw (B, C, G), pre-patched (B, C, T, V) and flattened (B, T,
    C*V) input."""
    table, params, x = setup
    if layout != "raw":  # (B, C, T, V), and (B, T, V*C) in the (v c) order
        x = x[:, :, table]
        if layout == "flattened":
            x = np.ascontiguousarray(x.transpose(0, 2, 3, 1).reshape(4, 80, 24))
    want = np.asarray(_jax_model(setup, jnp.float32).apply(params, jnp.asarray(x)))
    got = _port(setup, torch.float32)(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (4, 1)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_params_round_trip_bitwise(setup):
    """JAX tree -> port state dict -> JAX tree is bitwise, leaf for leaf."""
    _, params, _ = setup
    model = _port(setup, torch.float32)
    back = jax_params_from_mssit_state_dict(model.state_dict(), model)
    p = params["params"]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(p)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        assert flat_got[k].dtype == v.dtype and np.array_equal(flat_got[k], v), k


def test_from_config_builds_the_full_width_model():
    """``mssit_scan_age.yml``: stage dims 96 / 192 / 384 / 768 at dh 32,
    20,480 patches of 6 vertices, windows 64, 64, 64 and global at 320."""
    exp = load_config(REPO / "configs/training/mssit_scan_age.yml")
    model = tms.MSSiT.from_config(exp)
    assert model.stage_dims() == [96, 192, 384, 768] and model.num_patches == 20480
    assert model.patch_dim == 24 and model.dtype == torch.bfloat16
    plan = tms.stage_plan(model)
    assert [st["dim"] // st["heads"] for st in plan] == [32, 32, 32, 32]
    assert [st["window"] for st in plan] == [64, 64, 64, 320]
    assert [st["mixes"] for st in plan] == [["window", "axial"], ["window", "axial"],
                                            ["window", "axial"] * 3, ["window"] * 2]
    with pytest.raises(ValueError, match="on a SiT config"):
        tms.MSSiT.from_config(load_config(REPO / "configs/training/sit_tiny_scan_age.yml"))


# -- the fused serving path ---------------------------------------------------------------


def test_fused_bf16_matches_jax(setup):
    """The port's ``fused_mssit_forward`` in bf16 (the block kernels' plain
    versions) against the JAX one (Pallas interpret mode)."""
    _, params, x = setup
    jm = _jax_model(setup, jnp.bfloat16)
    want = np.asarray(jax.jit(lambda p, xx: jfm.fused_mssit_forward(jm, p, xx))(
        params, jnp.asarray(x)), np.float32)
    got = tfm.fused_mssit_forward(_port(setup, torch.bfloat16), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 1)
    assert np.abs(got - want).max() <= 5e-3 * np.abs(want).max()


@pytest.mark.parametrize("min_dim", [0, 10**9])
def test_fused_int8(setup, monkeypatch, min_dim):
    """``quant="int8"`` with ``INT8_MIN_DIM`` forced to 0 (every stage W8A8)
    against the JAX int8 path; forced past every stage, bitwise the bf16
    path."""
    _, params, x = setup
    model = _port(setup, torch.bfloat16)
    xt = torch.from_numpy(x)
    monkeypatch.setattr(tfused, "INT8_MIN_DIM", min_dim)
    got = tfm.fused_mssit_forward(model, xt, quant="int8").numpy()
    if min_dim:
        np.testing.assert_array_equal(got, tfm.fused_mssit_forward(model, xt).numpy())
        return
    calls = []
    real = tfm.fused_block_int8
    monkeypatch.setattr(tfm, "fused_block_int8", lambda *a, **k: calls.append(1) or real(*a, **k))
    tfm.fused_mssit_forward(model, xt, quant="int8")
    assert len(calls) == 4  # every block of both stages
    monkeypatch.setattr(jfm, "INT8_MIN_DIM", 0)
    jm = _jax_model(setup, jnp.bfloat16)
    want = np.asarray(jax.jit(lambda p, xx: jfm.fused_mssit_forward(jm, p, xx, quant="int8"))(
        params, jnp.asarray(x)), np.float32)
    assert np.abs(got - want).max() <= 0.08 * np.abs(want).max()


@pytest.mark.parametrize("kwarg,error", [(dict(mesh=object()), NotImplementedError),
                                         (dict(scan_blocks=True), NotImplementedError),
                                         (dict(quant="int4"), ValueError)])
def test_fused_refuses_unported_modes(setup, kwarg, error):
    with pytest.raises(error):
        tfm.fused_mssit_forward(_port(setup, torch.bfloat16), torch.zeros(1, 4, 162), **kwarg)


# -- the attention forward at dh 32, and the wrappers' checks ---------------------------------


def _bound(want, dtype):
    m = float(np.abs(want).max())
    return 2e-5 * m if dtype == "float32" else 2 * 2.0 ** (math.floor(math.log2(m)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,valid", [(20, 20), (64, 64), (64, 50), (80, 80), (80, 70),
                                     (320, 300), (20, 15)])
def test_attention_forward_dh32_matches_jax(dtype, N, valid):
    """The attention forward's plain version at dh 32 (the CPU side of the
    kernel's wrapper) against the JAX ``flash_attention`` in interpret
    mode."""
    r = np.random.default_rng(N + valid)
    q, k, v = (sc * r.standard_normal((2, 3, N, 32)).astype(np.float32) for sc in (1.5, 1.5, 1))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_flash_attention(*(jnp.asarray(t).astype(jdt) for t in (q, k, v)),
                                          valid).astype(jnp.float32))
    got, _ = tfa.flash_attention_fwd(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)), valid)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= _bound(want, dtype), err


@pytest.mark.parametrize("nq,nk,dh,dropout,resident,pack", [
    (64, 64, 32, False, False, 0), (320, 320, 32, False, False, 0), (80, 80, 32, False, True, 4),
    (20, 20, 32, False, True, 3), (100, 100, 32, False, True, 3), (321, 321, 32, False, False, 0),
    (8, 321, 32, False, False, 0), (320, 320, 64, False, False, 0),
    (320, 320, 32, True, False, 0)])
def test_attention_forward_route_and_pack(nq, nk, dh, dropout, resident, pack):
    """The forward's route rule (``resident_fwd``, as ``csrc/flash_attention.cu``
    takes it): the MS-SiT folds whose sequences are not whole 64-row tiles
    (dh 32, queries = keys <= 320, no dropout: the axial folds of 20 and 80
    rows) run the resident kernel; the folds of 64 and 320 rows, longer
    sequences, the CLS block's 8 queries, dh 64 and dropout the streamed
    kernel. Its units (``fwd_pack``): three sequences of 20 in one tile,
    four of 80 or three of 100 across five tiles."""
    assert tfa.resident_fwd(nq, nk, dh, dropout) is resident
    if resident:
        assert tfa.fwd_pack(nq) == pack
        assert tfa.fwd_pack(nq) * nq <= 320


@pytest.mark.parametrize("dh,taken", [(32, True), (64, True), (48, True), (20, True),
                                      (136, True)])
def test_wrapper_head_dim_checks_take_dh32_training(dh, taken):
    """What the CUDA wrappers take, reached through their checks with CPU
    tensors: the attention (forward and backward), ``fused_block`` (serving,
    its training forward and ``fused_block_bwd``), the CLS block and its
    backward and ``fused_block_int8`` take every dim_head >= 1: 32, 48 and
    64 as they are, 20 in padded heads (the int8 block's 4 x 20 = 80 off 16
    too), 136 on the wide kernels."""
    for check in (tfa.check_dim_head, tfb.check_dim_head):
        if taken:
            check(dh)
        else:
            with pytest.raises(NotImplementedError, match="dim_head"):
                check(dh)
    heads = 192 // dh if 192 % dh == 0 else 4
    x = torch.zeros((2, 10, 192), dtype=torch.bfloat16)
    w = [torch.zeros(n, dtype=torch.float32) for n in (192, 192, 192, 192, 192, 768, 192)]
    hd = heads * dh
    bf = lambda o, i: torch.zeros((o, i), dtype=torch.bfloat16)  # noqa: E731
    pb = (w[0], w[1], bf(3 * hd, 192), bf(192, hd), w[2], w[3], w[4], bf(768, 192), w[5],
          bf(192, 768), w[6])
    if taken:
        tfb._check_cuda_args(x, pb, heads, dh, 10)
    else:
        with pytest.raises(NotImplementedError, match="dim_head"):
            tfb._check_cuda_args(x, pb, heads, dh, 10)
    q8 = lambda o, i: torch.zeros((o, i), dtype=torch.int8)  # noqa: E731
    params = (w[0], w[1], q8(3 * hd, 192), torch.ones(3 * hd), q8(192, hd), torch.ones(192),
              w[2], w[3], w[4], q8(768, 192), torch.ones(768), w[5], q8(192, 768),
              torch.ones(192), w[6])
    if taken:
        tq8._check_cuda_args(x, params, heads, dh, 10)
    else:
        with pytest.raises(NotImplementedError, match="dim_head"):
            tq8._check_cuda_args(x, params, heads, dh, 10)


@pytest.mark.parametrize("dh", [32, 64])
def test_attention_cuda_checks_take_the_dh32_backward(dh):
    """The CUDA attention wrappers' checks, before any launch: the forward
    and the backward (q, k, v, o, dO) pass at dh 32 as at 64, the dropout
    kernels' too (one check for both: every multiple of 8 from 8 to 128;
    MS-SiT's dropout still runs the plain softmax, as in JAX)."""
    q = torch.zeros((1, 2, 8, dh), dtype=torch.bfloat16)
    tfa._check_cuda(q, q, q, 8)
    tfa._check_cuda(q, q, q, 8, ("o", q), ("do", q))
    tfa.check_dim_head(dh)
    with pytest.raises(ValueError, match="k .* and v"):
        tfa._check_cuda(q, q[..., :8], q[..., :8], 8)


# -- run_testing and the CLIs ---------------------------------------------------------------------


def _split(d: Path, n: int, seed: int):
    d.mkdir(parents=True, exist_ok=True)
    r = np.random.default_rng(seed)
    np.save(d / "validation_data.npy", r.standard_normal((n, 4, 162)).astype(np.float32))
    np.save(d / "validation_labels.npy", r.uniform(30, 45, n).astype(np.float32))


def _cfg(data_dir, ckpt, dtype):
    return {"resolution": {"ico": ICO, "sub_ico": LEVEL},
            "transformer": {"model": "MS-SiT", "num_classes": 1, "num_channels": 4},
            "mssit": {k: list(v) if isinstance(v, tuple) else v for k, v in ARCH.items()},
            "training": {"bs": 4, "bs_val": 2},
            "data": {"data_path": str(data_dir), "split": "validation", "streaming": "off"},
            "testing": {"path_to_ckpt": str(ckpt)},
            "tpu": {"compute_dtype": dtype}}


def _csv(path):
    with open(path) as f:
        return [(float(r["pred"]), float(r["target"])) for r in csv.DictReader(f)]


@pytest.mark.parametrize("dtype,route", [("float32", "modular"), ("bfloat16", "fused")])
def test_run_testing_matches_jax(setup, tmp_path, monkeypatch, dtype, route):
    """``run_testing`` on an MS-SiT config and a JAX params npz: float32
    serves the modular model, bfloat16 ``fused_mssit_forward`` (the JAX
    trainer's route by dtype); MAE and results.csv against the JAX
    ``run_testing`` on the same npz and split."""
    _, params, _ = setup
    _split(tmp_path / "data", 5, 3)
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
        orbax_io.save_params_npz(tmp_path / side / "best_params.npz", params)
    want = jax_runner.run_testing(jax_from_dict(
        _cfg(tmp_path / "data", tmp_path / "jax" / "best_params.npz", dtype)))
    calls = {"fused": 0, "modular": 0}
    real_fused, real_forward = tfm.fused_mssit_forward, tms.MSSiT.forward

    def fused(*a, **kw):
        calls["fused"] += 1
        return real_fused(*a, **kw)

    def forward(self, x):
        calls["modular"] += 1
        return real_forward(self, x)

    monkeypatch.setattr(tfm, "fused_mssit_forward", fused)
    monkeypatch.setattr(tms.MSSiT, "forward", forward)
    got = trunner.run_testing(from_dict(
        _cfg(tmp_path / "data", tmp_path / "torch" / "best_params.npz", dtype)), device="cpu")
    assert calls[route] == 3 and sum(calls.values()) == 3  # 5 surfaces at bs_val 2
    rows_t, rows_j = _csv(tmp_path / "torch" / "results.csv"), _csv(tmp_path / "jax" /
                                                                     "results.csv")
    assert (got["n"], len(rows_t)) == (want["n"], len(rows_j)) == (5, 5)
    assert [t for _, t in rows_t] == [t for _, t in rows_j]
    pj = np.array([p for p, _ in rows_j])
    tol = 1e-4 if dtype == "float32" else 5e-3 * np.abs(pj).max()
    assert np.abs(np.array([p for p, _ in rows_t]) - pj).max() <= tol
    assert abs(got["mae"] - want["mae"]) <= tol


_NO_JAX = ("import sys\n"
           "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
           "'orbax.checkpoint', 'surface_vision_transformers_tpu'):\n"
           "    sys.modules[m] = None\n")


def _run_cli(tool, cfg, *args):
    code = _NO_JAX + (
        "import runpy\n"
        f"sys.argv = [{tool!r}, {str(cfg)!r}, '--device', 'cpu', *{list(args)!r}]\n"
        f"runpy.run_module('surface_vision_transformers_tpu_torch.cli.{tool}', "
        "run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)))


def test_cli_test_on_mssit_without_jax(setup, tmp_path):
    """``cli.test`` serves an MS-SiT config in a subprocess with JAX blocked,
    bf16 and int8 (stages gate by width: the 64- and 128-wide stages here
    stay bf16, so int8 prints the bf16 results), from a params npz the port
    wrote; results.csv has a row per surface."""
    table, params, _ = setup
    _split(tmp_path / "data", 3, 5)
    model = _port(setup, torch.float32)
    orbax_io.save_params_npz(tmp_path / "best_params.npz",
                             jax_params_from_mssit_state_dict(model.state_dict(), model))
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(yaml.safe_dump(_cfg(tmp_path / "data", tmp_path / "best_params.npz",
                                       "bfloat16")))
    outs = []
    for extra in ((), ("--set", "tpu.quant=int8")):
        out = _run_cli("test", cfg, *extra)
        assert out.returncode == 0, out.stderr
        assert "'mae'" in out.stdout.strip().splitlines()[-1]
        outs.append(_csv(tmp_path / "results.csv"))
    assert len(outs[0]) == 3 and outs[0] == outs[1]


def _shrink_args(data_dir, runs):
    """``--set`` overrides that cut a shipped MS-SiT config to the test's
    size (lists and numbers parsed as YAML, as the JAX CLI parses them):
    ICO / LEVEL and ARCH, two epochs of batches of 2."""
    sets = [f"resolution.ico={ICO}", f"resolution.sub_ico={LEVEL}",
            f"data.data_path={data_dir}", f"logging.folder_to_save_model={runs}",
            "training.bs=2", "training.bs_val=2", "training.epochs=2", "training.val_epoch=1"]
    sets += [f"mssit.{k}={list(v) if isinstance(v, tuple) else v}" for k, v in ARCH.items()]
    return [a for s in sets for a in ("--set", s)]


@pytest.mark.parametrize("tool,config", [("train", "configs/training/mssit_scan_age.yml"),
                                         ("pretrain", "configs/pretraining/mssit_mpp.yml")])
def test_cli_training_runs_mssit_without_jax(tmp_path, tool, config):
    """``cli.train`` / ``cli.pretrain`` on the shipped MS-SiT configs (cut to
    the test's size by ``--set``; bfloat16: the fused blocks' plain
    versions here) in a subprocess with JAX blocked: the results dict and
    the run's files; after ``cli.pretrain``, ``cli.train`` finetunes from
    its ``encoder_best_params.npz``."""
    data = tmp_path / "data"
    _split(data, 3, 7)
    r = np.random.default_rng(8)
    np.save(data / "train_data.npy", r.standard_normal((4, 4, 162)).astype(np.float32))
    np.save(data / "train_labels.npy", r.uniform(30, 45, 4).astype(np.float32))
    out = _run_cli(tool, REPO / config, *_shrink_args(data, tmp_path / "runs"))
    assert out.returncode == 0, out.stderr
    metric = "best_mae" if tool == "train" else "best_loss"
    assert f"'{metric}'" in out.stdout.strip().splitlines()[-1]
    (run_dir,) = (tmp_path / "runs").iterdir()
    files = ["best_params.npz", "final_params.npz", "hparams_results.yml"]
    files += ["preds.csv"] if tool == "train" else ["encoder_best_params.npz"]
    for f in files:
        assert (run_dir / f).exists(), f
    if tool == "pretrain":
        out = _run_cli("train", REPO / "configs/training/mssit_scan_age.yml",
                       *_shrink_args(data, tmp_path / "finetune"),
                       "--set", "training.load_weights_ssl=true",
                       "--set", f"weights.ssl_mpp={run_dir / 'encoder_best_params.npz'}")
        assert out.returncode == 0, out.stderr
        assert "'best_mae'" in out.stdout.strip().splitlines()[-1]
