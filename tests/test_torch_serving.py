"""The serving slice end to end on the CPU (plain block versions) against
the JAX package: ``fused_forward`` against JAX ``fused_forward`` (Pallas
interpret mode), ``run_testing`` against JAX ``run_testing``, the CLI, and
the port's independence from JAX.

Tolerances, float32: the JAX block kernels use tanh-GELU and an unshifted
clamped softmax, so ``fused_forward`` agrees to 1e-3 (as each block does);
JAX ``run_testing`` on the CPU runs ``SiT.apply`` (erf-GELU, shifted
softmax), the port's plain blocks compute the same, so 1e-4.
"""

import csv
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from surface_vision_transformers_tpu.checkpoints import orbax_io
from surface_vision_transformers_tpu.models import SiT as JaxSiT
from surface_vision_transformers_tpu.models.fused import fused_forward as jax_fused_forward
from surface_vision_transformers_tpu.train import runner as jax_runner
from surface_vision_transformers_tpu.utils.config import from_dict as jax_from_dict
from surface_vision_transformers_tpu_torch.checkpoints.convert import state_dict_from_jax
from surface_vision_transformers_tpu_torch.models import fused as tfused
from surface_vision_transformers_tpu_torch.models.sit import SiT
from surface_vision_transformers_tpu_torch.train import runner as trunner
from surface_vision_transformers_tpu_torch.utils.config import from_dict
from tests.torch_ref import TorchSiT

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "surface_vision_transformers_tpu_torch"
TRANSFORMER = dict(dim=32, depth=2, heads=2, mlp_dim=64, dim_head=16)
MEANS = np.array([0.5, -1.0, 2.0, 0.1], np.float32).reshape(1, 4, 1)
STDS = np.array([1.5, 0.5, 2.0, 1.0], np.float32).reshape(1, 4, 1)


@pytest.fixture(scope="module")
def jax_params():
    m = JaxSiT(dtype=jnp.float32, num_patches=320, num_vertices=153,
               **TRANSFORMER)
    p = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 320, 153)))
    return jax.tree.map(np.asarray, p)


def _raw(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 4, 40962)).astype(np.float32)


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_fused_forward_matches_jax(jax_params, table_sub2, pool):
    kw = dict(pool=pool, patch_table=table_sub2.indices, norm_means=MEANS,
              norm_stds=STDS, num_patches=320, num_vertices=153, **TRANSFORMER)
    x = _raw(2, 1)
    want = np.asarray(jax_fused_forward(JaxSiT(dtype=jnp.float32, **kw),
                                        jax_params, jnp.asarray(x)))
    model = SiT(dtype=torch.float32, **kw)
    model.load_state_dict(state_dict_from_jax(jax_params, 2), strict=True)
    got = tfused.fused_forward(model.eval(), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    with torch.no_grad():  # and the port's eager model computes the same
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), got,
                                   atol=1e-5, rtol=0)


def test_predict_pads_the_last_batch(jax_params, table_sub2):
    model = SiT(dtype=torch.float32, patch_table=table_sub2.indices,
                num_patches=320, num_vertices=153, **TRANSFORMER)
    model.load_state_dict(state_dict_from_jax(jax_params, 2), strict=True)
    x = _raw(5, 2)
    got = tfused.predict(model, x, device="cpu", batch_size=2)
    whole = tfused.fused_forward(model, torch.from_numpy(x)).numpy()
    assert got.shape == (5, 1)
    np.testing.assert_allclose(got, whole, atol=1e-5, rtol=0)


def test_predict_on_missing_cuda_raises(jax_params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = SiT(dtype=torch.bfloat16, num_patches=320, num_vertices=153,
                **TRANSFORMER)
    with pytest.raises(RuntimeError, match="cuda"):
        tfused.predict(model, np.zeros((1, 4, 320, 153), np.float32),
                       device="cuda")


@pytest.mark.parametrize("kwarg,error", [(dict(mesh=object()), NotImplementedError),
                                         (dict(quant="int4"), ValueError),
                                         (dict(scan_blocks=True), NotImplementedError)])
def test_out_of_scope_modes_raise(kwarg, error):
    model = SiT(dtype=torch.float32, num_patches=20, num_vertices=15,
                **TRANSFORMER)
    with pytest.raises(error):
        tfused.fused_forward(model, torch.zeros(1, 4, 20, 15), **kwarg)


def _split(d: Path, n: int, seed: int):
    d.mkdir(parents=True, exist_ok=True)
    np.save(d / "validation_data.npy", _raw(n, seed))
    np.save(d / "validation_labels.npy",
            np.random.default_rng(seed + 1).uniform(30, 45, n).astype(np.float32))


def _raw_cfg(data_dir, ckpt):
    return {"resolution": {"ico": 6, "sub_ico": 2},
            "transformer": dict(TRANSFORMER),
            "training": {"bs": 4, "bs_val": 2},
            "data": {"data_path": str(data_dir), "split": "validation",
                     "streaming": "off"},
            "testing": {"path_to_ckpt": str(ckpt)},
            "tpu": {"compute_dtype": "float32"}}


def _csv(path):
    with open(path) as f:
        return [(float(r["pred"]), float(r["target"])) for r in csv.DictReader(f)]


def test_run_testing_matches_jax(jax_params, tmp_path):
    _split(tmp_path / "data", 5, 3)
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
        orbax_io.save_params_npz(tmp_path / side / "best_params.npz", jax_params)
    want = jax_runner.run_testing(jax_from_dict(
        _raw_cfg(tmp_path / "data", tmp_path / "jax" / "best_params.npz")))
    got = trunner.run_testing(from_dict(
        _raw_cfg(tmp_path / "data", tmp_path / "torch" / "best_params.npz")),
        device="cpu")
    assert (got["n"], got["split"]) == (want["n"], want["split"]) == (5, "validation")
    assert abs(got["mae"] - want["mae"]) < 1e-4
    rows_j = _csv(tmp_path / "jax" / "results.csv")
    rows_t = _csv(tmp_path / "torch" / "results.csv")
    assert len(rows_t) == len(rows_j) == 5
    assert [t for _, t in rows_t] == [t for _, t in rows_j]
    np.testing.assert_allclose([p for p, _ in rows_t], [p for p, _ in rows_j],
                               atol=1e-4, rtol=0)


def _counting(monkeypatch):
    """Count the serving routes: ``fused_forward`` and the modular
    ``SiT.forward``."""
    calls = {"fused": 0, "modular": 0}
    real_fused, real_forward = tfused.fused_forward, SiT.forward

    def fused(*a, **kw):
        calls["fused"] += 1
        return real_fused(*a, **kw)

    def forward(self, x):
        calls["modular"] += 1
        return real_forward(self, x)

    monkeypatch.setattr(tfused, "fused_forward", fused)
    monkeypatch.setattr(SiT, "forward", forward)
    return calls


def test_run_testing_float32_serves_the_modular_model_as_jax(jax_params, tmp_path,
                                                              monkeypatch):
    """float32 ``run_testing`` takes ``Trainer.evaluate``'s route, the
    modular SiT forward, as the JAX trainer's ``_use_fused_inference``
    (bfloat16 only) does: ``fused_block`` takes bfloat16 alone on CUDA. Its
    MAE and results.csv are the JAX ``run_testing``'s on the same params npz
    and split; bfloat16 still serves through ``fused_forward``."""
    _split(tmp_path / "data", 5, 6)
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
        orbax_io.save_params_npz(tmp_path / side / "best_params.npz", jax_params)
    want = jax_runner.run_testing(jax_from_dict(
        _raw_cfg(tmp_path / "data", tmp_path / "jax" / "best_params.npz")))
    calls = _counting(monkeypatch)
    cfg = _raw_cfg(tmp_path / "data", tmp_path / "torch" / "best_params.npz")
    got = trunner.run_testing(from_dict(cfg), device="cpu")
    assert calls == {"fused": 0, "modular": 3}  # 5 surfaces at bs_val 2
    assert abs(got["mae"] - want["mae"]) < 1e-4
    rows_t = _csv(tmp_path / "torch" / "results.csv")
    rows_j = _csv(tmp_path / "jax" / "results.csv")
    assert [t for _, t in rows_t] == [t for _, t in rows_j]
    np.testing.assert_allclose([p for p, _ in rows_t], [p for p, _ in rows_j],
                               atol=1e-4, rtol=0)
    cfg["tpu"]["compute_dtype"] = "bfloat16"
    calls.update(fused=0, modular=0)
    trunner.run_testing(from_dict(cfg), device="cpu")
    assert calls == {"fused": 3, "modular": 0}


@pytest.mark.parametrize("dtype,route", [(torch.float32, "modular"),
                                         (torch.bfloat16, "fused")])
def test_predict_routes_by_dtype(jax_params, table_sub2, monkeypatch, dtype, route):
    """``predict`` serves bfloat16 through ``fused_forward`` and any other
    dtype through the model's own forward (the JAX ``predict``'s rule), the
    same numbers either way in float32."""
    model = SiT(dtype=dtype, patch_table=table_sub2.indices, num_patches=320,
                num_vertices=153, **TRANSFORMER)
    model.load_state_dict(state_dict_from_jax(jax_params, 2), strict=True)
    x = _raw(3, 9)
    calls = _counting(monkeypatch)
    got = tfused.predict(model, x, device="cpu", batch_size=2)
    assert got.shape == (3, 1) and np.isfinite(got).all()
    assert calls[route] == 2 and sum(calls.values()) == 2
    if dtype == torch.float32:
        np.testing.assert_allclose(
            got, tfused.fused_forward(model, torch.from_numpy(x)).numpy(), atol=1e-5, rtol=0)


def test_run_testing_refuses_what_it_cannot_serve(tmp_path):
    _split(tmp_path / "data", 2, 4)
    cfg = _raw_cfg(tmp_path / "data", "")
    with pytest.raises(ValueError, match="needs weights"):
        trunner.run_testing(from_dict(cfg), device="cpu")
    cfg["testing"]["path_to_ckpt"] = str(tmp_path)
    with pytest.raises(ValueError, match="directory"):
        trunner.run_testing(from_dict(cfg), device="cpu")
    cfg["testing"]["path_to_ckpt"] = str(tmp_path / "best_params.npz")
    cfg["transformer"] = dict(cfg["transformer"], num_classes=2)
    with pytest.raises(NotImplementedError, match="regression and MPP"):
        trunner.run_testing(from_dict(cfg), device="cpu")


_NO_JAX = ("import sys\n"
           "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
           "'orbax.checkpoint', 'surface_vision_transformers_tpu'):\n"
           "    sys.modules[m] = None\n")


def _run(code, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO, env=env, **kw)


def test_cli_runs_end_to_end_without_jax(tmp_path):
    _split(tmp_path / "data", 3, 5)
    torch.manual_seed(0)
    pth = tmp_path / "run" / "checkpoint.pth"
    pth.parent.mkdir()
    torch.save(TorchSiT(num_patches=320, num_vertices=153,
                        **TRANSFORMER).state_dict(), pth)
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(yaml.safe_dump(_raw_cfg(tmp_path / "data", "set by --set")))
    out = _run(_NO_JAX + (
        "import runpy\n"
        f"sys.argv = ['test', {str(cfg)!r}, '--device', 'cpu',\n"
        f"            '--set', 'testing.path_to_ckpt={pth}']\n"
        "runpy.run_module('surface_vision_transformers_tpu_torch.cli.test',\n"
        "                 run_name='__main__')\n"))
    assert out.returncode == 0, out.stderr
    assert "'mae'" in out.stdout
    rows = _csv(tmp_path / "run" / "results.csv")
    assert len(rows) == 3 and all(np.isfinite(p) for p, _ in rows)


def test_port_imports_without_jax():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
        for p in PKG.rglob("*.py"))
    out = _run(_NO_JAX + "import importlib\n"
               f"for m in {mods!r}:\n    importlib.import_module(m)\n"
               "print(len(sys.modules))\n")
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 20
    assert {"surface_vision_transformers_tpu_torch.ops.flash_attention",
            "surface_vision_transformers_tpu_torch.ops.attention",
            "surface_vision_transformers_tpu_torch.ops.fused_block_int8",
            "surface_vision_transformers_tpu_torch.ops.patch_embed",
            "surface_vision_transformers_tpu_torch.ops.quant",
            "surface_vision_transformers_tpu_torch.models.mpp",
            "surface_vision_transformers_tpu_torch.cli.pretrain",
            "surface_vision_transformers_tpu_torch.geometry.icosphere"} <= set(mods)


def test_no_file_of_the_port_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax"
                     r"|surface_vision_transformers_tpu(?!_torch))\b", re.M)
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        assert not pat.search(f.read_text()), f
