"""SiT-base on the sub-ico-3 grid (N = 1,281), CPU, against the JAX package:
the recompute route's backward, the route rule, the config, and a narrow
sub-ico-3 SiT end to end.

Tolerances, as the largest |port - reference| over the largest |reference|
of each gradient (dx on the rows < valid_len):
* the recompute backward against the port's ``fused_block_bwd_reference``
  (the same function, the same rounding points; LayerNorm through
  ``F.layer_norm`` and autograd instead of the explicit formulas): 1e-5 in
  float32 and one bf16 step (2^-8) in bfloat16.
* against ``jax.vjp`` of ``_xla_block_ref(attn="flash")`` (Pallas interpret
  mode): 4.9e-4 in float32 and 7.1e-3 in bfloat16, the largest readings of
  the chain backward against the JAX Pallas backwards, for the same reasons
  (tanh-GELU in the JAX mirror, its bf16 parameter gradients); read 4.1e-4
  and 5.2e-3 here.
* the narrow sub-ico-3 SiT: ``fused_forward`` against the JAX
  ``fused_forward`` to 1e-3 (the JAX Pallas blocks' tanh-GELU and clamped
  softmax, as in ``tests/test_torch_serving.py``); the gradient of
  ``fused_train_forward``'s loss against ``jax.grad`` of ``SiT.apply``'s
  (erf-GELU, shifted softmax: the port's numerics) to 1e-4 of each
  parameter's largest gradient, float32.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from surface_vision_transformers_tpu import geometry as jgeo
from surface_vision_transformers_tpu.models import SiT as JaxSiT
from surface_vision_transformers_tpu.models.fused import fused_forward as jax_fused_forward
from surface_vision_transformers_tpu.ops.pallas import fused_block as jfb
from surface_vision_transformers_tpu.utils import config as jax_config
from surface_vision_transformers_tpu_torch.checkpoints.convert import state_dict_from_jax
from surface_vision_transformers_tpu_torch.geometry import load_patch_table
from surface_vision_transformers_tpu_torch.models import fused as tfused
from surface_vision_transformers_tpu_torch.models.sit import SiT
from surface_vision_transformers_tpu_torch.ops import fused_block as tfb
from surface_vision_transformers_tpu_torch.utils import config

REPO = Path(__file__).resolve().parent.parent
BASE_CFG = REPO / "configs/training/sit_base_subico3.yml"
HEADS, DH, MLP, DIM = 2, 16, 64, 32
B, N, VALID = 2, 24, 19
ORDER = ("ln1_s", "ln1_b", "w_qkv", "w_out", "b_out", "ln2_s", "ln2_b",
         "w_fc1", "b_fc1", "w_fc2", "b_fc2")
MATS = ("w_qkv", "w_out", "w_fc1", "w_fc2")
NAMES = ("dx",) + ORDER


def _block(seed):
    """Flax-layout block parameters, x and a cotangent from a numpy seed."""
    r = np.random.default_rng(seed)
    hd = HEADS * DH

    def u(shape, fan_in, gain=1.0):
        b = gain / np.sqrt(fan_in)
        return r.uniform(-b, b, shape).astype(np.float32)

    def ln():
        return ((1 + 0.1 * r.standard_normal(DIM)).astype(np.float32),
                (0.1 * r.standard_normal(DIM)).astype(np.float32))

    (s1, b1), (s2, b2) = ln(), ln()
    p = dict(ln1_s=s1, ln1_b=b1, w_qkv=u((DIM, 3 * hd), DIM, 2.0),
             w_out=u((hd, DIM), hd, 4.0), b_out=u((DIM,), hd), ln2_s=s2,
             ln2_b=b2, w_fc1=u((DIM, MLP), DIM), b_fc1=u((MLP,), DIM),
             w_fc2=u((MLP, DIM), MLP), b_fc2=u((DIM,), MLP))
    x = r.standard_normal((B, N, DIM)).astype(np.float32)
    g = r.standard_normal((B, N, DIM)).astype(np.float32)
    g[:, VALID:] = 0.0
    return p, x, g


def _torch_params(p, dt=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(p[k].T)).to(dt) if k in MATS
            else torch.from_numpy(p[k]) for k in ORDER]


def _rel_errs(got, want):
    out = {}
    for name, a, b in zip(NAMES, got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, name
        if name == "dx":
            a, b = a[:, :VALID], b[:, :VALID]
        out[name] = float(np.abs(a - b).max() / np.abs(b).max())
    return out


def _recompute(p, x, g, dtype):
    """The port's recompute backward: bf16/fp32 compute, fp32 masters."""
    tdt = getattr(torch, dtype)
    got = tfb.fused_block_recompute_bwd(
        torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt), *_torch_params(p),
        heads=HEADS, dim_head=DH, valid_len=VALID)
    return [t.float().numpy() for t in got]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2.0 ** -8)])
def test_recompute_backward_is_the_chain_backward(dtype, tol):
    p, x, g = _block(1)
    tdt = getattr(torch, dtype)
    want = tfb.fused_block_bwd_reference(
        torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt), *_torch_params(p, tdt),
        heads=HEADS, dim_head=DH, valid_len=VALID)
    errs = _rel_errs(_recompute(p, x, g, dtype), [t.float().numpy() for t in want])
    assert max(errs.values()) <= tol, errs


@pytest.mark.parametrize("dtype,tol", [("float32", 4.9e-4), ("bfloat16", 7.1e-3)])
def test_recompute_backward_matches_jax_flash_route(dtype, tol):
    p, x, g = _block(2)
    jdt = getattr(jnp, dtype)
    args = [jnp.asarray(p[k]).astype(jdt) if k in MATS else jnp.asarray(p[k])
            for k in ORDER]

    def ref(xx, *a):
        return jfb._xla_block_ref(xx, *a, heads=HEADS, dim_head=DH, valid_len=VALID,
                                  ln_eps=1e-5, attn="flash")

    out, vjp = jax.vjp(ref, jnp.asarray(x).astype(jdt), *args)
    want = [np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(g).astype(out.dtype))]
    got = _recompute(p, x, g, dtype)
    got = [t.T if n in MATS else t for n, t in zip(NAMES, got)]  # -> flax layout
    errs = _rel_errs(got, want)
    assert max(errs.values()) <= tol, errs


def _sit_configs():
    out = []
    for path in sorted((REPO / "configs").glob("t*/*.yml")):  # training/, testing/
        if yaml.safe_load(path.read_text()).get("transformer", {}).get("model", "SiT") == "SiT":
            out.append(path)
    return out


@pytest.mark.parametrize("path", _sit_configs(), ids=lambda p: p.stem)
def test_route_rule_matches_jax(path):
    """The port's route per block shape against the JAX package's own
    predicates at its padded N: a non-CLS block recomputes exactly where
    ``_fbt_bwd`` falls back to ``jax.vjp`` of ``_xla_block_ref``, and the CLS
    block, which the port always runs on its chain, never falls back."""
    m = config.load_config(path).model
    n = m.num_patches + 1
    n_pad = -(-n // 8) * 8
    shape = (n_pad, m.dim, m.mlp_dim, m.heads * m.dim_head, m.heads)
    mono = jfb._bwd_kernel_feasible(*shape)
    assert tfb.uses_recompute(n, m.dim) == (not mono and not jfb._split_bwd_feasible(*shape))
    cls_split = (not mono or jfb._prefer_split(m.dim)) and jfb._split_cls_bwd_feasible(*shape)
    assert mono or cls_split
    assert tfb.uses_recompute(n, m.dim) == (path.stem == "sit_base_subico3")


def test_sit_base_config_loads_as_in_jax():
    got, want = config.load_config(BASE_CFG), jax_config.load_config(BASE_CFG)
    for f in ("dim", "depth", "heads", "dim_head", "mlp_dim", "num_patches",
              "num_vertices", "pool"):
        assert getattr(got.model, f) == getattr(want.model, f), f
    assert (got.model.num_patches, got.model.num_vertices) == (1280, 45)
    assert (got.model.dim, got.model.heads, got.model.dim_head, got.model.mlp_dim) == (
        768, 12, 64, 3072)
    assert (got.training.bs, got.training.bs_val) == (want.training.bs, want.training.bs_val) == (
        128, 64)
    assert (got.ico, got.sub_ico) == (want.ico, want.sub_ico) == (6, 3)


NARROW = dict(dim=64, depth=2, heads=1, mlp_dim=128, dim_head=64,
              num_patches=1280, num_vertices=45)


@pytest.fixture(scope="module")
def narrow():
    """JAX params of a narrow sub-ico-3 SiT, the table, and the port's model
    carrying the same weights (through the checkpoint converter)."""
    table = load_patch_table(6, 3).indices
    m = JaxSiT(dtype=jnp.float32, **NARROW)
    params = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(3),
                                             jnp.zeros((1, 4, 1280, 45))))["params"]
    model = SiT(dtype=torch.float32, patch_table=table, **NARROW)
    model.load_state_dict(state_dict_from_jax(params, NARROW["depth"]), strict=True)
    x = np.random.default_rng(5).standard_normal((2, 4, 40962)).astype(np.float32)
    return table, params, model, x


def test_narrow_sub_ico3_forward_matches_jax(narrow):
    table, params, model, x = narrow
    assert np.array_equal(table, jgeo.load_patch_table(6, 3).indices)
    jmodel = JaxSiT(dtype=jnp.float32, patch_table=table, **NARROW)
    want = np.asarray(jax_fused_forward(jmodel, {"params": params}, jnp.asarray(x)))
    got = tfused.fused_forward(model.eval(), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_narrow_sub_ico3_gradient_matches_jax(narrow, monkeypatch):
    """Block 0 (N = 1,281) trains on the recompute route, block 1 (CLS) on
    the chain; the loss gradient of every parameter matches ``jax.grad``."""
    table, params, model, x = narrow
    assert tfb.uses_recompute(1281, NARROW["dim"])
    y = np.array([0.3, -0.2], np.float32)
    jmodel = JaxSiT(dtype=jnp.float32, patch_table=table, **NARROW)
    jgrads = jax.grad(lambda p: jnp.mean(
        (jmodel.apply({"params": p}, jnp.asarray(x)).squeeze(-1) - y) ** 2))(
        jax.tree.map(jnp.asarray, params))
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), NARROW["depth"])

    calls = []
    recompute = tfb.fused_block_recompute_bwd

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return recompute(*a, **kw)

    monkeypatch.setattr(tfb, "fused_block_recompute_bwd", counted)
    model.zero_grad()
    out = tfused.fused_train_forward(model, torch.from_numpy(x))
    loss = ((out.squeeze(-1) - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    assert calls == [(2, 1281, NARROW["dim"])]
    for name, prm in model.named_parameters():
        w = want[name].numpy()
        err = np.abs(prm.grad.numpy() - w).max() / max(np.abs(w).max(), 1e-12)
        assert err <= 1e-4, f"{name}: {err:.3g}"
    assert math.isfinite(loss.detach().item())


def test_runners_use_the_generated_table_and_npz_goes_both_ways(tmp_path):
    """``run_training`` on raw sub-ico-3 surfaces (the generated table), then
    its ``best_params.npz`` served by the JAX ``run_testing`` and the port's
    at the best validation MAE."""
    from surface_vision_transformers_tpu.train import runner as jax_runner
    from surface_vision_transformers_tpu_torch.train import runner

    r = np.random.default_rng(9)
    data = r.standard_normal((7, 4, 40962)).astype(np.float32)
    labels = r.uniform(30, 45, 7).astype(np.float32)
    split = tmp_path / "data"
    split.mkdir()
    np.save(split / "validation_data.npy", data[4:])
    np.save(split / "validation_labels.npy", labels[4:])
    cfg = {"resolution": {"ico": 6, "sub_ico": 3},
           "transformer": {k: v for k, v in NARROW.items() if k[:4] != "num_"},
           "training": {"bs": 4, "bs_val": 2, "epochs": 1, "val_epoch": 1, "LR": 1e-4},
           "optimisation": {"optimiser": "SGD"}, "SGD": {"momentum": 0.9},
           "logging": {"folder_to_save_model": str(tmp_path / "runs")},
           "data": {"data_path": str(split), "split": "validation", "streaming": "off"},
           "tpu": {"compute_dtype": "float32"}}
    got = runner.run_training(config.from_dict(cfg), device="cpu", progress=False,
                              datasets={"train": (data[:4], labels[:4]),
                                        "validation": (data[4:], labels[4:])})
    cfg["testing"] = {"path_to_ckpt": str(Path(got["run_dir"]) / "best_params.npz")}
    jres = jax_runner.run_testing(jax_config.from_dict(cfg))
    tres = runner.run_testing(config.from_dict(cfg), device="cpu")
    assert jres["n"] == tres["n"] == 3
    assert abs(tres["mae"] - got["best_mae"]) < 1e-4
    assert abs(jres["mae"] - got["best_mae"]) < 1e-4
