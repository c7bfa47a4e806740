"""The port's MPP pretraining on the CPU against the JAX package: the
corruption's counts and rates, ``MPP`` against ``MPP.apply`` under a fixed
corruption, ``fused_mpp_loss`` (plain blocks) and every gradient against
``jax.value_and_grad`` of ``MPP.apply``, the reconstruction head's backward
against ``jax.vjp`` of ``_masked_mse_recon``, the frozen decoder against the
JAX ``Trainer``'s optimizer, checkpoints both ways, and the run / test /
finetune chain with ``cli.pretrain`` without JAX.

Tolerances: ``MPP`` loss and reconstruction against ``MPP.apply`` at
float32 / HIGHEST 2e-5 of the largest value (as ``tests/test_torch_sit.py``);
``fused_mpp_loss`` loss 2e-5 relative and each gradient 1e-4 of its largest
value (the fused blocks' plain versions form LayerNorm, softmax and the
residuals in another order than the modular model); ``_masked_mse_recon``
float32 2e-5 of each gradient's largest value, bfloat16 two bf16 steps (the
GEMM operands are rounded to bf16 on both sides, the sums differ in order);
the corruption rates within 0.02 of their expectation at 15,360 draws, as
``tests/test_mpp.py``; ``run_testing`` against the run's best val loss 1e-6
relative (the same weights and fixed corruption).
"""

import ast
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

from surface_vision_transformers_tpu.checkpoints import orbax_io
from surface_vision_transformers_tpu.checkpoints.torch_import import mpp_params_from_torch
from surface_vision_transformers_tpu.models import MPP as JaxMPP
from surface_vision_transformers_tpu.models import SiT as JaxSiT
from surface_vision_transformers_tpu.models.fused import _masked_mse_recon
from surface_vision_transformers_tpu.train import trainer as jax_trainer
from surface_vision_transformers_tpu.utils import config as jax_config
from surface_vision_transformers_tpu_torch.checkpoints import convert
from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
from surface_vision_transformers_tpu_torch.geometry import load_patch_table
from surface_vision_transformers_tpu_torch.models import fused as tfused
from surface_vision_transformers_tpu_torch.models.mpp import (
    MPP,
    corrupt_sequence,
    exact_count_mask,
)
from surface_vision_transformers_tpu_torch.models.sit import SiT
from surface_vision_transformers_tpu_torch.train import runner
from surface_vision_transformers_tpu_torch.train.trainer import Trainer
from surface_vision_transformers_tpu_torch.utils import config

REPO = Path(__file__).resolve().parent.parent
CFG = dict(dim=64, depth=2, heads=2, mlp_dim=128, num_patches=40, num_vertices=15)
PATCH_DIM = 4 * CFG["num_vertices"]


@pytest.mark.parametrize("prob,L", [(0.75, 320), (0.15, 80), (0.5, 20)])
def test_exact_mask_count(prob, L):
    mask, n = exact_count_mask(8, L, prob, generator=torch.Generator().manual_seed(0))
    assert n == math.ceil(prob * L)
    assert (mask.sum(1) == n).all()


def test_corruption_rates():
    B, L, D = 64, 320, 12
    g = torch.Generator().manual_seed(1)
    tokens = torch.randn((B, L, D), generator=g)
    corrupted, mask, n = corrupt_sequence(tokens, torch.full((1, 1, D), 1e9),
                                          mask_prob=0.75, replace_prob=0.8,
                                          swap_prob=0.02, generator=g)
    assert n == 240 and (mask.sum(1) == n).all()
    replaced = corrupted[:, :, 0] > 1e8
    assert abs(replaced[mask].float().mean().item() - 0.8) < 0.02
    assert torch.equal(corrupted[~mask], tokens[~mask])  # unmasked rows untouched
    swapped = ((corrupted - tokens).abs().amax(-1) > 0) & ~replaced & mask
    assert abs(swapped[mask].float().mean().item() - 0.02) < 0.02
    assert swapped.any()


def _jax_mpp(seed=0):
    sit = JaxSiT(dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, **CFG)
    mpp = JaxMPP(encoder=sit)
    x = np.random.default_rng(seed).standard_normal((3, 4, 40, 15)).astype(np.float32)
    params = jax.tree.map(np.asarray, mpp.init({"params": jax.random.PRNGKey(seed)},
                                               jnp.asarray(x), jax.random.PRNGKey(1)))
    return mpp, params["params"], x


def _fixed_corruption(x, mask_token, seed):
    """An exact-count corruption (mask, corrupted) in numpy: 30 of the 40
    positions per row, most replaced by the mask token, some by noise."""
    r = np.random.default_rng(seed)
    target = x.transpose(0, 2, 3, 1).reshape(x.shape[0], 40, PATCH_DIM)
    mask = np.zeros(target.shape[:2], bool)
    for row in mask:
        row[r.permutation(40)[:30]] = True
    corrupted = target.copy()
    corrupted[mask] = np.asarray(mask_token).reshape(-1)
    corrupted[mask & (r.random(mask.shape) < 0.1)] = r.standard_normal(PATCH_DIM)
    return mask, corrupted.astype(np.float32)


def _port_mpp(params, dtype=torch.float32):
    model = MPP(SiT(dtype=dtype, **CFG))
    runner.load_model_state(model, convert.mpp_state_dict_from_jax(params, CFG["depth"]))
    return model


def test_mpp_matches_jax_under_fixed_corruption():
    mpp, params, x = _jax_mpp()
    mask, corrupted = _fixed_corruption(x, params["mask_token"], 2)
    w = np.array([1.0, 0.0, 1.0], np.float32)
    model = _port_mpp(params)
    for sw in (None, w):
        want_loss, want_recon = mpp.apply(
            {"params": params}, jnp.asarray(x), fixed_mask=jnp.asarray(mask),
            fixed_corrupted=jnp.asarray(corrupted),
            sample_weights=None if sw is None else jnp.asarray(sw))
        loss, recon = model(torch.from_numpy(x), fixed_mask=torch.from_numpy(mask),
                            fixed_corrupted=torch.from_numpy(corrupted),
                            sample_weights=None if sw is None else torch.from_numpy(sw))
        want_recon = np.asarray(want_recon)
        assert abs(loss.item() - float(want_loss)) <= 2e-5 * abs(float(want_loss))
        assert np.abs(recon.detach().numpy() - want_recon).max() <= 2e-5 * np.abs(
            want_recon).max()


def _grad_tree(model):
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    return convert.jax_params_from_mpp_state_dict(grads, CFG["depth"])


def test_fused_mpp_loss_and_gradients_match_jax():
    mpp, params, x = _jax_mpp(3)
    mask, corrupted = _fixed_corruption(x, params["mask_token"], 4)

    def loss_fn(p):
        return mpp.apply({"params": p}, jnp.asarray(x), fixed_mask=jnp.asarray(mask),
                         fixed_corrupted=jnp.asarray(corrupted))[0]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params))
    model = _port_mpp(params)
    loss = tfused.fused_mpp_loss(model, torch.from_numpy(x), corruption=(
        torch.from_numpy(corrupted), torch.from_numpy(mask), 30))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 2e-5 * float(want_loss)
    got = jax.tree_util.tree_flatten_with_path(_grad_tree(model))[0]
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want_grads))[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-12), str(k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_mse_recon_backward_matches_jax(dtype):
    r = np.random.default_rng(5)
    B, L, dim, P = 2, 12, 32, 20
    h, target = r.standard_normal((B, L, dim)), r.standard_normal((B, L, P))
    kernel, bias = 0.2 * r.standard_normal((dim, P)), 0.1 * r.standard_normal(P)
    maskw = (r.random((B, L)) < 0.6) * np.array([[1.0], [0.0]])
    inv_denom = 1.0 / (1.0 * 7 * P)
    h, target, kernel, bias, maskw = (a.astype(np.float32) for a in (h, target, kernel, bias, maskw))
    cdt = getattr(jnp, dtype)
    loss, vjp = jax.vjp(lambda a, k, b: _masked_mse_recon(cdt, a, k, b, jnp.asarray(target),
                                                          jnp.asarray(maskw), inv_denom),
                        jnp.asarray(h).astype(cdt), jnp.asarray(kernel), jnp.asarray(bias))
    want = [np.asarray(t, np.float32) for t in vjp(jnp.float32(1.0))]
    want[1] = want[1].T  # flax (in, out) -> torch (out, in)
    ht = torch.from_numpy(h).to(getattr(torch, dtype)).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(kernel.T)).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    got_loss = tfused._MaskedMSERecon.apply(ht, wt, bt, torch.from_numpy(target),
                                            torch.from_numpy(maskw), torch.tensor(inv_denom),
                                            getattr(torch, dtype))
    got_loss.backward()
    assert abs(got_loss.item() - float(loss)) <= 2e-5 * abs(float(loss))
    for name, a, b in zip(("dh", "dkernel", "dbias"), (ht.grad, wt.grad, bt.grad), want):
        m = np.abs(b).max()
        tol = 2e-5 * m if dtype == "float32" else 2 * 2.0 ** (math.floor(math.log2(m)) - 7)
        assert np.abs(a.float().numpy() - b).max() <= tol, name


def _mpp_raw(optimize_decoder=True, dtype="float32"):
    return {"SSL": "mpp", "resolution": {"ico": 6, "sub_ico": 2},
            "transformer": dict(dim=32, depth=2, heads=2, mlp_dim=64, dim_head=16),
            "training": {"bs": 4, "bs_val": 4, "LR": 1e-2},
            "pretraining_mpp": {"optimize_decoder": optimize_decoder},
            "tpu": {"compute_dtype": dtype}}


def test_frozen_decoder_matches_jax_rule():
    """Under optimize_decoder: false the JAX optimizer's update is zero on
    exactly the leaves the port leaves out of its optimizer, and a port step
    leaves them bit for bit."""
    raw = _mpp_raw(optimize_decoder=False)
    jtr = jax_trainer.Trainer(jax_config.from_dict(raw))
    x = np.random.default_rng(6).standard_normal((4, 4, 320, 153)).astype(np.float32)
    state = jtr.init_state(x)
    ones = jax.tree.map(jnp.ones_like, state.params)
    updates, _ = jtr.optimizer.update(ones, state.opt_state, state.params)
    frozen_jax = {jax.tree_util.keystr(k) for k, u in
                  jax.tree_util.tree_flatten_with_path(updates)[0] if not np.any(np.asarray(u))}
    assert frozen_jax == {"['mask_token']", "['to_original']['bias']",
                          "['to_original']['kernel']"}

    exp = config.from_dict(raw)
    model = runner.build_model(exp)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tr = Trainer(exp, model)
    frozen = {k for k, p in model.named_parameters() if not p.requires_grad}
    assert frozen == {"mask_token", "to_original.weight", "to_original.bias"}
    tr.optimizer_step(torch.from_numpy(x), None, torch.ones(4))
    for k, v in model.state_dict().items():
        if not k.startswith("transformer.mlp_head."):  # MPP never runs the encoder's head
            assert torch.equal(v, before[k]) == (k in frozen), k


def test_mpp_checkpoints_both_ways(tmp_path):
    _, params, x = _jax_mpp(7)
    state = convert.mpp_state_dict_from_jax(params, CFG["depth"])
    back = convert.jax_params_from_mpp_state_dict(state, CFG["depth"])
    a = jax.tree_util.tree_flatten_with_path(back)[0]
    b = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, u), (_, v) in zip(a, b):
        assert np.array_equal(u, v), str(k)
    # a port MPP's state dict is the reference layout (with the encoder's
    # unused head): as a .pth it loads strictly, its encoder alone into a
    # SiT, and the JAX package reads the same tree from it
    ref = _port_mpp(params).state_dict()
    torch.save(ref, tmp_path / "mpp.pth")
    loaded = runner.load_state_dict_any(str(tmp_path / "mpp.pth"), CFG["depth"])
    MPP(SiT(**CFG)).load_state_dict(loaded, strict=True)
    SiT(**CFG).load_state_dict(convert.encoder_state(loaded), strict=True)
    jtree = mpp_params_from_torch({k: v.numpy() for k, v in ref.items()}, CFG["depth"])
    for k, v in b:
        node = jtree
        for key in k:
            node = node[key.key]
        assert np.array_equal(np.asarray(node), v), str(k)


def _split(d: Path, n: int, seed: int, split: str):
    d.mkdir(parents=True, exist_ok=True)
    data, labels = make_regression_dataset(n, raw_vertices=40962, seed=seed)
    np.save(d / f"{split}_data.npy", data)
    np.save(d / f"{split}_labels.npy", labels)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """``run_training`` on an MPP config: 8 raw training surfaces at bs 4,
    6 validation surfaces at bs_val 4 (a ragged last batch), 3 epochs."""
    tmp = tmp_path_factory.mktemp("mpp")
    _split(tmp / "data", 8, 0, "train")
    _split(tmp / "data", 6, 1, "validation")
    raw = _mpp_raw()
    raw["training"].update(epochs=3, val_epoch=1, seed=0)
    raw["data"] = {"data_path": str(tmp / "data"), "split": "validation"}
    raw["logging"] = {"folder_to_save_model": str(tmp / "runs")}
    got = runner.run_training(config.from_dict(raw), device="cpu", progress=False)
    return tmp, raw, got


def test_run_training_writes_the_mpp_files(pretrained):
    tmp, raw, got = pretrained
    run_dir = Path(got["run_dir"])
    assert run_dir.name.endswith("-mpp")
    assert {"best_loss", "best_epoch"} <= set(got) and "best_mae" not in got
    for f in ("best_params.npz", "encoder_best_params.npz", "final_params.npz",
              "encoder_final_params.npz", "hparams_results.yml", "metrics_val.csv"):
        assert (run_dir / f).exists(), f
    assert not (run_dir / "preds.csv").exists()
    res = yaml.safe_load((run_dir / "hparams_results.yml").read_text())["results"]
    assert res["best_loss"] == got["best_loss"] and math.isfinite(got["best_loss"])


def test_run_testing_reproduces_the_best_val_loss(pretrained):
    tmp, raw, got = pretrained
    raw = dict(raw, testing={"path_to_ckpt": str(Path(got["run_dir"]) / "best_params.npz")})
    res = runner.run_testing(config.from_dict(raw), device="cpu")
    assert res["n"] == 6 and res["split"] == "validation"
    assert abs(res["loss"] - got["best_loss"]) <= 1e-6 * got["best_loss"]
    assert not (Path(got["run_dir"]) / "results.csv").exists()


def test_jax_package_reads_the_ports_mpp_checkpoint(pretrained):
    """The JAX MPP's parameter tree takes the port's best_params.npz leaf for
    leaf, and ``MPP.apply`` on it equals the port's MPP under one fixed
    corruption (pre-patched input, float32 / HIGHEST)."""
    tmp, raw, got = pretrained
    loaded = orbax_io.load_params_npz(Path(got["run_dir"]) / "best_params.npz")["params"]
    raw_vertices = np.load(tmp / "data" / "validation_data.npy")[:2]
    patched = np.ascontiguousarray(raw_vertices[:, :, load_patch_table(6, 2).indices])
    jtr = jax_trainer.Trainer(jax_config.from_dict(
        dict(raw, tpu={"compute_dtype": "float32", "matmul_precision": "highest"})))
    init = jtr.init_state(patched).params
    a = jax.tree_util.tree_flatten_with_path(init)[0]
    b = jax.tree_util.tree_flatten_with_path(loaded)[0]
    assert [(k, np.shape(u)) for k, u in a] == [(k, np.shape(u)) for k, u in b]
    model = runner.build_model(config.from_dict(raw))
    runner.load_model_state(model, convert.mpp_state_dict_from_jax(loaded, 2))
    mask = np.zeros((2, 320), bool)
    mask[:, ::3] = True
    corrupted = patched.transpose(0, 2, 3, 1).reshape(2, 320, -1).copy()
    corrupted[mask] = loaded["mask_token"].reshape(-1)
    want, _ = jtr.mpp.apply({"params": jax.tree.map(jnp.asarray, loaded)}, jnp.asarray(patched),
                            fixed_mask=jnp.asarray(mask), fixed_corrupted=jnp.asarray(corrupted))
    loss, _ = model(torch.from_numpy(patched), fixed_mask=torch.from_numpy(mask),
                    fixed_corrupted=torch.from_numpy(corrupted))
    assert abs(loss.item() - float(want)) <= 2e-5 * float(want)


def test_finetune_loads_every_encoder_tensor(pretrained):
    tmp, raw, got = pretrained
    enc_npz = Path(got["run_dir"]) / "encoder_best_params.npz"
    ft = config.from_dict({"resolution": raw["resolution"], "transformer": raw["transformer"],
                           "training": {"load_weights_ssl": True},
                           "weights": {"ssl_mpp": str(enc_npz)},
                           "tpu": {"compute_dtype": "float32"}})
    model = SiT.from_config(ft)
    head = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("mlp_head.")}
    runner._load_initial_weights(ft, model)
    want = convert.state_dict_from_jax(orbax_io.load_params_npz(enc_npz)["params"], 2)
    # every encoder tensor; the head, which MPP never trains, keeps its init
    assert set(want) == set(model.state_dict()) - set(head)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k] if k in want else head[k]), k
    full = runner.load_state_dict_any(str(Path(got["run_dir"]) / "best_params.npz"), 2)
    for k, v in convert.encoder_state(full).items():
        assert torch.equal(v, want[k]), k


def test_mpp_run_initialised_from_a_sit_checkpoint(pretrained, tmp_path):
    """An MPP config with ``load_weights_ssl`` on a SiT params npz nests it
    as the MPP's encoder (the JAX runner's rule); the decoder keeps its
    init."""
    tmp, raw, got = pretrained
    sit = SiT(dtype=torch.float32, **{k: v for k, v in raw["transformer"].items()},
              num_patches=320, num_vertices=153)
    sit_npz = tmp_path / "sit.npz"
    convert.save_params_npz(sit_npz, {"params": convert.jax_params_from_state_dict(
        sit.state_dict(), 2)})
    exp = config.from_dict(dict(raw, training=dict(raw["training"], load_weights_ssl=True),
                                weights={"ssl_mpp": str(sit_npz)}))
    model = runner.build_model(exp)
    decoder = model.to_original.weight.clone()
    runner._load_initial_weights(exp, model)
    for k, v in sit.state_dict().items():
        assert torch.equal(model.state_dict()["transformer." + k], v), k
    assert torch.equal(model.to_original.weight, decoder)


_NO_JAX = ("import sys\n"
           "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
           "'orbax.checkpoint', 'surface_vision_transformers_tpu'):\n"
           "    sys.modules[m] = None\n")


def test_cli_pretrain_then_test_without_jax(tmp_path):
    """``cli.pretrain`` on the shipped SiT-tiny MPP config (narrowed, the
    fused bfloat16 route on the CPU's plain versions), then ``cli.test`` on
    its best_params.npz, with JAX unimportable."""
    _split(tmp_path / "data", 4, 2, "train")
    _split(tmp_path / "data", 4, 3, "validation")
    sets = [f"data.data_path={tmp_path / 'data'}", "data.split=validation",
            "training.bs=2", "training.bs_val=2", "training.epochs=2", "training.val_epoch=1",
            "transformer.dim=32", "transformer.depth=1", "transformer.heads=1",
            "transformer.mlp_dim=64", f"logging.folder_to_save_model={tmp_path / 'runs'}"]

    def cli(tool, *extra):
        args = [a for s in (*sets, *extra) for a in ("--set", s)]
        code = _NO_JAX + (
            "import runpy\n"
            f"sys.argv = ['{tool}', {str(REPO / 'configs/pretraining/sit_tiny_mpp.yml')!r},"
            f" '--device', 'cpu', *{args!r}]\n"
            f"runpy.run_module('surface_vision_transformers_tpu_torch.cli.{tool}',\n"
            "                 run_name='__main__')\n")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=300, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)))
        assert out.returncode == 0, out.stderr
        return ast.literal_eval(out.stdout.strip().splitlines()[-1])

    res = cli("pretrain")
    run_dir = Path(res["run_dir"])
    assert (run_dir / "encoder_best_params.npz").exists()
    tested = cli("test", f"testing.path_to_ckpt={run_dir / 'best_params.npz'}")
    assert abs(tested["loss"] - res["best_loss"]) <= 1e-5 * res["best_loss"]
