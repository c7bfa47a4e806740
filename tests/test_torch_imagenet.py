"""ImageNet initialisation in the port against the JAX package: the timm
transfer (``checkpoints.convert.imagenet_state_from_timm``) against JAX's
``imagenet_params_from_timm``, and ``run_training``'s rule, JAX's: the timm
file of ``weights.imagenet`` is laid over the model only where
``training.load_weights_imagenet`` is on and the path is set; with the flag
alone both packages train from their seeded init. The timm state dicts are
synthetic (``tests/test_imagenet_transfer.py``'s layout): the real weights
are a download. Also the refusal check at the tail keys' defaults and on
the shipped configs (``tpu.profile_epoch`` and ``tpu.debug_nans`` run away
from them too: ``tests/test_torch_tail.py``).

Tolerances: the transfer is a copy, compared exactly; two ``run_training``
runs at LR 0 keep their initial parameters, compared exactly."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from surface_vision_transformers_tpu.checkpoints import orbax_io
from surface_vision_transformers_tpu.checkpoints.torch_import import (
    imagenet_params_from_timm,
)
from surface_vision_transformers_tpu.models import SiT as JaxSiT
from surface_vision_transformers_tpu.train import runner as jax_runner
from surface_vision_transformers_tpu.utils import config as jax_config
from surface_vision_transformers_tpu_torch.checkpoints.convert import (
    imagenet_state_from_timm,
    load_params_npz,
    state_dict_from_jax,
)
from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
from surface_vision_transformers_tpu_torch.train import runner
from surface_vision_transformers_tpu_torch.utils import config

REPO = Path(__file__).resolve().parent.parent
DIM, DEPTH, HEADS, MLP = 32, 2, 2, 64
TRANSFORMER = dict(dim=DIM, depth=DEPTH, heads=HEADS, mlp_dim=MLP, dim_head=16)


def fake_timm_state(seed=0):
    """A timm-ViT-layout state dict with the keys the transfer reads (and one
    it does not)."""
    g = torch.Generator().manual_seed(seed)
    s = {}

    def t(*shape):
        return torch.randn(*shape, generator=g)

    for i in range(DEPTH):
        s[f"blocks.{i}.norm1.weight"] = t(DIM)
        s[f"blocks.{i}.norm1.bias"] = t(DIM)
        s[f"blocks.{i}.attn.qkv.weight"] = t(3 * DIM, DIM)
        s[f"blocks.{i}.attn.proj.weight"] = t(DIM, DIM)
        s[f"blocks.{i}.attn.proj.bias"] = t(DIM)
        s[f"blocks.{i}.norm2.weight"] = t(DIM)
        s[f"blocks.{i}.norm2.bias"] = t(DIM)
        s[f"blocks.{i}.mlp.fc1.weight"] = t(MLP, DIM)
        s[f"blocks.{i}.mlp.fc1.bias"] = t(MLP)
        s[f"blocks.{i}.mlp.fc2.weight"] = t(DIM, MLP)
        s[f"blocks.{i}.mlp.fc2.bias"] = t(DIM)
    s["norm.weight"] = t(DIM)
    s["norm.bias"] = t(DIM)
    s["patch_embed.proj.weight"] = t(DIM, 3, 16, 16)  # not transferred
    return s


@pytest.fixture(scope="module")
def jax_init():
    m = JaxSiT(dtype=jnp.float32, num_patches=320, num_vertices=153, **TRANSFORMER)
    return jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 320, 153))))


def test_transfer_matches_jax(jax_init):
    params = jax_init["params"]
    timm = fake_timm_state()
    want = state_dict_from_jax(imagenet_params_from_timm(params, timm, DEPTH), DEPTH)
    base = state_dict_from_jax(params, DEPTH)
    got = imagenet_state_from_timm(base, timm, DEPTH)
    assert set(got) == set(want) == set(base)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)
    moved = {k for k in base if not torch.equal(got[k], base[k])}
    assert moved == {k for k in base if k.startswith("transformer.")} | {
        "mlp_head.0.weight", "mlp_head.0.bias"}  # the embeddings, CLS and head Linear stay


def _cfg(root, init_npz, imagenet=None, flag=True, lr=2e-3):
    c = {"resolution": {"ico": 6, "sub_ico": 2}, "transformer": dict(TRANSFORMER),
         "training": {"bs": 8, "bs_val": 4, "epochs": 1, "val_epoch": 1, "LR": lr,
                      "seed": 0, "load_weights_imagenet": flag},
         "weights": {"imagenet": "" if imagenet is None else str(imagenet)},
         "optimisation": {"optimiser": "SGD"}, "SGD": {"momentum": 0.9},
         "logging": {"folder_to_save_model": str(root)},
         "data": {"streaming": "off", "split": "validation"},
         "tpu": {"compute_dtype": "float32"}}
    if init_npz is not None:
        c["training"]["load_weights_ssl"] = True
        c["weights"]["ssl_mpp"] = str(init_npz)
    return c


def _data():
    d, lab = make_regression_dataset(14, seed=3)
    return {"train": (d[:8], lab[:8]), "validation": (d[8:], lab[8:])}


def _final(res):
    return load_params_npz(Path(res["run_dir"]) / "final_params.npz")["params"]


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_flag_without_a_path_trains_from_the_seeded_init(tmp_path):
    """The flag with an empty ``weights.imagenet``: the port's run equals its
    run without the flag bit for bit (the seeded init, no file read), and the
    JAX runner, given the same config, trains to the end as well."""
    ds = _data()
    with_flag = runner.run_training(config.from_dict(_cfg(tmp_path / "a", None)),
                                    datasets=ds, device="cpu", progress=False)
    without = runner.run_training(config.from_dict(_cfg(tmp_path / "b", None, flag=False)),
                                  datasets=ds, device="cpu", progress=False)
    assert "-imgnet" in Path(with_flag["run_dir"]).name
    a, b = _leaves(_final(with_flag)), _leaves(_final(without))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want = jax_runner.run_training(jax_config.from_dict(_cfg(tmp_path / "jax", None)),
                                   datasets=ds, progress=False)
    assert want["training_finished"] and with_flag["training_finished"]
    assert "-imgnet" in Path(want["run_dir"]).name


def test_a_path_lays_the_timm_weights_over_the_model(tmp_path, jax_init):
    """Flag and path: both runners lay the timm file over the same initial
    parameters (a params npz under ``load_weights_ssl``, as JAX applies SSL
    first); at LR 0 the final parameters are the initial ones, and the two
    packages' ``final_params.npz`` are equal, the transferred leaves timm's."""
    orbax_io.save_params_npz(tmp_path / "init.npz", jax_init)
    timm = fake_timm_state(seed=1)
    torch.save(timm, tmp_path / "vit.pth")
    ds = _data()
    cfg = _cfg(tmp_path / "torch", tmp_path / "init.npz", tmp_path / "vit.pth", lr=0.0)
    got = runner.run_training(config.from_dict(cfg), datasets=ds, device="cpu", progress=False)
    cfg = _cfg(tmp_path / "jax", tmp_path / "init.npz", tmp_path / "vit.pth", lr=0.0)
    want = jax_runner.run_training(jax_config.from_dict(cfg), datasets=ds, progress=False)
    a, b = _leaves(_final(got)), _leaves(_final(want))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(a["encoder/layers_1_mlp/fc2/kernel"],
                                  timm["blocks.1.mlp.fc2.weight"].numpy().T)
    np.testing.assert_array_equal(a["head_norm/scale"], timm["norm.weight"].numpy())
    np.testing.assert_array_equal(a["pos_embedding"], jax_init["params"]["pos_embedding"])


def test_tail_keys_at_their_defaults_run(tmp_path):
    raw = _cfg(tmp_path, None)
    raw["tpu"].update(profile_epoch=-1, debug_nans=False)
    runner._refuse_unported(config.from_dict(raw))


@pytest.mark.parametrize("path", sorted((REPO / "configs").glob("*/*.yml")),
                         ids=lambda p: p.stem)
def test_shipped_configs_are_not_refused(path):
    exp = config.from_dict(yaml.safe_load(path.read_text()))
    runner._refuse_unported(exp)


@pytest.mark.parametrize("cfg", ["configs/training/mssit_scan_age.yml",
                                 "configs/pretraining/sit_tiny_mpp.yml"])
def test_imagenet_path_on_a_model_without_a_mapping_raises(tmp_path, cfg):
    """JAX's transfer reads a SiT's ``encoder`` blocks: an MS-SiT or an MPP
    tree has none, so the port refuses a given timm file there with a message
    (with the flag alone it trains from the seeded init)."""
    raw = yaml.safe_load((REPO / cfg).read_text())
    raw.setdefault("training", {})["load_weights_imagenet"] = True
    raw.setdefault("weights", {})["imagenet"] = str(tmp_path / "vit.pth")
    with pytest.raises(NotImplementedError, match="ImageNet"):
        runner._refuse_unported(config.from_dict(raw))
    raw["weights"]["imagenet"] = ""
    runner._refuse_unported(config.from_dict(raw))
