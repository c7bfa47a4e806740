"""Whole models at the last widths the JAX package runs (dim and mlp_dim
off 8, off 16 in int8 stages), on the CPU, against the JAX package; the
blocks alone are ``tests/test_torch_model_widths.py``.

- a SiT at dim 60 (3 x 20, mlp 150) and dim 100 (4 x 25, mlp 300) through
  ``sit_params_to_torch``: serving (``prepare_weights`` lays the stream
  out padded) and one training step (the masters padded each step by a
  differentiable copy) against the JAX package (the rules of
  ``tests/test_torch_head_widths_sit.py``: serving 2e-5 absolute and 1e-5
  relative, the loss 2e-5 relative, each gradient 1e-4 of its largest
  value), its gradients and state dict in the reference shapes;
- an MS-SiT at embed_dim 36 (stage dims 36 / 72) and mlp_ratio 3.5 (hidden
  widths 126 / 252), at ``tests/test_torch_mssit.py``'s size, through
  ``checkpoints/convert.py``'s MS-SiT mapping, bf16 and int8 served against
  the JAX ``fused_mssit_forward`` (that file's bounds: 5e-3 and 0.08 of the
  largest output);
- a fused serving artifact of a SiT at dim 60, bf16 and int8, traced on the
  CPU: its weights laid out padded and its outputs ``fused_forward``'s bit
  for bit (``tests/test_torch_export.py``'s rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu import geometry as G
from surface_vision_transformers_tpu.checkpoints.torch_import import sit_params_to_torch
from surface_vision_transformers_tpu.models import MSSiT as JaxMSSiT
from surface_vision_transformers_tpu.models import SiT as JaxSiT
from surface_vision_transformers_tpu.models import fused_mssit as jfm
from surface_vision_transformers_tpu_torch.checkpoints.convert import mssit_state_dict_from_jax
from surface_vision_transformers_tpu_torch.models import fused as tfused
from surface_vision_transformers_tpu_torch.models import fused_mssit as tfm
from surface_vision_transformers_tpu_torch.models import mssit as tms
from surface_vision_transformers_tpu_torch.models.sit import SiT
from surface_vision_transformers_tpu_torch.serving import svt_ops

SITS = {"60": dict(dim=60, heads=3, dim_head=20, mlp_dim=150),
        "100": dict(dim=100, heads=4, dim_head=25, mlp_dim=300)}
L, V, C = 23, 15, 4  # patches (N = 24 with the CLS token), vertices, channels


@pytest.fixture(scope="module", params=list(SITS))
def sit(request):
    """(JAX model, its params, the port's model on the same weights, x)."""
    kw = dict(SITS[request.param], depth=2, num_patches=L, num_vertices=V, num_channels=C)
    jmodel = JaxSiT(dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, **kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(kw["dim"]),
                                                  jnp.zeros((1, C, L, V)))["params"])
    model = SiT(dtype=torch.float32, **kw)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sit_params_to_torch(params, 2).items()}, strict=True)
    x = np.random.default_rng(kw["dim"]).standard_normal((2, C, L, V)).astype(np.float32)
    return jmodel, params, model, x


def test_sit_serving_matches_jax(sit):
    """``fused_forward`` (the plain versions on the padded stream
    ``prepare_weights`` lays out: every block, the CLS token and positions
    at the padded width, the LayerNorms counting ``model.dim``) against the
    JAX ``SiT.apply`` (``tests/test_golden_sit.py``'s rule)."""
    jmodel, params, model, x = sit
    w = tfused.prepare_weights(model.eval())
    assert w.width == svt_ops.padded_width(model.dim) > model.dim
    assert w.cls_token.shape[-1] == w.pos_embedding.shape[-1] == w.width
    assert all(blk[0].shape == (w.width,) and blk[7].shape[0] % 8 == 0 for blk in w.blocks)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    got = tfused.fused_forward(model, torch.from_numpy(x), w).numpy()
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_sit_training_step_matches_jax(sit):
    """One step's loss and every parameter's gradient through
    ``fused_train_forward`` (the masters padded each step by a
    differentiable copy) against ``jax.value_and_grad`` (the rules of
    ``tests/test_torch_head_widths_sit.py``); the gradients and the state
    dict in the reference shapes."""
    jmodel, params, model, x = sit
    y = np.array([0.3, -0.2], np.float32)
    jloss, jgrads = jax.value_and_grad(lambda p: jnp.mean(
        (jmodel.apply({"params": p}, jnp.asarray(x)).squeeze(-1) - y) ** 2))(
        jax.tree.map(jnp.asarray, params))
    want = sit_params_to_torch(jax.tree.map(np.asarray, jgrads), 2)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.train().zero_grad()
    out = tfused.fused_train_forward(model, torch.from_numpy(x))
    loss = ((out.squeeze(-1) - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 2e-5 * abs(float(jloss)) + 1e-7
    for name, prm in model.named_parameters():
        w = np.asarray(want[name])
        assert prm.grad.shape == w.shape == shapes[name], name
        err = np.abs(prm.grad.numpy() - w).max() / max(np.abs(w).max(), 1e-12)
        assert err <= 1e-4, f"{name}: {err:.3g}"
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes


ICO, LEVEL = 2, 1  # 162 vertices, 80 patches x 6 (tests/test_torch_mssit.py's size)
MSSIT = dict(ico=ICO, patch_level=LEVEL, num_vertices=6, embed_dim=36, depths=(2, 2),
             heads=(2, 4), window=4, global_max=2, mlp_ratio=3.5)


@pytest.fixture(scope="module")
def mssit():
    """(table, JAX float32 params, raw input (4, 4, 162)) at embed_dim 36 and
    mlp_ratio 3.5."""
    table = G.load_patch_table(ICO, LEVEL).indices
    x = np.random.default_rng(36).standard_normal((4, 4, 162)).astype(np.float32)
    model = JaxMSSiT(**MSSIT, dtype=jnp.float32, patch_table=table)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(36), jnp.asarray(x)))
    return table, params, x


@pytest.mark.parametrize("quant_mode", [None, "int8"])
def test_mssit_serving_matches_jax(mssit, monkeypatch, quant_mode):
    """An MS-SiT whose stage 0 (dim 36) and hidden widths (126, 252) are
    off 8, through ``mssit_state_dict_from_jax``, served by
    ``fused_mssit_forward`` in bf16 (5e-3 of the largest output) and, with
    ``INT8_MIN_DIM`` 0, int8 in every stage (0.08; rows padded to 16:
    stage widths 48 / 80) against the JAX one (interpret mode)."""
    table, params, x = mssit
    model = tms.MSSiT(**MSSIT, dtype=torch.bfloat16, patch_table=table)
    model.load_state_dict(mssit_state_dict_from_jax(params), strict=True)
    kw = {} if quant_mode is None else dict(quant="int8")
    if quant_mode:
        monkeypatch.setattr(tfused, "INT8_MIN_DIM", 0)
        monkeypatch.setattr(jfm, "INT8_MIN_DIM", 0)
    w = tfm.prepare_mssit_weights(model.eval(), quant_mode)
    align = 16 if quant_mode else 8
    assert [s.width for s in w.stages] == [svt_ops.padded_width(d, align) for d in (36, 72)]
    jm = JaxMSSiT(**MSSIT, dtype=jnp.bfloat16, patch_table=table)
    want = np.asarray(jax.jit(lambda p, xx: jfm.fused_mssit_forward(jm, p, xx, **kw))(
        params, jnp.asarray(x)), np.float32)
    got = tfm.fused_mssit_forward(model, torch.from_numpy(x), w, **kw).numpy()
    assert got.shape == want.shape == (4, 1) and np.isfinite(got).all()
    bound = 0.08 if quant_mode else 5e-3
    assert np.abs(got - want).max() <= bound * np.abs(want).max()


@pytest.mark.parametrize("quant_mode", [None, "int8"])
def test_fused_artifact_at_a_padded_width(tmp_path, monkeypatch, quant_mode):
    """A fused serving artifact (``serving.artifact``, traced on the CPU) of
    a SiT at dim 60 (mlp 150; int8 with ``INT8_MIN_DIM`` 0: the stream on 64
    columns either way): its weights laid out padded, its graph the
    ``svt::`` operators with the LayerNorm count, its outputs
    ``fused_forward``'s bit for bit at each listed batch size."""
    from surface_vision_transformers_tpu_torch.serving import artifact

    if quant_mode:
        monkeypatch.setattr(tfused, "INT8_MIN_DIM", 0)
    table = np.arange(40, dtype=np.int32).reshape(8, 5)  # 8 patches, V=5
    torch.manual_seed(60)
    model = SiT(dim=60, depth=2, heads=3, dim_head=20, mlp_dim=150, num_patches=8,
                num_vertices=5, num_channels=3, patch_table=table, dtype=torch.bfloat16).eval()
    meta = artifact.export_serving(model, tmp_path, batch_sizes=(1, 3), fused=True,
                                   quant=quant_mode)
    block = "fused_block_int8" if quant_mode else "fused_block"
    assert meta["ops"] == {f"svt::{k}": {"patch_embed": 1, block: 1, "fused_block_cls": 1}.get(
        k, 0) for k in svt_ops.SCHEMAS}
    module, _ = artifact.make_serving_fn(model, quant=quant_mode, fused=True)
    w = module.weights()
    assert w.width == 64 and w.cls_token.shape[-1] == 64
    for B in (1, 3):
        x = torch.from_numpy(np.random.default_rng(B).standard_normal((B, 3, 40)).astype(
            np.float32)).to(torch.bfloat16)
        fn, _ = artifact.load_serving(tmp_path, B)
        want = tfused.fused_forward(model, x, w, quant=quant_mode)
        assert want.shape == (B, 1) and torch.isfinite(want).all()
        assert torch.equal(fn(x), want)
