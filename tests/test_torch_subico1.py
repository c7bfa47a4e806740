"""A narrow SiT on the ETL's other grids, CPU, against the JAX package: the
sub-ico-1 table (80 patches of 561 vertices, N = 81 with the CLS token) at 4
channels and at 3, and the sub-ico-2 table at 3 channels.

The port's ``fused_forward`` and ``fused_train_forward`` (float32: every
kernel's plain version) on raw (B, C, G) and on patched (B, C, L, V) input,
against the JAX ``SiT.apply`` at HIGHEST precision on the same weights
(``state_dict_from_jax``): within 2e-5 absolute and 1e-5 relative, as
``tests/test_golden_sit.py`` holds the JAX SiT to its torch reference. The
loss gradient of ``fused_train_forward`` against ``jax.grad`` of
``SiT.apply``'s: 1e-4 of each parameter's largest gradient, as
``tests/test_torch_sit_base.py`` holds the narrow sub-ico-3 SiT.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu import geometry as jgeo
from surface_vision_transformers_tpu.models import SiT as JaxSiT
from surface_vision_transformers_tpu_torch.checkpoints.convert import state_dict_from_jax
from surface_vision_transformers_tpu_torch.geometry import load_patch_table
from surface_vision_transformers_tpu_torch.models import fused as tfused
from surface_vision_transformers_tpu_torch.models.sit import SiT

WIDTH = dict(dim=64, depth=2, heads=1, mlp_dim=128, dim_head=64)
GRIDS = {"sub-ico 1": (1, 4), "sub-ico 1, C 3": (1, 3), "sub-ico 2, C 3": (2, 3)}


@pytest.fixture(scope="module", params=list(GRIDS))
def grid(request):
    """(table, JAX model, its params, the port's model on the same weights,
    raw x, patched x) of one grid, made from a numpy seed."""
    sub_ico, C = GRIDS[request.param]
    table = load_patch_table(6, sub_ico).indices
    assert np.array_equal(table, jgeo.load_patch_table(6, sub_ico).indices)
    L, V = table.shape
    kw = dict(WIDTH, num_patches=L, num_vertices=V, num_channels=C)
    jmodel = JaxSiT(dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, patch_table=table,
                    **kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(sub_ico),
                                                  jnp.zeros((1, C, L, V)))["params"])
    model = SiT(dtype=torch.float32, patch_table=table, **kw)
    model.load_state_dict(state_dict_from_jax(params, WIDTH["depth"]), strict=True)
    x = np.random.default_rng(10 * sub_ico + C).standard_normal((2, C, 40962)).astype(np.float32)
    return table, jmodel, params, model, x, np.ascontiguousarray(x[:, :, table])


@pytest.mark.parametrize("entry", ["fused_forward", "fused_train_forward"])
@pytest.mark.parametrize("kind", ["raw", "patched"])
def test_forward_matches_jax(grid, kind, entry):
    _, jmodel, params, model, x_raw, x_pat = grid
    x = x_raw if kind == "raw" else x_pat
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    if entry == "fused_forward":
        got = tfused.fused_forward(model.eval(), torch.from_numpy(x)).numpy()
    else:
        got = tfused.fused_train_forward(model.train(), torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_train_gradient_matches_jax(grid):
    """Every parameter's loss gradient through ``fused_train_forward`` on raw
    input: the embedding's (through ``patch_embed_train``), both blocks'
    (the CLS block attends 8 rows to N keys), the head's."""
    _, jmodel, params, model, x, _ = grid
    y = np.array([0.3, -0.2], np.float32)
    jgrads = jax.grad(lambda p: jnp.mean(
        (jmodel.apply({"params": p}, jnp.asarray(x)).squeeze(-1) - y) ** 2))(
        jax.tree.map(jnp.asarray, params))
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), WIDTH["depth"])
    model.train().zero_grad()
    out = tfused.fused_train_forward(model, torch.from_numpy(x))
    ((out.squeeze(-1) - torch.from_numpy(y)) ** 2).mean().backward()
    for name, prm in model.named_parameters():
        w = want[name].numpy()
        err = np.abs(prm.grad.numpy() - w).max() / max(np.abs(w).max(), 1e-12)
        assert err <= 1e-4, f"{name}: {err:.3g}"
