"""A whole SiT at head widths other than 64, on the CPU, against the JAX
package: 2 blocks, N = 24 on patched input, as 6 heads of 32 (dim 192) and
3 heads of 128 (dim 384), the weights carried across by the JAX package's
``sit_params_to_torch``. Serving (``fused_forward``: every kernel's plain
version) against the JAX ``SiT.apply`` at HIGHEST precision, 2e-5 absolute
and 1e-5 relative (the ``tests/test_golden_sit.py`` rule); one training
step's loss (2e-5 relative) and every parameter's gradient through
``fused_train_forward`` against ``jax.value_and_grad``, 1e-4 of each
parameter's largest gradient (the rule of ``tests/test_torch_subico1.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu.checkpoints.torch_import import sit_params_to_torch
from surface_vision_transformers_tpu.models import SiT as JaxSiT
from surface_vision_transformers_tpu_torch.models import fused as tfused
from surface_vision_transformers_tpu_torch.models.sit import SiT

SITS = {"6 x 32": dict(dim=192, heads=6, dim_head=32, mlp_dim=256),
        "3 x 128": dict(dim=384, heads=3, dim_head=128, mlp_dim=256)}
L, V, C = 23, 15, 4  # patches (N = 24 with the CLS token), vertices, channels


@pytest.fixture(scope="module", params=list(SITS))
def sit(request):
    """(JAX model, its params, the port's model on the same weights, x)."""
    kw = dict(SITS[request.param], depth=2, num_patches=L, num_vertices=V, num_channels=C)
    jmodel = JaxSiT(dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, **kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(kw["dim_head"]),
                                                  jnp.zeros((1, C, L, V)))["params"])
    model = SiT(dtype=torch.float32, **kw)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sit_params_to_torch(params, 2).items()}, strict=True)
    x = np.random.default_rng(kw["dim_head"]).standard_normal((2, C, L, V)).astype(np.float32)
    return jmodel, params, model, x


def test_sit_serving_matches_jax(sit):
    jmodel, params, model, x = sit
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    got = tfused.fused_forward(model.eval(), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_sit_training_step_matches_jax(sit):
    """One step's loss and every parameter's gradient through
    ``fused_train_forward`` (the fused blocks' autograd functions: the CLS
    block attends 8 rows to the 24 keys) against ``jax.value_and_grad``."""
    jmodel, params, model, x = sit
    y = np.array([0.3, -0.2], np.float32)
    jloss, jgrads = jax.value_and_grad(lambda p: jnp.mean(
        (jmodel.apply({"params": p}, jnp.asarray(x)).squeeze(-1) - y) ** 2))(
        jax.tree.map(jnp.asarray, params))
    want = sit_params_to_torch(jax.tree.map(np.asarray, jgrads), 2)
    model.train().zero_grad()
    out = tfused.fused_train_forward(model, torch.from_numpy(x))
    loss = ((out.squeeze(-1) - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 2e-5 * abs(float(jloss)) + 1e-7
    for name, prm in model.named_parameters():
        w = np.asarray(want[name])
        err = np.abs(prm.grad.numpy() - w).max() / max(np.abs(w).max(), 1e-12)
        assert err <= 1e-4, f"{name}: {err:.3g}"
