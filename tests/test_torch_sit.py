"""The port's eager SiT and weight conversion against the JAX package:
``state_dict_from_jax`` equals ``sit_params_to_torch`` bit for bit, the
reference state-dict layout loads strictly, and the forward matches
``SiT.apply`` at float32 / Precision.HIGHEST within 2e-5 (as
tests/test_golden_sit.py holds the JAX model to the reference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu.checkpoints.torch_import import (
    sit_params_to_torch,
)
from surface_vision_transformers_tpu.models import SiT as JaxSiT
from surface_vision_transformers_tpu_torch.checkpoints.convert import (
    state_dict_from_jax,
)
from surface_vision_transformers_tpu_torch.models.sit import SiT
from tests.torch_ref import TorchSiT

CFG = dict(dim=32, depth=2, heads=2, mlp_dim=64, dim_head=16,
           num_patches=320, num_vertices=153)
MEANS = np.array([0.5, -1.0, 2.0, 0.1], np.float32).reshape(1, 4, 1)
STDS = np.array([1.5, 0.5, 2.0, 1.0], np.float32).reshape(1, 4, 1)


def _jax_model(pool, table=None, stats=False):
    kw = dict(norm_means=MEANS, norm_stds=STDS) if stats else {}
    return JaxSiT(dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST,
                  pool=pool, patch_table=table, **kw, **CFG)


@pytest.fixture(scope="module")
def jax_params():
    p = _jax_model("cls").init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 320, 153)))
    return jax.tree.map(np.asarray, p)


def _port(pool, params, table=None, stats=False):
    kw = dict(norm_means=MEANS, norm_stds=STDS) if stats else {}
    m = SiT(pool=pool, patch_table=table, dtype=torch.float32, **kw, **CFG)
    m.load_state_dict(state_dict_from_jax(params, CFG["depth"]), strict=True)
    return m.eval()


def test_state_dict_from_jax_is_bit_exact(jax_params):
    want = sit_params_to_torch(jax_params, depth=CFG["depth"])
    got = state_dict_from_jax(jax_params, CFG["depth"])
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_reference_state_dict_loads_strict():
    torch.manual_seed(0)
    ref = TorchSiT(**CFG)
    m = SiT(dtype=torch.float32, **CFG)
    m.load_state_dict(ref.state_dict(), strict=True)
    assert set(m.state_dict()) == set(ref.state_dict())
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal((2, 4, 320, 153)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(m(x), ref(x), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_patched_input_matches_jax(jax_params, pool):
    x = np.random.default_rng(2).standard_normal((2, 4, 320, 153)).astype(np.float32)
    want = np.asarray(_jax_model(pool).apply(jax_params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(pool, jax_params)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_raw_input_matches_jax(jax_params, table_sub2, pool):
    """Raw (B, C, G) vertices: gather + folded normalisation + embed."""
    x = np.random.default_rng(3).standard_normal((2, 4, 40962)).astype(np.float32)
    jm = _jax_model(pool, table_sub2.indices, stats=True)
    want = np.asarray(jm.apply(jax_params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(pool, jax_params, table_sub2.indices, stats=True)(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_encoded_sequence_matches_jax(jax_params):
    """Pre-pooling parity: the JAX model pads to 384 rows, the port does
    not pad; the valid rows agree."""
    x = np.random.default_rng(4).standard_normal((2, 4, 320, 153)).astype(np.float32)
    want = np.asarray(_jax_model("cls").apply(jax_params, jnp.asarray(x),
                                              method=JaxSiT.encode))[:, :321]
    with torch.no_grad():
        got = _port("cls", jax_params).encode(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 321, CFG["dim"])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_raw_input_without_table_raises(jax_params):
    with pytest.raises(ValueError, match="patch_table"):
        _port("cls", jax_params)(torch.zeros(1, 4, 40962))
