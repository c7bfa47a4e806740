"""The port's patch embedding against the JAX package's, on the shipped
sub-ico-2 table (320 patches x 153 vertices), float32. The gathers and
reshapes are exact; the folds and contractions sum in another order, so
<= 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surface_vision_transformers_tpu.ops as jp
from surface_vision_transformers_tpu_torch.ops import patchify as tp

DIM = 32


@pytest.fixture(scope="module")
def inputs(table_sub2):
    r = np.random.default_rng(0)
    L, V = table_sub2.indices.shape
    return dict(
        idx=table_sub2.indices,
        x=r.standard_normal((2, 4, 40962)).astype(np.float32),
        kernel=(r.standard_normal((V * 4, DIM)) * 0.05).astype(np.float32),
        bias=(r.standard_normal(DIM) * 0.1).astype(np.float32),
        means=r.uniform(-1, 1, (1, 4, 1)).astype(np.float32),
        stds=r.uniform(0.5, 2, (1, 4, 1)).astype(np.float32),
    )


def test_patchify(inputs):
    want = np.asarray(jp.patchify(jnp.asarray(inputs["x"]), inputs["idx"]))
    got = tp.patchify(torch.from_numpy(inputs["x"]), inputs["idx"]).numpy()
    np.testing.assert_array_equal(got, want)


def test_rearrange_patched():
    x = np.random.default_rng(1).standard_normal((2, 4, 20, 15)).astype(np.float32)
    np.testing.assert_array_equal(
        tp.rearrange_patched(torch.from_numpy(x)).numpy(),
        np.asarray(jp.rearrange_patched(jnp.asarray(x))))


def test_fold_normalization(inputs):
    V = inputs["idx"].shape[1]
    jk, jb = jp.fold_normalization(jnp.asarray(inputs["kernel"]),
                                   jnp.asarray(inputs["bias"]),
                                   inputs["means"], inputs["stds"], V)
    tk, tb = tp.fold_normalization(torch.from_numpy(inputs["kernel"]),
                                   torch.from_numpy(inputs["bias"]),
                                   inputs["means"], inputs["stds"], V)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5, rtol=0)


def test_normalize_tokens(inputs):
    tok = np.random.default_rng(2).standard_normal((2, 5, 8)).astype(np.float32)
    want = np.asarray(jp.normalize_tokens(jnp.asarray(tok), inputs["means"],
                                          inputs["stds"]))
    got = tp.normalize_tokens(torch.from_numpy(tok), inputs["means"],
                              inputs["stds"]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("normalize", [False, True])
def test_fused_patch_embed(inputs, normalize):
    stats = dict(means=inputs["means"], stds=inputs["stds"]) if normalize else {}
    want = np.asarray(jp.fused_patch_embed(
        jnp.asarray(inputs["x"]), inputs["idx"], jnp.asarray(inputs["kernel"]),
        jnp.asarray(inputs["bias"]), compute_dtype=jnp.float32, **stats))
    got = tp.fused_patch_embed(
        torch.from_numpy(inputs["x"]), inputs["idx"],
        torch.from_numpy(inputs["kernel"]), torch.from_numpy(inputs["bias"]),
        compute_dtype=torch.float32, **stats).numpy()
    assert got.shape == (2, 320, DIM)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_fused_patch_embed_equals_patchify_then_linear(inputs):
    """The (c, v) contraction is the (v c)-token GEMM reordered."""
    x = torch.from_numpy(inputs["x"])
    k, b = torch.from_numpy(inputs["kernel"]), torch.from_numpy(inputs["bias"])
    direct = tp.patchify(x, inputs["idx"]) @ k + b
    fused = tp.fused_patch_embed(x, inputs["idx"], k, b,
                                 compute_dtype=torch.float32)
    torch.testing.assert_close(fused, direct, atol=1e-5, rtol=0)
