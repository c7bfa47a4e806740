"""The port's patch-embed kernel's plain version against the JAX Pallas
``pallas_patch_embed`` (interpret mode), on the shipped sub-ico-2 table and
the generated sub-ico-3 table, normalisation folded; ``PatchEmbed``'s
gradients; and the routes that reach it.

Tolerances: float32 1e-5 (the gathers are exact; the fold and the
contraction sum in another order). bfloat16: one bf16 step at each output's
magnitude (both round the same tokens and weights and add a float32 bias
before one rounding; a different summation order can move a value across a
rounding boundary). Gradients, float32: 1e-4 relative to the largest
(sums over every token in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surface_vision_transformers_tpu.ops as jp
from surface_vision_transformers_tpu import geometry as jgeo
from surface_vision_transformers_tpu.ops.pallas.patch_embed import pallas_patch_embed
from surface_vision_transformers_tpu_torch.ops import patch_embed as tpe
from surface_vision_transformers_tpu_torch.ops import patchify as tp
from surface_vision_transformers_tpu_torch.ops.attention import kernel_route

DIM = 32


@pytest.fixture(scope="module")
def tables(table_sub2):
    return {2: table_sub2.indices, 3: jgeo.load_patch_table(6, 3).indices}


def _inputs(V, seed):
    r = np.random.default_rng(seed)
    return dict(
        x=r.standard_normal((2, 4, 40962)).astype(np.float32),
        kernel=(r.standard_normal((V * 4, DIM)) * 0.05).astype(np.float32),
        bias=(r.standard_normal(DIM) * 0.1).astype(np.float32),
        means=r.uniform(-1, 1, (1, 4, 1)).astype(np.float32),
        stds=r.uniform(0.5, 2, (1, 4, 1)).astype(np.float32),
    )


def _step(v):
    """The spacing of bf16 values at magnitude |v| (8 significand bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


def _bf16_steps(got, want):
    """|got - want| in bf16 steps at each element's magnitude."""
    return np.abs(got - want) / _step(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sub_ico", [2, 3])
def test_reference_matches_pallas(tables, sub_ico, dtype):
    idx = tables[sub_ico]
    L, V = idx.shape
    inp = _inputs(V, sub_ico)
    jk, jb = jp.fold_normalization(jnp.asarray(inp["kernel"]), jnp.asarray(inp["bias"]),
                                   inp["means"], inp["stds"], V)
    want = np.asarray(pallas_patch_embed(jnp.asarray(inp["x"]), idx, jk, jb,
                                         compute_dtype=getattr(jnp, dtype))).astype(np.float32)
    w, b = tpe.embed_matrix(torch.from_numpy(inp["kernel"]), torch.from_numpy(inp["bias"]), V,
                            means=inp["means"], stds=inp["stds"],
                            compute_dtype=getattr(torch, dtype))
    assert w.shape == (DIM, -(-V * 4 // tpe.K_STEP) * tpe.K_STEP) and b.dtype == torch.float32
    assert not w[:, V * 4:].any()  # the K padding is zero
    x = torch.from_numpy(inp["x"])
    got = tpe.patch_embed(x, tpe.table_tensor(idx, "cpu"), w, b)  # CPU: the plain version
    assert got.shape == (2, L, DIM) and got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert _bf16_steps(got, want).max() <= 1.0
        # gather_embed rounds the product, then adds a bf16 bias: within two
        # steps at the largest output
        plain = tp.fused_patch_embed(x, idx, torch.from_numpy(inp["kernel"]),
                                     torch.from_numpy(inp["bias"]), means=inp["means"],
                                     stds=inp["stds"], compute_dtype=torch.bfloat16)
        assert np.abs(plain.float().numpy() - got).max() <= 2 * _step(np.abs(got).max())


@pytest.mark.parametrize("normalize", [False, True])
def test_patch_embed_train_gradients(tables, normalize):
    """``patch_embed_train`` (``PatchEmbed``) against autograd of the plain
    embedding in float32: output and the gradients of the Linear's weight
    and bias."""
    idx = tables[3]
    V = idx.shape[1]
    inp = _inputs(V, 5)
    stats = dict(means=inp["means"], stds=inp["stds"]) if normalize else {}
    x = torch.from_numpy(inp["x"])
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, idx.shape[0], DIM)).astype(np.float32))

    def run(fn):
        k = torch.from_numpy(inp["kernel"]).requires_grad_()
        b = torch.from_numpy(inp["bias"]).requires_grad_()
        out = fn(k, b)
        dk, db = torch.autograd.grad(out, (k, b), g)
        return out.detach(), dk, db

    got = run(lambda k, b: tpe.patch_embed_train(x, tpe.table_tensor(idx, "cpu"), k, b,
                                                 compute_dtype=torch.float32, **stats))
    want = run(lambda k, b: tp.fused_patch_embed(x, idx, k, b, compute_dtype=torch.float32,
                                                 **stats))
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
    for a, r in zip(got[1:], want[1:]):
        assert a.shape == r.shape and a.dtype == torch.float32
        torch.testing.assert_close(a, r, atol=1e-4 * r.abs().max().item(), rtol=0)


def test_patch_embed_backward_is_autograd_of_the_reference(tables):
    """``PatchEmbed``'s hand-written backward equals autograd of
    ``patch_embed_reference`` on the same bf16 operands, padding included."""
    idx = tpe.table_tensor(tables[2], "cpu")
    inp = _inputs(idx.shape[1], 7)
    x = torch.from_numpy(inp["x"])
    w0 = torch.from_numpy(inp["kernel"].T.copy())
    g = torch.randn(2, idx.shape[0], DIM, generator=torch.Generator().manual_seed(0))
    g = g.bfloat16()

    w1, b1 = w0.clone().requires_grad_(), torch.from_numpy(inp["bias"]).requires_grad_()
    out = tpe.PatchEmbed.apply(x, idx, w1, b1, torch.bfloat16)
    dw1, db1 = torch.autograd.grad(out, (w1, b1), g)

    w2, b2 = w0.clone().requires_grad_(), torch.from_numpy(inp["bias"]).requires_grad_()
    ref = tpe.patch_embed_reference(x, idx, tpe._padded(w2, torch.bfloat16), b2.float())
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    # autograd rounds the weight gradient to bf16 at the weight's cast; the
    # hand-written backward keeps it in float32: within one bf16 step
    dw2, db2 = torch.autograd.grad(ref.float(), (w2, b2), g.float())
    assert dw1.dtype == db1.dtype == torch.float32
    assert _bf16_steps(dw1.numpy(), dw2.numpy()).max() <= 1.0
    torch.testing.assert_close(db1, db2, atol=1e-4 * db2.abs().max().item(), rtol=0)


def test_routes_and_refusals(tables):
    """The kernel route is CUDA bf16 under "auto" only; the wrapper refuses
    other devices."""
    idx = tpe.table_tensor(tables[2], "cpu")
    assert idx.dtype == torch.int32 and idx.is_contiguous()
    t = torch.zeros(1)
    assert not kernel_route("auto", t, torch.bfloat16)
    assert not kernel_route("plain", t, torch.bfloat16)
    w, b = tpe.embed_matrix(torch.zeros(idx.shape[1] * 4, DIM), torch.zeros(DIM),
                            idx.shape[1])
    with pytest.raises(ValueError, match="cpu or cuda"):
        tpe.patch_embed(torch.zeros((1, 4, 40962), device="meta"), idx, w, b)
    before = tpe.patch_embed.launches
    tpe.patch_embed(torch.zeros((1, 4, 40962)), idx, w, b)
    assert tpe.patch_embed.launches == before  # the plain version launches nothing
