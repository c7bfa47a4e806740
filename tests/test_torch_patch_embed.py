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
    # the kernel's refusals (``_check_cuda_args``, on CPU tensors here): the
    # shipped shape passes; 3 channels, and a table whose 64 rows leave the
    # A ring no room in shared memory (80 patches of 561 vertices), do not
    x = torch.zeros((1, 4, 40962))
    tpe._check_cuda_args(x, idx, w, b)
    w3, b3 = tpe.embed_matrix(torch.zeros(idx.shape[1] * 3, DIM), torch.zeros(DIM),
                              idx.shape[1])
    with pytest.raises(NotImplementedError, match="4 channels"):
        tpe._check_cuda_args(torch.zeros((1, 3, 40962)), idx, w3, b3)
    big = torch.zeros((80, 561), dtype=torch.int32)
    wb, bb = tpe.embed_matrix(torch.zeros(561 * 4, DIM), torch.zeros(DIM), 561)
    with pytest.raises(NotImplementedError, match="shared memory"):
        tpe._check_cuda_args(x, big, wb, bb)


# The kernel's tiling (``embed_plan``, mirroring csrc/patch_embed.cu's) at
# the shapes the port runs, and past two N-tiles at sub-ico 2, where an
# item's ten K-slices do not fit the ring and each pass is gathered again:
# (L, V, Kp, dim) -> (nb, mw, nw, ks, passes, reps, sa, sw)
PLANS = {
    "sub-ico 2, dim 192 (SiT-tiny)": ((320, 153, 640, 192), (192, 1, 1, 10, 1, 1, 8, 3)),
    "sub-ico 2, dim 384 (SiT-small)": ((320, 153, 640, 384), (192, 1, 2, 10, 1, 1, 7, 2)),
    "sub-ico 3, dim 768 (SiT-base)": ((1280, 45, 192, 768), (192, 1, 2, 3, 2, 1, 8, 2)),
    "sub-ico 5, dim 96 (MS-SiT)": ((20480, 6, 64, 96), (96, 2, 1, 1, 1, 1, 8, 1)),
    "sub-ico 2, dim 768": ((320, 153, 640, 768), (192, 1, 2, 10, 1, 2, 7, 2)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_embed_plan(name):
    """The tiling the kernel takes: one consumer warpgroup up to a
    192-column N-tile, two on their own N-tiles past it, two on an item's
    64-row halves at dim <= 96; an A ring of up to 8 K-slices in the shared
    memory the rest leaves (at most an H100 block's 232,448 bytes)."""
    (L, V, kp, dim), want = PLANS[name]
    p = tpe.embed_plan(L, V, kp, dim)
    assert tuple(p[k] for k in ("nb", "mw", "nw", "ks", "passes", "reps", "sa", "sw")) == want
    assert 0 < p["bytes"] <= 232448
    if p["passes"] > 1:  # an item's slices stay in the ring for every pass
        assert p["ks"] <= p["sa"]


def _walk_tokens(x, table, kp, dim, ctas=132):
    """The kernel's gather walk, in numpy: CTA c takes items [c T / ctas,
    (c + 1) T / ctas) of the T (group, sample, rep) items, groups outer; an
    item's K-slice s holds vertices 16 s .. 16 s + 15 of its 64 mw patches in
    (v c) order, zeros past V and past L. -> ((B, L, kp) tokens, times each
    (sample, patch) row was gathered)."""
    B, C, _ = x.shape
    L, V = table.shape
    p = tpe.embed_plan(L, V, kp, dim)
    rows, reps = 64 * p["mw"], p["reps"]
    items = -(-L // rows) * B * reps
    out, seen = np.zeros((B, L, kp), x.dtype), np.zeros((B, L), int)
    for c in range(ctas):
        for it in range(items * c // ctas, items * (c + 1) // ctas):
            g, b = it // (B * reps), it // reps % B
            ls = np.arange(g * rows, min(g * rows + rows, L))
            for s in range(p["ks"]):
                vs = np.arange(16 * s, min(16 * s + 16, V))
                if len(vs):
                    vals = x[b][:, table[ls][:, vs]]  # (C, rows, vertices)
                    cols = C * vs[:, None] + np.arange(C)  # (vertices, C)
                    out[b, ls[:, None, None], cols[None]] = vals.transpose(1, 2, 0)
            seen[b, ls] += 1
    return out, seen, reps


@pytest.mark.parametrize("sub_ico,dim", [(2, 192), (2, 768), (3, 768), (5, 96)])
def test_kernel_walk_gathers_the_tokens(tables, sub_ico, dim):
    """The kernel's walk of items and K-slices (``embed_plan``) gathers every
    (sample, patch) row reps times, and its tiles hold ``_tokens`` in (v c)
    order, zero-padded to Kp, on the shipped sub-ico 2, 3 and 5 tables."""
    table = tables[sub_ico] if sub_ico in tables else jgeo.load_patch_table(6, sub_ico).indices
    table = np.asarray(table)
    L, V = table.shape
    kp = -(-4 * V // tpe.K_STEP) * tpe.K_STEP
    x = np.random.default_rng(sub_ico).standard_normal((2, 4, 40962)).astype(np.float32)
    got, seen, reps = _walk_tokens(x, table, kp, dim)
    want = tpe._tokens(torch.from_numpy(x), tpe.table_tensor(table, "cpu")).numpy()
    np.testing.assert_array_equal(got[..., :4 * V], want)
    assert not got[..., 4 * V:].any()
    assert (seen == reps).all()
