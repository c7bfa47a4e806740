"""The CLS block's forward as the port's chain runs it on the card, on the CPU.

On ``cls_ln1_in_kv`` (dims 96 / 192) the chain is [LN1 + K/V], one
few-query attention launch that makes its own Q (LN1 of each sample's top
rows, their product with W_q, then attention with its row log-sum-exp),
the out-projection and the MLP half. Here:

- the attention launch's plain version (``cls_attention_reference``, made
  of the existing plain pieces) against the JAX package's
  ``flash_attention`` (Pallas interpret mode; it takes Nq != Nk) on the same
  Q, K and V, at the few-query kernel's shapes: 8 queries against 321 keys,
  against 328 with valid_len 321, against 130 with valid_len 129, and 1
  query; float32 to 2e-5 and bfloat16 to two bf16 steps of the largest
  |JAX| output, as ``tests/test_torch_flash_attention.py`` states them;
- the chain's plain pieces composed, against ``fused_block_cls_reference``
  (the same arithmetic, row by row, up to the order in which the CPU's BLAS
  sums a product of fewer rows) and the JAX package's
  ``fused_block_cls`` (``tests/test_torch_fused_block.py``'s tolerances);
- the route rules (``few_query_fwd``, ``cls_fwd_route``, ``cls_ln1_in_kv``,
  ``cls_fwd_launches``) at the CLS shapes of SiT-tiny, SiT-small and
  SiT-base and at their limits, exact integers. ``chip_smoke.py`` holds
  the C entry ``svt_cls_fwd_route`` and the device kernels a call against
  them on the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu.ops.pallas import fused_block as jfb
from surface_vision_transformers_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from surface_vision_transformers_tpu_torch.ops import flash_attention as tfa
from surface_vision_transformers_tpu_torch.ops import fused_block as tfb

DH = 64
# (B, heads, query rows, N keys, valid_len, dim)
ATT_CASES = {"Nq8_Nk321": (1, 2, 8, 321, 321, 64), "Nq8_Nk328_vl321": (1, 2, 8, 328, 321, 64),
             "Nq8_Nk130_vl129": (2, 2, 8, 130, 129, 96), "Nq1_Nk321": (1, 2, 1, 321, 321, 64)}


def _att_inputs(case, seed):
    B, H, _, N, _, dim = ATT_CASES[case]
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, N, dim)).astype(np.float32)
    g = (1 + 0.1 * r.standard_normal(dim)).astype(np.float32)
    b = (0.1 * r.standard_normal(dim)).astype(np.float32)
    w_q = (r.uniform(-1, 1, (H * DH, dim)) * 1.5 / np.sqrt(dim) * np.sqrt(3)).astype(np.float32)
    k = (1.5 * r.standard_normal((B, N, H * DH))).astype(np.float32)
    v = r.standard_normal((B, N, H * DH)).astype(np.float32)
    return x, g, b, w_q, k, v


def _bound(want, dtype):
    m = float(np.abs(want).max())
    if dtype == "float32":
        return 2e-5 * m
    return 2 * 2.0 ** (math.floor(math.log2(m)) - 7)


def _heads(t, H):
    """(B, L, H*dh) -> (B, H, L, dh)."""
    B, L, _ = t.shape
    return t.reshape(B, L, H, DH).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATT_CASES))
def test_cls_attention_matches_jax_flash_attention(case, dtype):
    """The attention launch's plain version against JAX's flash_attention
    on the Q it made, and its Q and lse against their own definitions."""
    B, H, rows, N, vl, dim = ATT_CASES[case]
    x, g, b, w_q, k, v = _att_inputs(case, seed=len(case))
    tdt = getattr(torch, dtype)
    xt, kt, vt, wt = (torch.from_numpy(t).to(tdt) for t in (x, k, v, w_q))
    sv = {}
    got = tfb.cls_attention_reference(xt, torch.from_numpy(g), torch.from_numpy(b), wt, kt, vt,
                                      heads=H, valid_len=vl, rows=rows, saved=sv)
    assert got.shape == (B, rows, H * DH) and got.dtype == tdt
    assert sv["q"].shape == (B, rows, H * DH) and sv["lse"].shape == (B, H, rows)
    q = sv["q"].float().numpy()
    jdt = getattr(jnp, dtype)
    want = np.asarray(jax_flash_attention(
        *(jnp.asarray(_heads(t, H)).astype(jdt) for t in (q, k, v)), vl).astype(jnp.float32))
    want = want.transpose(0, 2, 1, 3).reshape(B, rows, H * DH)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= _bound(want, dtype), f"{err:.3g} > {_bound(want, dtype):.3g}"
    # Q is the rounded product of the top rows' LayerNorm; lse the row
    # log-sum-exp of the scaled scores over the valid keys
    h = tfb._layer_norm(xt[:, :rows], torch.from_numpy(g), torch.from_numpy(b), 1e-5).to(tdt)
    torch.testing.assert_close(sv["q"], (h.float() @ wt.float().t()).to(tdt), atol=0, rtol=0)
    s = torch.einsum("bhqd,bhkd->bhqk", torch.from_numpy(_heads(q, H)).double(),
                     torch.from_numpy(_heads(k, H)).to(tdt).double())[..., :vl] / 8
    torch.testing.assert_close(sv["lse"].double(), torch.logsumexp(s, -1), atol=1e-4, rtol=0)


# the small width of tests/test_torch_fused_block.py and one at SiT-tiny's
# width: (B, N, valid_len, dim, heads, dim_head, mlp)
CHAIN_SHAPES = {"small": (3, 24, 19, 32, 2, 64, 64), "tiny width": (2, 48, 43, 192, 3, 64, 768)}


def _block_params(seed, shape):
    dim, heads, dh, mlp = shape[3:]
    hd = heads * dh
    r = np.random.default_rng(seed)

    def u(s, fan_in):
        bd = 1 / np.sqrt(fan_in)
        return r.uniform(-bd, bd, s).astype(np.float32)

    return [(1 + 0.1 * r.standard_normal(dim)).astype(np.float32),
            (0.1 * r.standard_normal(dim)).astype(np.float32),
            u((dim, 3 * hd), dim), u((hd, dim), hd), u((dim,), hd),
            (1 + 0.1 * r.standard_normal(dim)).astype(np.float32),
            (0.1 * r.standard_normal(dim)).astype(np.float32),
            u((dim, mlp), dim), u((mlp,), dim), u((mlp, dim), mlp), u((dim,), mlp)]


def _torch_params(p, dt):
    """Torch Linear layout (out, in) for the matrices, float32 vectors."""
    return [torch.from_numpy(np.ascontiguousarray(a.T)).to(dt) if a.ndim == 2
            else torch.from_numpy(a) for a in p]


def _chain_pieces(x, params, heads, dim_head, valid_len, saved):
    """The CLS forward as the few-query route runs it, each launch's plain
    version in order: LN1 + K/V, the attention making its Q, the
    out-projection with x's top rows, the MLP half."""
    (ln1_s, ln1_b, w_qkv, w_out, b_out, ln2_s, ln2_b, w_fc1, b_fc1, w_fc2, b_fc2) = params
    dt, hd, rows = x.dtype, heads * dim_head, min(8, x.shape[1])
    kv, h1, stats1 = tfb.ln_gemm_reference(x, ln1_s, ln1_b, w_qkv[hd:])
    attn = tfb.cls_attention_reference(x, ln1_s, ln1_b, w_qkv[:hd], kv[..., :hd], kv[..., hd:],
                                       heads=heads, dim_head=dim_head, valid_len=valid_len,
                                       saved=saved)
    x1 = (x[:, :rows].float() + (tfb._mm(attn, w_out) + b_out)).to(dt)
    saved.update(h1=h1, kv=kv, stats1=stats1, attn=attn, x1=x1)
    return tfb.mlp_reference(x1, ln2_s, ln2_b, w_fc1, b_fc1, w_fc2, b_fc2, saved=saved)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(CHAIN_SHAPES))
def test_chain_pieces_are_the_cls_block(shape, dtype):
    """The pieces composed equal ``fused_block_cls_reference`` up to the
    order of the products' sums, with every save of the training form; and
    the JAX package's
    ``fused_block_cls`` within 1e-3 (float32) or two bf16 steps below 8
    (bfloat16) on the top rows."""
    B, N, vl, dim, heads, dh, _ = sh = CHAIN_SHAPES[shape]
    p = _block_params(30 + len(shape), sh)
    x = np.random.default_rng(31).standard_normal((B, N, dim)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    args = _torch_params(p, tdt)
    xt = torch.from_numpy(x).to(tdt)
    sv, want_sv = {}, {}
    got = _chain_pieces(xt, args, heads, dh, vl, sv)
    want = tfb.fused_block_cls_reference(xt, *args, heads=heads, dim_head=dh, valid_len=vl,
                                         saved=want_sv)
    # the products of the top rows alone may sum in another order than those
    # of every row (the CPU's BLAS blocks by shape): float32 within 1e-6 of
    # the largest value, bfloat16 within one bf16 step of it
    for name in ("out", *tfb.TRAIN_SAVED_CLS):
        a, b = (got, want) if name == "out" else (sv[name], want_sv[name])
        step = 1e-6 if dtype == "float32" else 2.0 ** -7
        tol = step * 2.0 ** math.ceil(math.log2(float(b.float().abs().max()) + 1e-30))
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=0, msg=name)
    assert set(sv) == set(tfb.TRAIN_SAVED_CLS)
    jargs = [jnp.asarray(a).astype(jdt) if a.ndim == 2 else jnp.asarray(a) for a in p]
    jout = np.asarray(jfb.fused_block_cls(jnp.asarray(x).astype(jdt), *jargs, heads=heads,
                                          dim_head=dh, valid_len=vl).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), jout[:, :8],
                               atol=1e-3 if dtype == "float32" else 0.0625, rtol=0)


# The CLS forward's route at the shapes the port serves and trains: name ->
# ((N, dim), (few_query_fwd(8, N), cls_fwd_route, cls_ln1_in_kv, device
# kernels a call, serving or training))
ROUTES = {
    "SiT-tiny": ((321, 192), (True, True, True, 6)),
    "SiT-tiny N 328": ((328, 192), (True, True, True, 6)),
    "dim 96": ((321, 96), (True, True, True, 6)),
    "SiT-small width": ((321, 384), (True, True, False, 8)),
    "SiT-base": ((1281, 768), (True, True, False, 8)),
    "4,096 keys (the limit)": ((4096, 192), (True, True, True, 6)),
    "4,097 keys": ((4097, 192), (False, False, False, 8)),
    "8 rows, 8 keys": ((8, 192), (False, False, False, 8)),
    "dim 128": ((321, 128), (True, True, False, 8)),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_cls_forward_route(name):
    """Where the CLS forward's attention is one few-query launch (up to
    4,096 keys: their fp32 scores in shared memory), where it makes its own
    Q with LN1 in the K/V product (dims 96, 192: the F_LNA widths), and
    the device kernels one call runs, serving or training: 6 there ([LN1 +
    K/V], the attention, the out-projection, LN2, fc1, fc2), else 8 (LN1,
    K/V and Q apart)."""
    (N, dim), (few, route, ln_kv, launches) = ROUTES[name]
    rows = min(8, N)
    assert tfa.few_query_fwd(rows, N, DH) is few
    assert tfb.cls_fwd_route(N, rows) is route
    assert tfb.cls_ln1_in_kv(N, rows, dim) is ln_kv
    assert tfb.cls_fwd_launches(N, dim) == launches


def test_few_query_forward_limits():
    """The few-query forward's edges: every head dim up to 128 (32, 128 and
    20, in padded heads, too; 136 runs the wide kernel at these shapes), 1
    to 8 queries, more keys than 8 and at most 4,096; never with dropout;
    its backward twin takes any number of keys."""
    assert tfa.few_query_fwd(8, 9, 64) and tfa.few_query_fwd(1, 4096, 64)
    assert not tfa.few_query_fwd(9, 321, 64) and not tfa.few_query_fwd(8, 8, 64)
    assert not tfa.few_query_fwd(8, 4097, 64) and tfa.few_query_bwd(8, 4097, 64)
    assert tfa.few_query_fwd(8, 321, 32) and not tfa.few_query_fwd(8, 321, 64, dropout=True)
    assert tfa.few_query_fwd(8, 321, 128) and tfa.few_query_fwd(1, 4096, 128)
    assert tfa.few_query_fwd(8, 321, 20) and not tfa.few_query_fwd(8, 321, 136)
    assert tfa.wide_fwd(136) and not tfa.wide_fwd(128) and tfa.wide_fwd(129)


def test_cpu_forward_counts_no_few_query_launch():
    """On CPU tensors the public forward and the CLS block run their plain
    versions and count no launch of the few-query kernel."""
    before = tfa.few_query_fwd.launches
    q = torch.randn(1, 2, 8, DH)
    k, v = torch.randn(1, 2, 40, DH), torch.randn(1, 2, 40, DH)
    o, lse = tfa.flash_attention_fwd(q, k, v)
    torch.testing.assert_close(o, tfa.flash_attention_reference(q, k, v)[0], atol=0, rtol=0)
    sh = CHAIN_SHAPES["small"]
    args = _torch_params(_block_params(5, sh), torch.float32)
    x = torch.randn(sh[0], sh[1], sh[3])
    tfb.fused_block_cls(x, *args, heads=sh[4], dim_head=sh[5])
    assert tfa.few_query_fwd.launches == before
