"""The blocks at head widths other than 64, on the CPU, against the JAX
package: the port's plain versions beside the kernels that
``chip_smoke.py`` phase 39 holds against them on the card
(``tests/test_torch_head_widths_sit.py`` holds a whole SiT at these widths).

- attention dropout at dh 32 and 128: the port's plain dropout versions on
  the JAX dropout kernel's own mask (``_keep_mask_host``), as
  ``tests/test_torch_attention.py`` holds dh 64; float32 2e-5 and bfloat16
  two bf16 steps of the largest |JAX| value;
- ``fused_block_cls`` and the gradients of ``fused_block_cls_train`` at dh
  32 and 128 against the JAX package's ``fused_block_cls`` and ``jax.vjp`` of
  its ``fused_block_cls_train`` (Pallas interpret mode), and past dim 768,
  where both packages take their recompute route; the tolerances of
  ``tests/test_torch_block_train.py`` and ``tests/test_torch_cls_fwd.py``
  (the JAX kernels differentiate tanh-GELU, the port exact erf-GELU):
  float32 1e-3, bfloat16 2e-2 of each gradient's largest |JAX| value; the
  forward 1e-3 (float32) and two bf16 steps below 8 (bfloat16) absolute.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu.ops.pallas import fused_block as jfb
from surface_vision_transformers_tpu.ops.pallas.flash_attention import (
    _keep_mask_host,
    flash_attention_qkv_dropout as jax_flash_attention_qkv_dropout,
)
from surface_vision_transformers_tpu_torch.ops import flash_attention as tfa
from surface_vision_transformers_tpu_torch.ops import fused_block as tfb

ORDER = ("ln1_s", "ln1_b", "w_qkv", "w_out", "b_out", "ln2_s", "ln2_b",
         "w_fc1", "b_fc1", "w_fc2", "b_fc2")
MATS = ("w_qkv", "w_out", "w_fc1", "w_fc2")
NAMES = ("dx",) + ORDER
# name -> (B, N, valid_len, dim, heads, dim_head, mlp)
BLOCKS = {"dh32": (2, 24, 19, 64, 2, 32, 64), "dh128": (2, 24, 19, 128, 2, 128, 64),
          "dim 776 (recompute)": (2, 24, 19, 776, 2, 16, 64)}


def _bound(want, dtype):
    m = float(np.abs(want).max())
    if dtype == "float32":
        return 2e-5 * m
    return 2 * 2.0 ** (math.floor(math.log2(m)) - 7)


def _check(got, want, dtype, names):
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = np.abs(a - b).max()
        assert err <= _bound(b, dtype), f"{name}: {err:.3g} > {_bound(b, dtype):.3g}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [32, 128])
def test_dropout_matches_jax_on_its_mask(dh, dtype):
    """The JAX dropout kernel's forward and backward against the port's
    plain dropout versions given the JAX kernel's own keep mask (the two
    packages draw different bits from a seed)."""
    B, H, N, vl, rate, seed = 2, 2, 128, 100, 0.35, 4321
    r = np.random.default_rng(dh)
    qkv = np.concatenate([1.5 * r.standard_normal((B, N, 2 * H * dh)),
                          r.standard_normal((B, N, H * dh))], -1).astype(np.float32)
    g = r.standard_normal((B, N, H * dh)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jseed = jnp.array(seed, jnp.int32)
    out, vjp = jax.vjp(lambda t: jax_flash_attention_qkv_dropout(t, H, vl, rate, jseed),
                       jnp.asarray(qkv).astype(jdt))
    (grad,) = vjp(jnp.asarray(g).astype(jdt))
    want = [np.asarray(t.astype(jnp.float32)) for t in (out, grad)]
    keep = torch.from_numpy(np.array(_keep_mask_host(jseed, B, H, N, rate)))
    x, gt = torch.from_numpy(qkv).to(tdt), torch.from_numpy(g).to(tdt)
    o, lse = tfa.flash_attention_qkv_reference(x, H, vl, keep, rate)
    dqkv = tfa.flash_attention_qkv_bwd_reference(x, o, lse, gt, H, vl, keep, rate)
    # query rows >= valid_len: the JAX forward computes them, the backward drops them
    _check([o.float().numpy()[:, :vl], dqkv.float().numpy()], [want[0][:, :vl], want[1]],
           dtype, ("o", "dqkv"))


def _params(name):
    """Flax-layout block parameters from a numpy seed; Q/K and the
    out-projection scaled up so that attention moves the output."""
    _, _, _, dim, heads, dh, mlp = BLOCKS[name]
    r = np.random.default_rng(dim + dh)
    hd = heads * dh

    def u(shape, fan_in, gain=1.0):
        b = gain / np.sqrt(fan_in)
        return r.uniform(-b, b, shape).astype(np.float32)

    def ln():
        return ((1 + 0.1 * r.standard_normal(dim)).astype(np.float32),
                (0.1 * r.standard_normal(dim)).astype(np.float32))

    (ln1_s, ln1_b), (ln2_s, ln2_b) = ln(), ln()
    return dict(ln1_s=ln1_s, ln1_b=ln1_b, w_qkv=u((dim, 3 * hd), dim, 2.0),
                w_out=u((hd, dim), hd, 4.0), b_out=u((dim,), hd), ln2_s=ln2_s, ln2_b=ln2_b,
                w_fc1=u((dim, mlp), dim), b_fc1=u((mlp,), dim), w_fc2=u((mlp, dim), mlp),
                b_fc2=u((dim,), mlp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_cls_block_matches_jax(name, dtype):
    """``fused_block_cls`` and the 12 gradients of ``fused_block_cls_train``
    (through its autograd function: the chain's plain backward, or past dim
    768 the recompute route) against the JAX package's."""
    B, N, vl, dim, heads, dh, _ = BLOCKS[name]
    assert tfb.cls_uses_recompute(dim) is (dim > 768)
    p = _params(name)
    r = np.random.default_rng(dim)
    x = r.standard_normal((B, N, dim)).astype(np.float32)
    g = r.standard_normal((B, 8, dim)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(p[k]).astype(jdt) if k in MATS else jnp.asarray(p[k]) for k in ORDER]
    jout = np.asarray(jfb.fused_block_cls(jnp.asarray(x).astype(jdt), *jargs, heads=heads,
                                          dim_head=dh, valid_len=vl).astype(jnp.float32))
    out, vjp = jax.vjp(lambda xx, *a: jfb.fused_block_cls_train(xx, *a, heads, dh, vl),
                       jnp.asarray(x).astype(jdt), *jargs)
    want = [np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(g).astype(out.dtype))]
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    masters = [torch.from_numpy(np.ascontiguousarray(p[k].T) if k in MATS else p[k])
               .requires_grad_() for k in ORDER]
    serving = tfb.fused_block_cls(xt.detach(), *[
        m.detach().to(tdt) if m.dim() == 2 else m.detach() for m in masters],
        heads=heads, dim_head=dh, valid_len=vl)
    np.testing.assert_allclose(serving.float().numpy(), jout[:, :8],
                               atol=1e-3 if dtype == "float32" else 0.0625, rtol=0)
    y = tfb.fused_block_cls_train(xt, *masters, heads=heads, dim_head=dh, valid_len=vl)
    y.backward(torch.from_numpy(g).to(tdt))
    got = [xt.grad.float().numpy()] + [
        m.grad.float().numpy().T if k in MATS else m.grad.float().numpy()
        for k, m in zip(ORDER, masters)]
    tol = 1e-3 if dtype == "float32" else 2e-2
    for n, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, n
        if n == "dx":
            a, b = a[:, :vl], b[:, :vl]
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= tol, f"{n}: {err:.3g} > {tol}"
