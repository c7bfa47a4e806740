"""The attention at the last head widths the JAX package runs, on the CPU,
against the JAX package: dh off 8 (4, 12, 20, 60, 100: the card lays a head
out in ``head_cols(dh)`` columns, zeros past dh) and past the widest tile
(136, 192, 256, 384: the wide kernels). ``tests/test_torch_head_widths.py``
holds the multiples of 8 up to 128; ``test_torch_head_widths_padded_blocks.py``
the blocks, the int8 block and a whole SiT at these widths.

- ``flash_attention`` (forward and backward: the plain versions beside the
  kernels) against the JAX package's ``flash_attention`` and ``jax.vjp`` of
  it (Pallas interpret mode, as ``tests/test_kernels.py`` runs it), N = 72
  with valid_len 70, and 8 queries against 72 keys (the few-query shape);
- the padded route's own host transform (``padded_attention_reference``:
  q, k, v and the cotangent padded by ``pad_heads``, the plain versions at
  the layout's width with the true width's softmax scale, the outputs
  cropped) against the JAX package, and a run at the layout's own scale,
  the trap the kernels built for 32 and 64 columns would spring, failing;
- the route rules at these widths: the wide kernels past 128 columns, the
  few-query kernels up to 128, the backward's workspace by the layout.

Tolerances, of the largest |JAX| value of each output (those of
``tests/test_torch_head_widths.py``): float32 2e-5, bfloat16 two bf16
steps. ``chip_smoke.py`` phase 40 holds the kernels against these plain
versions on the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from surface_vision_transformers_tpu_torch.ops import flash_attention as tfa

PADDED = (4, 12, 20, 60, 100)
WIDE = (136, 192, 256, 384)
# (B, H, query rows, keys, valid_len)
CASES = {"N72_vl70": (2, 2, 72, 72, 70), "Nq8_Nk72_vl70": (2, 2, 8, 72, 70)}


def _bound(want, dtype):
    m = float(np.abs(want).max())
    if dtype == "float32":
        return 2e-5 * m
    return 2 * 2.0 ** (math.floor(math.log2(m)) - 7)


def _worst(got, want, dtype):
    """Largest |got - want| over its bound across the outputs."""
    worst = 0.0
    for a, b in zip(got, want):
        assert a.shape == b.shape, (a.shape, b.shape)
        worst = max(worst, float(np.abs(a - b).max()) / _bound(b, dtype))
    return worst


def _inputs(dh, case):
    B, H, nq, nk, vl = CASES[case]
    r = np.random.default_rng(dh + nq)
    q, k = ((1.5 * r.standard_normal((B, H, n, dh))).astype(np.float32) for n in (nq, nk))
    v = r.standard_normal((B, H, nk, dh)).astype(np.float32)
    g = r.standard_normal((B, H, nq, dh)).astype(np.float32)
    return (q, k, v, g), vl


def _jax(arrays, vl, dtype):
    q, k, v, g = arrays
    jdt = getattr(jnp, dtype)
    out, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, vl),
                       *(jnp.asarray(t).astype(jdt) for t in (q, k, v)))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *vjp(jnp.asarray(g).astype(jdt)))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,case", [(dh, "N72_vl70") for dh in PADDED + WIDE]
                         + [(dh, "Nq8_Nk72_vl70") for dh in (4, 20, 136, 384)])
def test_attention_matches_jax_at_the_last_widths(dh, case, dtype):
    """o, dq, dk, dv through the autograd function against ``jax.vjp`` of
    the JAX kernel; the cotangent nonzero on every row, so the query rows
    >= valid_len that both sides drop are exercised."""
    arrays, vl = _inputs(dh, case)
    want = _jax(arrays, vl, dtype)
    tdt = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy(t).to(tdt).requires_grad_() for t in arrays[:3])
    o = tfa.flash_attention(qt, kt, vt, vl)
    o.backward(torch.from_numpy(arrays[3]).to(tdt))
    got = [t.detach().float().numpy() for t in (o, qt.grad, kt.grad, vt.grad)]
    assert _worst(got, want, dtype) <= 1


@pytest.mark.parametrize("dh", PADDED)
@pytest.mark.parametrize("case", list(CASES))
def test_padded_route_matches_jax_and_its_trap_fails(dh, case):
    """The padded route's host transform (``pad_heads``, the plain versions
    at ``head_cols(dh)`` columns with dh's softmax scale, the outputs
    cropped) equals the JAX package, float32, at 2e-5; the same at the
    layout's scale 1 / sqrt(head_cols(dh)) fails the tolerance by far."""
    arrays, vl = _inputs(dh, case)
    want = _jax(arrays, vl, "float32")
    q, k, v, g = (torch.from_numpy(t) for t in arrays)
    o, _, dq, dk, dv = tfa.padded_attention_reference(q, k, v, vl, g)
    assert _worst([t.numpy() for t in (o, dq, dk, dv)], want, "float32") <= 1
    dp = tfa.head_cols(dh)
    assert dp > dh and dp % 8 == 0 and tfa.pad_heads(q, dp)[..., dh:].abs().max() == 0
    qp, kp, vp, gp = (tfa.pad_heads(t, dp) for t in (q, k, v, g))
    ow, lw = tfa.flash_attention_reference(qp, kp, vp, vl)  # the layout's own scale
    trap = [ow, *tfa.flash_attention_bwd_reference(qp, kp, vp, ow, lw, gp, vl)]
    assert _worst([t[..., :dh].numpy() for t in trap], want, "float32") > 100


@pytest.mark.parametrize("dh", PADDED + WIDE + (8, 64, 128, 129))
def test_routes_at_the_last_widths(dh):
    """Past 128 columns (dh > 128) the wide kernels take every shape, with
    and without dropout, and ask no workspace; up to 128 the few-query
    kernels take the CLS block's shapes at any dh; the streamed backward's
    workspace holds dQ sums of the head's layout, ``head_cols(dh)``
    columns; only dh 32 takes the resident kernels."""
    wide = dh > 128
    tfa.check_dim_head(dh)
    assert tfa.head_cols(dh) == -(-dh // 8) * 8
    assert tfa.wide_fwd(dh) is wide and tfa.wide_bwd(dh) is wide
    assert tfa.few_query_fwd(8, 321, dh) is (not wide)
    assert tfa.few_query_bwd(8, 321, dh) is (not wide)
    assert not tfa.resident_bwd(80, 80, dh) and not tfa.resident_fwd(80, 80, dh)
    assert tfa.bwd_workspace_floats(2, 3, 321, 321, dh) == (
        0 if wide else 4 * 2 * 3 * 6 * (64 * tfa.head_cols(dh) + 1))
    assert tfa.bwd_workspace_floats(2, 3, 8, 321, dh) == 0
