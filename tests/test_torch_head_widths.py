"""The attention at the head widths the port's wgmma tiles hold as they are
(a multiple of 8 from 8 to 128), on the CPU, against the JAX package, and
the rules that route and refuse widths
(``tests/test_torch_head_widths_padded.py`` holds the others: dh off 8 and
past 128).

- ``flash_attention`` (forward and backward: the plain versions beside the
  kernels) against the JAX package's ``flash_attention`` and ``jax.vjp`` of
  it (Pallas interpret mode, as ``tests/test_kernels.py`` runs it) at dh 8,
  16, 32, 48, 96 and 128, N = 72 with valid_len 70, and 8 queries against 72
  keys (the few-query kernels' shape) at dh 8 and 128 (the tiles of 32 and
  128 columns);
- the route rules at the new widths (``tile_width``, the few-query and
  resident rules, the backward's workspace, the CLS forward's route and
  launches, the CLS block's recompute route past dim 768) and the checks:
  dh 20 and 4 (padded heads), 136 (past the widest tile) taken in every
  wrapper's check, dh 0 refused naming the reason.

Tolerances, of the largest |JAX| value of each output: float32 2e-5 (the
same algorithm, sums in another order; the ``tests/test_golden_sit.py``
rule); bfloat16 two bf16 steps (delta is rowsum(dO . O) here and rowsum(P .
dP) in the JAX kernel: the same quantity, rounded at other points).
``chip_smoke.py`` phase 39 holds the kernels against these plain versions
on the card.
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
from surface_vision_transformers_tpu_torch.ops import fused_block as tfb
from surface_vision_transformers_tpu_torch.ops import fused_block_int8 as tq8

WIDTHS = (8, 16, 32, 48, 96, 128)
# (B, H, query rows, keys, valid_len)
CASES = {"N72_vl70": (2, 2, 72, 72, 70), "Nq8_Nk72_vl70": (2, 2, 8, 72, 70)}


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
@pytest.mark.parametrize("dh,case", [(dh, "N72_vl70") for dh in WIDTHS]
                         + [(dh, "Nq8_Nk72_vl70") for dh in (8, 128)])
def test_attention_matches_jax_at_every_width(dh, case, dtype):
    """o, dq, dk, dv through the autograd function against ``jax.vjp`` of
    the JAX kernel; the cotangent nonzero on every row, so the query rows
    >= valid_len that both sides drop are exercised."""
    B, H, nq, nk, vl = CASES[case]
    r = np.random.default_rng(dh + nq)
    q, k = ((1.5 * r.standard_normal((B, H, n, dh))).astype(np.float32) for n in (nq, nk))
    v = r.standard_normal((B, H, nk, dh)).astype(np.float32)
    g = r.standard_normal((B, H, nq, dh)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, vl),
                       *(jnp.asarray(t).astype(jdt) for t in (q, k, v)))
    want = [np.asarray(t.astype(jnp.float32)) for t in (out, *vjp(jnp.asarray(g).astype(jdt)))]
    qt, kt, vt = (torch.from_numpy(t).to(tdt).requires_grad_() for t in (q, k, v))
    o = tfa.flash_attention(qt, kt, vt, vl)
    o.backward(torch.from_numpy(g).to(tdt))
    got = [t.detach().float().numpy() for t in (o, qt.grad, kt.grad, vt.grad)]
    _check(got, want, dtype, ("o", "dq", "dk", "dv"))


# -- the route rules and the refusals ------------------------------------------------------


@pytest.mark.parametrize("dh,tile", [(8, 32), (24, 32), (32, 32), (40, 64), (64, 64),
                                     (72, 128), (80, 128), (128, 128)])
def test_tile_width(dh, tile):
    """A head runs in the smallest tile of 32, 64 or 128 columns that holds
    it (csrc/flash_attention_widths.cu)."""
    assert tfa.tile_width(dh) == tile


@pytest.mark.parametrize("dh", tfa.DIM_HEADS)
def test_routes_at_every_width(dh):
    """The few-query kernels take every width (the CLS block's 8 rows
    against N keys), without dropout and up to 4,096 keys forward; the
    resident kernels stay dh 32's; the streamed backward's workspace holds
    four dQ sums of 64 x dh floats and a turn counter per query tile; the
    few-query and resident routes take none."""
    assert dh % 8 == 0 and 8 <= dh <= 128
    tfa.check_dim_head(dh)
    assert tfa.few_query_fwd(8, 321, dh) and tfa.few_query_bwd(8, 321, dh)
    assert tfa.few_query_fwd(1, 4096, dh) and not tfa.few_query_fwd(8, 4097, dh)
    assert not tfa.few_query_fwd(8, 321, dh, dropout=True)
    assert not tfa.few_query_bwd(8, 321, dh, dropout=True)
    assert tfa.resident_bwd(80, 80, dh) is (dh == 32)
    assert tfa.resident_fwd(80, 80, dh) is (dh == 32)
    assert tfa.bwd_workspace_floats(2, 3, 8, 321, dh) == 0
    assert tfa.bwd_workspace_floats(2, 3, 321, 321, dh) == (
        4 * 2 * 3 * 6 * (64 * dh + 1))  # N 321: past the resident kernel


@pytest.mark.parametrize("dh", [8, 32, 48, 64, 80, 128])
def test_cls_forward_route_by_width(dh):
    """The CLS forward's attention is the few-query launch at every width;
    it makes its own Q (and LN1 runs in the K/V product: six launches) at
    dims 96 / 192 up to dh 64, its Q^T one m64 product; wider heads run the
    Q product (eight launches)."""
    assert tfb.cls_fwd_route(321, 8, dh)
    assert tfb.cls_ln1_in_kv(321, 8, 192, dh) is (dh <= 64)
    assert tfb.cls_fwd_launches(321, 192, dh) == (6 if dh <= 64 else 8)
    assert not tfb.cls_ln1_in_kv(321, 8, 384, dh)
    assert not tfb.cls_fwd_route(4097, 8, dh)


@pytest.mark.parametrize("dim,recompute", [(192, False), (768, False), (776, True),
                                           (1024, True)])
def test_cls_block_recompute_route(dim, recompute):
    """The CLS block trains on the chain up to dim 768 (the LayerNorm
    backward's width) at any N, and on the recompute route past it, as the
    full block does; the full block's rule is unchanged."""
    assert tfb.cls_uses_recompute(dim) is recompute
    assert tfb.uses_recompute(321, dim) is recompute
    assert not tfb.cls_uses_recompute(192) and tfb.uses_recompute(1281, 192)


@pytest.mark.parametrize("dh,reason", [(20, None), (136, None), (4, None), (0, ">= 1")])
def test_refused_widths_name_the_reason(dh, reason):
    """dh 20 and 4 (laid out in padded heads: a head's columns would start
    off 16 bytes) and 136 (past the widest tile: the wide kernels) are taken
    by the attention's check, with and without dropout, and by the block
    chains' and the int8 block's checks (heads x dh off 16 too); only a
    width below 1 is refused, naming the reason."""
    heads, dim = 2, 192
    hd = heads * dh
    x = torch.zeros((2, 10, dim), dtype=torch.bfloat16)
    vec = [torch.zeros(n) for n in (dim, dim, dim, dim, dim, 768, dim)]
    params = (vec[0], vec[1], torch.zeros((3 * hd, dim), dtype=torch.bfloat16),
              torch.zeros((dim, hd), dtype=torch.bfloat16), vec[2], vec[3], vec[4],
              torch.zeros((768, dim), dtype=torch.bfloat16), vec[5],
              torch.zeros((dim, 768), dtype=torch.bfloat16), vec[6])
    q8 = lambda o, i: torch.zeros((o, i), dtype=torch.int8)  # noqa: E731
    p8 = (vec[0], vec[1], q8(3 * hd, dim), torch.ones(3 * hd), q8(dim, hd), torch.ones(dim),
          vec[2], vec[3], vec[4], q8(768, dim), torch.ones(768), vec[5], q8(dim, 768),
          torch.ones(dim), vec[6])
    q = torch.zeros((1, 2, 8, dh), dtype=torch.bfloat16)
    if reason is None:
        tfa.check_dim_head(dh)
        tfa._check_cuda(q, q, q, 8)
        tfb._check_cuda_args(x, params, heads, dh, 10)
        tq8._check_cuda_args(x, p8, heads, dh, 10)
        assert tfa.wide_fwd(dh) is (dh > 128)
        return
    with pytest.raises(ValueError, match=reason):
        tfa.check_dim_head(dh)
    with pytest.raises(ValueError, match=reason):
        tfa._check_cuda(q, q, q, 8)
    with pytest.raises(ValueError, match=reason):
        tfb._check_cuda_args(x, params, heads, dh, 10)
    with pytest.raises(ValueError, match=reason):
        tq8._check_cuda_args(x, p8, heads, dh, 10)


@pytest.mark.parametrize("dh,heads", [(8, 24), (48, 4), (80, 3), (128, 3)])
def test_taken_widths_pass_every_check(dh, heads):
    """At a taken width the block chains' checks pass for both blocks, and
    the int8 block's at any heads x dh (3 x 80 = 240 makes int8 rows of a
    multiple of 16 bytes; 3 x 8 = 24 does not, and is taken too: the chain
    pads the attention's int8 rows to 16 bytes); dim off 16 is taken too
    (the chain lays the rows out padded, ``svt_ops.pad_int8_dims``)."""
    dim = 384 if dh == 128 else 192
    hd = heads * dh
    x = torch.zeros((2, 10, dim), dtype=torch.bfloat16)
    vec = [torch.zeros(n) for n in (dim, dim, dim, dim, dim, 768, dim)]
    params = (vec[0], vec[1], torch.zeros((3 * hd, dim), dtype=torch.bfloat16),
              torch.zeros((dim, hd), dtype=torch.bfloat16), vec[2], vec[3], vec[4],
              torch.zeros((768, dim), dtype=torch.bfloat16), vec[5],
              torch.zeros((dim, 768), dtype=torch.bfloat16), vec[6])
    tfb._check_cuda_args(x, params, heads, dh, 10)
    q8 = lambda o, i: torch.zeros((o, i), dtype=torch.int8)  # noqa: E731
    p8 = (vec[0], vec[1], q8(3 * hd, dim), torch.ones(3 * hd), q8(dim, hd), torch.ones(dim),
          vec[2], vec[3], vec[4], q8(768, dim), torch.ones(768), vec[5], q8(dim, 768),
          torch.ones(dim), vec[6])
    tq8._check_cuda_args(x, p8, heads, dh, 10)
    tq8._check_cuda_args(x, (*p8[:2], q8(3 * 24, dim), torch.ones(3 * 24), q8(dim, 24),
                             *p8[5:]), 3, 8, 10)
    d8 = dim - 8  # off 16: taken
    tq8._check_cuda_args(torch.zeros((2, 10, d8), dtype=torch.bfloat16),
                         (vec[0][:d8], vec[1][:d8], q8(3 * hd, d8), torch.ones(3 * hd),
                          q8(d8, hd), torch.ones(d8), vec[2][:d8], vec[3][:d8], vec[4][:d8],
                          q8(768, d8), torch.ones(768), vec[5], q8(d8, 768), torch.ones(d8),
                          vec[6][:d8]), heads, dh, 10)
