"""The port's ``flash_attention`` (plain versions, CPU) against the JAX
package's ``flash_attention`` and ``jax.vjp`` of it (Pallas interpret mode,
as ``tests/test_kernels.py`` runs it), and its autograd function and
dispatch.

Cases: B=2, H=2, dh=64, N=72 with valid_len 70, and 8 queries against 72
keys. The cotangent is nonzero on every row, so the rows >= valid_len that
both sides drop are exercised. Tolerances, of the largest |JAX| value of
each output: float32 2e-5 (the same algorithm, sums in another order);
bfloat16 two bf16 steps (delta is rowsum(dO . O) here and rowsum(P . dP) in
the JAX kernel: the same quantity, rounded at other points).
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

CASES = {"N72_vl70": (2, 2, 72, 72, 70), "Nq8_Nk72": (2, 2, 8, 72, 70)}
DH = 64


def _inputs(case, seed):
    B, H, nq, nk, _ = CASES[case]
    r = np.random.default_rng(seed)
    q = (1.5 * r.standard_normal((B, H, nq, DH))).astype(np.float32)
    k = (1.5 * r.standard_normal((B, H, nk, DH))).astype(np.float32)
    v = r.standard_normal((B, H, nk, DH)).astype(np.float32)
    g = r.standard_normal((B, H, nq, DH)).astype(np.float32)
    return q, k, v, g


def _bound(want, dtype):
    m = float(np.abs(want).max())
    if dtype == "float32":
        return 2e-5 * m
    return 2 * 2.0 ** (math.floor(math.log2(m)) - 7)


def _jax(q, k, v, g, vl, dtype):
    jdt = getattr(jnp, dtype)
    out, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, vl),
                       *(jnp.asarray(t).astype(jdt) for t in (q, k, v)))
    grads = vjp(jnp.asarray(g).astype(jdt))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_backward_match_jax(case, dtype):
    q, k, v, g = _inputs(case, seed=len(case))
    vl = CASES[case][4]
    want = _jax(q, k, v, g, vl, dtype)
    tdt = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy(t).to(tdt).requires_grad_() for t in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, vl)
    out.backward(torch.from_numpy(g).to(tdt))
    got = [t.detach().float().numpy() for t in (out, qt.grad, kt.grad, vt.grad)]
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        err = np.abs(a - b).max()
        assert err <= _bound(b, dtype), f"{name}: {err:.3g} > {_bound(b, dtype):.3g}"


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_is_autograd_of_plain_forward(case):
    """float32: the explicit backward equals autograd through the plain
    forward on the rows < valid_len, and gives the other rows nothing."""
    q, k, v, g = _inputs(case, seed=7)
    vl = CASES[case][4]
    g[:, :, vl:] = 0.0  # rows >= valid_len: no autograd gradient to compare
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    o, lse = tfa.flash_attention_reference(qt, kt, vt, vl)
    gt = torch.from_numpy(g)
    want = torch.autograd.grad(o, [qt, kt, vt], gt)
    got = tfa.flash_attention_bwd_reference(qt.detach(), kt.detach(), vt.detach(),
                                            o.detach(), lse.detach(), gt, vl)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())
    if CASES[case][2] > vl:
        grad_q = tfa.flash_attention_bwd_reference(
            qt.detach(), kt.detach(), vt.detach(), o.detach(), lse.detach(),
            torch.ones_like(gt), vl)[0]
        assert bool((grad_q[:, :, vl:] == 0).all())


def test_lse_is_the_row_log_sum_exp():
    q, k, v, _ = _inputs("N72_vl70", seed=3)
    qt, kt, vt = (torch.from_numpy(t) for t in (q, k, v))
    _, lse = tfa.flash_attention_fwd(qt, kt, vt, 70)
    s = (qt @ kt.transpose(-1, -2))[..., :70] / 8.0
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0, atol=1e-5)


def test_cpu_runs_the_plain_versions_and_counts_no_launch():
    q, k, v, g = (torch.from_numpy(t).bfloat16() for t in _inputs("Nq8_Nk72", seed=4))
    before = (tfa.flash_attention_fwd.launches, tfa.flash_attention_bwd.launches)
    o, lse = tfa.flash_attention_fwd(q, k, v, 70)
    want_o, want_lse = tfa.flash_attention_reference(q, k, v, 70)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, g, 70)
    for a, b in zip(got, tfa.flash_attention_bwd_reference(q, k, v, o, lse, g, 70)):
        assert torch.equal(a, b)
    assert (tfa.flash_attention_fwd.launches, tfa.flash_attention_bwd.launches) == before


def test_other_devices_raise():
    t = torch.empty((1, 1, 8, DH), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.flash_attention_fwd(t, t, t)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.flash_attention_bwd(t, t, t, t, torch.empty((1, 1, 8), device="meta"), t)
