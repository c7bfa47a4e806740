"""The port's modular attention path on the CPU against the JAX package:
``flash_attention_qkv`` and ``flash_attention_tiled`` (plain versions)
against the JAX kernels and ``jax.vjp`` of them (Pallas interpret mode, as
``tests/test_kernels.py`` runs them); ``flash_attention_qkv_dropout``'s
plain versions fed the JAX package's own interpret-mode mask
(``_keep_mask_host``); the Philox keep bits the CUDA kernels draw; the
modular ``Attention`` / ``SiT`` and the training route rule.

Tolerances, of the largest |JAX| value of each output: float32 2e-5 (the
same algorithm, sums in another order); bfloat16 two bf16 steps (rounded at
other points). The plain dropout backward against autograd of the plain
forward on a fixed mask: 1e-5 of each gradient's largest value (float32).
The modular SiT against ``SiT.apply`` at float32 / HIGHEST: 2e-5, as
``tests/test_torch_sit.py``. Kernel route against plain route on the CPU (the
same masks, float32): 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu.models import SiT as JaxSiT
from surface_vision_transformers_tpu.ops.pallas.flash_attention import (
    _keep_mask_host,
    flash_attention_qkv as jax_flash_attention_qkv,
    flash_attention_qkv_dropout as jax_flash_attention_qkv_dropout,
    flash_attention_tiled as jax_flash_attention_tiled,
)
from surface_vision_transformers_tpu.train import trainer as jax_trainer
from surface_vision_transformers_tpu.utils import config as jax_config
from surface_vision_transformers_tpu_torch.checkpoints.convert import state_dict_from_jax
from surface_vision_transformers_tpu_torch.models import sit as tsit
from surface_vision_transformers_tpu_torch.ops import attention as tattn
from surface_vision_transformers_tpu_torch.ops import flash_attention as tfa
from surface_vision_transformers_tpu_torch.train.trainer import Trainer
from surface_vision_transformers_tpu_torch.utils import config

DH, H = 64, 2


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


def _packed(B, N, seed):
    r = np.random.default_rng(seed)
    qkv = np.concatenate([1.5 * r.standard_normal((B, N, 2 * H * DH)),
                          r.standard_normal((B, N, H * DH))], -1).astype(np.float32)
    return qkv, r.standard_normal((B, N, H * DH)).astype(np.float32)


def _jax_vjp(fn, x, g, dtype):
    jdt = getattr(jnp, dtype)
    out, vjp = jax.vjp(fn, jnp.asarray(x).astype(jdt))
    (grad,) = vjp(jnp.asarray(g).astype(jdt))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, grad)]


def _torch_grad(fn, x, g, dtype):
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    out = fn(xt)
    out.backward(torch.from_numpy(g).to(tdt))
    return [t.detach().float().numpy() for t in (out, xt.grad)]


# -- flash_attention_qkv --------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_matches_jax(dtype):
    """N = 128 with keys >= 100 masked; every cotangent row nonzero."""
    qkv, g = _packed(2, 128, 0)
    want = _jax_vjp(lambda t: jax_flash_attention_qkv(t, H, 100), qkv, g, dtype)
    got = _torch_grad(lambda t: tfa.flash_attention_qkv(t, H, 100), qkv, g, dtype)
    _check(got, want, dtype, ("o", "dqkv"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_unpadded_matches_jax_padded(dtype):
    """The JAX package pads SiT's 321 tokens to 384 and masks the rest; the
    port runs N = 321: the valid rows agree."""
    qkv, g = _packed(1, 384, 1)
    want = _jax_vjp(lambda t: jax_flash_attention_qkv(t, H, 321), qkv, g, dtype)
    got = _torch_grad(lambda t: tfa.flash_attention_qkv(t, H), qkv[:, :321], g[:, :321], dtype)
    _check(got, [w[:, :321] for w in want], dtype, ("o", "dqkv"))
    assert np.abs(want[1][:, 321:, H * DH:]).max() == 0  # masked keys get nothing


def test_qkv_backward_writes_the_packed_layout():
    """The backward's dqkv is one (B, N, 3 H dh) tensor in [dq | dk | dv]
    order, equal to the split-head gradients concatenated."""
    qkv, g = (torch.from_numpy(t) for t in _packed(2, 40, 2))
    o, lse = tfa.flash_attention_qkv_fwd(qkv, H, 33)
    dqkv = tfa.flash_attention_qkv_bwd(qkv, o, lse, torch.from_numpy(_packed(2, 40, 3)[1]), H, 33)
    q, k, v = tfa.split_qkv(qkv, H)
    do = torch.from_numpy(_packed(2, 40, 3)[1]).view(2, 40, H, DH).transpose(1, 2)
    parts = tfa.flash_attention_bwd_reference(q, k, v, tfa._heads_of(o, H), lse, do, 33)
    assert dqkv.shape == qkv.shape and dqkv.is_contiguous()
    torch.testing.assert_close(dqkv, torch.cat([tfa.merge_heads(p) for p in parts], -1))


# -- flash_attention_qkv_dropout -----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_matches_jax_on_its_mask(dtype):
    """Forward and backward of the JAX dropout kernel against the port's
    plain versions given the JAX kernel's own keep mask."""
    B, N, vl, rate, seed = 2, 128, 100, 0.35, 1234
    qkv, g = _packed(B, N, 4)
    jseed = jnp.array(seed, jnp.int32)
    want = _jax_vjp(lambda t: jax_flash_attention_qkv_dropout(t, H, vl, rate, jseed),
                    qkv, g, dtype)
    keep = torch.from_numpy(np.array(_keep_mask_host(jseed, B, H, N, rate)))
    tdt = getattr(torch, dtype)
    x, gt = torch.from_numpy(qkv).to(tdt), torch.from_numpy(g).to(tdt)
    o, lse = tfa.flash_attention_qkv_reference(x, H, vl, keep, rate)
    dqkv = tfa.flash_attention_qkv_bwd_reference(x, o, lse, gt, H, vl, keep, rate)
    # query rows >= valid_len: the JAX forward computes them, the backward drops them
    _check([o.float().numpy()[:, :vl], dqkv.float().numpy()],
           [want[0][:, :vl], want[1]], dtype, ("o", "dqkv"))


def test_dropout_plain_backward_is_autograd_of_plain_forward():
    """delta = rowsum(dO . O) with O the dropped output is the right
    correction: the explicit backward equals autograd on a fixed mask."""
    B, N, vl, rate = 2, 48, 45, 0.3
    qkv, g = _packed(B, N, 5)
    g[:, vl:] = 0.0
    keep = tfa.dropout_keep_mask(11, B, H, N, N, rate)
    x = torch.from_numpy(qkv).requires_grad_()
    o, lse = tfa.flash_attention_qkv_reference(x, H, vl, keep, rate)
    (want,) = torch.autograd.grad(o, [x], torch.from_numpy(g))
    got = tfa.flash_attention_qkv_bwd_reference(x.detach(), o.detach(), lse.detach(),
                                                torch.from_numpy(g), H, vl, keep, rate)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


def test_dropout_autograd_regenerates_the_mask():
    """On the CPU the differentiable entry runs the plain versions on the
    kernels' Philox mask of its seed, forward and backward."""
    B, N, rate, seed = 2, 40, 0.25, 99
    qkv, g = _packed(B, N, 6)
    x = torch.from_numpy(qkv).requires_grad_()
    out = tfa.flash_attention_qkv_dropout(x, H, None, rate, seed)
    out.backward(torch.from_numpy(g))
    keep = tfa.dropout_keep_mask(seed, B, H, N, N, rate)
    o, lse = tfa.flash_attention_qkv_reference(x.detach(), H, None, keep, rate)
    torch.testing.assert_close(out.detach(), o, rtol=0, atol=0)
    torch.testing.assert_close(x.grad, tfa.flash_attention_qkv_bwd_reference(
        x.detach(), o, lse, torch.from_numpy(g), H, None, keep, rate), rtol=0, atol=0)
    with pytest.raises(ValueError, match="rate"):
        tfa.flash_attention_qkv_dropout(x, H, None, 0.0, seed)


# -- the Philox keep bits ----------------------------------------------------------------


def test_philox_known_answer():
    """Philox4x32-10 of counter 0 under key 0 (the Random123 test vector)."""
    assert [int(w) for w in tfa.philox4x32(0, 0, 0, 0)] == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_keep_mask_rate_and_seeds():
    rate = 0.25
    keep = tfa.dropout_keep_mask(5, 2, 3, 128, 128, rate)
    assert keep.shape == (2, 3, 128, 128)
    assert abs(keep.float().mean().item() - (1 - rate)) < 0.01
    assert not torch.equal(keep, tfa.dropout_keep_mask(6, 2, 3, 128, 128, rate))
    assert torch.equal(keep, tfa.dropout_keep_mask(5, 2, 3, 128, 128, rate))
    # each (sample, head) pair draws its own bits
    assert not torch.equal(keep[0, 0], keep[0, 1]) and not torch.equal(keep[0, 0], keep[1, 0])


def test_keep_bits_do_not_depend_on_the_tiling():
    """The keep bit of (b, h, row, col) is a function of its absolute
    coordinates: drawn one score at a time over a tile at an odd offset (as
    the dK/dV pass draws them) it equals the whole-row draw (as the
    forward's), for a mask wider than a multiple of four."""
    seed, B, N, rate = 21, 2, 70, 0.4
    full = tfa.dropout_keep_mask(seed, B, H, N, N, rate)
    thr = tfa.dropout_threshold(rate)
    rows = torch.arange(13, 45).view(-1, 1)
    cols = torch.arange(37, 70).view(1, -1)
    for bh in range(B * H):
        words = torch.stack(tfa.philox4x32(rows, cols >> 2, seed, bh), -1)
        tile = words.gather(-1, (cols & 3).expand(rows.shape[0], -1)[..., None])[..., 0] >= thr
        assert torch.equal(tile, full[bh // H, bh % H, 13:45, 37:70])


# -- flash_attention_tiled -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_matches_jax(dtype):
    """N = 1600 (the JAX kernel pads it to 2048), keys >= 1590 masked. The
    cotangent is 0 on rows >= 1590: the JAX tiled dQ pass, unlike the port
    and the other JAX kernels, does not drop those rows."""
    B, N, vl = 1, 1600, 1590
    r = np.random.default_rng(7)
    q, k, v, g = (r.standard_normal((B, 1, N, DH)).astype(np.float32) * s
                  for s in (1.5, 1.5, 1.0, 1.0))
    g[:, :, vl:] = 0.0
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(lambda a, b, c: jax_flash_attention_tiled(a, b, c, vl),
                       *(jnp.asarray(t).astype(jdt) for t in (q, k, v)))
    want = [np.asarray(t.astype(jnp.float32)) for t in (out, *vjp(jnp.asarray(g).astype(jdt)))]
    qt, kt, vt = (torch.from_numpy(t).to(tdt).requires_grad_() for t in (q, k, v))
    o = tfa.flash_attention_tiled(qt, kt, vt, vl)
    o.backward(torch.from_numpy(g).to(tdt))
    got = [t.detach().float().numpy() for t in (o, qt.grad, kt.grad, vt.grad)]
    got[0], want[0] = got[0][:, :, :vl], want[0][:, :, :vl]
    _check(got, want, dtype, ("o", "dq", "dk", "dv"))


def test_multi_head_attention_routes(monkeypatch):
    """Plain route for CPU tensors; on the kernel route ``flash_attention``,
    and the long-sequence entry beyond MAX_PACKED_SEQ tokens."""
    called = []
    for name in ("flash_attention", "flash_attention_tiled"):
        monkeypatch.setattr(tattn, name, lambda *a, _n=name, _f=getattr(tfa, name):
                            called.append(_n) or _f(*a))
    r = np.random.default_rng(8)
    for n in (64, tattn.MAX_PACKED_SEQ + 8):
        q, k, v = (torch.from_numpy(r.standard_normal((1, 1, n, DH)).astype(np.float32))
                   for _ in range(3))
        plain = tattn.plain_attention(q, k, v, 60)
        assert torch.equal(tattn.multi_head_attention(q, k, v, 60), plain)
        with monkeypatch.context() as mp:
            mp.setattr(tattn, "kernel_route", lambda backend, t: True)
            routed = tattn.multi_head_attention(q, k, v, 60)
        torch.testing.assert_close(routed, plain, rtol=0, atol=1e-5)
    assert called == ["flash_attention", "flash_attention_tiled"]
    with pytest.raises(ValueError, match="backend"):
        tattn.kernel_route("pallas", q)


# -- the modular SiT ------------------------------------------------------------------------

CFG = dict(dim=64, depth=2, heads=H, mlp_dim=96, num_patches=40, num_vertices=15)


def test_sit_with_dropout_config_matches_jax_deterministic():
    """dropout > 0 in the config, no dropout rng: the forward is SiT.apply's
    deterministic one (float32 / HIGHEST)."""
    jm = JaxSiT(dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, dropout=0.2,
                emb_dropout=0.1, **CFG)
    x = np.random.default_rng(9).standard_normal((2, 4, 40, 15)).astype(np.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    m = tsit.SiT(dtype=torch.float32, dropout=0.2, emb_dropout=0.1, **CFG)
    m.load_state_dict(state_dict_from_jax(params["params"], CFG["depth"]), strict=True)
    got = m(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() <= 2e-5 * max(1.0, np.abs(want).max())


def test_kernel_route_equals_plain_route_with_dropout(monkeypatch):
    """The modular SiT with dropout on both routes from one seed: the
    kernel route (flash_attention_qkv_dropout, plain versions on the CPU)
    and the plain route draw the same masks, so the outputs and gradients
    agree."""
    torch.manual_seed(0)
    m = tsit.SiT(dtype=torch.float32, dropout=0.2, emb_dropout=0.1, **CFG)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 4, 40, 15)).astype(
        np.float32))
    calls = []
    real = tsit.flash_attention_qkv_dropout
    monkeypatch.setattr(tsit, "flash_attention_qkv_dropout",
                        lambda *a: calls.append(1) or real(*a))

    def run(kernel):
        monkeypatch.setattr(tsit, "kernel_route", lambda backend, t: kernel)
        m.zero_grad()
        out = m(x, rng=tsit.DropoutRNG(3, "cpu"))
        out.sum().backward()
        return out.detach(), [p.grad.clone() for p in m.parameters()]

    (o_k, g_k), (o_p, g_p) = run(True), run(False)
    assert len(calls) == CFG["depth"]
    torch.testing.assert_close(o_k, o_p, rtol=0, atol=1e-5)
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(1.0, b.abs().max().item()))
    undropped = m(x)
    assert not torch.allclose(undropped, o_p)  # the masks did something


@pytest.mark.parametrize("dtype,dropout,emb_dropout,fused_train", [
    ("bfloat16", 0.0, 0.0, True), ("bfloat16", 0.1, 0.0, True),
    ("bfloat16", 0.0, 0.1, True), ("bfloat16", 0.0, 0.0, False),
    ("float32", 0.0, 0.0, True)])
def test_route_rule_matches_jax(monkeypatch, dtype, dropout, emb_dropout, fused_train):
    """``Trainer.uses_fused_train`` against the JAX ``_use_fused_train`` (on
    a backend the JAX rule takes for a TPU, without a mesh)."""
    raw = {"transformer": dict(dim=32, depth=1, heads=1, mlp_dim=64, dropout=dropout,
                               emb_dropout=emb_dropout),
           "tpu": {"compute_dtype": dtype, "fused_train": fused_train}}
    exp = config.from_dict(raw)
    model = tsit.SiT.from_config(exp)
    got = Trainer(exp, model).uses_fused_train()
    jtr = jax_trainer.Trainer(jax_config.from_dict(raw))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert got == jtr._use_fused_train()
