"""The port's block backwards (plain versions, CPU) against ``jax.vjp`` of
the JAX package's ``fused_block_train`` / ``fused_block_cls_train`` (Pallas
interpret mode), through both of its routes, and against ``torch.autograd``
through the port's own plain forward; plus the autograd functions and their
device dispatch.

The JAX package routes dim <= 256 to the monolithic ``_block_bwd`` /
``_block_cls_bwd`` and dim > 256 to the split ``_block_bwd_split`` /
``_block_cls_bwd_split`` (``_prefer_split``); dims 32 and 272 hold both.
Dim 192 (3 heads of 64, mlp 768, B=3, N=48) holds the edges of the CUDA
GEMM engine's tiling (csrc/gemm.cuh): B*N = 144 rows, not a multiple of 64
or 128; the CLS block's 24 rows; a 576-wide qkv.

Tolerances, as the largest |port - JAX| over the largest |JAX| of each of
the 12 gradients (dx on the rows < valid_len, where the cotangent lives):
* float32, 1e-3: the JAX kernels differentiate tanh-GELU and the clamped
  unshifted softmax, the port exact erf-GELU and the shifted one; measured
  <= 4.9e-4 (the MLP grads, where GELU' enters), <= 6e-5 elsewhere.
* bfloat16, 2e-2: the same forms move values across bf16 rounding points,
  and the JAX package rounds its parameter gradients to bf16 (the port keeps
  them float32); measured <= 7.1e-3, about two bf16 steps (2^-8 relative).
The plain backward against autograd of the plain forward, float32: rtol
1e-5 of the largest gradient (measured <= 8e-7; only the order of the
float32 sums differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu.ops.pallas import fused_block as jfb
from surface_vision_transformers_tpu_torch.ops import fused_block as tfb

HEADS, DH, MLP = 2, 16, 64
B, N, VALID = 2, 24, 19
# dim -> (B, N, valid_len, heads, dim_head, mlp)
SHAPES = {32: (B, N, VALID, HEADS, DH, MLP), 272: (B, N, VALID, HEADS, DH, MLP),
          192: (3, 48, 43, 3, 64, 768)}
ORDER = ("ln1_s", "ln1_b", "w_qkv", "w_out", "b_out", "ln2_s", "ln2_b",
         "w_fc1", "b_fc1", "w_fc2", "b_fc2")
MATS = ("w_qkv", "w_out", "w_fc1", "w_fc2")
NAMES = ("dx",) + ORDER


def _params(dim, seed):
    """Flax-layout block parameters from a numpy seed; Q/K and the
    out-projection scaled up so that attention moves the output."""
    r = np.random.default_rng(seed)
    _, _, _, heads, dh, mlp = SHAPES.get(dim, SHAPES[32])
    hd = heads * dh

    def u(shape, fan_in, gain=1.0):
        b = gain / np.sqrt(fan_in)
        return r.uniform(-b, b, shape).astype(np.float32)

    def ln():
        return ((1 + 0.1 * r.standard_normal(dim)).astype(np.float32),
                (0.1 * r.standard_normal(dim)).astype(np.float32))

    (ln1_s, ln1_b), (ln2_s, ln2_b) = ln(), ln()
    return dict(ln1_s=ln1_s, ln1_b=ln1_b, w_qkv=u((dim, 3 * hd), dim, 2.0),
                w_out=u((hd, dim), hd, 4.0), b_out=u((dim,), hd),
                ln2_s=ln2_s, ln2_b=ln2_b, w_fc1=u((dim, mlp), dim),
                b_fc1=u((mlp,), dim), w_fc2=u((mlp, dim), mlp),
                b_fc2=u((dim,), mlp))


def _torch_args(p, dt):
    return [torch.from_numpy(np.ascontiguousarray(p[k].T)).to(dt)
            if k in MATS else torch.from_numpy(p[k]) for k in ORDER]


def _inputs(dim, cls, seed):
    b, n, valid = SHAPES.get(dim, SHAPES[32])[:3]
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, n, dim)).astype(np.float32)
    g = r.standard_normal((b, 8 if cls else n, dim)).astype(np.float32)
    g[:, valid:] = 0.0  # padding rows carry no cotangent
    return x, g


def _jax_grads(p, x, g, cls, jdt):
    _, _, valid, heads, dh, _ = SHAPES.get(x.shape[-1], SHAPES[32])
    fn = jfb.fused_block_cls_train if cls else jfb.fused_block_train
    args = [jnp.asarray(p[k]).astype(jdt) if k in MATS else jnp.asarray(p[k])
            for k in ORDER]
    out, vjp = jax.vjp(lambda xx, *a: fn(xx, *a, heads, dh, valid),
                       jnp.asarray(x).astype(jdt), *args)
    return [np.asarray(t.astype(jnp.float32))
            for t in vjp(jnp.asarray(g).astype(out.dtype))]


def _port_grads(p, x, g, cls, tdt):
    _, _, valid, heads, dh, _ = SHAPES.get(x.shape[-1], SHAPES[32])
    ref = tfb.fused_block_cls_bwd_reference if cls else tfb.fused_block_bwd_reference
    got = ref(torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt),
              *_torch_args(p, tdt), heads=heads, dim_head=dh, valid_len=valid)
    # torch (out, in) -> flax (in, out) for the matrices
    return [t.float().numpy().T if n in MATS else t.float().numpy()
            for n, t in zip(NAMES, got)]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("cls", [False, True], ids=["block", "cls_block"])
@pytest.mark.parametrize("dim", [32, 272, 192], ids=["monolithic", "split", "gemm_edges"])
def test_backward_matches_jax_vjp(dim, cls, dtype, tol):
    assert jfb._prefer_split(dim) == (dim > 256)
    valid = SHAPES[dim][2]
    p = _params(dim, seed=dim)
    x, g = _inputs(dim, cls, seed=dim + 1)
    want = _jax_grads(p, x, g, cls, getattr(jnp, dtype))
    got = _port_grads(p, x, g, cls, getattr(torch, dtype))
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        if name == "dx":
            a, b = a[:, :valid], b[:, :valid]
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= tol, f"{name}: {err:.3g} > {tol}"


@pytest.mark.parametrize("cls", [False, True], ids=["block", "cls_block"])
def test_plain_backward_is_autograd_of_plain_forward(cls):
    p = [t.requires_grad_() for t in _torch_args(_params(32, 7), torch.float32)]
    x0, g0 = _inputs(32, cls, 8)
    x = torch.from_numpy(x0).requires_grad_()
    fwd = tfb.fused_block_cls_reference if cls else tfb.fused_block_reference
    out = fwd(x, *p, heads=HEADS, dim_head=DH, valid_len=VALID)
    g = torch.from_numpy(g0)
    want = torch.autograd.grad(out, [x, *p], g)
    bwd = tfb.fused_block_cls_bwd_reference if cls else tfb.fused_block_bwd_reference
    got = bwd(x.detach(), g, *[t.detach() for t in p], heads=HEADS,
              dim_head=DH, valid_len=VALID)
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item(),
                                   msg=name)


@pytest.mark.parametrize("cls", [False, True], ids=["block", "cls_block"])
def test_autograd_function_runs_the_plain_versions_on_cpu(cls):
    """``fused_block[_cls]_train`` on CPU tensors: the plain forward, the
    plain backward, float32 gradients on float32 masters from a bfloat16
    compute dtype, and no kernel launch counted."""
    masters = [t.requires_grad_() for t in _torch_args(_params(32, 9), torch.float32)]
    x0, g0 = _inputs(32, cls, 10)
    x = torch.from_numpy(x0).bfloat16().requires_grad_()
    fn = tfb.fused_block_cls_train if cls else tfb.fused_block_train
    counters = (tfb.fused_block, tfb.fused_block_cls, tfb.fused_block_bwd,
                tfb.fused_block_cls_bwd)
    before = [c.launches for c in counters]
    out = fn(x, *masters, heads=HEADS, dim_head=DH, valid_len=VALID)
    g = torch.from_numpy(g0).bfloat16()
    out.backward(g)
    assert [c.launches for c in counters] == before
    cast = [m.detach().bfloat16() if k in MATS else m.detach()
            for k, m in zip(ORDER, masters)]
    fwd = tfb.fused_block_cls_reference if cls else tfb.fused_block_reference
    bwd = tfb.fused_block_cls_bwd_reference if cls else tfb.fused_block_bwd_reference
    kw = dict(heads=HEADS, dim_head=DH, valid_len=VALID)
    torch.testing.assert_close(out, fwd(x.detach(), *cast, **kw), atol=0, rtol=0)
    want = bwd(x.detach(), g, *cast, **kw)
    torch.testing.assert_close(x.grad, want[0], atol=0, rtol=0)
    for m, w in zip(masters, want[1:]):
        assert m.grad.dtype == torch.float32
        torch.testing.assert_close(m.grad, w, atol=0, rtol=0)


def test_cuda_request_without_cuda_raises(monkeypatch):
    """Training on ``device="cuda"`` where there is none raises; there is no
    CPU fallback."""
    from surface_vision_transformers_tpu_torch.train.runner import run_training
    from surface_vision_transformers_tpu_torch.utils.config import from_dict

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_training(from_dict({}), device="cuda", datasets={})


@pytest.mark.parametrize("kwarg", [dict(mesh=object()), dict(scan_blocks=True)])
def test_fused_train_forward_refuses_unported_modes(kwarg):
    from surface_vision_transformers_tpu_torch.models.fused import fused_train_forward
    from surface_vision_transformers_tpu_torch.models.sit import SiT

    model = SiT(dim=32, depth=1, heads=HEADS, mlp_dim=MLP, dim_head=DH,
                num_patches=20, num_vertices=15, dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        fused_train_forward(model, torch.zeros(1, 4, 20, 15), **kwarg)


def test_other_devices_raise():
    x = torch.empty((B, N, 32), device="meta")
    g = torch.empty((B, N, 32), device="meta")
    args = _torch_args(_params(32, 0), torch.float32)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfb.fused_block_bwd(x, g, *args, saved={}, heads=HEADS, dim_head=DH)
