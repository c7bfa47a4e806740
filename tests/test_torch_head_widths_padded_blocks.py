"""The blocks, the int8 block and a whole SiT at the last head widths the
JAX package runs (3 heads of 20: padded heads; 2 or 3 heads of 192: past
the widest tile; the int8 block at 5 x 72, heads x dh off 16), on the CPU,
against the JAX package, and the layout the card runs them in
(``serving/svt_ops.py``: ``pad_block``, ``pad_int8_block``, ``crop_heads``)
around the plain versions.

- ``fused_block``, ``fused_block_cls`` and the gradients of
  ``fused_block_train`` / ``fused_block_cls_train`` against the JAX
  package's (Pallas interpret mode): the tolerances of
  ``tests/test_torch_head_widths_blocks.py`` (the JAX kernels differentiate
  tanh-GELU, the port exact erf-GELU): float32 1e-3, bfloat16 2e-2 of each
  gradient's largest |JAX| value; the forward 1e-3 (float32) and two bf16
  steps below 8 (bfloat16) absolute;
- the padded layout: the plain block on ``pad_block``'s weights at the
  layout's width with dh's softmax scale equals the plain block at dh
  (float32, 1e-5 of the largest value), its weight gradients are zero on
  the padded rows and columns and ``crop_heads`` of them are the unpadded
  ones; at the layout's own scale it fails;
- ``fused_block_int8`` at 5 x 72 against the JAX ``fused_block_int8``
  (``tests/test_torch_int8.py``'s rel-L2 2e-3), its integer parts bit for
  bit: the weight quantizer against JAX's, and in the chain's layout (heads
  in ``head_cols`` columns, int8 rows of ``int8_cols``) the attention rows'
  codes and scales and the out-projection's int32 sums against the plain
  ones at the true width;
- a whole SiT at 3 x 20 and 3 x 192 through ``sit_params_to_torch``:
  serving and one training step against the JAX package
  (``tests/test_torch_head_widths_sit.py``'s rules), its gradients and
  state dict in the reference shapes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu.checkpoints.torch_import import sit_params_to_torch
from surface_vision_transformers_tpu.models import SiT as JaxSiT
from surface_vision_transformers_tpu.ops.pallas import fused_block as jfb
from surface_vision_transformers_tpu.ops.pallas import fused_block_int8 as jq
from surface_vision_transformers_tpu_torch.models import fused as tfused
from surface_vision_transformers_tpu_torch.models.sit import SiT
from surface_vision_transformers_tpu_torch.ops import flash_attention as tfa
from surface_vision_transformers_tpu_torch.ops import fused_block as tfb
from surface_vision_transformers_tpu_torch.ops import fused_block_int8 as tq8
from surface_vision_transformers_tpu_torch.ops import quant
from surface_vision_transformers_tpu_torch.serving import svt_ops

ORDER = ("ln1_s", "ln1_b", "w_qkv", "w_out", "b_out", "ln2_s", "ln2_b",
         "w_fc1", "b_fc1", "w_fc2", "b_fc2")
MATS = ("w_qkv", "w_out", "w_fc1", "w_fc2")
NAMES = ("dx",) + ORDER
# name -> (B, N, valid_len, dim, heads, dim_head, mlp)
BLOCKS = {"3 x 20": (2, 24, 19, 64, 3, 20, 64), "2 x 192": (2, 24, 19, 128, 2, 192, 64)}


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


def _torch(p):
    """The torch-layout (out, in) float32 parameters in the kernels' order."""
    return [torch.from_numpy(np.ascontiguousarray(p[k].T) if k in MATS else p[k])
            for k in ORDER]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cls", [False, True], ids=["fused_block", "fused_block_cls"])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name, cls, dtype):
    """The serving block and the 12 gradients of its training form (through
    its autograd function: the chain's plain backward) against the JAX
    package's."""
    B, N, vl, dim, heads, dh, _ = BLOCKS[name]
    p = _params(name)
    r = np.random.default_rng(dim + cls)
    rows = 8 if cls else N
    x = r.standard_normal((B, N, dim)).astype(np.float32)
    g = r.standard_normal((B, rows, dim)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jserve, jtrain = ((jfb.fused_block_cls, jfb.fused_block_cls_train) if cls
                      else (jfb.fused_block, jfb.fused_block_train))
    serve, train = ((tfb.fused_block_cls, tfb.fused_block_cls_train) if cls
                    else (tfb.fused_block, tfb.fused_block_train))
    jargs = [jnp.asarray(p[k]).astype(jdt) if k in MATS else jnp.asarray(p[k]) for k in ORDER]
    jout = np.asarray(jserve(jnp.asarray(x).astype(jdt), *jargs, heads=heads, dim_head=dh,
                             valid_len=vl).astype(jnp.float32))[:, :rows]
    out, vjp = jax.vjp(lambda xx, *a: jtrain(xx, *a, heads, dh, vl),
                       jnp.asarray(x).astype(jdt), *jargs)
    want = [np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(g).astype(out.dtype))]
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    masters = [t.requires_grad_() for t in _torch(p)]
    served = serve(xt.detach(), *[m.detach().to(tdt) if m.dim() == 2 else m.detach()
                                  for m in masters], heads=heads, dim_head=dh, valid_len=vl)
    np.testing.assert_allclose(served.float().numpy(), jout,
                               atol=1e-3 if dtype == "float32" else 0.0625, rtol=0)
    y = train(xt, *masters, heads=heads, dim_head=dh, valid_len=vl)
    y.backward(torch.from_numpy(g).to(tdt))
    got = [xt.grad.float().numpy()] + [
        m.grad.float().numpy().T if k in MATS else m.grad.float().numpy()
        for k, m in zip(ORDER, masters)]
    tol = 1e-3 if dtype == "float32" else 2e-2
    for n, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, n  # the reference layout: no padded gradient
        if n == "dx":
            a, b = a[:, :vl], b[:, :vl]
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= tol, f"{n}: {err:.3g} > {tol}"


def _scaled(monkeypatch, dh):
    """The plain versions inside the blocks take dh's softmax scale."""
    sc = dh ** -0.5
    monkeypatch.setattr(tfb, "flash_attention_reference",
                        functools.partial(tfa.flash_attention_reference, scale=sc))
    monkeypatch.setattr(tfb, "flash_attention_bwd_reference",
                        functools.partial(tfa.flash_attention_bwd_reference, scale=sc))


@pytest.mark.parametrize("cls", [False, True], ids=["fused_block", "fused_block_cls"])
@pytest.mark.parametrize("heads,dh", [(3, 20), (5, 12)])
def test_padded_block_layout(monkeypatch, heads, dh, cls):
    """The chain's layout around the plain versions: the block on
    ``pad_block``'s weights (zero rows of W_qkv and zero columns of W_out
    past each head's dh) at ``head_cols(dh)`` with dh's softmax scale is the
    block at dh, forward and backward; the padded rows' and columns'
    gradients are zero and ``crop_heads`` gives the unpadded ones; the same
    at the layout's own scale fails."""
    B, N, vl, dim, mlp = 2, 24, 19, 64, 64
    dp = tfa.head_cols(dh)
    r = np.random.default_rng(dh)
    params = _torch({**_params("3 x 20"), **{
        "w_qkv": r.uniform(-0.25, 0.25, (dim, 3 * heads * dh)).astype(np.float32),
        "w_out": r.uniform(-0.5, 0.5, (heads * dh, dim)).astype(np.float32)}})
    padded = svt_ops.pad_block(params, heads, dh)
    assert padded[2].shape == (3 * heads * dp, dim) and padded[3].shape == (dim, heads * dp)
    assert padded[2].view(3 * heads, dp, dim)[:, dh:].abs().max() == 0
    assert padded[3].view(dim, heads, dp)[..., dh:].abs().max() == 0
    assert torch.equal(svt_ops.crop_heads(padded[2], 3 * heads, dh, 0), params[2])
    assert torch.equal(svt_ops.crop_heads(padded[3], heads, dh, 1), params[3])
    x = torch.from_numpy(r.standard_normal((B, N, dim)).astype(np.float32))
    g = torch.from_numpy(r.standard_normal((B, 8 if cls else N, dim)).astype(np.float32))
    fwd = tfb.fused_block_cls_reference if cls else tfb.fused_block_reference
    bwd = tfb.fused_block_cls_bwd_reference if cls else tfb.fused_block_bwd_reference
    want = [fwd(x, *params, heads=heads, dim_head=dh, valid_len=vl),
            *bwd(x, g, *params, heads=heads, dim_head=dh, valid_len=vl)]

    def run(ps):
        return [fwd(x, *ps, heads=heads, dim_head=dp, valid_len=vl),
                *bwd(x, g, *ps, heads=heads, dim_head=dp, valid_len=vl)]

    trap = run(padded)  # the layout's own scale 1 / sqrt(dp)
    _scaled(monkeypatch, dh)
    got = run(padded)
    # [out, dx, d_ln1_s, d_ln1_b, d_w_qkv, d_w_out, ...]
    assert got[4].view(3 * heads, dp, dim)[:, dh:].abs().max() == 0
    assert got[5].view(dim, heads, dp)[..., dh:].abs().max() == 0
    got[4] = svt_ops.crop_heads(got[4], 3 * heads, dh, 0)
    got[5] = svt_ops.crop_heads(got[5], heads, dh, 1)
    errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want)]
    assert max(errs) <= 1e-5, errs
    assert float((trap[0] - want[0]).abs().max() / want[0].abs().max()) > 1e-2


@pytest.mark.parametrize("heads,dh", [(5, 72), (3, 20)])
def test_int8_layout_integer_parts_bitwise(heads, dh):
    """In the int8 chain's layout (``pad_int8_block``: heads in
    ``head_cols(dh)`` columns, the attention's int8 rows and q_out's K
    rounded up to ``int8_cols``), the attention rows' codes and scales are
    the unpadded rows' (the padded columns' codes 0) and the
    out-projection's int32 sums the exact product's at the true width, bit
    for bit; q_qkv's padded rows and scales are zero, and the workspace
    holds the padded rows."""
    dim, hd, dp = 96, heads * dh, tfa.head_cols(dh)
    hp, hq = heads * dp, svt_ops.int8_cols(heads * dp)
    assert hq % 16 == 0 and hq > hd
    r = np.random.default_rng(hd)
    w = [torch.from_numpy((r.standard_normal(s) * 0.1).astype(np.float32))
         for s in ((3 * hd, dim), (dim, hd), (64, dim), (dim, 64))]
    q = quant.quantize_block_weights(*w)
    vec = torch.zeros(dim)
    p8 = (vec, vec, q[0], q[1], q[2], q[3], vec, vec, vec, q[4], q[5], torch.zeros(64), q[6],
          q[7], vec)
    pp = svt_ops.pad_int8_block(p8, heads, dh)
    assert pp[2].shape == (3 * hp, dim) and pp[3].shape == (3 * hp,) and pp[4].shape == (dim, hq)
    assert torch.equal(svt_ops.crop_heads(pp[2], 3 * heads, dh, 0), q[0])
    assert torch.equal(svt_ops.crop_heads(pp[3], 3 * heads, dh, 0), q[1])
    assert not pp[2].view(3 * heads, dp, dim)[:, dh:].any()
    assert not pp[3].view(3 * heads, dp)[:, dh:].any() and not pp[4][:, hp:].any()
    attn = torch.from_numpy((r.standard_normal((40, hd)) * 2).astype(np.float32))
    attn[1] = 0.0  # the 1e-30 floor
    rows = torch.nn.functional.pad(svt_ops.pad_heads(attn, heads, dh, 1), (0, hq - hp))
    qa, sa = quant.quant_rows(attn)
    qpad, spad = quant.quant_rows(rows)
    assert torch.equal(svt_ops.crop_heads(qpad[:, :hp], heads, dh, 1), qa)
    assert torch.equal(spad, sa) and not qpad[:, hp:].any()
    assert torch.equal(quant.int8_product(qpad, pp[4]), quant.int8_product(qa, q[2]))
    ws = svt_ops.int8_workspace(40, dim, hp, 64)
    assert ws["attn"][0] == (40, hq) and ws["qa"][0] == (40, max(dim, hq))


def test_int8_block_matches_jax_at_5x72():
    """``fused_block_int8`` (its plain version on the CPU) at 5 heads of 72
    (inner width 360, off 16) against the JAX ``fused_block_int8``: the
    weight quantizer bit for bit, the block within rel-L2 2e-3 and both
    within 0.01 of the float32 block."""
    B, N, vl, dim, heads, dh, mlp = 2, 24, 19, 64, 5, 72, 64
    r = np.random.default_rng(5)

    def mk(*s):
        return (r.standard_normal(s) * 0.1).astype(np.float32)

    w = dict(ln1_s=mk(dim) + 1, ln1_b=mk(dim), w_qkv=mk(dim, 3 * heads * dh),
             w_out=mk(heads * dh, dim), b_out=mk(dim), ln2_s=mk(dim) + 1, ln2_b=mk(dim),
             w_fc1=mk(dim, mlp), b_fc1=mk(mlp), w_fc2=mk(mlp, dim), b_fc2=mk(dim))
    x = r.standard_normal((B, N, dim)).astype(np.float32)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    qs = jq.quantize_block_weights(jw["w_qkv"], jw["w_out"], jw["w_fc1"], jw["w_fc2"])
    kw = dict(heads=heads, dim_head=dh, valid_len=vl)
    want = np.asarray(jq.fused_block_int8(
        jnp.asarray(x), jw["ln1_s"], jw["ln1_b"], qs[0], qs[1], qs[2], qs[3], jw["b_out"],
        jw["ln2_s"], jw["ln2_b"], qs[4], qs[5], jw["b_fc1"], qs[6], qs[7], jw["b_fc2"], **kw))
    fp32_jax = np.asarray(jfb.fused_block(jnp.asarray(x), *(jw[k] for k in ORDER), **kw))
    t = dict(zip(ORDER, _torch(w)))
    q = quant.quantize_block_weights(t["w_qkv"], t["w_out"], t["w_fc1"], t["w_fc2"])
    for i, (qt, qj) in enumerate(zip(q, qs)):
        qj = np.asarray(qj)
        np.testing.assert_array_equal(qt.numpy(), qj.T if i % 2 == 0 else qj.reshape(-1))
    params = (t["ln1_s"], t["ln1_b"], q[0], q[1], q[2], q[3], t["b_out"], t["ln2_s"],
              t["ln2_b"], q[4], q[5], t["b_fc1"], q[6], q[7], t["b_fc2"])
    xt = torch.from_numpy(x)
    got = tq8.fused_block_int8(xt, *params, **kw).numpy()
    fp32 = tfb.fused_block_reference(xt, *(t[k] for k in ORDER), **kw).numpy()

    def rel(a, b):
        return float(np.linalg.norm(a[:, :vl] - b[:, :vl]) / np.linalg.norm(b[:, :vl]))

    assert np.isfinite(got).all() and rel(got, want) < 2e-3
    assert rel(got, fp32) < 0.01 and rel(want, fp32_jax) < 0.01


SITS = {"3 x 20": dict(dim=96, heads=3, dim_head=20, mlp_dim=128),
        "3 x 192": dict(dim=128, heads=3, dim_head=192, mlp_dim=128)}
L, V, C = 23, 15, 4  # patches (N = 24 with the CLS token), vertices, channels


@pytest.fixture(scope="module", params=list(SITS))
def sit(request):
    """(JAX model, its params, the port's model on the same weights, x)."""
    kw = dict(SITS[request.param], depth=2, num_patches=L, num_vertices=V, num_channels=C)
    jmodel = JaxSiT(dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, **kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(kw["dim_head"]),
                                                  jnp.zeros((1, C, L, V)))["params"])
    model = SiT(dtype=torch.float32, **kw)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sit_params_to_torch(params, 2).items()}, strict=True)
    x = np.random.default_rng(kw["dim_head"]).standard_normal((2, C, L, V)).astype(np.float32)
    return jmodel, params, model, x


def test_sit_serving_matches_jax(sit):
    jmodel, params, model, x = sit
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    got = tfused.fused_forward(model.eval(), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_sit_training_step_matches_jax(sit):
    """One step's loss and every parameter's gradient through
    ``fused_train_forward`` against ``jax.value_and_grad``; the gradients
    and the state dict in the reference shapes (W_qkv (3 heads dh, dim),
    W_out (dim, heads dh)): the padded layout never reaches them."""
    jmodel, params, model, x = sit
    y = np.array([0.3, -0.2], np.float32)
    jloss, jgrads = jax.value_and_grad(lambda p: jnp.mean(
        (jmodel.apply({"params": p}, jnp.asarray(x)).squeeze(-1) - y) ** 2))(
        jax.tree.map(jnp.asarray, params))
    want = sit_params_to_torch(jax.tree.map(np.asarray, jgrads), 2)
    model.train().zero_grad()
    out = tfused.fused_train_forward(model, torch.from_numpy(x))
    loss = ((out.squeeze(-1) - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 2e-5 * abs(float(jloss)) + 1e-7
    state, qkv = model.state_dict(), 0
    for name, prm in model.named_parameters():
        w = np.asarray(want[name])
        assert prm.grad.shape == prm.shape == state[name].shape == w.shape, name
        if name.endswith("to_qkv.weight"):
            qkv += 1
            assert prm.shape[0] % 3 == 0 and (prm.shape[0] // 3) % 8 != 0 or \
                (prm.shape[0] // 3) in (3 * 192,), name  # 3 x 20 = 60: no padded rows
        err = np.abs(prm.grad.numpy() - w).max() / max(np.abs(w).max(), 1e-12)
        assert err <= 1e-4, f"{name}: {err:.3g}"
    assert qkv == 2
