"""The last widths the JAX package runs: dim and mlp_dim off 8 (off 16 in
the int8 block), on the CPU, against the JAX package, and the padded layout
the card runs them in (``serving/svt_ops.py``: ``padded_width``,
``pad_dims``, ``pad_int8_dims``, the laid-out copy of x; every LayerNorm
counting the true width, ``ln_dim``) around the plain versions.

- ``fused_block``, ``fused_block_cls`` and the gradients of
  ``fused_block_train`` / ``fused_block_cls_train`` against the JAX
  package's (Pallas interpret mode) at (dim, heads x dh, mlp) = (60, 3 x 20,
  150), (94, 2 x 47, 384) and (100, 4 x 25, 300): the tolerances of
  ``tests/test_torch_head_widths_padded_blocks.py`` (float32 1e-3, bfloat16
  2e-2 of each gradient's largest |JAX| value; the forward 1e-3 in float32,
  two bf16 steps below 8 in bfloat16);
- the padded layout: the plain block at the laid-out width with the true
  LayerNorm count, cropped, is the plain block at the true width (float32,
  1e-5 of the largest value), forward and backward, its x and weight
  gradients zero on the padded rows and columns; counted at the padded
  width it fails;
- ``fused_block_int8`` at (56, 2 x 28, 120) and (60, 3 x 20, 150) against
  the JAX ``fused_block_int8`` (rel-L2 2e-3), the weight quantizer bit for
  bit, and in the int8 layout the LayerNorm rows' codes and scales, the
  int32 sums and the whole block bit for bit the true width's;
- ``patch_embed`` against ``pallas_patch_embed`` at dim 100, and on a
  padded W (the kernel's layout) the same tokens;
- the route rules: the fused routes that count every column (F_LNA, the
  fused MLP, the CTA's LN1) take unpadded widths only, so 94 and 188 do not
  take the dim-96 / 192 routes; the LayerNorm epilogue takes the padded
  width with the true count.

``tests/test_torch_model_widths_models.py`` holds the whole models.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surface_vision_transformers_tpu.ops as jp
from surface_vision_transformers_tpu.ops.pallas import fused_block as jfb
from surface_vision_transformers_tpu.ops.pallas import fused_block_int8 as jq
from surface_vision_transformers_tpu.ops.pallas.patch_embed import pallas_patch_embed
from surface_vision_transformers_tpu_torch.ops import fused_block as tfb
from surface_vision_transformers_tpu_torch.ops import fused_block_int8 as tq8
from surface_vision_transformers_tpu_torch.ops import patch_embed as tpe
from surface_vision_transformers_tpu_torch.ops import quant
from surface_vision_transformers_tpu_torch.serving import svt_ops

ORDER = ("ln1_s", "ln1_b", "w_qkv", "w_out", "b_out", "ln2_s", "ln2_b",
         "w_fc1", "b_fc1", "w_fc2", "b_fc2")
MATS = ("w_qkv", "w_out", "w_fc1", "w_fc2")
NAMES = ("dx",) + ORDER
# name -> (B, N, valid_len, dim, heads, dim_head, mlp)
BLOCKS = {"60": (2, 24, 19, 60, 3, 20, 150), "94": (2, 24, 19, 94, 2, 47, 384),
          "100": (2, 24, 19, 100, 4, 25, 300)}


def _params(dim, heads, dh, mlp, seed):
    """Flax-layout block parameters from a numpy seed; Q/K and the
    out-projection scaled up so that attention moves the output."""
    r = np.random.default_rng(seed)
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


def _block(name):
    B, N, vl, dim, heads, dh, mlp = BLOCKS[name]
    return _params(dim, heads, dh, mlp, dim + dh)


def _past(t, shape):
    """The elements of t outside its leading ``shape`` block (zeroed inside)."""
    z = t.detach().clone()
    z[tuple(slice(0, n) for n in shape)] = 0
    return z


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
    package's, at a dim and an mlp_dim off 8."""
    B, N, vl, dim, heads, dh, _ = BLOCKS[name]
    p = _block(name)
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
    assert served.shape == (B, rows, dim)
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


@pytest.mark.parametrize("cls", [False, True], ids=["fused_block", "fused_block_cls"])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_padded_dim_layout(name, cls):
    """The chains' layout around the plain versions: x and the parameters
    as ``svt_ops.laid_out`` copies them for the CUDA entries (the row width
    and the hidden width rounded up to 8, ``pad_dims``' zero rows and
    columns), the plain block there with the LayerNorms counting the true
    width, cropped, is the block at the true width, forward and backward;
    dx and every gradient are zero past the true width, and cropping them
    gives the unpadded ones; counted at the padded width it fails."""
    B, N, vl, dim, heads, dh, mlp = BLOCKS[name]
    params = _torch(_block(name))
    r = np.random.default_rng(dim)
    rows = 8 if cls else N
    x = torch.from_numpy(r.standard_normal((B, N, dim)).astype(np.float32))
    g = torch.from_numpy(r.standard_normal((B, rows, dim)).astype(np.float32))
    xp, padded, width = svt_ops.laid_out(x, params, 7, svt_ops.ROW_ALIGN, svt_ops.pad_dims)
    dp, mp = svt_ops.padded_width(dim), svt_ops.padded_width(mlp)
    assert width == dim and xp.shape == (B, N, dp) and not xp[..., dim:].any()
    assert [tuple(t.shape) for t in padded] == [
        (dp,), (dp,), (3 * heads * dh, dp), (dp, heads * dh), (dp,), (dp,), (dp,), (mp, dp),
        (mp,), (dp, mp), (dp,)]
    for t, t0 in zip(padded, params):
        assert torch.equal(svt_ops.crop_to(t, t0.shape), t0)
        assert not _past(t, t0.shape).any()  # zeros past the true widths
    gp = svt_ops.pad_to(g, (B, rows, dp))
    fwd = tfb.fused_block_cls_reference if cls else tfb.fused_block_reference
    bwd = tfb.fused_block_cls_bwd_reference if cls else tfb.fused_block_bwd_reference
    kw = dict(heads=heads, dim_head=dh, valid_len=vl)
    want = [fwd(x, *params, **kw), *bwd(x, g, *params, **kw)]
    got = [fwd(xp, *padded, ln_dim=dim, **kw), *bwd(xp, gp, *padded, ln_dim=dim, **kw)]
    for t, w in zip(got, want):  # [out, dx, d_ln1_s, ..., d_b_fc2]
        assert not _past(t, w.shape).any()  # zero past the true widths
    errs = [float((svt_ops.crop_to(a, b.shape) - b).abs().max() / b.abs().max())
            for a, b in zip(got, want)]
    assert max(errs) <= 1e-5, errs
    trap = fwd(xp, *padded, **kw)[..., :dim]  # LayerNorms counting the padded width
    assert float((trap - want[0]).abs().max() / want[0].abs().max()) > 1e-2
    trap_bwd = bwd(xp, gp, *padded, **kw)[0][..., :dim]
    assert float((trap_bwd - want[1]).abs().max() / want[1].abs().max()) > 1e-2


INT8 = {"56": (2, 24, 19, 56, 2, 28, 120), "60": (2, 24, 19, 60, 3, 20, 150)}


@pytest.mark.parametrize("name", list(INT8))
def test_int8_block_matches_jax(name):
    """``fused_block_int8`` (its plain version on the CPU) at a dim and an
    mlp off 16 against the JAX ``fused_block_int8``: the weight quantizer
    bit for bit, the block within rel-L2 2e-3 and both within 0.01 of the
    float32 block; then in the int8 layout (``laid_out`` with
    ``pad_int8_dims``: rows of 16 bytes) the LayerNorm rows' codes and
    scales, qkv's int32 sums and the whole block bit for bit the true
    width's."""
    B, N, vl, dim, heads, dh, mlp = INT8[name]
    r = np.random.default_rng(dim)

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
    got = tq8.fused_block_int8(xt, *params, **kw)
    fp32 = tfb.fused_block_reference(xt, *(t[k] for k in ORDER), **kw).numpy()

    def rel(a, b):
        return float(np.linalg.norm(a[:, :vl] - b[:, :vl]) / np.linalg.norm(b[:, :vl]))

    assert np.isfinite(got.numpy()).all() and rel(got.numpy(), want) < 2e-3
    assert rel(got.numpy(), fp32) < 0.01 and rel(want, fp32_jax) < 0.01
    # the int8 layout
    xp, pp, _ = svt_ops.laid_out(xt, params, 9, svt_ops.INT8_ROW_ALIGN, svt_ops.pad_int8_dims)
    dp = svt_ops.padded_width(dim, 16)
    assert dp % 16 == 0 and dp > dim and pp[9].shape[0] % 16 == 0
    h = tfb._layer_norm(xt, t["ln1_s"], t["ln1_b"], 1e-5)
    hp = tfb._layer_norm(xp, pp[0], pp[1], 1e-5, n=dim)
    (qa, sa), (qp, sp) = quant.quant_rows(h), quant.quant_rows(hp)
    assert torch.equal(qp[..., :dim], qa) and torch.equal(sp, sa) and not qp[..., dim:].any()
    assert torch.equal(quant.int8_product(qp, pp[2]), quant.int8_product(qa, q[0]))
    laid = tq8.fused_block_int8(xp, *pp, ln_dim=dim, **kw)
    assert torch.equal(laid[..., :dim], got) and not laid[..., dim:].any()
    trap = tq8.fused_block_int8(xp, *pp, **kw)[..., :dim]  # counted at the padded width
    assert rel(trap.numpy(), got.numpy()) > 1e-2


def test_patch_embed_matches_pallas_at_dim_100(table_sub2):
    """The embedding at dim 100 (off 8) against ``pallas_patch_embed``
    (float32, 1e-5), and on W's rows and the bias padded to 104, as the
    kernel's CUDA entry and a padded stream lay them out, the same tokens
    bit for bit with zero columns past 100."""
    dim, C = 100, 4
    idx = table_sub2.indices
    V = idx.shape[1]
    r = np.random.default_rng(100)
    x = r.standard_normal((2, C, 40962)).astype(np.float32)
    kernel = (r.standard_normal((V * C, dim)) * 0.05).astype(np.float32)
    bias = (r.standard_normal(dim) * 0.1).astype(np.float32)
    means = r.uniform(-1, 1, (1, C, 1)).astype(np.float32)
    stds = r.uniform(0.5, 2, (1, C, 1)).astype(np.float32)
    jk, jb = jp.fold_normalization(jnp.asarray(kernel), jnp.asarray(bias), means, stds, V)
    want = np.asarray(pallas_patch_embed(jnp.asarray(x), idx, jk, jb,
                                         compute_dtype=jnp.float32))
    w, b = tpe.embed_matrix(torch.from_numpy(kernel), torch.from_numpy(bias), V, means=means,
                            stds=stds, compute_dtype=torch.float32)
    tab = tpe.table_tensor(idx, "cpu")
    got = tpe.patch_embed(torch.from_numpy(x), tab, w, b)
    assert got.shape == (2, idx.shape[0], dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    dp = svt_ops.padded_width(dim)
    wp, bp = svt_ops.pad_to(w, (dp, w.shape[1])), svt_ops.pad_to(b, (dp,))
    laid = tpe.patch_embed(torch.from_numpy(x), tab, wp, bp)
    assert torch.equal(laid[..., :dim], got) and not laid[..., dim:].any()


@pytest.mark.parametrize("dim,heads,dh,mlp", [(94, 2, 47, 384), (188, 4, 47, 768),
                                               (60, 3, 20, 150), (100, 4, 25, 300)])
def test_routes_take_the_true_width(dim, heads, dh, mlp):
    """The CUDA wrappers' checks take the width (reached with CPU tensors:
    no ``NotImplementedError``), at the true width and laid out padded with
    ``ln_dim``. In the padded layout the routes that count every column of
    a row (F_LNA's LN1, the fused MLP's LN2, the few-query CTA's LN1) are
    not taken, even where the padded width is 96 or 192, which alone would
    take them; the CLS forward launches eight kernels; the backward's
    LayerNorm epilogue runs at the padded width with the true count (dp <=
    192); the training routes follow the true width."""
    dp, mp = svt_ops.padded_width(dim), svt_ops.padded_width(mlp)
    params = [t.bfloat16() if t.dim() == 2 else t
              for t in _torch(_params(dim, heads, dh, mlp, dim))]
    x = torch.zeros((2, 10, dim), dtype=torch.bfloat16)
    tfb._check_cuda_args(x, params, heads, dh, 10)
    xl, pl, _ = svt_ops.laid_out(x, params, 7, svt_ops.ROW_ALIGN, svt_ops.pad_dims)
    tfb._check_cuda_args(xl, pl, heads, dh, 10, ln_dim=dim)
    q = quant.quantize_block_weights(*(params[i].float() for i in (2, 3, 7, 9)))
    p8 = (params[0], params[1], *q[:4], params[4], params[5], params[6], q[4], q[5],
          params[8], q[6], q[7], params[10])
    tq8._check_cuda_args(x, p8, heads, dh, 10)
    for train in (False, True):
        assert not tfb.fuses_mlp(dp, mp, train, ln_dim=dim)
    assert not tfb.cls_ln1_in_kv(321, 8, dp, 64, ln_dim=dim)
    assert tfb.cls_fwd_launches(321, dp, 64, ln_dim=dim) == 8
    if dp in tfb.FUSED_MLP_DIMS:  # 94 and 188: the padded width alone takes them
        assert tfb.fuses_mlp(dp, mp) and tfb.fuses_mlp(dp, mp, ln_dim=dp)
        assert tfb.cls_ln1_in_kv(321, 8, dp, 64) and tfb.cls_fwd_launches(321, dp, 64) == 6
    assert tfb.ln_in_epilogue(dp) is (dp <= 192)
    assert tfb.block_bwd_dh_floats(2, 321, dp) == (0 if dp <= 192 else 2 * 321 * dp)
    assert not tfb.uses_recompute(321, dim) and not tfb.cls_uses_recompute(dim)
    assert tfb.uses_recompute(321, 770) and tfb.cls_uses_recompute(770)
