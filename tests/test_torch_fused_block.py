"""The port's block kernels' plain versions against the JAX Pallas kernels
(interpret mode on the CPU), and the wrappers' device dispatch.

Tolerances: in float32 the two differ only by the JAX kernel's tanh-GELU
(< 3e-4 from erf) and its unshifted clamped softmax (equal to the shifted
one up to rounding), so 1e-3 on the valid rows (measured <= 1.6e-4). In
bfloat16 both round at the same points, but the GELU and softmax forms above
can move a value across a rounding boundary; outputs here stay below 8,
where a bf16 step is at most 1/32, so atol 0.0625 = two steps (measured: one
step, 1/64 at 2..4).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu.ops.pallas import fused_block as jfb
from surface_vision_transformers_tpu_torch.ops import fused_block as tfb

DIM, HEADS, DH, MLP = 32, 2, 16, 64
B, N, VALID = 3, 24, 19
HD = HEADS * DH
# (B, N, valid_len, dim, heads, dim_head, mlp): the small shape, and one at
# the edges of the CUDA GEMM engine's tiling (csrc/gemm.cuh): B*N = 144 rows,
# not a multiple of 64 or 128; the CLS block's 3 * 8 = 24 rows; dim 192 with
# a 576-wide qkv (the JAX kernels need N % 8 == 0, so N = 48, not 43).
SMALL = (B, N, VALID, DIM, HEADS, DH, MLP)
GEMM_EDGES = (3, 48, 43, 192, 3, 64, 768)


def _params(seed=0, shape=SMALL):
    """Flax-layout block parameters from a numpy seed."""
    dim, heads, dh, mlp = shape[3:]
    hd = heads * dh
    r = np.random.default_rng(seed)

    def u(shape, fan_in):
        b = 1 / np.sqrt(fan_in)
        return r.uniform(-b, b, shape).astype(np.float32)

    return dict(
        ln1_s=(1 + 0.1 * r.standard_normal(dim)).astype(np.float32),
        ln1_b=(0.1 * r.standard_normal(dim)).astype(np.float32),
        w_qkv=u((dim, 3 * hd), dim), w_out=u((hd, dim), hd),
        b_out=u((dim,), hd),
        ln2_s=(1 + 0.1 * r.standard_normal(dim)).astype(np.float32),
        ln2_b=(0.1 * r.standard_normal(dim)).astype(np.float32),
        w_fc1=u((dim, mlp), dim), b_fc1=u((mlp,), dim),
        w_fc2=u((mlp, dim), mlp), b_fc2=u((dim,), mlp),
    )


ORDER = ("ln1_s", "ln1_b", "w_qkv", "w_out", "b_out", "ln2_s", "ln2_b",
         "w_fc1", "b_fc1", "w_fc2", "b_fc2")
MATS = ("w_qkv", "w_out", "w_fc1", "w_fc2")


def _jax_args(p, dt):
    return [jnp.asarray(p[k]).astype(dt) if k in MATS else jnp.asarray(p[k])
            for k in ORDER]


def _torch_args(p, dt):
    """Torch Linear layout (out, in) for the matrices, float32 vectors."""
    return [torch.from_numpy(np.ascontiguousarray(p[k].T)).to(dt)
            if k in MATS else torch.from_numpy(p[k]) for k in ORDER]


def _x(seed=1, shape=SMALL):
    b, n, _, dim = shape[:4]
    return np.random.default_rng(seed).standard_normal(
        (b, n, dim)).astype(np.float32)


KERNELS = {  # name -> (JAX kernel, plain version, CLS?, shape)
    "fused_block": (jfb.fused_block, tfb.fused_block_reference, False, SMALL),
    "fused_block_cls": (jfb.fused_block_cls, tfb.fused_block_cls_reference, True, SMALL),
    "fused_block-gemm_edges": (jfb.fused_block, tfb.fused_block_reference, False,
                               GEMM_EDGES),
    "fused_block_cls-gemm_edges": (jfb.fused_block_cls, tfb.fused_block_cls_reference,
                                   True, GEMM_EDGES),
}


def _case(name):
    """-> (JAX kernel, plain version, rows compared, output rows, shape,
    kwargs)."""
    jfn, tfn, cls, shape = KERNELS[name]
    b, n, valid, dim, heads, dh, _ = shape
    kw = dict(heads=heads, dim_head=dh, valid_len=valid)
    return jfn, tfn, 8 if cls else valid, 8 if cls else n, shape, kw


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_reference_matches_jax_fp32(name):
    jfn, tfn, rows, out_rows, shape, kw = _case(name)
    p, x = _params(shape=shape), _x(shape=shape)
    want = np.asarray(jfn(jnp.asarray(x), *_jax_args(p, jnp.float32), **kw))
    got = tfn(torch.from_numpy(x), *_torch_args(p, torch.float32), **kw).numpy()
    assert got.shape == (shape[0], out_rows, shape[3])
    np.testing.assert_allclose(got[:, :rows], want[:, :rows], atol=1e-3, rtol=0)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_reference_matches_jax_bf16(name):
    jfn, tfn, rows, _, shape, kw = _case(name)
    p, x = _params(2, shape), _x(3, shape)
    want = np.asarray(
        jfn(jnp.asarray(x).astype(jnp.bfloat16), *_jax_args(p, jnp.bfloat16),
            **kw).astype(jnp.float32))
    got = tfn(torch.from_numpy(x).bfloat16(), *_torch_args(p, torch.bfloat16),
              **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy()[:, :rows], want[:, :rows],
                               atol=0.0625, rtol=0)


def test_cls_block_is_the_first_rows_of_the_full_block():
    p, x = _params(4), torch.from_numpy(_x(5))
    kw = dict(heads=HEADS, dim_head=DH, valid_len=VALID)
    full = tfb.fused_block_reference(x, *_torch_args(p, torch.float32), **kw)
    top = tfb.fused_block_cls_reference(x, *_torch_args(p, torch.float32), **kw)
    torch.testing.assert_close(top, full[:, :8], atol=1e-6, rtol=0)


@pytest.mark.parametrize("wrapper,plain", [
    (tfb.fused_block, tfb.fused_block_reference),
    (tfb.fused_block_cls, tfb.fused_block_cls_reference),
])
def test_cpu_tensors_run_the_plain_version(wrapper, plain):
    p, x = _params(6), torch.from_numpy(_x(7)).bfloat16()
    args = _torch_args(p, torch.bfloat16)
    kw = dict(heads=HEADS, dim_head=DH, valid_len=VALID)
    before = wrapper.launches
    torch.testing.assert_close(wrapper(x, *args, **kw), plain(x, *args, **kw),
                               atol=0, rtol=0)
    assert wrapper.launches == before  # counts kernel launches only


def test_other_devices_raise():
    p = _params()
    x = torch.empty((B, N, DIM), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfb.fused_block(x, *_torch_args(p, torch.float32), heads=HEADS,
                        dim_head=DH)


def test_import_loads_neither_triton_nor_the_kernels():
    code = (
        "import sys\n"
        "from surface_vision_transformers_tpu_torch.ops import fused_block, _native\n"
        "assert 'triton' not in sys.modules\n"
        "assert _native.library.cache_info().currsize == 0\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# -- the block GEMMs alone (csrc/gemm.cuh's products, plain versions) ---------------
#
# At the engine's edges: M = 144 rows (B*N of GEMM_EDGES, not a multiple of 64
# or 128), a 576-wide qkv over K = 192, fc1's 768 and fc2's 192 columns. The
# JAX side computes the same function with float32 products at HIGHEST
# precision and jax.nn.gelu(approximate=False). Tolerances: float32 2e-5 of
# the largest output (only the order of float32 sums differs); bfloat16 two
# bf16 steps at the largest output (one rounding each, after float32 sums in
# other orders).

GEMM_M = GEMM_EDGES[0] * GEMM_EDGES[1]


def _gemm_operands(seed, m, n, k):
    r = np.random.default_rng(seed)
    a = r.standard_normal((m, k)).astype(np.float32)
    w = r.uniform(-1, 1, (n, k)).astype(np.float32) / np.sqrt(k)
    bias = (0.1 * r.standard_normal(n)).astype(np.float32)
    res = r.standard_normal((m, n)).astype(np.float32)
    return a, w, bias, res


def _bf16_steps(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def _assert_close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=2 * _bf16_steps(want), rtol=0)


def _jnp(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _jax_dot(a, b):
    return jnp.dot(a.astype(jnp.float32), b.astype(jnp.float32),
                   precision=jax.lax.Precision.HIGHEST)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue,n,k", [("none", 576, 192), ("gelu", 768, 192),
                                          ("residual", 192, 768)],
                         ids=["qkv", "fc1", "fc2"])
def test_gemm_reference_matches_jax(epilogue, n, k, dtype):
    """``gemm_reference`` (the forward chain's products with their epilogues)
    against the same function in JAX."""
    a, w, bias, res = _gemm_operands(11, GEMM_M, n, k)
    ta, tw = (torch.from_numpy(t).to(getattr(torch, dtype)) for t in (a, w))
    ja, jw = _jnp(a, dtype), _jnp(w, dtype)
    c = _jax_dot(ja, jw.T)
    if epilogue == "gelu":
        got, pre = tfb.gemm_reference(ta, tw, torch.from_numpy(bias), gelu=True)
        want_pre = c + bias
        _assert_close(pre.numpy(), want_pre, "float32")
        want = jax.nn.gelu(want_pre, approximate=False).astype(ja.dtype)
    elif epilogue == "residual":
        tr = torch.from_numpy(res).to(getattr(torch, dtype))
        got = tfb.gemm_reference(ta, tw, torch.from_numpy(bias), tr)
        want = (c + bias + _jnp(res, dtype).astype(jnp.float32)).astype(ja.dtype)
    else:
        got = tfb.gemm_reference(ta, tw)
        want = c.astype(ja.dtype)
    assert got.dtype == getattr(torch, dtype)
    _assert_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)


def _check_gemm_ln(ln, dim):
    """``gemm_ln_reference`` in LN2's form (ln 2: K = mlp, the bf16 residual
    g, four column sums) or LN1's (ln 1: K = qkv's width, the float32
    residual dx1, two sums) against ``jnp.dot`` then the JAX kernel's
    ``_ln_bwd`` plus the residual, from bf16 operands."""
    r = np.random.default_rng(14 + dim + ln)
    k = 4 * dim if ln == 2 else 3 * dim
    a = (0.01 * r.standard_normal((GEMM_M, k))).astype(np.float32)
    w = (r.uniform(-1, 1, (k, dim)) / np.sqrt(k)).astype(np.float32)
    x = r.standard_normal((GEMM_M, dim)).astype(np.float32)
    gamma = (1 + 0.1 * r.standard_normal(dim)).astype(np.float32)
    res = (0.01 * r.standard_normal((GEMM_M, dim))).astype(np.float32)
    ja, jw, jx = (_jnp(t, "bfloat16") for t in (a, w, x))
    xf = jx.astype(jnp.float32)
    mu = xf.mean(-1, keepdims=True)
    rstd = jax.lax.rsqrt(((xf - mu) ** 2).mean(-1, keepdims=True) + 1e-5)
    dx, dscale, dbias = jfb._ln_bwd(_jax_dot(ja, jw), (xf - mu) * rstd, rstd, jnp.asarray(gamma))
    jres = _jnp(res, "bfloat16").astype(jnp.float32) if ln == 2 else jnp.asarray(res)
    out = dx + jres
    stats = torch.from_numpy(np.concatenate([np.asarray(mu), np.asarray(rstd)], -1))
    tres = torch.from_numpy(res).bfloat16() if ln == 2 else torch.from_numpy(res)
    got, got_b, sums = tfb.gemm_ln_reference(
        *(torch.from_numpy(t).bfloat16() for t in (a, w, x)), stats, torch.from_numpy(gamma),
        tres)
    _assert_close(got.numpy(), out, "float32")
    _assert_close(got_b.float().numpy(), np.asarray(out.astype(jnp.bfloat16).astype(jnp.float32)),
                  "bfloat16")
    want = [dscale[0], dbias[0]] + ([jres.sum(0), out.sum(0)] if ln == 2 else [])
    assert tuple(sums.shape) == (len(want), dim)
    for s_, w_ in zip(sums, want):
        _assert_close(s_.numpy(), w_, "float32")


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "gelu_grad", "ln2-dim96",
                                  "ln2-dim192", "ln1-dim96", "ln1-dim192"])
def test_gemm_nn_reference_matches_jax(kind):
    """``gemm_nn_reference`` (the backward's dX products: a @ w with w the
    (out, in) weight; df1 with GELU' and its column sums) against JAX; and
    at dims 96 and 192 the product that makes dh with the LayerNorm backward
    in its epilogue (``_check_gemm_ln``): its float32 output and column sums
    within 2e-5 of their largest value, the bf16 output within two bf16
    steps."""
    if kind.startswith("ln"):
        _check_gemm_ln(int(kind[2]), int(kind.split("dim")[1]))
        return
    dtype = "float32" if kind == "float32" else "bfloat16"
    r = np.random.default_rng(12)
    k, n = 192, 768
    a = (0.01 * r.standard_normal((GEMM_M, k))).astype(np.float32)
    w = (r.uniform(-1, 1, (k, n)) / np.sqrt(n)).astype(np.float32)
    pre = r.standard_normal((GEMM_M, n)).astype(np.float32)
    ta, tw = (torch.from_numpy(t).to(getattr(torch, dtype)) for t in (a, w))
    c = _jax_dot(_jnp(a, dtype), _jnp(w, dtype))
    if kind == "gelu_grad":
        got, colsum = tfb.gemm_nn_reference(ta, tw, torch.from_numpy(pre))
        gelu_grad = jax.vmap(jax.vmap(jax.grad(lambda v: jax.nn.gelu(v, approximate=False))))
        d = c * gelu_grad(jnp.asarray(pre))
        _assert_close(colsum.numpy(), d.sum(0), "float32")
        want = d.astype(jnp.bfloat16)
    else:
        got = tfb.gemm_nn_reference(ta, tw, out_dtype=getattr(torch, kind))
        want = c.astype(getattr(jnp, kind))
    _assert_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)


# -- the fused forward chain's parts (dims 96 and 192: csrc/fused_mlp.cu, the
# qkv product with LN1 in its prologue) --------------------------------------
#
# The JAX side is the JAX kernel's LayerNorm (jfb._layer_norm) and jnp.dot at
# HIGHEST precision with the port's rounding points (bf16 after LN and GELU
# in bf16) and exact-erf GELU; tolerances as the GEMMs' above.


def _mlp_operands(seed, dim, dtype):
    r = np.random.default_rng(seed)
    mlp = 4 * dim
    x = r.standard_normal((GEMM_M, dim)).astype(np.float32)
    g = (1 + 0.1 * r.standard_normal(dim)).astype(np.float32)
    b = (0.1 * r.standard_normal(dim)).astype(np.float32)
    w1 = (r.uniform(-1, 1, (mlp, dim)) / np.sqrt(dim)).astype(np.float32)
    b1 = (0.1 * r.standard_normal(mlp)).astype(np.float32)
    w2 = (r.uniform(-1, 1, (dim, mlp)) / np.sqrt(mlp)).astype(np.float32)
    b2 = (0.1 * r.standard_normal(dim)).astype(np.float32)
    tdt = getattr(torch, dtype)
    torch_args = [torch.from_numpy(t).to(tdt) if t.ndim == 2 else torch.from_numpy(t)
                  for t in (x, g, b, w1, b1, w2, b2)]
    jax_args = [_jnp(t, dtype) if t.ndim == 2 else jnp.asarray(t) for t in (x, g, b, w1, b1, w2, b2)]
    return torch_args, jax_args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim", [96, 192])
@pytest.mark.parametrize("part", ["mlp", "ln_gemm"])
def test_fused_chain_parts_match_jax(part, dim, dtype):
    """``mlp_reference`` (LN2 -> fc1 -> GELU -> fc2 + the residual, the
    fused MLP kernel's plain version) and ``ln_gemm_reference`` (LN1 then
    the qkv product, its LN statistics and rows) against the same function
    built in JAX at the widths the fused chain takes."""
    (x, g, b, w1, b1, w2, b2), (jx, jg, jb, jw1, jb1, jw2, jb2) = _mlp_operands(
        15 + dim, dim, dtype)
    jdt = jx.dtype
    h = jfb._layer_norm(jx, jg, jb, eps=1e-5).astype(jdt)
    if part == "ln_gemm":
        got, got_h, stats = tfb.ln_gemm_reference(x, g, b, w1, ln_eps=1e-5)
        want = _jax_dot(h, jw1.T).astype(jdt)
        _assert_close(got_h.float().numpy(), np.asarray(h.astype(jnp.float32)), dtype)
        xf = jx.astype(jnp.float32)
        mu = xf.mean(-1, keepdims=True)
        rstd = jax.lax.rsqrt(((xf - mu) ** 2).mean(-1, keepdims=True) + 1e-5)
        _assert_close(stats.numpy(), np.concatenate([np.asarray(mu), np.asarray(rstd)], -1),
                      "float32")
    else:
        fpre = _jax_dot(h, jw1.T) + jb1
        f = jax.nn.gelu(fpre, approximate=False).astype(jdt)
        want = (jx.astype(jnp.float32) + (_jax_dot(f, jw2.T) + jb2)).astype(jdt)
        sv = {}
        got = tfb.mlp_reference(x, g, b, w1, b1, w2, b2, ln_eps=1e-5, saved=sv)
        assert set(sv) == {"h2", "stats2", "fpre", "f"}
        _assert_close(sv["fpre"].numpy(), np.asarray(fpre), "float32")
    assert got.dtype == getattr(torch, dtype)
    _assert_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_half_then_mlp_half_is_the_block(dtype):
    """The plain attention half (LN1 + qkv, attention, out-projection with
    the residual) composed with the plain MLP half equals
    ``fused_block_reference`` bit for bit, with what each keeps for the
    backward: the fused chain's two new kernels split the block there."""
    shape = (2, 20, 20, 96, 3, 32, 384)
    p, x = _params(16, shape), torch.from_numpy(_x(17, shape))
    tdt = getattr(torch, dtype)
    x = x.to(tdt)
    (ln1_s, ln1_b, w_qkv, w_out, b_out, ln2_s, ln2_b, w_fc1, b_fc1, w_fc2,
     b_fc2) = args = _torch_args(p, tdt)
    kw = dict(heads=3, dim_head=32, valid_len=17)
    want_sv = {}
    want = tfb.fused_block_reference(x, *args, saved=want_sv, **kw)
    qkv, h1, stats1 = tfb.ln_gemm_reference(x, ln1_s, ln1_b, w_qkv)
    attn = tfb._attention(qkv[..., :96], qkv[..., 96:192], qkv[..., 192:], 3, 32, 17, tdt)
    x1 = (x.float() + (tfb._mm(attn, w_out) + b_out)).to(tdt)
    sv = {}
    got = tfb.mlp_reference(x1, ln2_s, ln2_b, w_fc1, b_fc1, w_fc2, b_fc2, saved=sv)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    for name, t in dict(h1=h1, stats1=stats1, qkv=qkv, attn=attn, x1=x1, **sv).items():
        torch.testing.assert_close(t, want_sv[name], atol=0, rtol=0)


def test_fused_chain_wrappers_run_the_plain_versions_on_cpu(monkeypatch):
    """``block_mlp`` and ``block_ln_gemm`` run their plain versions on CPU
    tensors (serving and training forms), count no launch there, refuse
    other devices, and on the CUDA route call the library with no fallback
    (a library that cannot load raises) and refuse the MLP's training form
    at dim 192, which the kernel is not built for."""
    (x, g, b, w1, b1, w2, b2), _ = _mlp_operands(18, 96, "bfloat16")
    before = tfb.block_mlp.launches, tfb.block_ln_gemm.launches
    torch.testing.assert_close(tfb.block_mlp(x, g, b, w1, b1, w2, b2),
                               tfb.mlp_reference(x, g, b, w1, b1, w2, b2), atol=0, rtol=0)
    out, sv = tfb.block_mlp(x, g, b, w1, b1, w2, b2, train=True)
    want_sv = {}
    torch.testing.assert_close(out, tfb.mlp_reference(x, g, b, w1, b1, w2, b2, saved=want_sv),
                               atol=0, rtol=0)
    for k in want_sv:
        torch.testing.assert_close(sv[k], want_sv[k], atol=0, rtol=0)
    for got, want in zip(tfb.block_ln_gemm(x, g, b, w1[:288], train=True),
                         tfb.ln_gemm_reference(x, g, b, w1[:288])):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert (tfb.block_mlp.launches, tfb.block_ln_gemm.launches) == before
    meta = torch.empty(x.shape, dtype=x.dtype, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfb.block_mlp(meta, g, b, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfb.block_ln_gemm(meta, g, b, w1)

    def no_library():
        raise RuntimeError("no CUDA device")

    monkeypatch.setattr(tfb, "_dispatch", lambda t: "cuda")
    monkeypatch.setattr(tfb._native, "library", no_library)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfb.block_mlp(x, g, b, w1, b1, w2, b2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfb.block_ln_gemm(x, g, b, w1[:288])
    with pytest.raises(ValueError, match="training form"):  # built at dim 96 only
        wide = torch.zeros((8, 192), dtype=torch.bfloat16)
        tfb.block_mlp(wide, torch.ones(192), torch.zeros(192), torch.zeros((768, 192)).bfloat16(),
                      torch.zeros(768), torch.zeros((192, 768)).bfloat16(), torch.zeros(192),
                      train=True)
    assert (tfb.block_mlp.launches, tfb.block_ln_gemm.launches) == before


@pytest.mark.parametrize("dim,mlp,fused,fused_train", [
    (96, 384, True, True), (192, 768, True, False), (384, 1536, False, False),
    (768, 3072, False, False), (64, 256, False, False), (96, 320, False, False),
    (192, 1536, False, False)])
def test_fused_mlp_route(dim, mlp, fused, fused_train):
    """The shape rule of the fused forward chain (``fuses_mlp``, mirroring
    ``csrc/fused_mlp.cu``'s ``fused_mlp_route``): serving at MS-SiT's stages
    0-1 (dims 96, 192) and SiT-tiny (192) takes it, the training forward at
    dim 96 only; stages 2-3 and SiT-small / -base widths keep the seven
    launches, as do widths or hidden sizes the kernel is not built for."""
    assert tfb.fuses_mlp(dim, mlp) is fused
    assert tfb.fuses_mlp(dim, mlp, train=True) is fused_train


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_grad_reference_matches_jax(dtype):
    """``weight_grad_reference`` (a^T b over the token rows, float32) against
    JAX, at dW_qkv's shape over the edge case's 144 rows."""
    r = np.random.default_rng(13)
    a = (0.01 * r.standard_normal((GEMM_M, 576))).astype(np.float32)
    b = r.standard_normal((GEMM_M, 192)).astype(np.float32)
    got = tfb.weight_grad_reference(*(torch.from_numpy(t).to(getattr(torch, dtype))
                                      for t in (a, b)))
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), _jax_dot(_jnp(a, dtype).T, _jnp(b, dtype)), "float32")


def test_gemm_wrappers_run_the_plain_versions_on_cpu():
    a, w, bias, res = (torch.from_numpy(t).bfloat16() if t.ndim == 2 else torch.from_numpy(t)
                       for t in _gemm_operands(14, 40, 192, 64))
    torch.testing.assert_close(tfb.block_gemm(a, w), tfb.gemm_reference(a, w), atol=0, rtol=0)
    torch.testing.assert_close(tfb.block_gemm(a, w, bias, res),
                               tfb.gemm_reference(a, w, bias, res), atol=0, rtol=0)
    for got, want in zip(tfb.block_gemm(a, w, bias, gelu=True),
                         tfb.gemm_reference(a, w, bias, gelu=True)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    wt = w.t().contiguous()
    torch.testing.assert_close(tfb.block_gemm_nn(w, wt, out_dtype=torch.float32),
                               tfb.gemm_nn_reference(w, wt, out_dtype=torch.float32),
                               atol=0, rtol=0)
    torch.testing.assert_close(tfb.block_weight_grad(a, res.bfloat16()),
                               tfb.weight_grad_reference(a, res.bfloat16()), atol=0, rtol=0)


@pytest.mark.parametrize("offset,rows,error", [
    (0, None, None), (8, None, None), (1, None, ValueError), (4, None, ValueError),
    (0, 8, None), (0, 4, None), (0, 2, None), (0, 1, None),
    (0, 3, NotImplementedError), (0, 5, NotImplementedError), (0, 7, NotImplementedError),
])
def test_check_tma_operands(offset, rows, error):
    """The host checks of what the GEMM engine's TMA loads take: bases on 16
    bytes (a bf16 view ``offset`` values into an aligned buffer) and a CLS
    row count that divides 64."""
    t = torch.zeros(64, dtype=torch.bfloat16)[offset:offset + 16]
    if error is None:
        tfb.check_tma_operands(t, cls_rows=rows)
    else:
        with pytest.raises(error):
            tfb.check_tma_operands(t, cls_rows=rows)


def _cuda_check_args(dim_head=64, heads=1):
    """bf16 block arguments for the CUDA wrappers' checks, reached with CPU
    tensors; every tensor a fresh torch allocation (on 64 bytes)."""
    shape = (B, N, VALID, DIM, heads, dim_head, MLP)
    x = torch.zeros((B, N, DIM), dtype=torch.bfloat16)
    args = [t.clone() for t in _torch_args(_params(0, shape), torch.bfloat16)]
    return x, [a.float() if a.dim() == 1 else a for a in args]


@pytest.mark.parametrize("name", ["ln1_s", "ln1_b", "b_out", "ln2_s", "ln2_b",
                                  "b_fc1", "b_fc2"])
def test_bf16_wrapper_refuses_fp32_vectors_off_16_bytes(name):
    """The engine stages the fp32 biases as float4 (csrc/gemm.cuh), so a
    bias view 4 bytes into its storage would fault on the card: the bf16
    block wrappers refuse it, as the int8 wrapper does, and ``block_gemm``'s
    check (``check_vectors``) refuses it too."""
    x, args = _cuda_check_args()
    tfb._check_cuda_args(x, args, 1, 64, VALID)  # aligned: taken
    i = ORDER.index(name)
    off = torch.zeros(args[i].numel() + 1)[1:]  # 4 bytes into a fresh allocation
    off.copy_(args[i])
    assert off.data_ptr() % 16 == 4 and off.is_contiguous()
    args[i] = off
    with pytest.raises(ValueError, match="16 bytes"):
        tfb._check_cuda_args(x, args, 1, 64, VALID)
    with pytest.raises(ValueError, match="16 bytes"):
        tfb.check_vectors({"bias": (off, off.numel())})


@pytest.mark.parametrize("dim_head,heads,error", [
    (64, 1, None), (32, 2, None), (16, 4, None), (128, 1, None),
    (20, 4, None), (136, 1, None),
])
def test_bf16_wrapper_head_dims(dim_head, heads, error):
    """``fused_block``, its training forward and ``fused_block_bwd``, and the
    CLS block and its backward (one check for both), take every head dim
    the attention kernels take: every dim_head >= 1 (dh 20 in padded heads,
    136 on the wide kernels)."""
    x, args = _cuda_check_args(dim_head, heads)
    if error is None:
        tfb._check_cuda_args(x, args, heads, dim_head, VALID)
    else:
        with pytest.raises(error, match="dim_head"):
            tfb._check_cuda_args(x, args, heads, dim_head, VALID)
