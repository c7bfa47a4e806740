"""W8A8 int8 serving in the port against the JAX package: the quantizers
and the integer product bit for bit, ``fused_block_int8_reference``
against the JAX ``fused_block_int8`` (Pallas interpret mode),
``fused_forward(quant="int8")`` against the JAX ``fused_forward``, and the
crossover rule through ``Trainer.evaluate``, ``run_testing`` and the CLI.

Tolerances:

* quantizer codes and scales, the int32 accumulators and the dequantized
  product: bitwise (the same IEEE divisions, round half to even, exact
  integer sums);
* a block, float32: the port has erf-GELU and the shifted softmax where the
  JAX kernel has tanh-GELU and the clamped unshifted softmax; a GELU output
  3e-4 off can move an activation code by one, so the two int8 blocks sit
  apart by the quantization step, not by rounding. Measured rel-L2 gap
  port vs JAX 4.2e-4 (N=64, valid 50) and 4.9e-4 (N=321); held to 2e-3.
  Both held to test_int8's 0.01 of the float32 block (measured 0.0034-
  0.0035). At SiT-base width (dim 768, fan-in scaled weights) port vs JAX
  measured 1.39e-3 (N=64) and 1.45e-3 (N=130), held to the same 2e-3; the
  int8 block sits 0.0112 / 0.0108 from the float32 block there, JAX's
  exactly as far, so that gap is the function's: the port's is held to
  within 2% of JAX's own;
* the chain's two-pass quantization of f (absmax per 192-column tile, then
  the codes by the scale of their maximum) and the wrapper's plain f codes:
  bitwise against ``quant_rows``;
* the model, float32, through ``state_dict_from_jax``: port vs JAX
  fused_forward rel-L2 measured 8.4e-4 (cls) and 2.3e-4 (mean), held to
  2e-3; both within test_int8's 0.02 of the float32 modular model
  (measured 7.2e-4-1.3e-3), with the same argmax.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu.models import SiT as JaxSiT
from surface_vision_transformers_tpu.models.fused import fused_forward as jax_fused_forward
from surface_vision_transformers_tpu.ops.pallas import fused_block as jfb
from surface_vision_transformers_tpu.ops.pallas import fused_block_int8 as jq
from surface_vision_transformers_tpu_torch.checkpoints.convert import state_dict_from_jax
from surface_vision_transformers_tpu_torch.models import fused as tfused
from surface_vision_transformers_tpu_torch.models.sit import SiT
from surface_vision_transformers_tpu_torch.ops import fused_block as tfb
from surface_vision_transformers_tpu_torch.ops import fused_block_int8 as tq8
from surface_vision_transformers_tpu_torch.ops import quant
from surface_vision_transformers_tpu_torch.train import runner as trunner
from surface_vision_transformers_tpu_torch.train import trainer as trainer_mod
from surface_vision_transformers_tpu_torch.utils.config import from_dict

REPO = Path(__file__).resolve().parent.parent
CFG = dict(dim=32, depth=2, heads=2, mlp_dim=64, dim_head=16, num_patches=320,
           num_vertices=153)
BLOCK_GAP = 2e-3  # port vs JAX int8 block / model, rel-L2
FP32_BLOCK = 0.01  # int8 block vs the float32 block (test_int8's bound)
FP32_MODEL = 0.02  # int8 model vs the float32 modular model (test_int8's bound)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def _half_steps(rng, rows, cols, scale):
    """(rows, cols) float32 whose every row has absmax 127 * scale (so the
    scale is ``scale`` exactly when it is a power of two) and entries on
    half steps k + 0.5 of it, to pin round half to even; row 1 is zero (the
    1e-30 floor)."""
    h = (rng.integers(-126, 126, (rows, cols)) + 0.5) * scale
    h[:, 0] = 127 * scale
    h[1] = 0.0
    return h.astype(np.float32)


@pytest.mark.parametrize("scale", [2.0 ** -7, 1.0, 2.0 ** 5])
def test_weight_quantizer_bitwise(scale):
    rng = np.random.default_rng(0)
    w_in_out = np.concatenate([_half_steps(rng, 48, 64, scale).T,
                               (rng.standard_normal((64, 40)) * scale).astype(np.float32)], 1)
    qj, sj = jq.quantize_weight_int8(jnp.asarray(w_in_out))
    qt, st = quant.quantize_weight_int8(torch.from_numpy(np.ascontiguousarray(w_in_out.T)))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32 and st.shape == (88,)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj).T)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj).reshape(-1))
    assert (qt.numpy()[1] == 0).all() and st.numpy()[1] == np.float32(1e-30) / np.float32(127)
    # half steps: even codes only, in the half-step columns
    assert (np.abs(qt.numpy()[:48, 1:].astype(np.int32)) % 2 == 0).all()


@pytest.mark.parametrize("scale", [2.0 ** -7, 1.0, 3.3])
def test_row_quantizer_bitwise(scale):
    rng = np.random.default_rng(1)
    h = np.concatenate([_half_steps(rng, 40, 96, scale),
                        (rng.standard_normal((24, 96)) * scale).astype(np.float32)])
    qj, sj = jq._quant_rows(jnp.asarray(h))
    qt, st = quant.quant_rows(torch.from_numpy(h))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert np.isfinite(st.numpy()).all() and (qt.numpy()[1] == 0).all()


def test_int8_product_and_mm_bitwise():
    rng = np.random.default_rng(2)
    qa = rng.integers(-127, 128, (64, 3072)).astype(np.int8)  # |acc| up to 5e7 > 2^24
    qa[:4] = 127
    qw = rng.integers(-127, 128, (3072, 48)).astype(np.int8)
    qw[:, :2] = 127
    want = np.asarray(jax.lax.dot_general(jnp.asarray(qa), jnp.asarray(qw),
                                          (((1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32))
    got = quant.int8_product(torch.from_numpy(qa), torch.from_numpy(np.ascontiguousarray(qw.T)))
    assert got.dtype == torch.int32 and np.abs(want).max() > 2 ** 24
    np.testing.assert_array_equal(got.numpy(), want)

    h = rng.standard_normal((64, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 48)) * 0.1).astype(np.float32)
    jw, js = jq.quantize_weight_int8(jnp.asarray(w))
    tw, ts = quant.quantize_weight_int8(torch.from_numpy(np.ascontiguousarray(w.T)))
    np.testing.assert_array_equal(
        quant.int8_mm_reference(torch.from_numpy(h), tw, ts).numpy(),
        np.asarray(jq._int8_mm(jnp.asarray(h), jw, js)))


def _block_weights(rng, dim, heads, dh, mlp, fan_in=False):
    """test_int8's block weights (flax (in, out) layout); with ``fan_in``
    the matrices' std is 1 / sqrt(fan-in) (a model's initial scale) in
    place of 0.1."""
    def mk(*s):
        scale = s[0] ** -0.5 if fan_in and len(s) == 2 else 0.1
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return dict(ln1_s=mk(dim) + 1, ln1_b=mk(dim), w_qkv=mk(dim, 3 * heads * dh),
                w_out=mk(heads * dh, dim), b_out=mk(dim), ln2_s=mk(dim) + 1, ln2_b=mk(dim),
                w_fc1=mk(dim, mlp), b_fc1=mk(mlp), w_fc2=mk(mlp, dim), b_fc2=mk(dim))


# (dim, heads, dim_head, mlp): test_int8's narrow block and SiT-base's width
WIDTHS = {"narrow": (32, 2, 16, 64), "base": (768, 12, 64, 3072)}
FUNCTION_GAP = 0.02  # SiT-base width: the port's int8-vs-fp32 gap within 2% of JAX's own


@pytest.mark.parametrize("n,valid,n_jax,width", [
    pytest.param(64, 50, 64, "narrow", id="64-50-64"),
    pytest.param(321, 321, 328, "narrow", id="321-321-328"),
    pytest.param(64, 50, 64, "base", id="base-64-50-64"),
    pytest.param(130, 129, 136, "base", id="base-130-129-136"),
])
def test_fused_block_int8_reference_matches_jax(n, valid, n_jax, width):
    rng = np.random.default_rng(3)
    B, (dim, heads, dh, mlp) = 2, WIDTHS[width]
    w = _block_weights(rng, dim, heads, dh, mlp, fan_in=width == "base")
    x = rng.standard_normal((B, n_jax, dim)).astype(np.float32)
    x[:, n:] = 0.0  # the JAX package's padding rows
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    qs = jq.quantize_block_weights(jw["w_qkv"], jw["w_out"], jw["w_fc1"], jw["w_fc2"])
    kw = dict(heads=heads, dim_head=dh, valid_len=valid)
    want = np.asarray(jq.fused_block_int8(
        jnp.asarray(x), jw["ln1_s"], jw["ln1_b"], qs[0], qs[1], qs[2], qs[3], jw["b_out"],
        jw["ln2_s"], jw["ln2_b"], qs[4], qs[5], jw["b_fc1"], qs[6], qs[7], jw["b_fc2"],
        **kw))[:, :valid]
    fp32_jax = np.asarray(jfb.fused_block(
        jnp.asarray(x), *(jw[k] for k in ("ln1_s", "ln1_b", "w_qkv", "w_out", "b_out", "ln2_s",
                                           "ln2_b", "w_fc1", "b_fc1", "w_fc2", "b_fc2")),
        **kw))[:, :valid]

    t = {k: torch.from_numpy(np.ascontiguousarray(v.T) if v.ndim == 2 else v)
         for k, v in w.items()}
    q = quant.quantize_block_weights(t["w_qkv"], t["w_out"], t["w_fc1"], t["w_fc2"])
    params = (t["ln1_s"], t["ln1_b"], q[0], q[1], q[2], q[3], t["b_out"], t["ln2_s"],
              t["ln2_b"], q[4], q[5], t["b_fc1"], q[6], q[7], t["b_fc2"])
    xt = torch.from_numpy(x[:, :n].copy())
    got = tq8.fused_block_int8_reference(xt, *params, **kw).numpy()[:, :valid]
    # the dispatching wrapper takes the plain version on the CPU
    np.testing.assert_array_equal(tq8.fused_block_int8(xt, *params, **kw).numpy()[:, :valid], got)
    fp32 = tfb.fused_block_reference(
        xt, *(t[k] for k in ("ln1_s", "ln1_b", "w_qkv", "w_out", "b_out", "ln2_s", "ln2_b",
                             "w_fc1", "b_fc1", "w_fc2", "b_fc2")), **kw).numpy()[:, :valid]
    assert np.isfinite(got).all()
    assert _rel(got, want) < BLOCK_GAP
    if width == "narrow":
        assert _rel(got, fp32) < FP32_BLOCK and _rel(want, fp32_jax) < FP32_BLOCK
    else:  # the quantization's own gap at this width: the function's, as large in JAX
        assert abs(_rel(got, fp32) - _rel(want, fp32_jax)) < FUNCTION_GAP * _rel(want, fp32_jax)


@pytest.mark.parametrize("tile,cols", [(192, 3072), (192, 576), (192, 200), (64, 96)])
def test_quant_rows_from_tile_partials_bitwise(tile, cols):
    """fc1's two passes in plain form: each row's absmax per ``tile``
    columns, then the codes by the scale of their maximum, equal
    ``quant_rows`` (a zero row, half steps, a ragged last tile)."""
    rng = np.random.default_rng(4)
    h = np.concatenate([_half_steps(rng, 24, cols, 2.0 ** -3),
                        (rng.standard_normal((40, cols)) * 3.3).astype(np.float32)])
    h[30, cols - 1] = 1e3  # the row's absmax in the last tile
    ht = torch.from_numpy(h)
    part = quant.row_absmax_partials(ht, tile)
    assert part.shape == (-(-cols // tile), 64) and part.dtype == torch.float32
    q, s = quant.quant_rows_from_partials(ht, part)
    qp, sp = quant.quant_rows(ht)
    np.testing.assert_array_equal(q.numpy(), qp.numpy())
    np.testing.assert_array_equal(s.numpy(), sp.reshape(-1).numpy())
    assert s.numpy()[1] == np.float32(1e-30) / np.float32(127) and (q.numpy()[1] == 0).all()
    qj, sj = jq._quant_rows(jnp.asarray(h))  # and the JAX quantizer's
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))


def test_fc1_codes_reference_is_quant_rows_of_f():
    """The plain f codes the kernel is held to: quant_rows of the plain
    int8 block's f (erf-GELU of the dequantized fc1 product + bias)."""
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.standard_normal((70, 96)).astype(np.float32))
    qa, sa = quant.quant_rows(h)
    qw, sw = quant.quantize_weight_int8(
        torch.from_numpy((rng.standard_normal((400, 96)) * 0.1).astype(np.float32)))
    bias = torch.from_numpy(rng.standard_normal(400).astype(np.float32))
    q, s = tq8.fc1_codes_reference(qa, sa.reshape(-1), qw, sw, bias)
    f = torch.nn.functional.gelu(quant.int8_mm_reference(h, qw, sw) + bias)
    qp, sp = quant.quant_rows(f)
    assert q.dtype == torch.int8 and s.shape == (70,)
    np.testing.assert_array_equal(q.numpy(), qp.numpy())
    np.testing.assert_array_equal(s.numpy(), sp.reshape(-1).numpy())


def test_int8_workspace_holds_no_float32_f():
    """The chain's scratch: f only as int8 codes, one absmax partial per row
    and 192-column tile; at SiT-base bs 64 about half of what the chain
    with f in fp32 took."""
    M, dim, hd, mlp = 64 * 1281, 768, 768, 3072
    ws = tq8.int8_workspace(M, dim, hd, mlp)
    assert list(ws) == ["qa", "sa", "qf", "sf", "part", "qkv", "attn", "x1"]
    assert ws["qf"] == ((M, mlp), torch.int8) and ws["part"] == ((16, M), torch.float32)
    assert not any(shape[-1] == mlp and dt == torch.float32 for shape, dt in ws.values())
    assert ws["x1"] == ((M, dim), torch.float32) and ws["qa"] == ((M, dim), torch.int8)
    total = sum(np.prod(shape) * torch.empty((), dtype=dt).element_size()
                for shape, dt in ws.values())
    # the fp32-f chain's scratch: codes (M, mlp), scales, qkv, attn, x1 and f in fp32
    fp32_f = M * (mlp + 4 + 2 * 3 * hd + 2 * hd + 4 * dim + 4 * mlp)
    assert total < 0.55 * fp32_f  # 1.08 GB against 2.02 GB
    assert tq8.int8_workspace(10, 192, 192, 200)["part"][0] == (2, 10)  # a ragged last tile


def test_int8_wrapper_argument_checks():
    """What the CUDA wrapper takes and refuses, reached with CPU tensors:
    dim or mlp off 16 taken (the chain lays the rows out padded,
    ``svt_ops.pad_int8_dims``), a head width the
    attention kernels do not take (a multiple of 8 from 8 to 128: 32, MS-SiT's,
    and 48 are taken, 20 is not), a bad valid_len, non-int8 codes, a bias
    off 16 bytes; the part wrappers take CUDA tensors only."""
    rng = np.random.default_rng(6)

    def params(dim, heads, mlp):
        t = {k: torch.from_numpy(np.ascontiguousarray(v.T) if v.ndim == 2 else v)
             for k, v in _block_weights(rng, dim, heads, 64, mlp).items()}
        q = quant.quantize_block_weights(t["w_qkv"], t["w_out"], t["w_fc1"], t["w_fc2"])
        return (t["ln1_s"], t["ln1_b"], q[0], q[1], q[2], q[3], t["b_out"], t["ln2_s"],
                t["ln2_b"], q[4], q[5], t["b_fc1"], q[6], q[7], t["b_fc2"])

    x = torch.zeros((2, 10, 192), dtype=torch.bfloat16)
    tq8._check_cuda_args(x, params(192, 3, 768), 3, 64, 10)  # SiT-tiny width: taken
    tq8._check_cuda_args(torch.zeros((2, 10, 200), dtype=torch.bfloat16),
                         params(200, 3, 768), 3, 64, 10)  # dim off 16: taken
    tq8._check_cuda_args(x, params(192, 3, 760), 3, 64, 10)  # mlp off 16: taken
    tq8._check_cuda_args(x, params(192, 3, 768), 6, 32, 10)  # dh 32: taken
    tq8._check_cuda_args(x, params(192, 3, 768), 4, 48, 10)  # dh 48: taken
    # 4 x 20: padded heads, and heads x dh = 80 off 16 (the chain pads the rows)
    p20 = {k: torch.from_numpy(np.ascontiguousarray(v.T) if v.ndim == 2 else v)
           for k, v in _block_weights(rng, 192, 4, 20, 768).items()}
    q20 = quant.quantize_block_weights(p20["w_qkv"], p20["w_out"], p20["w_fc1"], p20["w_fc2"])
    tq8._check_cuda_args(x, (p20["ln1_s"], p20["ln1_b"], *q20[:4], p20["b_out"], p20["ln2_s"],
                             p20["ln2_b"], q20[4], q20[5], p20["b_fc1"], q20[6], q20[7],
                             p20["b_fc2"]), 4, 20, 10)
    with pytest.raises(ValueError, match="valid_len"):
        tq8._check_cuda_args(x, params(192, 3, 768), 3, 64, 11)
    with pytest.raises(TypeError, match="bfloat16"):
        tq8._check_cuda_args(x.float(), params(192, 3, 768), 3, 64, 10)
    p = list(params(192, 3, 768))
    p[2] = p[2].float()
    with pytest.raises(ValueError, match="q_qkv must be int8"):
        tq8._check_cuda_args(x, tuple(p), 3, 64, 10)
    p = list(params(192, 3, 768))
    p[6] = torch.zeros(193)[1:]  # b_out off 16 bytes: the scales and biases load as float4
    with pytest.raises(ValueError, match="on 16 bytes"):
        tq8._check_cuda_args(x, tuple(p), 3, 64, 10)
    qa = torch.zeros((8, 192), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tq8.quant_rows_kernel(torch.zeros((8, 192)))
    with pytest.raises(ValueError, match="CUDA int8"):
        tq8.int8_gemm_kernel(qa, qa)
    with pytest.raises(ValueError, match="CUDA int8"):
        tq8.fc1_codes_kernel(qa, torch.ones(8), qa, torch.ones(8), torch.zeros(8))


@pytest.fixture(scope="module")
def jax_model_params():
    m = JaxSiT(dtype=jnp.float32, **CFG)
    x = jnp.zeros((1, 4, 320, 153))
    return jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0), x))


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_fused_forward_int8_matches_jax(jax_model_params, pool):
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (4, 4, 320, 153)))
    jm = JaxSiT(dtype=jnp.float32, pool=pool, **CFG)
    want = np.asarray(jax_fused_forward(jm, jax_model_params, jnp.asarray(x), quant="int8"))
    model = SiT(dtype=torch.float32, pool=pool, **CFG)
    model.load_state_dict(state_dict_from_jax(jax_model_params, CFG["depth"]), strict=True)
    model.eval()
    w = tfused.prepare_weights(model, "int8")
    n_int8 = CFG["depth"] - (pool == "cls")
    assert [len(b) for b in w.blocks] == [15] * n_int8 + [11] * (CFG["depth"] - n_int8)
    got = tfused.fused_forward(model, torch.from_numpy(x), w, quant="int8").numpy()
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    assert _rel(got, want) < BLOCK_GAP
    assert _rel(got, ref) < FP32_MODEL and _rel(want, ref) < FP32_MODEL
    assert (got.argmax(-1) == ref.argmax(-1)).all()
    with pytest.raises(ValueError, match="prepared for quant='int8'"):
        tfused.fused_forward(model, torch.from_numpy(x), w)


def test_resolve_quant_crossover(capsys, monkeypatch):
    assert tfused.INT8_MIN_DIM == 384  # the JAX package's crossover
    assert tfused.resolve_quant("none", 768) is None
    assert tfused.resolve_quant("int8", 384) == "int8"
    assert tfused.resolve_quant("int8", 192) is None
    assert "int8" in capsys.readouterr().out
    assert tfused.resolve_quant("int8", 192, notice=False) is None
    assert capsys.readouterr().out == ""
    with pytest.raises(ValueError):
        tfused.resolve_quant("int4", 768)
    monkeypatch.setattr(tfused, "INT8_MIN_DIM", 1)
    assert tfused.resolve_quant("int8", 32) == "int8"


def _regression_cfg(**tpu):
    return from_dict({"resolution": {"ico": 6, "sub_ico": 2},
                      "transformer": {"dim": 32, "depth": 2, "heads": 2, "mlp_dim": 64,
                                      "dim_head": 16},
                      "training": {"bs": 2, "bs_val": 2}, "tpu": tpu})


def test_trainer_evaluate_hands_quant_to_fused_forward(monkeypatch, capsys):
    """``tpu.quant: int8`` reaches ``fused_forward(quant=...)`` from the
    config alone; below the crossover the trainer serves bf16 and says so
    once (the JAX test_config_quant_key_reaches_infer)."""
    exp = _regression_cfg(quant="int8", compute_dtype="bfloat16")
    seen = []
    real = trainer_mod.fused_forward

    def spy(model, x, weights=None, **kw):
        seen.append(kw.get("quant"))
        return real(model, x, weights, **kw)

    monkeypatch.setattr(trainer_mod, "fused_forward", spy)
    torch.manual_seed(0)
    model = SiT.from_config(exp)
    x = torch.randn(3, 4, 320, 153)
    y = torch.full((3,), 35.0)
    tr = trainer_mod.Trainer(exp, model)
    m, preds = tr.evaluate(x, y)
    assert seen and set(seen) == {None} and "int8" in capsys.readouterr().out
    tr.evaluate(x, y)
    assert capsys.readouterr().out == ""  # the notice is printed once
    assert np.isfinite(preds).all() and np.isfinite(m.mae)

    monkeypatch.setattr(tfused, "INT8_MIN_DIM", 1)
    seen.clear()
    m8, preds8 = trainer_mod.Trainer(exp, model).evaluate(x, y)
    assert seen and set(seen) == {"int8"} and np.isfinite(preds8).all()
    assert not np.array_equal(preds8, preds)


def _split(d: Path, n: int, seed: int):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    np.save(d / "validation_data.npy", rng.standard_normal((n, 4, 40962)).astype(np.float32))
    np.save(d / "validation_labels.npy", rng.uniform(30, 45, n).astype(np.float32))


def _testing_cfg(data_dir, ckpt, quant_mode):
    """A bfloat16 serving config: ``tpu.quant`` reaches only the fused
    route, which serves bfloat16 (float32 serves the modular model)."""
    return {"resolution": {"ico": 6, "sub_ico": 2},
            "transformer": {"dim": 32, "depth": 2, "heads": 2, "mlp_dim": 64, "dim_head": 16},
            "training": {"bs": 4, "bs_val": 2},
            "data": {"data_path": str(data_dir), "split": "validation"},
            "testing": {"path_to_ckpt": str(ckpt)},
            "tpu": {"compute_dtype": "bfloat16", "quant": quant_mode}}


@pytest.fixture
def served(tmp_path, jax_model_params):
    from surface_vision_transformers_tpu.checkpoints import orbax_io

    _split(tmp_path / "data", 3, 7)
    orbax_io.save_params_npz(tmp_path / "best_params.npz", jax_model_params)
    return lambda q: from_dict(_testing_cfg(tmp_path / "data", tmp_path / "best_params.npz", q))


def test_run_testing_int8_below_crossover_serves_bf16(served, capsys):
    """SiT-tiny-narrow (dim 32 < 384) with ``tpu.quant: int8``: the result
    of ``tpu.quant: none`` and one notice (the JAX rule)."""
    plain = trunner.run_testing(served("none"), device="cpu")
    assert "int8" not in capsys.readouterr().out
    got = trunner.run_testing(served("int8"), device="cpu")
    assert capsys.readouterr().out.count("int8") == 1
    assert got == plain


def test_run_testing_int8_past_crossover_runs_int8_blocks(served, monkeypatch):
    monkeypatch.setattr(tfused, "INT8_MIN_DIM", 1)
    calls = []
    real = tfused.fused_block_int8
    monkeypatch.setattr(tfused, "fused_block_int8",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    plain = trunner.run_testing(served("none"), device="cpu")
    assert not calls
    got = trunner.run_testing(served("int8"), device="cpu")
    assert len(calls) == 2 * 1  # two batches of bs_val 2, one int8 block each (CLS last)
    assert got["n"] == 3 and np.isfinite(got["mae"]) and got["mae"] != plain["mae"]
    assert abs(got["mae"] - plain["mae"]) < 0.05 * plain["mae"]


_NO_JAX = ("import sys\n"
           "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
           "'orbax.checkpoint', 'surface_vision_transformers_tpu'):\n"
           "    sys.modules[m] = None\n")


def test_cli_test_int8_without_jax(tmp_path, jax_model_params):
    """``cli.test --set tpu.quant=int8`` with JAX blocked, the crossover
    patched down so that the narrow model takes the int8 blocks."""
    import yaml

    from surface_vision_transformers_tpu.checkpoints import orbax_io

    _split(tmp_path / "data", 3, 8)
    orbax_io.save_params_npz(tmp_path / "best_params.npz", jax_model_params)
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(yaml.safe_dump(_testing_cfg(tmp_path / "data", tmp_path / "best_params.npz",
                                               "none")))
    code = _NO_JAX + (
        "import runpy\n"
        "import surface_vision_transformers_tpu_torch.models.fused as f\n"
        "f.INT8_MIN_DIM = 1\n"
        "real, n = f.fused_block_int8, []\n"
        "f.fused_block_int8 = lambda *a, **k: n.append(1) or real(*a, **k)\n"
        f"sys.argv = ['test', {str(cfg)!r}, '--device', 'cpu', '--set', 'tpu.quant=int8']\n"
        "runpy.run_module('surface_vision_transformers_tpu_torch.cli.test', run_name='__main__')\n"
        "print('int8 blocks', len(n))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert "'mae'" in lines[-2] and lines[-1] == "int8 blocks 2"
