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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu.ops.pallas import fused_block as jfb
from surface_vision_transformers_tpu_torch.ops import fused_block as tfb

DIM, HEADS, DH, MLP = 32, 2, 16, 64
B, N, VALID = 3, 24, 19
HD = HEADS * DH


def _params(seed=0):
    """Flax-layout block parameters from a numpy seed."""
    r = np.random.default_rng(seed)

    def u(shape, fan_in):
        b = 1 / np.sqrt(fan_in)
        return r.uniform(-b, b, shape).astype(np.float32)

    return dict(
        ln1_s=(1 + 0.1 * r.standard_normal(DIM)).astype(np.float32),
        ln1_b=(0.1 * r.standard_normal(DIM)).astype(np.float32),
        w_qkv=u((DIM, 3 * HD), DIM), w_out=u((HD, DIM), HD),
        b_out=u((DIM,), HD),
        ln2_s=(1 + 0.1 * r.standard_normal(DIM)).astype(np.float32),
        ln2_b=(0.1 * r.standard_normal(DIM)).astype(np.float32),
        w_fc1=u((DIM, MLP), DIM), b_fc1=u((MLP,), DIM),
        w_fc2=u((MLP, DIM), MLP), b_fc2=u((DIM,), MLP),
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


def _x(seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, N, DIM)).astype(np.float32)


KERNELS = {
    "fused_block": (jfb.fused_block, tfb.fused_block_reference, VALID),
    "fused_block_cls": (jfb.fused_block_cls, tfb.fused_block_cls_reference, 8),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_reference_matches_jax_fp32(name):
    jfn, tfn, rows = KERNELS[name]
    p, x = _params(), _x()
    kw = dict(heads=HEADS, dim_head=DH, valid_len=VALID)
    want = np.asarray(jfn(jnp.asarray(x), *_jax_args(p, jnp.float32), **kw))
    got = tfn(torch.from_numpy(x), *_torch_args(p, torch.float32), **kw).numpy()
    assert got.shape == (B, rows if name == "fused_block_cls" else N, DIM)
    np.testing.assert_allclose(got[:, :rows], want[:, :rows], atol=1e-3, rtol=0)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_reference_matches_jax_bf16(name):
    jfn, tfn, rows = KERNELS[name]
    p, x = _params(2), _x(3)
    kw = dict(heads=HEADS, dim_head=DH, valid_len=VALID)
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
