"""The port's MS-SiT training slice on the CPU against the JAX package: the
attention backward and ``fused_block_train`` at head dim 32 (the kernels'
plain versions here; the JAX Pallas kernels in interpret mode, as the JAX
package's own tests run them), the route rule at MS-SiT's folds,
``fused_mssit_train_forward``, the modular ``MSSiT`` under autograd,
masked-window pretraining (``models.mpp_mssit``, ``fused_mssit_mpp_loss``,
the converter), the trainer and the runner on the two MS-SiT configs, and
the CLIs without JAX.

Size: ICO 2, LEVEL 1 (80 patches x 6 vertices), embed_dim 64, heads (2, 4),
depths (2, 2), window 4, global_max 2: both stages run dh 32, stage 0 folds
into windows of 4 and axially into groups of 20 (N not a multiple of 8),
stage 1 attends globally. Inputs from numpy seeds.

Tolerances, of the largest |reference| value of each output or gradient:
* the attention backward at dh 32: float32 2e-5, bfloat16 two bf16 steps
  (as ``tests/test_torch_mssit.py``'s forward);
* ``fused_block_train``, ``fused_mssit_train_forward`` and the fused MPP
  loss: float32 1e-3, bfloat16 2e-2, the pattern of
  ``tests/test_torch_block_train.py``: the JAX kernels differentiate
  tanh-GELU and the clamped unshifted softmax, the port exact erf-GELU and
  the shifted softmax, and the JAX package rounds its parameter gradients
  to bf16 where the port keeps them float32;
* the modular model and the port's fused path against the JAX modular
  model in float32 (the same function, sums in another order): losses and
  gradients 1e-4 (measured <= 1e-6); the modular model in bfloat16 3e-2
  (measured <= 2.2e-2, every gap above 1e-2 in a bias gradient: a sum over
  every token of bf16 cotangents, rounded at other points by the two
  frameworks);
* trainer runs in float32 against the JAX trainer: losses and MAE 1e-4,
  final parameters within 1e-4 (Adam(W) in float32, sums in another order).
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from surface_vision_transformers_tpu import geometry as G
from surface_vision_transformers_tpu.checkpoints import orbax_io
from surface_vision_transformers_tpu.models import MPPMSSiT as JaxMPPMSSiT
from surface_vision_transformers_tpu.models import MSSiT as JaxMSSiT
from surface_vision_transformers_tpu.models import fused_mssit as jfm
from surface_vision_transformers_tpu.models import mpp_mssit as jmpp
from surface_vision_transformers_tpu.ops.pallas import fused_block as jfb
from surface_vision_transformers_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from surface_vision_transformers_tpu.ops.pallas.flash_attention import (
    flash_attention_qkv as jax_flash_attention_qkv,
)
from surface_vision_transformers_tpu.train import runner as jax_runner
from surface_vision_transformers_tpu.utils.config import from_dict as jax_from_dict
from surface_vision_transformers_tpu_torch.checkpoints.convert import (
    jax_params_from_mpp_mssit_state_dict,
    jax_params_from_mssit_state_dict,
    mpp_mssit_state_dict_from_jax,
    mssit_state_dict_from_jax,
)
from surface_vision_transformers_tpu_torch.models import fused_mssit as tfm
from surface_vision_transformers_tpu_torch.models import mpp_mssit as tmpp
from surface_vision_transformers_tpu_torch.models import mssit as tms
from surface_vision_transformers_tpu_torch.models.sit import DropoutRNG
from surface_vision_transformers_tpu_torch.ops import flash_attention as tfa
from surface_vision_transformers_tpu_torch.ops import fused_block as tfb
from surface_vision_transformers_tpu_torch.train import runner as trunner
from surface_vision_transformers_tpu_torch.train import trainer as ttrainer
from surface_vision_transformers_tpu_torch.utils.config import from_dict, load_config

REPO = Path(__file__).resolve().parent.parent
ICO, LEVEL = 2, 1  # 162 vertices, 80 patches x 6
ARCH = dict(embed_dim=64, depths=(2, 2), heads=(2, 4), window=4, global_max=2)
KW = dict(ico=ICO, patch_level=LEVEL, num_vertices=6, **ARCH)


def _bound(want, dtype):
    m = float(np.abs(want).max())
    return 2e-5 * m if dtype == "float32" else 2 * 2.0 ** (math.floor(math.log2(m)) - 7)


def _rel(a, b):
    """Largest |a - b| over the largest |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- the attention backward at dh 32 -------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,valid", [(8, 8), (20, 20), (20, 13), (64, 64), (64, 50),
                                     (80, 80), (80, 70)])
def test_attention_backward_dh32_matches_jax(dtype, N, valid):
    """``flash_attention``'s backward at dh 32 (the kernel wrapper's plain
    version on CPU tensors) against ``jax.vjp`` of the JAX
    ``flash_attention`` (interpret mode): dq, dk and dv, ragged N and
    valid_len included."""
    r = np.random.default_rng(N + valid)
    q, k, v = (sc * r.standard_normal((2, 3, N, 32)).astype(np.float32) for sc in (1.5, 1.5, 1))
    do = r.standard_normal((2, 3, N, 32)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, valid),
                     *(jnp.asarray(t).astype(jdt) for t in (q, k, v)))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do).astype(jdt))]
    qt, kt, vt = (torch.from_numpy(t).to(tdt).requires_grad_() for t in (q, k, v))
    tfa.flash_attention(qt, kt, vt, valid).backward(torch.from_numpy(do).to(tdt))
    for name, t, w in zip("qkv", (qt, kt, vt), want):
        err = np.abs(t.grad.float().numpy() - w).max()
        assert err <= _bound(w, dtype), (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid", [128, 100])
def test_attention_qkv_backward_dh32_matches_jax(dtype, valid):
    """``flash_attention_qkv`` (the modular MS-SiT's attention) at dh 32:
    dqkv in the packed [dq | dk | dv] layout against the JAX VJP, at the
    JAX kernel's N % 128 == 0."""
    r = np.random.default_rng(valid)
    qkv = r.standard_normal((2, 128, 3 * 3 * 32)).astype(np.float32)
    do = r.standard_normal((2, 128, 96)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda a: jax_flash_attention_qkv(a, 3, valid), jnp.asarray(qkv).astype(jdt))
    want = np.asarray(vjp(jnp.asarray(do).astype(jdt))[0].astype(jnp.float32))
    xt = torch.from_numpy(qkv).to(tdt).requires_grad_()
    tfa.flash_attention_qkv(xt, 3, valid).backward(torch.from_numpy(do).to(tdt))
    assert np.abs(xt.grad.float().numpy() - want).max() <= _bound(want, dtype)


# -- fused_block_train at dh 32 -----------------------------------------------------------

ORDER = ("ln1_s", "ln1_b", "w_qkv", "w_out", "b_out", "ln2_s", "ln2_b",
         "w_fc1", "b_fc1", "w_fc2", "b_fc2")
MATS = ("w_qkv", "w_out", "w_fc1", "w_fc2")
# (dim, heads, B, N): stage 0's width (96 = 3 x 32, ragged against 64-column
# tiles) on an axial-like fold of N = 20 (the JAX path pads it to 24), and
# stage 1's (192) on a window-like fold
BLOCK_SHAPES = {96: (96, 3, 2, 20), 192: (192, 6, 2, 16)}


def _block_params(dim, heads, seed):
    r = np.random.default_rng(seed)
    hd, mlp = heads * 32, 4 * dim

    def u(shape, fan_in, gain=1.0):
        b = gain / np.sqrt(fan_in)
        return r.uniform(-b, b, shape).astype(np.float32)

    def ln():
        return ((1 + 0.1 * r.standard_normal(dim)).astype(np.float32),
                (0.1 * r.standard_normal(dim)).astype(np.float32))

    (s1, b1), (s2, b2) = ln(), ln()
    return dict(ln1_s=s1, ln1_b=b1, w_qkv=u((dim, 3 * hd), dim, 2.0), w_out=u((hd, dim), hd, 4.0),
                b_out=u((dim,), hd), ln2_s=s2, ln2_b=b2, w_fc1=u((dim, mlp), dim),
                b_fc1=u((mlp,), dim), w_fc2=u((mlp, dim), mlp), b_fc2=u((dim,), mlp))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("dim", sorted(BLOCK_SHAPES))
def test_fused_block_train_dh32_matches_jax_vjp(dim, dtype, tol):
    """The port's block backward at dh 32 (``fused_block_train`` on CPU
    tensors: the plain forward and backward) against ``jax.vjp`` of the JAX
    ``fused_block_train`` (interpret mode), which pads N to a multiple of 8
    with valid_len; the port runs the fold unpadded."""
    _, heads, B, N = BLOCK_SHAPES[dim]
    n_pad = -(-N // 8) * 8
    p = _block_params(dim, heads, dim)
    r = np.random.default_rng(dim + 1)
    x = r.standard_normal((B, N, dim)).astype(np.float32)
    g = r.standard_normal((B, N, dim)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    pad = ((0, 0), (0, n_pad - N), (0, 0))
    jargs = [jnp.asarray(p[k]).astype(jdt) if k in MATS else jnp.asarray(p[k]) for k in ORDER]
    out, vjp = jax.vjp(lambda xx, *a: jfb.fused_block_train(xx, *a, heads, 32, N),
                       jnp.asarray(np.pad(x, pad)).astype(jdt), *jargs)
    want = [np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(np.pad(g, pad)).astype(
        out.dtype))]
    want[0] = want[0][:, :N]
    masters = [torch.from_numpy(np.ascontiguousarray(p[k].T) if k in MATS else p[k])
               .requires_grad_() for k in ORDER]
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    tfb.fused_block_train(xt, *masters, heads=heads, dim_head=32).backward(
        torch.from_numpy(g).to(tdt))
    got = [xt.grad.float().numpy()] + [m.grad.numpy().T if k in MATS else m.grad.numpy()
                                       for k, m in zip(ORDER, masters)]
    for name, a, b in zip(("dx",) + ORDER, got, want):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= tol, (name, _rel(a, b))


# (B*groups, N, dim, heads) of every MS-SiT fold at mssit_scan_age.yml, B = 64
MSSIT_FOLDS = [(20480, 64, 96, 3), (4096, 320, 96, 3), (5120, 64, 192, 6), (4096, 80, 192, 6),
               (1280, 64, 384, 12), (4096, 20, 384, 12), (64, 320, 768, 24)]


@pytest.mark.parametrize("fold", MSSIT_FOLDS, ids=lambda f: f"{f[0]}x{f[1]}x{f[2]}")
def test_route_rule_at_mssit_folds_matches_jax(fold):
    """Every MS-SiT fold trains on the chain route (``uses_recompute``
    false: N <= CHAIN_MAX_SEQ_LEN and dim <= 768), where the JAX package
    runs a Pallas backward (``_bwd_kernel_feasible`` or
    ``_split_bwd_feasible`` at its padded N) and never its XLA fallback."""
    _, N, dim, heads = fold
    shape = (-(-N // 8) * 8, dim, 4 * dim, heads * 32, heads)
    mono = jfb._bwd_kernel_feasible(*shape)
    split = (not mono or jfb._prefer_split(dim)) and jfb._split_bwd_feasible(*shape)
    assert mono or split
    assert not tfb.uses_recompute(N, dim)


# -- the fused training forward and the modular model ------------------------------------


@pytest.fixture(scope="module")
def setup():
    """(table, JAX float32 MSSiT params, raw input (4, 4, 162))."""
    table = G.load_patch_table(ICO, LEVEL).indices
    x = np.random.default_rng(0).standard_normal((4, 4, 162)).astype(np.float32)
    params = jax.tree.map(np.asarray, JaxMSSiT(**KW, dtype=jnp.float32, patch_table=table).init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    return table, params, x


def _port(setup, dtype, **kw):
    table, params, _ = setup
    m = tms.MSSiT(**KW, dtype=dtype, patch_table=table, **kw)
    m.load_state_dict(mssit_state_dict_from_jax(params), strict=True)
    return m


def _port_grads(model, loss):
    """{JAX leaf path: gradient in the JAX layout} of ``loss`` over the
    port's MS-SiT parameters."""
    loss.backward()
    return _flat(jax_params_from_mssit_state_dict(
        {k: p.grad for k, p in model.named_parameters()}, model))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("bfloat16", 2e-2)])
def test_fused_train_forward_grads_match_jax(setup, dtype, tol):
    """``fused_mssit_train_forward``'s loss and every parameter gradient
    (sum of squared predictions) against the JAX one (interpret mode)."""
    table, params, x = setup
    jm = JaxMSSiT(**KW, dtype=getattr(jnp, dtype), patch_table=table)

    def jloss(p):
        return jnp.sum(jfm.fused_mssit_train_forward(jm, p, jnp.asarray(x)) ** 2)

    wl, wg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, params))
    model = _port(setup, getattr(torch, dtype))
    loss = (tfm.fused_mssit_train_forward(model, torch.from_numpy(x)) ** 2).sum()
    assert abs(loss.item() - float(wl)) <= tol * abs(float(wl))
    got, want = _port_grads(model, loss), _flat(wg["params"])
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(got[k], want[k]) <= tol, (k, _rel(got[k], want[k]))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_modular_grads_match_jax(setup, dtype, tol):
    """The modular MSSiT under autograd (float32, and bfloat16 as
    ``tpu.fused_train: false`` trains it) against ``MSSiT.apply``'s
    gradients."""
    table, params, x = setup
    jm = JaxMSSiT(**KW, dtype=getattr(jnp, dtype), patch_table=table)
    wl, wg = jax.value_and_grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) ** 2))(
        jax.tree.map(jnp.asarray, params))
    model = _port(setup, getattr(torch, dtype))
    loss = (model(torch.from_numpy(x)) ** 2).sum()
    assert abs(loss.item() - float(wl)) <= tol * abs(float(wl))
    got, want = _port_grads(model, loss), _flat(wg["params"])
    for k in want:
        assert _rel(got[k], want[k]) <= tol, (k, _rel(got[k], want[k]))


@pytest.mark.parametrize("kwarg", [dict(mesh=object()), dict(scan_blocks=True)])
@pytest.mark.parametrize("route", ["train_forward", "mpp_loss"])
def test_fused_training_refuses_unported_modes(setup, route, kwarg):
    """Meshes and ``scan_blocks`` raise on the fused training paths, as on
    the serving one."""
    x = torch.zeros(1, 4, 162)
    with pytest.raises(NotImplementedError):
        if route == "train_forward":
            tfm.fused_mssit_train_forward(_port(setup, torch.bfloat16), x, **kwarg)
        else:
            tfm.fused_mssit_mpp_loss(tmpp.MPPMSSiT(_port(setup, torch.bfloat16)), x,
                                     torch.Generator(), **kwarg)


def test_dropout_takes_the_plain_softmax(setup, monkeypatch):
    """With a ``DropoutRNG`` and dropout > 0 the window attention runs the
    plain softmax with dropout (the JAX route rule takes no kernel then),
    the masks come from the generator (same seed, same output; another
    seed, another), and without an rng the model is deterministic and
    equal to the rate-0 model."""
    _, _, x = setup
    model = _port(setup, torch.float32, dropout=0.1, emb_dropout=0.1)
    called = []
    monkeypatch.setattr(tms, "flash_attention_qkv", lambda *a: called.append(1))
    monkeypatch.setattr(tms, "kernel_route", lambda *a: True)  # as for CUDA bf16
    xt = torch.from_numpy(x)
    a, b = (model(xt, rng=DropoutRNG(s, "cpu")) for s in (1, 1))
    c = model(xt, rng=DropoutRNG(2, "cpu"))
    assert not called and torch.equal(a, b) and not torch.equal(a, c)
    monkeypatch.undo()
    np.testing.assert_array_equal(model(xt).detach().numpy(),
                                  _port(setup, torch.float32)(xt).detach().numpy())


# -- masked-window pretraining -----------------------------------------------------------------


@pytest.fixture(scope="module")
def mpp_setup(setup):
    """(JAX MPPMSSiT, its float32 params, raw input)."""
    table, _, x = setup
    jmpp_model = JaxMPPMSSiT(encoder=JaxMSSiT(**KW, dtype=jnp.float32, patch_table=table),
                             mask_prob=0.5)
    params = jax.tree.map(np.asarray, jmpp_model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), jax.random.PRNGKey(1)))
    return jmpp_model, params, x


def _port_mpp(setup, params, dtype=torch.float32):
    table = setup[0]
    m = tmpp.MPPMSSiT(tms.MSSiT(**KW, dtype=dtype, patch_table=table), mask_prob=0.5)
    trunner.load_model_state(m, mpp_mssit_state_dict_from_jax(params))
    return m


@pytest.mark.parametrize("cfg", [dict(KW), dict(KW, window=16), dict(KW, window=1),
                                 dict(ico=6, patch_level=5, num_vertices=6)])
def test_corruption_window_and_targets_match_jax(setup, cfg):
    """``corruption_window`` equals JAX's, and ``mssit_target_tokens`` is
    bitwise JAX's on raw (with normalisation), pre-patched and flattened
    input."""
    assert tmpp.corruption_window(tms.MSSiT(**cfg)) == jmpp.corruption_window(JaxMSSiT(**cfg))
    table, _, x = setup
    r = np.random.default_rng(1)
    stats = dict(norm_means=r.standard_normal(4).astype(np.float32),
                 norm_stds=(1 + r.random(4)).astype(np.float32))
    jm, tm = (JaxMSSiT(**KW, patch_table=table, **stats),
              tms.MSSiT(**KW, patch_table=table, **stats))
    patched = x[:, :, table]
    flat = np.ascontiguousarray(patched.transpose(0, 2, 3, 1).reshape(4, 80, 24))
    for inp in (x, patched, flat):
        np.testing.assert_array_equal(
            tmpp.mssit_target_tokens(tm, torch.from_numpy(inp)).numpy(),
            np.asarray(jmpp.mssit_target_tokens(jm, jnp.asarray(inp))))


def test_corruption_window_law():
    """The port's corruption (torch generator) keeps the JAX law: a
    window-constant mask with exactly ceil(mask_prob * nW) windows a
    sample, unmasked windows bitwise unchanged, replaced windows the mask
    token on every row; over many samples, the replaced share of the masked
    windows at replace_prob and the share swapped and left unreplaced at
    swap_prob / (1 - replace_prob) * (1 - replace_prob) * (1 - 1 / nW) (a
    window swapped with itself stays), each within four binomial standard
    deviations."""
    B, T, P, W = 512, 80, 24, 4
    mask_prob, replace_prob, swap_prob = 0.75, 0.8, 0.02
    nW = T // W
    target = torch.from_numpy(np.random.default_rng(1).standard_normal((B, T, P)).astype(
        np.float32))
    token = torch.full((1, 1, P), 9.0)
    corrupted, mask, n_masked = tmpp.corrupt_window_sequence(
        target, token, window=W, mask_prob=mask_prob, replace_prob=replace_prob,
        swap_prob=swap_prob, generator=torch.Generator().manual_seed(7))
    assert n_masked == math.ceil(mask_prob * nW)
    wmask = mask.reshape(B, nW, W).numpy()
    assert (wmask == wmask[:, :, :1]).all() and (wmask[:, :, 0].sum(1) == n_masked).all()
    c, t = corrupted.reshape(B, nW, W, P).numpy(), target.reshape(B, nW, W, P).numpy()
    masked = wmask[:, :, 0]
    np.testing.assert_array_equal(c[~masked], t[~masked])
    repl = (c == 9.0).all((2, 3))
    assert not repl[~masked].any()
    swapped = masked & ~repl & ~(c == t).all((2, 3))
    n = masked.sum()
    swap_rate = swap_prob / (1.0 - replace_prob)
    for share, p in ((repl[masked].mean(), replace_prob),
                     (swapped.sum() / n, swap_rate * (1.0 - replace_prob) * (1.0 - 1.0 / nW))):
        assert abs(share - p) <= 4 * math.sqrt(p * (1 - p) / n), (share, p)


def _jax_corruption(jmpp_model, params, x, seed):
    """The corruption the JAX MPP draws from PRNGKey(seed), as numpy."""
    enc = jmpp_model.encoder
    target = jmpp.mssit_target_tokens(enc, jnp.asarray(x))
    c, m, n = jmpp.corrupt_window_sequence(
        jax.random.PRNGKey(seed), target, jnp.asarray(params["params"]["mask_token"]),
        window=jmpp.corruption_window(enc), mask_prob=jmpp_model.mask_prob,
        replace_prob=jmpp_model.replace_prob, swap_prob=jmpp_model.swap_prob)
    return np.array(c), np.array(m), int(n)


@pytest.mark.parametrize("route", ["modular", "fused"])
def test_mpp_loss_on_a_fixed_corruption_matches_jax(setup, mpp_setup, route):
    """The MPP-MS-SiT loss and every gradient on one corruption (JAX's, from
    a PRNG key) against ``MPPMSSiT.apply`` with it through the
    fixed-corruption hook: the port's modular ``MPPMSSiT`` through the same
    hook, and ``fused_mssit_mpp_loss`` (the ``_MaskedMSERecon`` branch: W =
    up = 4) given it, whose float32 plain blocks compute the modular
    function; the fused loss also against the JAX ``fused_mssit_mpp_loss``
    drawing the same key (1e-3: its kernels' tanh-GELU)."""
    jmpp_model, params, x = mpp_setup
    c, m, n = _jax_corruption(jmpp_model, params, x, 11)
    jp = jax.tree.map(jnp.asarray, params)

    def jloss(p):
        return jmpp_model.apply({"params": p}, jnp.asarray(x), fixed_mask=jnp.asarray(m),
                                fixed_corrupted=jnp.asarray(c))[0]

    wl, wg = jax.value_and_grad(jloss)(jp["params"])
    model = _port_mpp(setup, params)
    xt = torch.from_numpy(x)
    if route == "modular":
        loss, _ = model(xt, fixed_mask=torch.from_numpy(m), fixed_corrupted=torch.from_numpy(c))
    else:
        loss = tfm.fused_mssit_mpp_loss(model, xt, corruption=(
            torch.from_numpy(c), torch.from_numpy(m), n))
        fused = jfm.fused_mssit_mpp_loss(jmpp_model, jp, jnp.asarray(x),
                                         jax.random.PRNGKey(11))[0]
        assert abs(loss.item() - float(fused)) <= 1e-3 * abs(float(fused))
    assert abs(loss.item() - float(wl)) <= 1e-4 * abs(float(wl))
    loss.backward()
    state = {k: torch.zeros_like(p) if p.grad is None else p.grad  # a given corruption:
             for k, p in model.named_parameters()}                 # no mask-token gradient
    got = _flat(jax_params_from_mpp_mssit_state_dict(state, model.encoder))
    want = _flat(wg)
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-4, (k, _rel(got[k], want[k]))


@pytest.mark.parametrize("fixed", [False, True], ids=["drawn", "given"])
def test_mpp_sample_weights_denominators_match_jax(setup, mpp_setup, fixed):
    """Under sample weights (the trainer's batch weights, a 0 on a re-read
    row) the loss counts as the JAX ``MPPMSSiT`` does: over the weight sum
    times the masked tokens a sample on a drawn corruption, over the
    weighted masked tokens on a given one. The drawn case feeds both
    packages one corruption through a stand-in for the draw."""
    jmpp_model, params, x = mpp_setup
    c, m, n = _jax_corruption(jmpp_model, params, x, 13)
    w = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    model = _port_mpp(setup, params)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if fixed:
        want = jmpp_model.apply(params, jnp.asarray(x), fixed_mask=jnp.asarray(m),
                                fixed_corrupted=jnp.asarray(c), sample_weights=jnp.asarray(w))[0]
        got = model(xt, fixed_mask=torch.from_numpy(m), fixed_corrupted=torch.from_numpy(c),
                    sample_weights=wt)[0]
    else:
        draws = jax.random.PRNGKey(13)
        want = jmpp_model.apply(params, jnp.asarray(x), draws, sample_weights=jnp.asarray(w))[0]
        model.corrupt = lambda target, generator: (torch.from_numpy(c), torch.from_numpy(m), n)
        got = model(xt, None, sample_weights=wt)[0]
    assert abs(got.item() - float(want)) <= 1e-4 * abs(float(want))


def test_fused_mpp_plain_branch_matches_modular():
    """W = 4 < up = 16 (three stages): the mask varies inside a final
    token's group, so ``fused_mssit_mpp_loss`` takes the plain expression
    under autograd; it equals the modular loss and its gradients on the
    same corruption."""
    table = G.load_patch_table(3, 2).indices  # 320 patches
    enc = tms.MSSiT(ico=3, patch_level=2, num_vertices=6, embed_dim=16, depths=(2, 2, 2),
                    heads=(2, 4, 4), window=4, global_max=2, dtype=torch.float32,
                    patch_table=table)
    torch.manual_seed(0)
    model = tmpp.MPPMSSiT(enc, mask_prob=0.5)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 4, 642)).astype(
        np.float32))
    assert tmpp.corruption_window(enc) % 4 ** (enc.num_stages - 1) != 0
    c, m, n = model.corrupt(model.target(x), torch.Generator().manual_seed(5))
    want, _ = model(x, fixed_mask=m, fixed_corrupted=c.detach())
    got = tfm.fused_mssit_mpp_loss(model, x, corruption=(c, m, n))
    assert abs(got.item() - want.item()) <= 1e-5 * want.item()
    g_fused = torch.autograd.grad(got, list(enc.parameters()) + [model.to_original.weight],
                                  allow_unused=True)
    g_mod = torch.autograd.grad(want, list(enc.parameters()) + [model.to_original.weight],
                                allow_unused=True)
    for a, b in zip(g_fused, g_mod):
        if b is not None:
            assert _rel(a.numpy(), b.numpy()) <= 1e-4


@pytest.mark.parametrize("route", ["modular", "fused"])
def test_mpp_loss_backprops_everywhere(setup, mpp_setup, route):
    """The loss reaches the encoder (every parameter but its head, which
    MPP never runs), the mask token and the decoder, finite."""
    _, params, x = mpp_setup
    model = _port_mpp(setup, params)
    gen = torch.Generator().manual_seed(3)
    xt = torch.from_numpy(x)
    loss = (model(xt, gen)[0] if route == "modular"
            else tfm.fused_mssit_mpp_loss(model, xt, gen))
    loss.backward()
    assert math.isfinite(loss.item())
    for k, p in model.named_parameters():
        if k.startswith(("encoder.head_norm.", "encoder.head.")):
            assert p.grad is None, k
        else:
            assert p.grad is not None and torch.isfinite(p.grad).all(), k
            assert p.grad.abs().sum() > 0, k


def test_mpp_mssit_params_round_trip_bitwise(setup, mpp_setup):
    """JAX MPPMSSiT tree -> port state dict -> JAX tree is bitwise, leaf for
    leaf; the encoder head (absent from the tree) keeps the model's own."""
    _, params, _ = mpp_setup
    model = _port_mpp(setup, params)
    back = jax_params_from_mpp_mssit_state_dict(model.state_dict(), model.encoder)
    want, got = _flat(params["params"]), _flat(back)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


# -- the trainer and the runner on the two MS-SiT configs -------------------------------------

SHRINK = {"resolution": {"ico": ICO, "sub_ico": LEVEL},
          "mssit": {k: list(v) if isinstance(v, tuple) else v for k, v in ARCH.items()}}


def _shrunk(config, root, init_npz, epochs=3, **training):
    """A shipped MS-SiT config cut to the test size: ICO 2 / LEVEL 1 and
    ARCH, a batch of 4 (n == bs: one step an epoch, so shuffling does not
    matter), validation every epoch, float32, initial weights from
    ``init_npz``."""
    raw = yaml.safe_load((REPO / config).read_text())
    raw.update(SHRINK)
    raw["training"].update(bs=4, bs_val=2, epochs=epochs, val_epoch=1, load_weights_ssl=True,
                           **training)
    raw["weights"] = {"ssl_mpp": str(init_npz)}
    raw["logging"] = {"folder_to_save_model": str(root)}
    raw["data"] = {"streaming": "off", "split": "validation"}
    raw["tpu"] = {"compute_dtype": "float32"}
    return raw


def _datasets(seed, n_train=4, n_val=3):
    r = np.random.default_rng(seed)
    d = r.standard_normal((n_train + n_val, 4, 162)).astype(np.float32)
    lab = r.uniform(30, 45, n_train + n_val).astype(np.float32)
    return {"train": (d[:n_train], lab[:n_train]), "validation": (d[n_train:], lab[n_train:])}


def _same_metrics(tdir, jdir):
    """Every epoch's train and val metrics of two run folders within 1e-4."""
    for f in ("metrics_train.csv", "metrics_val.csv"):
        got, want = (np.loadtxt(d / f, delimiter=",", skiprows=1, ndmin=2)[:, 2:]
                     for d in (tdir, jdir))
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=f)


def test_run_training_mssit_matches_jax(setup, tmp_path):
    """``run_training`` on the shrunk ``mssit_scan_age.yml`` (AdamW,
    constant LR) in float32 against the JAX ``run_training`` from the same
    params npz and data: the val MAE of every epoch, the best epoch, the
    final parameters; the files of a run."""
    _, params, _ = setup
    orbax_io.save_params_npz(tmp_path / "init.npz", params)
    ds = _datasets(4)
    cfg = "configs/training/mssit_scan_age.yml"
    want = jax_runner.run_training(jax_from_dict(_shrunk(cfg, tmp_path / "jax",
                                                         tmp_path / "init.npz")),
                                   datasets=ds, progress=False)
    got = trunner.run_training(from_dict(_shrunk(cfg, tmp_path / "torch", tmp_path / "init.npz")),
                               datasets=ds, device="cpu", progress=False)
    assert got["best_epoch"] == want["best_epoch"]
    assert abs(got["best_mae"] - want["best_mae"]) <= 1e-4 * want["best_mae"]
    jdir, tdir = Path(want["run_dir"]), Path(got["run_dir"])
    for f in ("best_params.npz", "final_params.npz", "preds.csv", "hparams_results.yml"):
        assert (tdir / f).exists(), f
    _same_metrics(tdir, jdir)
    a = _flat(orbax_io.load_params_npz(tdir / "final_params.npz"))
    b = _flat(orbax_io.load_params_npz(jdir / "final_params.npz"))
    init = _flat({"params": params["params"]})
    assert a.keys() == b.keys() == init.keys()
    assert max(np.abs(a[k] - init[k]).max() for k in a) > 1e-4  # training moved the weights
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-4, err_msg=k)


def _fixed_corruption_torch(target, mask_token, *, window, mask_prob, replace_prob, swap_prob,
                            generator):
    """A corruption that is a function of each sample's values alone (both
    packages build the same one, in any batch order): with o the count of
    positive values in the sample's first window, window w masked where (w
    + o) % nW < n_masked, replaced by the mask token on even w."""
    B, T, P = target.shape
    nW, n = T // window, math.ceil(mask_prob * (T // window))
    wins = target.reshape(B, nW, window * P)
    w = torch.arange(nW)
    wmask = (w[None, :] + (wins[:, 0] > 0).sum(-1)[:, None]) % nW < n
    repl = wmask & (w[None, :] % 2 == 0)
    token = mask_token.reshape(1, 1, P).to(wins.dtype).repeat(1, 1, window)
    return (torch.where(repl[:, :, None], token, wins).reshape(B, T, P),
            wmask.repeat_interleave(window, dim=1), n)


def _fixed_corruption_jax(key, target, mask_token, *, window, mask_prob, replace_prob, swap_prob):
    B, T, P = target.shape
    nW, n = T // window, math.ceil(mask_prob * (T // window))
    wins = target.reshape(B, nW, window * P)
    w = jnp.arange(nW)
    wmask = (w[None, :] + (wins[:, 0] > 0).sum(-1)[:, None]) % nW < n
    repl = wmask & (w[None, :] % 2 == 0)
    token = jnp.tile(mask_token.reshape(1, 1, P).astype(wins.dtype), (1, 1, window))
    return (jnp.where(repl[:, :, None], token, wins).reshape(B, T, P),
            jnp.repeat(wmask, window, axis=1), n)


def test_run_training_mssit_mpp_matches_jax(setup, mpp_setup, tmp_path, monkeypatch):
    """``run_training`` on the shrunk ``mssit_mpp.yml`` (MPP, AdamW) in
    float32 against the JAX ``run_training`` from the same MPP params npz,
    with both packages' window corruption replaced by one that depends on
    the shapes alone (the two draw from different generators): the val
    loss of every epoch, the final parameters, and the encoder npz the
    finetuning reads."""
    _, params, _ = mpp_setup
    orbax_io.save_params_npz(tmp_path / "init.npz", params)
    monkeypatch.setattr(tmpp, "corrupt_window_sequence", _fixed_corruption_torch)
    monkeypatch.setattr(jmpp, "corrupt_window_sequence", _fixed_corruption_jax)
    ds = _datasets(5)
    cfg = "configs/pretraining/mssit_mpp.yml"
    raw = {side: _shrunk(cfg, tmp_path / side, tmp_path / "init.npz") for side in ("jax", "t")}
    for r in raw.values():
        r["pretraining_mpp"]["mask_prob"] = 0.5
    want = jax_runner.run_training(jax_from_dict(raw["jax"]), datasets=ds, progress=False)
    got = trunner.run_training(from_dict(raw["t"]), datasets=ds, device="cpu", progress=False)
    assert got["best_epoch"] == want["best_epoch"]
    assert abs(got["best_loss"] - want["best_loss"]) <= 1e-4 * want["best_loss"]
    jdir, tdir = Path(want["run_dir"]), Path(got["run_dir"])
    _same_metrics(tdir, jdir)
    for name in ("final_params.npz", "encoder_best_params.npz"):
        a, b = (_flat(orbax_io.load_params_npz(d / name)) for d in (tdir, jdir))
        assert a.keys() == b.keys(), name
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-4, err_msg=f"{name} {k}")


def test_ssl_to_finetune_handoff(setup, mpp_setup, tmp_path):
    """A port MPP run's ``encoder_best_params.npz`` initialises an MS-SiT
    regression run (``training.load_weights_ssl``): every encoder leaf
    shared, the head freshly initialised; the JAX runner reads the same
    npz into its model leaf for leaf."""
    _, params, _ = mpp_setup
    orbax_io.save_params_npz(tmp_path / "init.npz", params)
    ds = _datasets(6)
    mpp_run = trunner.run_training(
        from_dict(_shrunk("configs/pretraining/mssit_mpp.yml", tmp_path / "ssl",
                          tmp_path / "init.npz", epochs=1)),
        datasets=ds, device="cpu", progress=False)
    enc_npz = Path(mpp_run["run_dir"]) / "encoder_best_params.npz"
    enc = _flat(orbax_io.load_params_npz(enc_npz))
    assert enc and not any("head" in k for k in enc)
    raw = _shrunk("configs/training/mssit_scan_age.yml", tmp_path / "ft", enc_npz, epochs=1,
                  LR=0.0)
    exp = from_dict(raw)
    model = trunner.build_model(exp, setup[0])
    head0 = model.head.weight.detach().clone()
    trunner._load_initial_weights(exp, model)
    tree = _flat({"params": jax_params_from_mssit_state_dict(model.state_dict(), model)})
    for k, v in enc.items():
        np.testing.assert_array_equal(tree[k], v, err_msg=k)
    assert torch.equal(model.head.weight, head0)
    sup = JaxMSSiT(**KW, patch_table=setup[0]).init(jax.random.PRNGKey(9), jnp.zeros((1, 4, 162)))
    loaded = orbax_io.load_params_npz(enc_npz)["params"]
    assert jax_runner._count_shared_leaves(sup["params"], loaded) == len(enc)


def test_trainer_routes_mssit_as_jax(setup, monkeypatch):
    """The route rule on MS-SiT: bfloat16 with ``tpu.fused_train`` runs
    ``fused_mssit_train_forward`` (MPP: ``fused_mssit_mpp_loss``); ``tpu.
    fused_train: false``, float32 or dropout the modular model; three bf16
    steps of each route stay within 2e-2 of the float32 losses."""
    _, params, x = setup
    calls = []
    for name in ("fused_mssit_train_forward", "fused_mssit_mpp_loss"):
        real = getattr(ttrainer, name)
        monkeypatch.setattr(ttrainer, name,
                            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    xt = torch.from_numpy(x)
    y = torch.tensor([30.0, 35.0, 40.0, 45.0])
    ones = torch.ones(4)
    losses = {}
    for dtype, fused, dropout in [("float32", True, 0.0), ("bfloat16", True, 0.0),
                                  ("bfloat16", False, 0.0), ("bfloat16", True, 0.1)]:
        raw = {"resolution": {"ico": ICO, "sub_ico": LEVEL}, **SHRINK,
               "transformer": {"model": "MS-SiT", "dropout": dropout},
               "training": {"bs": 4, "LR": 1e-3}, "optimisation": {"optimiser": "AdamW"},
               "tpu": {"compute_dtype": dtype, "fused_train": fused}}
        exp = from_dict(raw)
        model = trunner.build_model(exp, setup[0])
        model.load_state_dict(mssit_state_dict_from_jax(params), strict=True)
        trainer = ttrainer.Trainer(exp, model)
        calls.clear()
        losses[(dtype, fused, dropout)] = [
            float(trainer.optimizer_step(xt, y, ones)[0]) for _ in range(3)]
        want = dtype == "bfloat16" and fused and not dropout
        assert trainer.uses_fused_train() == want
        assert calls == (["fused_mssit_train_forward"] * 3 if want else [])
    ref = losses[("float32", True, 0.0)]
    for key in (("bfloat16", True, 0.0), ("bfloat16", False, 0.0)):
        np.testing.assert_allclose(losses[key], ref, rtol=2e-2)
    mpp_raw = {"SSL": "mpp", "resolution": {"ico": ICO, "sub_ico": LEVEL}, **SHRINK,
               "transformer": {"model": "MS-SiT"}, "training": {"bs": 4},
               "tpu": {"compute_dtype": "bfloat16"}}
    exp = from_dict(mpp_raw)
    trainer = ttrainer.Trainer(exp, trunner.build_model(exp, setup[0]))
    calls.clear()
    trainer.optimizer_step(trainer.mpp_tokens(xt), None, ones)
    assert calls == ["fused_mssit_mpp_loss"]


def test_frozen_decoder_mssit(setup, mpp_setup):
    """``pretraining_mpp.optimize_decoder: false`` on an MS-SiT MPP config
    leaves the decoder and the mask token untouched, as the JAX trainer
    does, while the encoder moves."""
    _, params, x = mpp_setup
    raw = {"SSL": "mpp", "resolution": {"ico": ICO, "sub_ico": LEVEL}, **SHRINK,
           "transformer": {"model": "MS-SiT"}, "training": {"bs": 4, "LR": 1e-3},
           "pretraining_mpp": {"mask_prob": 0.5, "optimize_decoder": False},
           "optimisation": {"optimiser": "AdamW"}, "tpu": {"compute_dtype": "float32"}}
    model = _port_mpp(setup, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = ttrainer.Trainer(from_dict(raw), model)
    trainer.optimizer_step(trainer.mpp_tokens(torch.from_numpy(x)), None, torch.ones(4))
    after = model.state_dict()
    for k in ("mask_token", "to_original.weight", "to_original.bias"):
        assert torch.equal(after[k], before[k]), k
    assert not torch.equal(after["encoder.patch_embedding.weight"],
                           before["encoder.patch_embedding.weight"])


@pytest.mark.parametrize("key,val,match", [("training.load_weights_imagenet", True, "ImageNet")])
def test_run_training_on_mssit_refuses_unported_modes(tmp_path, key, val, match):
    """MS-SiT trains now (under tensor parallelism too:
    ``tests/test_torch_mssit_tp.py``; profiled and under the NaN sanitizer:
    ``tests/test_torch_tail.py``). ImageNet initialisation with a timm file
    given raises: the JAX transfer maps a SiT's blocks only (with the flag
    alone, both packages train from the seeded init)."""
    raw = _shrunk("configs/training/mssit_scan_age.yml", tmp_path, tmp_path / "none.npz")
    block, leaf = key.split(".")
    raw.setdefault(block, {})[leaf] = val
    if leaf == "load_weights_imagenet":
        raw.setdefault("weights", {})["imagenet"] = str(tmp_path / "vit.pth")
    with pytest.raises(NotImplementedError, match=match):
        trunner.run_training(from_dict(raw), device="cpu", datasets={})


def test_full_width_configs_build_the_training_models():
    """The shipped configs build an ``MSSiT`` (regression) and an
    ``MPPMSSiT`` (pretraining, its decoder 768 -> 64 x 24) at full width,
    every stage at dh 32, and ``Trainer`` takes them."""
    for path, cls in (("configs/training/mssit_scan_age.yml", tms.MSSiT),
                      ("configs/pretraining/mssit_mpp.yml", tmpp.MPPMSSiT)):
        exp = load_config(REPO / path)
        model = trunner.build_model(exp)
        assert type(model) is cls
        enc = model.encoder if cls is tmpp.MPPMSSiT else model
        assert enc.stage_dims() == [96, 192, 384, 768]
        assert all(d // h == 32 for d, h in zip(enc.stage_dims(), enc.heads))
        if cls is tmpp.MPPMSSiT:
            assert tuple(model.to_original.weight.shape) == (64 * 24, 768)
            assert tmpp.corruption_window(enc) == 64
            assert exp.mpp.optimize_decoder
        ttrainer.Trainer(exp, model)
