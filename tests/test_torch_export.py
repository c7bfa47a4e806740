"""The port's serving export on the CPU against the JAX package:
``serving/artifact.py`` (``torch.export`` programs), the standalone
``loader.py``, the ``svt::`` operators (``serving/svt_ops.py``: schemas, fake
shapes, the CPU kernels the port registers) and ``cli.export``.

Sizes: JAX's fixture of ``tests/test_serving_artifact.py`` (a float32 SiT of
dim 32, depth 2, 8 patches x 5 vertices, 3 channels), a SiT-small-width
(dim 384) depth-2 bf16 SiT on sub-ico 2 for int8, and the small MS-SiT of
``tests/test_torch_mssit.py`` (ICO 2, LEVEL 1, embed 64, depths (2, 2)).

Tolerances: the plain artifact against JAX's ``export_serving(fused=False)``
on the same weights 1e-5 (float32, the same algorithm in another order; JAX's
own round trip holds 1e-6 against ``apply``); the plain artifact against the
port's own model, and every fused artifact against ``fused_forward`` on the
same weights, bit for bit (the same operators in the same order). On the
card, ``chip_smoke.py`` phase 34 runs the fused artifacts' kernels.
"""

import ast
import importlib.util
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from surface_vision_transformers_tpu.checkpoints import orbax_io
from surface_vision_transformers_tpu.cli import export as jax_export_cli
from surface_vision_transformers_tpu.models import SiT as JaxSiT
from surface_vision_transformers_tpu.serving import export_serving as jax_export_serving
from surface_vision_transformers_tpu.serving import load_serving as jax_load_serving
from surface_vision_transformers_tpu_torch.checkpoints.convert import (
    load_params_npz,
    load_torch_state_dict,
    state_dict_from_jax,
)
from surface_vision_transformers_tpu_torch.cli import export as export_cli
from surface_vision_transformers_tpu_torch.geometry import load_patch_table
from surface_vision_transformers_tpu_torch.models import fused, fused_mssit
from surface_vision_transformers_tpu_torch.models.mssit import MSSiT
from surface_vision_transformers_tpu_torch.models.sit import SiT
from surface_vision_transformers_tpu_torch.ops import fused_block as tfb
from surface_vision_transformers_tpu_torch.ops import fused_block_int8 as tq8
from surface_vision_transformers_tpu_torch.ops import patch_embed as tpe
from surface_vision_transformers_tpu_torch.ops import quant
from surface_vision_transformers_tpu_torch.serving import artifact, svt_ops

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(dim=32, depth=2, heads=2, mlp_dim=64, num_patches=8, num_vertices=5,
             num_channels=3)
TABLE = np.arange(40, dtype=np.int32).reshape(8, 5)  # 8 patches, V=5


@pytest.fixture(scope="module")
def small():
    """(JAX model, its params, the port's float32 SiT on the same weights)."""
    jm = JaxSiT(**SMALL, patch_table=TABLE, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 40)))["params"]
    m = SiT(**SMALL, patch_table=TABLE, dtype=torch.float32)
    m.load_state_dict(state_dict_from_jax(params, SMALL["depth"]), strict=True)
    return jm, params, m.eval()


@pytest.fixture(scope="module")
def plain_dir(small, tmp_path_factory):
    d = tmp_path_factory.mktemp("plain")
    artifact.export_serving(small[2], d, batch_sizes=(2, 4), fused=False,
                            input_dtype=torch.float32)
    return d


def _x(shape, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)).to(dtype)


def _small_bf16(small):
    m = SiT(**SMALL, patch_table=TABLE, dtype=torch.bfloat16)
    m.load_state_dict(small[2].state_dict(), strict=True)
    return m.eval()


def _standalone_env():
    """A subprocess environment whose path holds torch but not the repo."""
    path = [p for p in sys.path if p and Path(p).resolve() != REPO and "repo" not in p]
    return {"PATH": "/usr/bin:/bin", "PYTHONPATH": ":".join(path), "HOME": "/tmp",
            "CUDA_VISIBLE_DEVICES": ""}


# -- the plain artifact against JAX's --------------------------------------------------


@pytest.mark.parametrize("B", [2, 4])
def test_plain_artifact_matches_jax_export(small, plain_dir, tmp_path, B):
    jm, params, m = small
    jax_export_serving(jm, params, tmp_path, batch_sizes=(2, 4), fused=False,
                       input_dtype=jnp.float32)
    x = _x((B, 3, 40), B)
    want = np.asarray(jax_load_serving(tmp_path, B)[0](jnp.asarray(x.numpy())))
    fn, meta = artifact.load_serving(plain_dir, B)
    got = fn(x).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(fn(x), m(x))  # the same aten operators as the model's own forward
    assert meta["input_shape"] == [B, 3, 40] and meta["numerics"] == "plain"


def test_plain_meta_has_jax_keys(small, plain_dir, tmp_path):
    jm, params, _ = small
    want = jax_export_serving(jm, params, tmp_path, batch_sizes=(2, 4), fused=False,
                              input_dtype=jnp.float32)
    got = json.loads((plain_dir / "meta.json").read_text())
    assert set(want) <= set(got)
    assert got["input_dtype"] == want["input_dtype"] == "float32"
    assert {b: m["input_shape"] for b, m in got["batch_sizes"].items()} == \
        {b: m["input_shape"] for b, m in want["batch_sizes"].items()}
    assert got["ops"] == dict.fromkeys(artifact.OPS, 0) and got["library"] is None
    assert not (plain_dir / "svt_ops.py").exists()


def test_loader_is_framework_free(plain_dir):
    """The shipped loader.py runs the artifact with only torch importable:
    in a subprocess whose path excludes the repo."""
    r = subprocess.run([sys.executable, str(plain_dir / "loader.py"), "2"],
                       capture_output=True, text=True, timeout=300, env=_standalone_env(),
                       cwd=str(plain_dir))
    assert r.returncode == 0, r.stderr
    assert "OK" in r.stdout
    r = subprocess.run([sys.executable, "-c", "import surface_vision_transformers_tpu_torch"],
                       capture_output=True, text=True, timeout=300, env=_standalone_env(),
                       cwd=str(plain_dir))
    assert r.returncode != 0  # the package is out of reach there


def test_loader_module_matches(small, plain_dir):
    spec = importlib.util.spec_from_file_location("svt_artifact_loader",
                                                  plain_dir / "loader.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, info = mod.load(2)
    assert info["input_shape"] == [2, 3, 40] and info["device"] == "cpu"
    x = _x((2, 3, 40), 7)
    assert torch.equal(fn(x), small[2](x))
    with pytest.raises(ValueError, match="no artifact for batch size 3"):
        mod.load(3)


def test_unknown_batch_size_errors(plain_dir):
    with pytest.raises(KeyError):
        artifact.load_serving(plain_dir, 3)
    assert json.loads((plain_dir / "meta.json").read_text())["numerics"] == "plain"


def test_quant_rules(small):
    """JAX's rules: int8 below the crossover degrades to bf16 (plain stays
    plain); at the crossover width int8 without the kernels raises."""
    m = small[2]
    assert artifact.make_serving_fn(m, quant="int8", fused=False)[1] == "plain"
    assert artifact.make_serving_fn(_small_bf16(small), quant="int8", fused=True)[1] == \
        "bf16-fused"
    assert artifact.make_serving_fn(m)[1] == "plain"  # fused=None off the card
    wide = SiT(dim=384, depth=1, heads=6, mlp_dim=768, num_patches=8, num_vertices=5,
               num_channels=3, patch_table=TABLE)
    with pytest.raises(ValueError, match="fused"):
        artifact.make_serving_fn(wide, quant="int8", fused=False)
    assert artifact.make_serving_fn(wide, quant="int8", fused=True)[1] == "int8"


# -- fused artifacts: the svt operators -------------------------------------------------


class _OpCalls(TorchDispatchMode):
    """Counts the ``svt::`` operators a call dispatches."""

    def __init__(self):
        super().__init__()
        self.calls = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name.startswith("svt::"):
            self.calls[name] += 1
        return func(*args, **(kwargs or {}))


def _int8_sit():
    m = SiT(dim=384, depth=2, heads=6, mlp_dim=1536, patch_table=load_patch_table(6, 2).indices,
            dtype=torch.bfloat16)
    return m.eval()


def _subico1_sit():
    """A narrow bf16 SiT on the sub-ico-1 table (80 patches of 561 vertices,
    N = 81) at 3 channels: shapes the ETL writes."""
    m = SiT(dim=32, depth=2, heads=2, mlp_dim=64, num_patches=80, num_vertices=561,
            num_channels=3, patch_table=load_patch_table(6, 1).indices, dtype=torch.bfloat16)
    return m.eval()


def _small_mssit():
    table = load_patch_table(2, 1).indices
    return MSSiT(ico=2, patch_level=1, num_vertices=6, embed_dim=64, depths=(2, 2),
                 heads=(2, 4), window=4, global_max=2, patch_table=table,
                 dtype=torch.bfloat16).eval()


@pytest.mark.parametrize("case,quant,want", [
    ("small", None, {"patch_embed": 1, "fused_block": 1, "fused_block_cls": 1}),
    ("int8", "int8", {"patch_embed": 1, "fused_block_int8": 1, "fused_block_cls": 1}),
    ("mssit", None, {"patch_embed": 1, "fused_block": 4}),
    ("mssit", "int8", {"patch_embed": 1, "fused_block": 4}),  # no stage reaches 384
    ("subico1", None, {"patch_embed": 1, "fused_block": 1, "fused_block_cls": 1}),
])
def test_fused_artifact_holds_the_operators_fused_forward_calls(small, tmp_path, case, quant,
                                                                want):
    """A fused artifact traced on the CPU: its graph holds the ``svt::``
    operators ``fused_forward`` (``fused_mssit_forward``) calls, as many
    times, and its outputs are that forward's on the same weights, bit for
    bit, at every listed batch size."""
    torch.manual_seed(0)
    model = {"small": lambda: _small_bf16(small), "int8": _int8_sit, "mssit": _small_mssit,
             "subico1": _subico1_sit}[case]()
    meta = artifact.export_serving(model, tmp_path, batch_sizes=(1, 3), fused=True, quant=quant)
    assert meta["numerics"] == ("int8" if quant else "bf16-fused")
    assert meta["ops"] == {f"svt::{k}": want.get(k, 0) for k in svt_ops.SCHEMAS}
    assert meta["library"] is None and (tmp_path / "svt_ops.py").read_text() == \
        Path(svt_ops.__file__).read_text()
    module, _ = artifact.make_serving_fn(model, quant=quant, fused=True)
    forward = fused_mssit.fused_mssit_forward if case == "mssit" else fused.fused_forward
    G = int(model.patch_table.max()) + 1
    for B in (1, 3):
        x = _x((B, model.num_channels, G), B, torch.bfloat16)
        fn, _ = artifact.load_serving(tmp_path, B)
        with _OpCalls() as calls:
            want_out = forward(model, x, module.weights(), quant=quant)
        assert dict(calls.calls) == {f"svt::{k}": v for k, v in want.items()}
        assert torch.equal(fn(x), want_out)


def test_fused_artifact_equals_the_plain_embedding_within_a_step(small):
    """A fused artifact embeds raw input through ``svt::patch_embed`` on
    either device (``prepare_weights(embed_kernel=True)``); ``predict`` on
    the CPU keeps the plain gather. The two differ by at most one bf16 step
    of the embedding (the bias added before or after rounding), so the
    outputs stay close."""
    m = _small_bf16(small)
    module, _ = artifact.make_serving_fn(m, fused=True)
    x = _x((4, 3, 40), 11, torch.bfloat16)
    a = module(x)
    b = fused.fused_forward(m, x, fused.prepare_weights(m))
    assert module.weights().embed_kernel and not fused.prepare_weights(m).embed_kernel
    torch.testing.assert_close(a, b, atol=0.05, rtol=0.05)


def _block_args(rng, B, N, dim=64, heads=1, mlp=128):
    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    x = r(B, N, dim).bfloat16()
    p = (1 + r(dim, scale=0.1), r(dim, scale=0.1), r(3 * heads * 64, dim, scale=0.1).bfloat16(),
         r(dim, heads * 64, scale=0.1).bfloat16(), r(dim, scale=0.1), 1 + r(dim, scale=0.1),
         r(dim, scale=0.1), r(mlp, dim, scale=0.1).bfloat16(), r(mlp, scale=0.1),
         r(dim, mlp, scale=0.1).bfloat16(), r(dim, scale=0.1))
    return x, p


@pytest.mark.parametrize("op,N", [("fused_block", 9), ("fused_block_cls", 12),
                                  ("fused_block_cls", 8), ("fused_block_cls", 5),
                                  ("fused_block_cls", 4), ("fused_block_cls", 1),
                                  ("fused_block_int8", 7), ("patch_embed", None)])
def test_fake_shapes_equal_the_real_outputs(op, N):
    """Each operator's fake function, which ``torch.export`` traces,
    gives the shape, dtype and device of its CPU kernel's output: the CLS
    block's min(8, N) rows at N < 8 too."""
    rng = np.random.default_rng(3)
    if op == "patch_embed":
        idx = tpe.table_tensor(TABLE, "cpu")
        w, b = tpe.embed_matrix(torch.from_numpy(rng.standard_normal((20, 32)).astype(
            np.float32)), torch.zeros(32), 5)
        args = (_x((3, 4, 40), 1), idx, w, b)
    else:
        x, p = _block_args(rng, 3, N)
        if op == "fused_block_int8":
            q = quant.quantize_block_weights(p[2], p[3], p[7], p[9])
            p = (p[0], p[1], q[0], q[1], q[2], q[3], p[4], p[5], p[6], q[4], q[5], p[8], q[6],
                 q[7], p[10])
        args = (x, *p, 1, 64, N, 1e-5)
    fn = getattr(torch.ops.svt, op)
    real = fn(*args)
    with FakeTensorMode() as mode:
        fake = fn(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    assert (fake.shape, fake.dtype, fake.device) == (real.shape, real.dtype, real.device)
    if op == "fused_block_cls":
        assert real.shape == (3, min(8, N), 64)


def test_operators_run_the_plain_versions_on_the_cpu():
    """The port registers each operator's CPU kernel as its wrapper's plain
    version, so the wrappers give the plain version's bits through the
    operator, and count no launch."""
    rng = np.random.default_rng(4)
    x, p = _block_args(rng, 2, 10)
    before = (tfb.fused_block.launches, tfb.fused_block_cls.launches, sum(svt_ops.launches.values()))
    assert torch.equal(tfb.fused_block(x, *p, heads=1, dim_head=64, valid_len=9),
                       tfb.fused_block_reference(x, *p, heads=1, dim_head=64, valid_len=9))
    assert torch.equal(tfb.fused_block_cls(x, *p, heads=1, dim_head=64),
                       tfb.fused_block_cls_reference(x, *p, heads=1, dim_head=64))
    q = quant.quantize_block_weights(p[2], p[3], p[7], p[9])
    p8 = (p[0], p[1], q[0], q[1], q[2], q[3], p[4], p[5], p[6], q[4], q[5], p[8], q[6], q[7], p[10])
    assert torch.equal(tq8.fused_block_int8(x, *p8, heads=1, dim_head=64),
                       tq8.fused_block_int8_reference(x, *p8, heads=1, dim_head=64))
    assert before == (tfb.fused_block.launches, tfb.fused_block_cls.launches,
                      sum(svt_ops.launches.values()))


def test_standalone_loader_refuses_a_fused_artifact_without_cuda(small, tmp_path):
    artifact.export_serving(_small_bf16(small), tmp_path, batch_sizes=(2,), fused=True)
    r = subprocess.run([sys.executable, str(tmp_path / "loader.py"), "2"],
                       capture_output=True, text=True, timeout=300, env=_standalone_env(),
                       cwd=str(tmp_path))
    assert r.returncode != 0
    assert "CUDA" in r.stderr and "OK" not in r.stdout


def test_svt_ops_stands_alone():
    """``serving/svt_ops.py`` imports torch, ctypes and the standard library
    only: an artifact carries it verbatim to where the package is not."""
    tree = ast.parse(Path(svt_ops.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0] if not node.level else ".")
    assert names <= {"__future__", "collections", "ctypes", "torch"}, names
    assert not any(n.startswith("surface_vision_transformers_tpu") for n in names)


# -- cli.export ---------------------------------------------------------------------------


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.fixture(scope="module")
def params_npz(tmp_path_factory):
    d = tmp_path_factory.mktemp("npz")
    model = JaxSiT(dim=16, depth=1, heads=2, mlp_dim=32, dim_head=8, num_patches=20,
                   num_vertices=15, dtype=jnp.float32)
    orbax_io.save_params_npz(d / "a.npz", model.init(jax.random.PRNGKey(0),
                                                     jnp.zeros((1, 4, 20, 15))))
    return d / "a.npz"


def test_cli_export_roundtrip(params_npz, tmp_path):
    """npz -> reference .pth -> npz through the port's CLI gives the npz
    back, as the JAX CLI does (``tests/test_workflows.py``)."""
    pth, npz2 = tmp_path / "ref.pth", tmp_path / "b.npz"
    export_cli.main(["--src", str(params_npz), "--dst", str(pth), "--depth", "1"])
    export_cli.main(["--src", str(pth), "--dst", str(npz2), "--depth", "1"])
    a, b = dict(_flat(load_params_npz(params_npz))), dict(_flat(load_params_npz(npz2)))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cli_export_pth_equals_jax(params_npz, tmp_path, monkeypatch):
    """The port's .pth from an npz equals the JAX CLI's from the same npz."""
    export_cli.main(["--src", str(params_npz), "--dst", str(tmp_path / "port.pth"),
                     "--depth", "1"])
    monkeypatch.setattr(sys, "argv", ["export", "--src", str(params_npz), "--dst",
                                      str(tmp_path / "jax.pth"), "--depth", "1"])
    jax_export_cli.main()
    got, want = (load_torch_state_dict(tmp_path / n) for n in ("port.pth", "jax.pth"))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)


def test_cli_serve_equals_export_serving(tmp_path):
    """``--serve`` on the CPU writes the artifact ``export_serving`` writes
    for the config's model and weights (the plain one off the card), and
    ``--quant int8 --plain`` on a wide model raises."""
    table = load_patch_table(6, 2).indices
    cfg = {"resolution": {"ico": 6, "sub_ico": 2},
           "transformer": {"dim": 32, "depth": 2, "heads": 2, "mlp_dim": 64, "dim_head": 16},
           "tpu": {"compute_dtype": "float32"}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    torch.manual_seed(0)
    model = SiT(dim=32, depth=2, heads=2, mlp_dim=64, dim_head=16, patch_table=table,
                dtype=torch.float32)
    torch.save(model.state_dict(), tmp_path / "w.pth")
    export_cli.main(["--serve", str(tmp_path / "cli"), "--config", str(tmp_path / "cfg.json"),
                     "--src", str(tmp_path / "w.pth"), "--batch-sizes", "1,2",
                     "--set", "training.bs=8", "--device", "cpu"])
    want = artifact.export_serving(model, tmp_path / "api", batch_sizes=(1, 2),
                                   input_dtype=torch.bfloat16)
    got = json.loads((tmp_path / "cli" / "meta.json").read_text())
    assert {k: v for k, v in got.items() if k != "batch_sizes"} == \
        {k: v for k, v in want.items() if k != "batch_sizes"}
    x = _x((2, 4, 40962), 5, torch.bfloat16)
    a, b = (artifact.load_serving(tmp_path / n, 2)[0] for n in ("cli", "api"))
    assert torch.equal(a(x), b(x)) and torch.equal(a(x), model(x))
    cfg["transformer"].update(dim=384, heads=6, mlp_dim=768)
    (tmp_path / "wide.json").write_text(json.dumps(cfg))
    wide = SiT(dim=384, depth=2, heads=6, mlp_dim=768, dim_head=16, patch_table=table)
    torch.save(wide.state_dict(), tmp_path / "wide.pth")
    with pytest.raises(ValueError, match="fused"):
        export_cli.main(["--serve", str(tmp_path / "q"), "--config", str(tmp_path / "wide.json"),
                         "--src", str(tmp_path / "wide.pth"), "--quant", "int8", "--plain",
                         "--device", "cpu"])
