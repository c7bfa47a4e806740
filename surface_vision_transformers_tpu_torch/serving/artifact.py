"""Serving artifacts: the serving step as a ``torch.export`` program.

Counterpart of ``surface_vision_transformers_tpu.serving.artifact`` (which
writes ``jax.export`` blobs): the deployment entry point of the reference
(``tools/testing.py:53-101``: load a checkpoint, run batched inference) as
one exported program with the weights in it, which loads and runs WITHOUT
this package installed, only torch:

    from loader import load
    fn, meta = load(batch_size=8)   # a fused artifact needs CUDA (sm_90)
    out = fn(x)                     # x: meta["input_shape"] in meta["input_dtype"]

``export_serving`` writes ``serve.pt2`` (``torch.export.save``), a
``meta.json`` with the JAX artifact's keys, and the standalone
``loader.py``. The batch dimension is dynamic, from 1 to the largest of
``batch_sizes``: one program serves every listed size, where JAX writes a
blob a size (the weights are stored once). ``loader.load`` refuses a size
that ``meta.json`` does not list, as JAX's does.

Numerics, JAX's rules (``make_serving_fn``): "bf16-fused" (the kernels:
``models.fused.fused_forward`` or ``models.fused_mssit.fused_mssit_forward``
over weights laid out once, held as the program's buffers), "int8" (the same
under ``quant="int8"``; a SiT below ``INT8_MIN_DIM`` serves bf16), or
"plain" (the modular model, JAX's "xla"). A fused program holds the
``svt::`` operators (``serving/svt_ops.py``); traced on CUDA it carries a
verbatim copy of ``svt_ops.py`` and of the kernel library it was built with
(``libsvt_kernels_*.so``), whose sha256 the loader checks, so the artifact
carries its kernels as a Mosaic blob does. A plain program is traced on the
CPU, holds aten operators only, and runs on either device
(``torch.export.passes.move_to_device_pass`` at load).
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import shutil
from pathlib import Path

import torch
from torch import nn

from surface_vision_transformers_tpu_torch.models import fused as _fused
from surface_vision_transformers_tpu_torch.models.mssit import MSSiT
from surface_vision_transformers_tpu_torch.models.sit import SiT
from surface_vision_transformers_tpu_torch.serving import svt_ops

PROGRAM = "serve.pt2"
OPS = tuple(f"{svt_ops.NAMESPACE}::{name}" for name in svt_ops.SCHEMAS)

_LOADER = '''\
"""Standalone serving-artifact loader: needs ONLY torch (no framework).

    from loader import load
    fn, meta = load(batch_size=8)   # device: meta["device"] unless given
    out = fn(x)   # x: meta["input_shape"] in meta["input_dtype"], on that device

A fused artifact runs the hand-written kernels through the svt operators of
the ``svt_ops.py`` beside this file, bound to the kernel library beside it:
it needs CUDA on a card of compute capability 9.0, and a library whose
sha256 is meta.json's. A plain artifact runs on the CPU or, given
``device="cuda"``, on the card.

Self-check: ``python loader.py [batch_size]`` runs the artifact on zeros.
"""

import hashlib
import importlib.util
import json
import pathlib
import sys

import torch

_DIR = pathlib.Path(__file__).resolve().parent


def _kernels(meta):
    """The svt operators bound to this artifact's library, after the checks
    that it can run here."""
    what = f"this artifact's numerics ({meta['numerics']}) run the hand-written kernels"
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: they need CUDA, and torch.cuda.is_available() is False")
    cc = torch.cuda.get_device_capability()
    if tuple(cc) != (9, 0):
        raise RuntimeError(f"{what}: they are built for compute capability 9.0 (sm_90a), "
                           f"the card is {cc[0]}.{cc[1]}")
    lib = meta["library"]
    if lib is None:
        raise RuntimeError(f"{what}, and it carries no kernel library: it was traced "
                           "without CUDA")
    path = _DIR / lib["file"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != lib["sha256"]:
        raise RuntimeError(f"the kernel library {lib['file']} has sha256 {digest}, "
                           f"meta.json says {lib['sha256']}: refusing a changed library")
    ops = sys.modules.get("svt_ops")
    if ops is None:
        spec = importlib.util.spec_from_file_location("svt_ops", _DIR / "svt_ops.py")
        ops = importlib.util.module_from_spec(spec)
        sys.modules["svt_ops"] = ops
        spec.loader.exec_module(ops)
    ops.bind(path)
    return ops


def load(batch_size, device=None):
    meta = json.loads((_DIR / "meta.json").read_text())
    b = str(batch_size)
    if b not in meta["batch_sizes"]:
        raise ValueError(
            f"no artifact for batch size {batch_size}; "
            f"available: {sorted(meta['batch_sizes'], key=int)}"
        )
    m = meta["batch_sizes"][b]
    info = dict(meta, input_shape=m["input_shape"], device=device or meta["device"])
    if meta["numerics"] != "plain":
        info["launches"] = _kernels(meta).launches
    ep = torch.export.load(str(_DIR / m["file"]))
    if torch.device(info["device"]) != torch.device(meta["device"]):
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, info["device"])
    return ep.module(), info


if __name__ == "__main__":
    meta = json.loads((_DIR / "meta.json").read_text())
    bs = sys.argv[1] if len(sys.argv) > 1 else min(meta["batch_sizes"], key=int)
    fn, info = load(bs)
    x = torch.zeros(info["input_shape"], dtype=getattr(torch, info["input_dtype"]),
                    device=info["device"])
    with torch.no_grad():
        y = fn(x)
    print(f"B={bs}: {tuple(x.shape)} {x.dtype} -> {tuple(y.shape)} {y.dtype}  OK")
'''


def _map_tensors(obj, fn, leaf=torch.Tensor):
    """``obj`` (dataclasses, lists and tuples of them) with every ``leaf``
    replaced by ``fn(leaf)``."""
    if isinstance(obj, leaf):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _map_tensors(getattr(obj, f.name), fn, leaf)
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(o, fn, leaf) for o in obj)
    return obj


@dataclasses.dataclass(frozen=True)
class _Buffer:
    name: str


class ServingModule(nn.Module):
    """The fused serving forward of ``model``: ``forward(x)`` is
    ``forward_fn(model, x, weights, quant=quant)``, the prepared weights
    held as this module's buffers (each tensor once), so that an exported
    program carries them. ``model`` is kept outside the module tree: its
    own parameters are not part of the artifact."""

    def __init__(self, model, weights, forward_fn, quant):
        super().__init__()
        self._model = (model,)
        self._forward = forward_fn
        self.quant = quant
        names: dict[int, str] = {}

        def hold(t):
            if id(t) not in names:
                names[id(t)] = f"w{len(names)}"
                self.register_buffer(names[id(t)], t)
            return _Buffer(names[id(t)])

        self._layout = _map_tensors(weights, hold)

    def weights(self):
        """The prepared weights, from the buffers."""
        return _map_tensors(self._layout, lambda b: getattr(self, b.name), _Buffer)

    def forward(self, x):
        return self._forward(self._model[0], x, self.weights(), quant=self.quant)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _fused_by_default(model) -> bool:
    """``fused=None``: a bfloat16 model on the card, as ``predict`` routes."""
    return _model_device(model).type == "cuda" and _fused.serves_fused(model)


def make_serving_fn(model: SiT | MSSiT, *, quant: str | None = None,
                    fused: bool | None = None) -> tuple[nn.Module, str]:
    """The serving forward of ``model`` as a module ``(B, C, G) -> (B,
    num_classes)``, and its numerics: "bf16-fused", "int8" or "plain". The
    JAX package's rules: ``fused=None`` serves fused on CUDA (a bfloat16
    model on the card, as ``predict`` routes) and plain elsewhere; int8
    for a SiT below ``INT8_MIN_DIM`` serves bf16; ``quant`` without fused
    raises. A fused module holds the weights prepared for ``quant`` (raw
    input through ``patch_embed`` on either device); a plain one is the
    model itself, in eval mode."""
    if quant not in _fused.QUANTS:
        raise ValueError(f"unknown quant mode {quant!r}")
    if fused is None:
        fused = _fused_by_default(model)
    if quant == "int8" and isinstance(model, SiT) and model.dim < _fused.INT8_MIN_DIM:
        quant = None  # a wash below the crossover, as the trainer's rule says
    if quant is not None and not fused:
        raise ValueError("quant serving requires the fused (kernel) path")
    model.eval()
    if not fused:
        return model, "plain"
    if isinstance(model, MSSiT):
        from surface_vision_transformers_tpu_torch.models import fused_mssit

        weights = fused_mssit.prepare_mssit_weights(model, quant, embed_kernel=True)
        module = ServingModule(model, weights, fused_mssit.fused_mssit_forward, quant)
    else:
        weights = _fused.prepare_weights(model, quant, embed_kernel=True)
        module = ServingModule(model, weights, _fused.fused_forward, quant)
    return module, ("int8" if quant else "bf16-fused")


def op_counts(program) -> dict:
    """{``svt::`` operator: its calls} in an exported program's graph."""
    counts = dict.fromkeys(OPS, 0)
    for node in program.graph.nodes:
        if node.op == "call_function" and hasattr(node.target, "_schema"):
            name = node.target._schema.name
            if name in counts:
                counts[name] += 1
    return counts


def _sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def export_serving(model: SiT | MSSiT, dst, *, batch_sizes=(1, 8, 256), quant: str | None = None,
                   fused: bool | None = None, input_shape=None,
                   input_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Export the serving step of ``model`` to ``dst/`` for every batch
    size up to the largest of ``batch_sizes`` (a dynamic dimension).

    ``input_shape``: a sample's shape without the batch dimension, by
    default raw-vertex ``(C, G)`` from the model's patch table (what
    ``run_testing`` feeds). A fused program is traced on the model's device
    (on CUDA the kernel library is built first, and copied in with
    ``svt_ops.py``); a plain one on the CPU from a copy of the model. Writes
    ``serve.pt2``, ``meta.json`` and ``loader.py``; returns the meta dict."""
    from surface_vision_transformers_tpu_torch.ops import _native

    dst = Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    sizes = sorted({int(b) for b in batch_sizes})
    if not sizes or sizes[0] < 1:
        raise ValueError(f"batch sizes must be positive, got {list(batch_sizes)}")
    if input_shape is None:
        if model.patch_table is None:
            raise ValueError("model has no patch table; pass input_shape=(C, ...) explicitly "
                             "(pre-patched inputs: (C, L, V))")
        input_shape = (int(model.num_channels), int(model.patch_table.max()) + 1)
    plain = fused is False or (fused is None and not _fused_by_default(model))
    if plain and _model_device(model).type != "cpu":
        model = copy.deepcopy(model).cpu()  # traced on the CPU: aten operators only
    module, numerics = make_serving_fn(model, quant=quant, fused=fused)
    device = _model_device(model)
    example = torch.zeros((min(sizes[-1], 2), *input_shape), dtype=input_dtype, device=device)
    dynamic = None
    if sizes[-1] > 1:
        dynamic = ({0: torch.export.Dim("batch", min=1, max=sizes[-1])},)
    with torch.no_grad():
        program = torch.export.export(module, (example,), dynamic_shapes=dynamic,
                                      strict=False)
    torch.export.save(program, str(dst / PROGRAM))
    library = None
    if numerics != "plain":
        shutil.copyfile(svt_ops.__file__, dst / "svt_ops.py")
        if device.type == "cuda":
            lib = _native.build()
            shutil.copyfile(lib, dst / lib.name)
            library = {"file": lib.name, "sha256": _sha256(dst / lib.name)}
    nbytes = (dst / PROGRAM).stat().st_size
    meta = {
        "framework": "surface_vision_transformers_tpu_torch",
        "model": type(model).__name__,
        "numerics": numerics,
        "platforms": ["cuda"] if numerics != "plain" else ["cpu", "cuda"],
        "input_dtype": str(input_dtype).removeprefix("torch."),
        "batch_sizes": {str(b): {"file": PROGRAM, "input_shape": [b, *map(int, input_shape)],
                                 "bytes": nbytes} for b in sizes},
        "loader": "loader.py",
        "device": str(device),
        "torch": torch.__version__,
        "ops": op_counts(program),
        "library": library,
    }
    (dst / "meta.json").write_text(json.dumps(meta, indent=2))
    (dst / "loader.py").write_text(_LOADER)
    return meta


def load_serving(dst, batch_size, device=None):
    """Load an exported artifact in this package (the shipped ``loader.py``
    does the same with only torch): -> (callable, meta). A fused artifact
    runs through this package's ``svt::`` operators and kernel library. An
    unknown batch size raises ``KeyError``, as the JAX package's does."""
    dst = Path(dst)
    meta = json.loads((dst / "meta.json").read_text())
    m = meta["batch_sizes"][str(batch_size)]
    program = torch.export.load(str(dst / m["file"]))
    device = device or meta["device"]
    if torch.device(device) != torch.device(meta["device"]):
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return program.module(), dict(meta, input_shape=m["input_shape"], device=str(device))
