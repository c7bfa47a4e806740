"""The device mesh and its placement rules (counterpart of
``surface_vision_transformers_tpu.parallel.mesh``) over torch.distributed.

A run under a mesh computes what the single-process run of the same global
batch computes. The mesh is a ``DeviceMesh`` of the world's ranks with axes

    ('data', 'fsdp', 'model'[, 'pipe'])

('pipe' only where ``pipe > 1``, as in the JAX package, so meshes without
a pipeline keep their three axes). The batch is split over ('data',
'fsdp'): every rank draws what the single process draws (epoch order,
corruption, augmentation, dropout masks) and keeps its rows
(``Layout.batch_index_of``). Parameters are replicated on 'data', sharded
on dim 0 by FSDP2 (``fully_shard``) on 'fsdp', and split Megatron-style on
'model' (``parallel.tp``): the packed qkv and fc1 by their output features,
the out-projection and fc2 by their input features, so each residual branch
ends in one all-reduce. Under ``tpu.seq_sharding`` the 'model' axis splits
the tokens instead (``parallel.seq``) and the parameters stay whole there.
'pipe' holds contiguous stages of the blocks (``parallel.pipeline``).
FSDP is a batch axis beside each of them, as in the JAX package: under
TP or sequence sharding FSDP2 shards each 'model' rank's parameters (its TP
slices, or the whole ones) over the ('data', 'fsdp') ranks at its 'model'
coordinate, and in a pipeline a stage's over the ranks at its 'pipe'
coordinate. ``Layout`` holds a mesh's coordinates and process groups for
the trainer.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import warnings
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from surface_vision_transformers_tpu_torch.parallel.multihost import process_count

AXES = ("data", "fsdp", "model")
PIPE = "pipe"  # the fourth axis, present where mesh_pipe > 1


def batch_axes(mesh) -> tuple:
    """The mesh's batch axes, ('data', 'fsdp') where present."""
    return tuple(a for a in ("data", "fsdp") if a in (mesh.mesh_dim_names or ()))


def make_mesh(data: int = -1, fsdp: int = 1, model: int = 1, pipe: int = 1, devices=None,
              device_type: str | None = None):
    """The ('data', 'fsdp', 'model') ``DeviceMesh`` over the first
    data * fsdp * model * pipe ranks, with a fourth axis 'pipe' where
    ``pipe > 1``. ``data=-1`` takes every rank the other axes leave;
    ``devices`` is a rank count or a sequence of ranks (default: the world).
    ``device_type`` defaults to 'cuda', which raises where CUDA is not
    available (as a CUDA device request does everywhere in the port): a CPU
    mesh is asked for by name. Needs torch.distributed initialised
    (``initialize_multihost``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if devices is None:
        n = process_count()
    else:
        n = devices if isinstance(devices, int) else len(list(devices))
    rest = fsdp * model * pipe
    if data == -1:
        if n % rest:
            raise ValueError(f"{n} devices not divisible by fsdp*model*pipe={rest}")
        data = n // rest
    if data * rest > n:
        raise ValueError(f"mesh {data}x{fsdp}x{model}x{pipe} > {n} devices")
    if data * rest < n:
        # legal, but never silent: idle ranks must be a visible choice
        warnings.warn(f"mesh {data}x{fsdp}x{model}x{pipe} uses {data * rest} of {n} "
                      f"devices; set mesh_data=-1 to consume the rest", stacklevel=2)
    if device_type is None:
        device_type = "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh requested but torch.cuda.is_available() is False "
                           "(pass device_type='cpu' for a CPU mesh)")
    if pipe > 1:
        return init_device_mesh(device_type, (data, fsdp, model, pipe),
                                mesh_dim_names=AXES + (PIPE,))
    return init_device_mesh(device_type, (data, fsdp, model), mesh_dim_names=AXES)


def _key(cfg, name: str, default: int) -> int:
    if isinstance(cfg, dict):
        return int(cfg.get(name, default))
    return int(getattr(cfg, name, default))


def mesh_from_config(tpu_cfg, devices=None, device_type: str | None = None):
    """The run's mesh from the ``tpu.mesh_{data,fsdp,model,pipe}`` keys (an
    ``Experiment``, or the raw ``tpu`` dict); None when the run is one
    process and asks for no sharding, so that case runs as before."""
    n = process_count() if devices is None else (
        devices if isinstance(devices, int) else len(list(devices)))
    data = _key(tpu_cfg, "mesh_data", -1)
    fsdp = _key(tpu_cfg, "mesh_fsdp", 1)
    model = _key(tpu_cfg, "mesh_model", 1)
    pipe = _key(tpu_cfg, "mesh_pipe", 1)
    if fsdp == 1 and model == 1 and pipe == 1 and data in (-1, 1) and n == 1:
        return None
    return make_mesh(data=data, fsdp=fsdp, model=model, pipe=pipe, devices=devices,
                     device_type=device_type)


def mesh_shape(mesh) -> dict:
    """{'data': d, 'fsdp': f, 'model': m[, 'pipe': p]} of a mesh (the JAX
    results key)."""
    return {name: int(size) for name, size in zip(mesh.mesh_dim_names, mesh.mesh.shape)}


# -- parameter placement --------------------------------------------------------

# Megatron-style TP by module name (JAX ``_TP_RULES``; torch Linear weights
# are (out, in), JAX kernels (in, out)): qkv (``to_qkv``) and fc1 (``net.0``)
# split their output features, the out-projection (a SiT's ``to_out.0``, an
# MS-SiT window attention's ``to_out``) and fc2 (``net.3``) their input
# features, the MPP decoders (``to_original``) their output features. The
# packed qkv splits each of q, k and v by whole heads: the rank's rows are a
# (3, H, dh, dim) view's [:, heads of the rank], the out-projection's
# columns the same heads'.
TP_RULES: list[tuple[str, int]] = [
    ("to_qkv.weight", 0),
    ("to_out.0.weight", 1),
    ("to_out.weight", 1),
    ("net.0.weight", 0),  # fc1
    ("net.0.bias", 0),
    ("net.3.weight", 1),  # fc2
    ("to_original.weight", 0),
    ("to_original.bias", 0),
]


def tp_rule(name: str) -> Optional[int]:
    """The dim a parameter splits on over 'model', or None (replicated)."""
    for suffix, dim in TP_RULES:
        if name == suffix or name.endswith("." + suffix):
            return dim
    return None


def param_placement(name: str, shape, *, tp: bool, fsdp_size: int) -> tuple:
    """The placement of one parameter as a spec of axis names per dim (as a
    JAX PartitionSpec): 'model' where TP splits it, 'fsdp' on dim 0 under
    FSDP2 (which shards dim 0, padding an uneven last shard, where the JAX
    package takes the largest divisible axis; placement does not change the
    numerics)."""
    spec: list[Any] = [None] * len(shape)
    dim = tp_rule(name) if tp else None
    if dim is not None:
        spec[dim] = "model"
    if fsdp_size > 1 and len(shape) and spec[0] is None:
        spec[0] = "fsdp"
    return tuple(spec)


# -- the rank's rows of a batch ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rows:
    """A rank's rows ``index`` of a batch of ``total``: random draws are
    made at the batch's whole shape and these rows kept, so every rank
    draws what the single process draws. A tensor whose first dim folds k
    items a sample (batch-major, as MS-SiT's windows) keeps k rows a row."""

    index: torch.Tensor
    total: int

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """The rank's rows of ``full`` (first dim ``k * total``)."""
        k = full.shape[0] // self.total
        idx = self.index.to(full.device)
        if k == 1:
            return full.index_select(0, idx)
        return full.view(self.total, k, *full.shape[1:]).index_select(0, idx).reshape(
            -1, *full.shape[1:])

    def draw(self, fn, shape) -> torch.Tensor:
        """``fn(global shape)`` -> the rows of ``shape`` (a local shape)."""
        n = self.index.numel()
        if shape[0] % n:
            raise ValueError(f"a draw of {tuple(shape)} does not fold {n} rows")
        k = shape[0] // n
        return self.take(fn((k * self.total, *shape[1:])))


def even_split(n: int, index: int, count: int) -> tuple[np.ndarray, np.ndarray]:
    """(rows, valid) of part ``index`` of ``count`` of n rows: ceil(n /
    count) rows each, contiguous; a part that runs past n repeats row 0
    with valid False (weight 0)."""
    c = math.ceil(n / count)
    rows = np.arange(index * c, (index + 1) * c)
    valid = rows < n
    return np.where(valid, rows, 0), valid


class Layout:
    """A mesh seen from this rank: its coordinates, the process groups of
    its batch shard (('data', 'fsdp') at its 'model' and 'pipe'
    coordinates), of its model axis and of its pipeline (each at its batch
    coordinate), and the row rules. ``fsdp=True`` shards with FSDP2 on an
    'fsdp' axis of size 1 too (default: where it is wider), which runs
    FSDP2's machinery in one process; ``fsdp_mesh`` (a ``DeviceMesh`` with
    an axis 'fsdp') is the one FSDP2 shards over, by default the rank's
    ('data', 'fsdp') sub-mesh. ``seq=True`` (``tpu.seq_sharding``) gives
    the 'model' axis the tokens instead of the heads."""

    def __init__(self, mesh, fsdp: bool | None = None, seq: bool = False, fsdp_mesh=None):
        self.mesh = mesh
        self.shape = mesh_shape(mesh)
        coord = mesh.get_coordinate()
        if coord is None:
            raise RuntimeError(f"rank {dist.get_rank()} lies outside the mesh {self.shape}")
        self.data_index, self.fsdp_index, self.model_index = coord[:3]
        d, f, m = (self.shape[a] for a in AXES)
        p = self.shape.get(PIPE, 1)
        self.pipe_size, self.stage = p, (coord[3] if p > 1 else 0)
        self.batch_count = d * f
        self.batch_index = self.data_index * f + self.fsdp_index
        self.model_size = m
        self.fsdp = f > 1 if fsdp is None else fsdp
        self.seq = seq and m > 1
        self.tp = m > 1 and not seq
        self.pipe = p > 1
        self.pure_dp = not (self.fsdp or self.tp or self.seq or self.pipe)
        self.model_group = mesh.get_group("model") if m > 1 else None
        self.pipe_group = mesh.get_group(PIPE) if p > 1 else None
        # the global ranks of this rank's pipeline, stage by stage
        self.pipe_ranks = (mesh.mesh[self.data_index, self.fsdp_index, self.model_index].tolist()
                           if p > 1 else None)
        self.batch_group = None
        if self.batch_count > 1:
            if f == 1:
                self.batch_group = mesh.get_group("data")
            elif d == 1:
                self.batch_group = mesh.get_group("fsdp")
            else:  # every rank makes every group, in one order
                ranks = mesh.mesh.reshape(d * f, m * p)
                for j in range(m * p):
                    g = dist.new_group(ranks[:, j].tolist())
                    if j == self.model_index * p + self.stage:
                        self.batch_group = g
        self.fsdp_mesh = fsdp_mesh
        if self.fsdp and fsdp_mesh is None:
            self.fsdp_mesh = mesh["fsdp"] if d == 1 else mesh["data", "fsdp"]
        # the ranks whose FSDP2 shards make up a parameter
        self.fsdp_group = self.fsdp_mesh.get_group("fsdp") if self.fsdp else None

    def tensor_parallel(self) -> "Layout":
        """This layout with the 'model' axis holding heads, not tokens: the
        JAX package's MS-SiT under ``tpu.seq_sharding`` (its model takes the
        sequence fields and uses them nowhere; the TP placement rules lay
        its parameters out over 'model')."""
        lay = copy.copy(self)
        lay.seq, lay.tp = False, self.model_size > 1
        return lay

    @property
    def seed_salt(self) -> int:
        """What this rank adds to the attention-dropout kernel's seed, so
        that shards draw different masks: the JAX package's offsets for the
        'data' and 'fsdp' coordinates (the kernel seeds by local rows), and
        one for the 'model' coordinate (local heads)."""
        return (self.data_index * 2_654_435 + self.fsdp_index * 40_503
                + self.model_index * 7_919)

    def accum_steps(self, B: int, accum: int) -> int:
        """The microbatches a step of B rows splits into (as the single
        process: none where ``accum`` does not divide B)."""
        return accum if accum > 1 and B % accum == 0 else 1

    def batch_index_of(self, B: int, accum: int = 1) -> tuple[np.ndarray, np.ndarray]:
        """(rows, valid) of a global batch of B rows that this rank holds,
        microbatch after microbatch: the rank's ``even_split`` share of each
        of the step's ``accum_steps`` microbatches."""
        k = self.accum_steps(B, accum)
        mbs = B // k
        part, valid = even_split(mbs, self.batch_index, self.batch_count)
        rows = np.concatenate([j * mbs + part for j in range(k)])
        return rows, np.tile(valid, k)

    def micro_rows(self, mbs: int) -> Rows:
        """The rank's ``Rows`` of a microbatch of ``mbs`` rows."""
        part, _ = even_split(mbs, self.batch_index, self.batch_count)
        return Rows(torch.from_numpy(part), mbs)

    # -- collectives over the batch shards ------------------------------------------

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the batch shards (in place; returned)."""
        if self.batch_group is not None:
            dist.all_reduce(t, group=self.batch_group)
        return t

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every batch shard's equal-length ``t`` (rows first), concatenated
        in shard order."""
        if self.batch_group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.batch_count)]
        dist.all_gather(parts, t.contiguous(), group=self.batch_group)
        return torch.cat(parts)
