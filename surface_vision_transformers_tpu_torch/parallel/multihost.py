"""Multi-process start-up and the per-rank feed (counterpart of
``surface_vision_transformers_tpu.parallel.multihost``) over
torch.distributed.

Every rank runs the same program; ``initialize_multihost`` joins the ranks
into one process group, from its arguments or from the launcher's
environment (torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``)::

    torchrun --nproc_per_node N -m surface_vision_transformers_tpu_torch.cli.train \\
        cfg.yml --multihost --set tpu.mesh_fsdp=2

With one process and nothing asking for more it does nothing, so the same
command runs alone.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None) -> int:
    """Join the process group; -> this process's rank. Arguments default
    to the launcher's environment: ``coordinator_address`` to
    tcp://MASTER_ADDR:MASTER_PORT ("host:port", or a tcp:// or file:// URL),
    ``num_processes`` to WORLD_SIZE, ``process_id`` to RANK. The backend is
    nccl where CUDA is available, else gloo (``backend`` overrides it); a
    CUDA process binds cuda:LOCAL_RANK (modulo the visible cards). A no-op
    returning 0 when nothing asks for multiple processes. A second call
    asking for another world size, rank or backend is refused."""
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if dist.is_initialized():
        asked = {"world size": (num_processes, dist.get_world_size()),
                 "rank": (process_id, dist.get_rank()),
                 "backend": (backend, dist.get_backend())}
        clash = {k: v for k, v in asked.items() if v[0] is not None and v[0] != v[1]}
        if clash:
            raise RuntimeError(
                "initialize_multihost: torch.distributed is already initialised "
                + ", ".join(f"with {k} {have}, not {want}" for k, (want, have) in clash.items()))
        return dist.get_rank()
    if coordinator_address is None and num_processes is None:
        return 0
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize_multihost needs a coordinator address, a process count and a "
            "process id (arguments, or MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK)")
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=num_processes, rank=process_id)
    return dist.get_rank()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Whether this process writes the run's files and prints: rank 0."""
    return process_index() == 0


def process_local_slice(n_global: int, *, process_index=None, process_count=None):
    """(start, stop) of this process's contiguous sample range when a
    host-resident dataset of ``n_global`` samples is split evenly (remainder
    to the leading processes) across processes."""
    pi = globals()["process_index"]() if process_index is None else process_index
    pc = globals()["process_count"]() if process_count is None else process_count
    base, rem = divmod(n_global, pc)
    start = pi * base + min(pi, rem)
    return start, start + base + (1 if pi < rem else 0)


def local_rows(x, mesh, accum: int = 1):
    """The rows of global batch ``x`` (a tensor or an array, rows first)
    that this rank holds under ``mesh``: its contiguous share (microbatch by
    microbatch under ``accum``, ``Layout.batch_index_of``); ``x`` itself
    without a mesh."""
    if mesh is None:
        return x
    from surface_vision_transformers_tpu_torch.parallel.mesh import Layout

    layout = mesh if isinstance(mesh, Layout) else Layout(mesh)
    rows, _ = layout.batch_index_of(x.shape[0], accum)
    if isinstance(x, torch.Tensor):
        return x.index_select(0, torch.from_numpy(rows).to(x.device))
    return np.asarray(x)[rows]
