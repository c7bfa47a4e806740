#!/usr/bin/env python3
"""Which torch.distributed collectives the gloo backend carries on CUDA
tensors, two processes sharing one card.

    python3 scripts/gloo_cuda_probe.py

Each collective runs in a pair of fresh processes of this script (gloo, a
file rendezvous under /tmp, both ranks on cuda:0), so one that crashes its
process does not hide the next: all_reduce (fp32 and bf16), broadcast,
all_gather, all_gather_into_tensor, reduce_scatter_tensor,
broadcast_object_list, barrier, a ('data', 'fsdp', 'model') DeviceMesh's
group, FSDP2 (``fully_shard``) on two Linear layers for one SGD step, a
DTensor's ``distribute_tensor`` / ``full_tensor``, point-to-point
``send`` / ``recv`` (fp32 and bf16, a (2, 3) slice of a wider tensor too)
and ``isend`` / ``irecv`` both ways at once, and FSDP x TP as phase 37 (g)
would run it (``fsdp2_nccl_self``): FSDP2 on a ``DeviceMesh`` over a
one-rank NCCL group of each process, beside a tensor-parallel all-reduce
of CUDA tensors over the gloo world in forward and backward, one SGD step
and a ``full_tensor``. Prints one line a rank and
collective: ``ok`` with the result, ``FAIL`` with the exception, or the
return code of a process that died (-11: SIGSEGV). Phase 36 of
``chip_smoke.py`` runs DP and TP over gloo and FSDP over NCCL by what this
finds, and the pipeline's handoff (``parallel/pipeline.py``) stages through
the host or not by it.

    python3 scripts/gloo_cuda_probe.py send_recv isend_irecv   # some only
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist


def _mesh_group(rank, dev):
    from torch.distributed.device_mesh import init_device_mesh

    m = init_device_mesh("cuda", (1, 2, 1), mesh_dim_names=("data", "fsdp", "model"))
    t = torch.ones(2, device=dev)
    dist.all_reduce(t, group=m.get_group("fsdp"))
    return m.get_coordinate(), t.tolist()


def _fsdp2(rank, dev):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard

    m = init_device_mesh("cuda", (2,), mesh_dim_names=("fsdp",))
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Linear(16, 1)).to(dev)
    fully_shard(net[0], mesh=m)
    fully_shard(net, mesh=m)
    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    net(torch.randn(4, 8, device=dev)).sum().backward()
    opt.step()
    return float(net[0].weight.full_tensor().sum())


def _dtensor(rank, dev):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    m = init_device_mesh("cuda", (2,), mesh_dim_names=("fsdp",))
    d = distribute_tensor(torch.arange(8.0, device=dev).reshape(4, 2), m, [Shard(0)],
                          src_data_rank=None)
    return d.to_local().tolist(), float(d.full_tensor().sum())


class _WorldSum(torch.autograd.Function):
    """A TP branch's exit and entry in one: the forward sums over the
    world, the backward sums the gradient over it (gloo, CUDA tensors)."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def _fsdp2_nccl_self(rank, dev):
    """FSDP2 over a one-rank NCCL group (``DeviceMesh.from_group``; every
    rank makes every group, in one order) beside gloo all-reduces over the
    world, forward and backward; one SGD step."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.fsdp import fully_shard

    class Net(torch.nn.Module):  # a TP branch between two units
        def __init__(self):
            super().__init__()
            self.a, self.b = torch.nn.Linear(8, 16), torch.nn.Linear(16, 1)

        def forward(self, x):
            return self.b(_WorldSum.apply(self.a(x)))

    own = [dist.new_group([r], backend="nccl") for r in range(2)][rank]
    m = DeviceMesh.from_group(own, "cuda", mesh_dim_names=("fsdp",))
    torch.manual_seed(0)
    net = Net().to(dev)
    fully_shard(net.a, mesh=m)
    fully_shard(net, mesh=m)
    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    net(torch.randn(4, 8, device=dev)).sum().backward()
    opt.step()
    norm = net.a.weight.grad.to_local().square().sum()
    dist.all_reduce(norm, group=own)
    return float(net.a.weight.full_tensor().sum()), float(norm)


def _filled(rank, dev, dtype=torch.float32):
    return torch.full((4,), float(rank + 1), device=dev, dtype=dtype)


def _all_reduce(rank, dev, dtype=torch.float32):
    t = _filled(rank, dev, dtype)
    dist.all_reduce(t)
    return t.tolist()


def _broadcast(rank, dev):
    t = _filled(rank, dev)
    dist.broadcast(t, 0)
    return t.tolist()


def _all_gather(rank, dev):
    t = torch.full((2,), float(rank), device=dev)
    parts = [torch.empty_like(t) for _ in range(2)]
    dist.all_gather(parts, t)
    return torch.cat(parts).tolist()


def _all_gather_into_tensor(rank, dev):
    out = torch.empty(4, device=dev)
    dist.all_gather_into_tensor(out, torch.full((2,), float(rank), device=dev))
    return out.tolist()


def _reduce_scatter_tensor(rank, dev):
    out = torch.empty(2, device=dev)
    dist.reduce_scatter_tensor(out, torch.arange(4, device=dev, dtype=torch.float32) + rank)
    return out.tolist()


def _broadcast_object_list(rank, dev):
    names = [f"name{rank}"]
    dist.broadcast_object_list(names, src=0)
    return names


def _send_recv(rank, dev, dtype=torch.float32):
    """Rank 0 sends a slice of a wider tensor to rank 1, which receives it
    into a slice of its own, then the other way."""
    out = []
    for src in (0, 1):
        buf = torch.zeros(4, 6, device=dev, dtype=dtype)
        if rank == src:
            buf[:2, :3] = torch.arange(6, device=dev, dtype=dtype).view(2, 3) + 10 * src
            dist.send(buf[:2, :3].contiguous(), 1 - src)
        else:
            part = torch.empty(2, 3, device=dev, dtype=dtype)
            dist.recv(part, src)
            out.append(part.float().sum().item())
    return out


def _isend_irecv(rank, dev):
    """Both ranks send and receive at once (a ring of two)."""
    mine = torch.full((3,), float(rank + 1), device=dev)
    got = torch.empty(3, device=dev)
    ops = [dist.P2POp(dist.isend, mine, 1 - rank), dist.P2POp(dist.irecv, got, 1 - rank)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return got.tolist()


OPS = {
    "all_reduce": _all_reduce,
    "all_reduce_bf16": lambda r, d: _all_reduce(r, d, torch.bfloat16),
    "broadcast": _broadcast,
    "all_gather": _all_gather,
    "all_gather_into_tensor": _all_gather_into_tensor,
    "reduce_scatter_tensor": _reduce_scatter_tensor,
    "broadcast_object_list": _broadcast_object_list,
    "barrier": lambda r, d: dist.barrier(),
    "device_mesh": _mesh_group,
    "fsdp2": _fsdp2,
    "dtensor": _dtensor,
    "send_recv": _send_recv,
    "send_recv_bf16": lambda r, d: _send_recv(r, d, torch.bfloat16),
    "isend_irecv": _isend_irecv,
    "fsdp2_nccl_self": _fsdp2_nccl_self,
}


def rank_main(name: str, rank: int, rdv: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=2)
    try:
        print(f"RESULT ok {OPS[name](rank, torch.device('cuda'))}", flush=True)
    except Exception as e:  # reported, the next collective still runs
        print(f"RESULT FAIL {type(e).__name__}: {str(e)[:400]}", flush=True)
    dist.destroy_process_group()


def main(names=None) -> None:
    for name in names or OPS:
        rdv = f"/tmp/gloo_cuda_probe_{os.getpid()}_{name}"
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, __file__, name, str(r), rdv],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        for r, p in enumerate(procs):
            try:
                out = p.communicate(timeout=60)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                out = "TIMEOUT"
            lines = [line for line in out.splitlines() if line.startswith("RESULT")]
            print(f"{name} rank{r} rc={p.returncode} {lines[-1] if lines else out[-600:]}",
                  flush=True)
        if os.path.exists(rdv):
            os.remove(rdv)
        print(f"  {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[2] in ("0", "1"):
        rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
    else:
        main(sys.argv[1:])
