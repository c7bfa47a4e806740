"""One rank of the CPU gloo runs behind ``tests/test_torch_parallel.py``.

    python tests/torch_parallel_worker.py RENDEZVOUS_FILE RANK WORLD JOBS_JSON

Imports only torch and the port (never JAX). Joins the process group
through ``initialize_multihost`` with a ``file://`` rendezvous, runs every
job of JOBS_JSON in order, and writes each job's result (rank 0's, unless
the job says otherwise) where the job names. A job that raises writes the
error instead, so the parent test reports it.
"""

from __future__ import annotations

import json
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from surface_vision_transformers_tpu_torch import parallel  # noqa: E402
from surface_vision_transformers_tpu_torch.geometry import load_patch_table  # noqa: E402
from surface_vision_transformers_tpu_torch.models import mpp as mpp_mod  # noqa: E402
from surface_vision_transformers_tpu_torch.models import mpp_mssit as mpp_mssit_mod  # noqa: E402
from surface_vision_transformers_tpu_torch.models import mssit as mssit_mod  # noqa: E402
from surface_vision_transformers_tpu_torch.models import sit as sit_mod  # noqa: E402
from surface_vision_transformers_tpu_torch.models.sit import SiT  # noqa: E402
from surface_vision_transformers_tpu_torch.train import runner  # noqa: E402
from surface_vision_transformers_tpu_torch.train.trainer import Trainer  # noqa: E402
from surface_vision_transformers_tpu_torch.utils.config import from_dict  # noqa: E402


def _datasets(job):
    return {k: (np.load(v[0]), np.load(v[1])) for k, v in job["datasets"].items()}


def fixed_window_corruption(target, mask_token, *, window, mask_prob, replace_prob,
                            swap_prob, generator, rows=None):
    """An MS-SiT window corruption that is a function of each sample's
    values alone, so that the JAX side can build the same one: with o the
    count of positive values in the sample's first window, window w masked
    where (w + o) % nW < n_masked, replaced by the mask token on even w."""
    import math

    B, T, P = target.shape
    nW, n = T // window, math.ceil(mask_prob * (T // window))
    wins = target.reshape(B, nW, window * P)
    w = torch.arange(nW)
    wmask = (w[None, :] + (wins[:, 0] > 0).sum(-1)[:, None]) % nW < n
    repl = wmask & (w[None, :] % 2 == 0)
    token = mask_token.reshape(1, 1, P).to(wins.dtype).repeat(1, 1, window)
    return (torch.where(repl[:, :, None], token, wins).reshape(B, T, P),
            wmask.repeat_interleave(window, dim=1), n)


def fixed_token_corruption(tokens, mask_token, *, mask_prob, replace_prob, swap_prob,
                           generator, rows=None):
    """A SiT MPP corruption that is a function of each sample's values
    alone, so that the JAX side can build the same one: with o the count
    of positive values in the sample's first token, position l masked where
    (l + o) % L < n_masked, replaced by the mask token on even l."""
    import math

    B, L, D = tokens.shape
    n = math.ceil(mask_prob * L)
    pos = torch.arange(L)
    mask = (pos[None, :] + (tokens[:, 0] > 0).sum(-1)[:, None]) % L < n
    repl = mask & (pos[None, :] % 2 == 0)
    return torch.where(repl[:, :, None], mask_token.to(tokens.dtype), tokens), mask, n


def job_step(job):
    """One optimizer step (``job['steps']`` where given) of the config's
    model (a SiT, an MS-SiT or an MPP-MS-SiT) from a given state on a given
    batch, under the job's mesh (three or four axes)."""
    exp = from_dict(job["cfg"])
    x, w = (torch.from_numpy(np.load(job[k])) for k in ("x", "w"))
    y = torch.from_numpy(np.load(job["y"])) if job.get("y") else None
    table = load_patch_table(exp.ico, exp.sub_ico).indices if x.dim() == 3 else None
    model = runner.build_model(exp, table)
    model.load_state_dict(torch.load(job["init"], weights_only=True))
    mesh = parallel.make_mesh(*job["shape"], device_type="cpu")
    trainer = Trainer(exp, model, mesh=mesh)
    rows, valid = trainer.layout.batch_index_of(x.shape[0], exp.training.grad_accum)
    rows = torch.from_numpy(rows)
    drawn = mpp_mssit_mod.corrupt_window_sequence, mpp_mod.corrupt_sequence
    if job.get("fixed_corruption"):
        mpp_mssit_mod.corrupt_window_sequence = fixed_window_corruption
        mpp_mod.corrupt_sequence = fixed_token_corruption
    try:
        for _ in range(job.get("steps", 1)):
            loss, _ = trainer.optimizer_step(x[rows], None if y is None else y[rows],
                                             w[rows] * torch.from_numpy(valid), total=x.shape[0])
    finally:
        mpp_mssit_mod.corrupt_window_sequence, mpp_mod.corrupt_sequence = drawn
    loss = trainer.layout.all_reduce(loss.detach().reshape(1))
    state = trainer.model_state()
    if parallel.is_primary():
        torch.save({"state": state, "loss": float(loss)}, job["out"])


# the attention entries a run's modules call: {count's name: (module, entry)}
COUNTED = {"qkv": (sit_mod, "flash_attention_qkv"), "fa": (sit_mod, "flash_attention"),
           "mssit_qkv": (mssit_mod, "flash_attention_qkv")}


def job_train(job):
    """``run_training`` of a config (its ``tpu.mesh_*`` keys lay it out),
    with the attention entries counted (``COUNTED``: ``<name>_calls``) and,
    for ``job['heads']``, the heads each call of the MS-SiT entry got."""
    calls = {k: 0 for k in COUNTED}
    heads = []
    saved = {k: getattr(mod, attr) for k, (mod, attr) in COUNTED.items()}

    def counting(name, fn):
        def call(*a, **k):
            calls[name] += 1
            if name == "mssit_qkv":
                heads.append(a[1])
            return fn(*a, **k)
        return call

    for k, (mod, attr) in COUNTED.items():
        setattr(mod, attr, counting(k, saved[k]))
    try:
        res = runner.run_training(from_dict(job["cfg"]), device="cpu",
                                  datasets=_datasets(job), progress=False)
    except ValueError as e:  # a refusal the job expects
        if not job.get("refusal"):
            raise
        res = {"error": f"{type(e).__name__}: {e}"}
    finally:
        for k, (mod, attr) in COUNTED.items():
            setattr(mod, attr, saved[k])
    res.update({f"{k}_calls": v for k, v in calls.items()})
    res["mssit_heads"] = sorted(set(heads))
    if job.get("all_ranks"):
        Path(job["out"] + f".rank{parallel.multihost.process_index()}").write_text(
            json.dumps(res))
    elif parallel.is_primary():
        Path(job["out"]).write_text(json.dumps(res))


def job_resume(job):
    """``run_training`` resumed under this job's mesh from a copy of the
    run folder an earlier job wrote."""
    import shutil

    torch.distributed.barrier()
    src = Path(json.loads(Path(job["from"]).read_text())["run_dir"])
    dst = Path(job["copy"])
    if parallel.is_primary():
        shutil.copytree(src, dst)
    torch.distributed.barrier()
    res = runner.run_training(from_dict(job["cfg"]), device="cpu", datasets=_datasets(job),
                              progress=False, resume_from=str(dst))
    if parallel.is_primary():
        Path(job["out"]).write_text(json.dumps(res))


def job_testing(job):
    """``run_testing`` of a config with ``testing.path_to_ckpt`` set, in the
    group (a pipeline evaluates through its schedule)."""
    res = runner.run_testing(from_dict(job["cfg"]), device="cpu")
    if parallel.is_primary():
        Path(job["out"]).write_text(json.dumps(res))


def job_cli(job):
    """``cli.train --multihost`` in this process, which has joined the
    group already: the runner lays the run out over both ranks."""
    import contextlib
    import io

    from surface_vision_transformers_tpu_torch.cli import train

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main([job["config"], "--multihost", "--device", "cpu"])
    Path(job["out"] + f".rank{parallel.multihost.process_index()}").write_text(out.getvalue())


def _refusal(fn):
    try:
        fn()
    except (NotImplementedError, ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def job_refusals(job):
    """What a mesh refuses, each as 'Type: message' (None where it ran)."""
    from surface_vision_transformers_tpu_torch.models.fused import fused_train_forward

    cfg = job["cfg"]
    out = {}

    def trainer(shape, **model_kw):
        exp = from_dict(cfg)
        model = SiT.from_config(exp, **model_kw)
        return Trainer(exp, model, mesh=parallel.make_mesh(*shape, device_type="cpu"))

    out["heads"] = _refusal(lambda: trainer((1, 1, 2), heads=3, dim_head=16))
    out["heads_1"] = _refusal(lambda: trainer((1, 1, 2), heads=1, dim_head=64))
    exp = from_dict(cfg)
    x = torch.zeros(2, 4, 20, 15)

    def fsdp_tp_step():  # FSDP2 on the size-1 'fsdp' axis beside TP: one step
        tr = Trainer(exp, SiT.from_config(exp), mesh=parallel.Layout(
            parallel.make_mesh(1, 1, 2, device_type="cpu"), fsdp=True))
        loss, _ = tr.optimizer_step(x, torch.ones(2), torch.ones(2), total=2)
        out["fsdp_tp_loss"] = float(loss)

    out["fsdp_tp"] = _refusal(fsdp_tp_step)
    for name, shape in (("fused_fsdp", (1, 2, 1)), ("fused_tp", (1, 1, 2))):
        tr = trainer(shape)
        out[name] = _refusal(lambda: fused_train_forward(tr.model, x, mesh=tr.mesh))
        out[name + "_route"] = tr.uses_fused_train()
    tr = trainer((2, 1, 1))
    out["fused_dp"] = _refusal(lambda: fused_train_forward(tr.model, x[:1], mesh=tr.mesh))
    out["init_again"] = _refusal(lambda: parallel.initialize_multihost(
        "127.0.0.1:1", 3, 0))
    out["init_same"] = parallel.initialize_multihost()
    if parallel.is_primary():
        Path(job["out"]).write_text(json.dumps(out))


def job_groups(job):
    """Each of the job's mesh shapes as this rank's ``Layout`` sees it: the
    ranks of its batch, 'model', pipeline and FSDP groups, its seed salt and
    its rows of a batch of 16, one file a rank."""
    import torch.distributed as dist

    def ranks(group):
        return None if group is None else dist.get_process_group_ranks(group)

    out = {}
    for shape in job["shapes"]:
        lay = parallel.Layout(parallel.make_mesh(*shape, device_type="cpu"))
        out[str(tuple(shape))] = {
            "batch": ranks(lay.batch_group), "model": ranks(lay.model_group),
            "pipe": lay.pipe_ranks, "fsdp": ranks(lay.fsdp_group), "salt": lay.seed_salt,
            "rows": lay.batch_index_of(16)[0].tolist()}
    Path(job["out"] + f".rank{parallel.multihost.process_index()}").write_text(json.dumps(out))


JOBS = {"step": job_step, "train": job_train, "resume": job_resume, "cli": job_cli,
        "refusals": job_refusals, "testing": job_testing, "groups": job_groups}


def main():
    rdv, rank, world, jobs = sys.argv[1:5]
    torch.set_num_threads(1)
    parallel.initialize_multihost(f"file://{rdv}", int(world), int(rank))
    for job in json.loads(Path(jobs).read_text()):
        try:
            JOBS[job["kind"]](job)
        except Exception:
            Path(job["out"] + f".error{rank}").write_text(traceback.format_exc())
            torch.distributed.destroy_process_group()
            raise
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
