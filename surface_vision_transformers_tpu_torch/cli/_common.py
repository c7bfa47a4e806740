"""Shared CLI plumbing: ``python -m surface_vision_transformers_tpu_torch.cli.
<tool> <config> [--set dotted.key=value ...] [--device DEV] [--multihost
[--dist-backend nccl|gloo]]`` (train and pretrain also ``[--resume
RUN_DIR]``; preprocess, which runs on the host, without ``--device`` or
``--multihost``), the JAX package's positional-config UX plus an explicit
device. ``--multihost`` joins the process group
(``parallel.initialize_multihost``, torchrun's environment) before the
runner, and leaves it at exit; ``--dist-backend`` names its backend where
the default (NCCL on CUDA) will not do, as for ranks sharing one GPU."""

from __future__ import annotations

import argparse
import atexit

from surface_vision_transformers_tpu_torch.utils.config import read_config_file


def _parse_value(text: str):
    """A value as YAML reads it, as the JAX CLI parses ``--set`` (64, 1.0e-5,
    false / no / off, ~ for None, [1, 2], any other word as a string)."""
    import yaml

    return yaml.safe_load(text)


def apply_overrides(raw: dict, overrides) -> dict:
    """``raw`` with each ``dotted.key=value`` of ``overrides`` set (the
    value read as YAML), in place; returns it."""
    for ov in overrides:
        key, _, val = ov.partition("=")
        *parents, leaf = key.split(".")
        cur = raw
        for k in parents:
            cur = cur.setdefault(k, {})
        cur[leaf] = _parse_value(val)
    return raw


def parse_config(description: str, argv=None, with_resume: bool = False,
                 with_device: bool = True):
    """(raw config dict with overrides applied, device), and the
    ``--resume`` run folder (or None) last under ``with_resume``; the raw
    dict alone, with no ``--device`` flag, under ``with_device=False``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("config", help="path to the YAML (or .json) config")
    if with_resume:
        p.add_argument(
            "--resume", metavar="RUN_DIR", default=None,
            help="continue an interrupted run in this run folder from its newest "
            "checkpoint (last/final/best)")
    p.add_argument(
        "--set", action="append", default=[], metavar="dotted.key=value",
        help="override a config value (repeatable), e.g. --set training.bs=64")
    if with_device:
        p.add_argument(
            "--device", default="cuda",
            help="torch device to run on (default cuda; there is no fallback "
            "when it is missing)")
        p.add_argument(
            "--multihost", action="store_true",
            help="join the torch.distributed process group first (one process a "
            "GPU, e.g. under torchrun; rank, world size and address from its "
            "environment); tpu.mesh_* then lays the run out over the ranks")
        p.add_argument(
            "--dist-backend", choices=("nccl", "gloo"), default=None,
            help="with --multihost, the torch.distributed backend (default nccl on "
            "CUDA, gloo on the CPU); gloo lets several ranks share one GPU, which "
            "NCCL refuses")
    args = p.parse_args(argv)
    raw = apply_overrides(read_config_file(args.config), args.set)
    if not with_device:
        return raw
    if args.multihost:
        start_multihost(args.dist_backend)
    if with_resume:
        return raw, args.device, args.resume
    return raw, args.device


def start_multihost(backend: str | None = None) -> None:
    """``initialize_multihost(backend=backend)``; a group it made is
    destroyed at exit."""
    import torch.distributed as dist

    from surface_vision_transformers_tpu_torch.parallel import initialize_multihost

    joined = dist.is_initialized()
    initialize_multihost(backend=backend)
    if dist.is_initialized() and not joined:
        atexit.register(dist.destroy_process_group)
