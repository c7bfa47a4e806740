"""Checkpoint conversion and serving export CLI (the JAX package's
``cli.export``, with the same flags).

Move weights between the JAX package's params npz and the reference
PyTorch layout, either way (by extension)::

    python -m surface_vision_transformers_tpu_torch.cli.export \
        --src logs/SiT/<run>/best_params.npz --dst checkpoint.pth --depth 12
    python -m surface_vision_transformers_tpu_torch.cli.export \
        --src checkpoint.pth --dst params.npz --depth 12

An npz of any tree the port reads (SiT, MPP, MS-SiT, MPP-MS-SiT) becomes
its state dict; a ``.pt``/``.pth`` of a SiT (or MPP) state dict becomes a
JAX params npz.

Serving artifacts (``--serve``): the serving step exported with
``torch.export`` (``serving/artifact.py``), loadable with only torch::

    python -m surface_vision_transformers_tpu_torch.cli.export \
        --serve artifacts/ --config cfg.yml --src best_params.npz \
        --batch-sizes 1,8,256 [--quant int8] [--plain] [--set k=v ...] [--device cuda]

The parameters load as ``run_testing`` loads them. On the default device,
CUDA (there is no fallback), a bfloat16 config exports the kernels
("bf16-fused", or "int8" under ``--quant int8``); ``--plain`` exports the
modular model, traced on the CPU (``--xla`` in the JAX package).
"""

from __future__ import annotations

import argparse
import time


def _serve(args) -> None:
    from surface_vision_transformers_tpu_torch.cli._common import apply_overrides
    from surface_vision_transformers_tpu_torch.geometry import load_patch_table
    from surface_vision_transformers_tpu_torch.models.fused import _device
    from surface_vision_transformers_tpu_torch.serving.artifact import export_serving
    from surface_vision_transformers_tpu_torch.train.runner import (
        _as_layout,
        build_model,
        load_model_state,
        load_state_dict_any,
    )
    from surface_vision_transformers_tpu_torch.utils.config import from_dict, read_config_file

    exp = from_dict(apply_overrides(read_config_file(args.config), args.set))
    if exp.is_pretraining:
        raise SystemExit("--serve exports a regression model; the config is an MPP one")
    dev = _device(args.device)
    model = build_model(exp, load_patch_table(exp.ico, exp.sub_ico).indices)
    load_model_state(model, _as_layout(load_state_dict_any(args.src, exp.model.depth), model))
    t0 = time.perf_counter()
    meta = export_serving(
        model.to(dev), args.serve,
        batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
        quant=(args.quant if args.quant != "none" else None),
        fused=(False if args.plain else None))
    sizes = {b: m["bytes"] for b, m in meta["batch_sizes"].items()}
    print(f"wrote serving artifacts ({meta['numerics']}, platforms {meta['platforms']}, "
          f"traced on {meta['device']}) to {args.serve} in {time.perf_counter() - t0:.2f} s: "
          f"{sizes}", flush=True)


def _convert(args) -> None:
    import torch

    from surface_vision_transformers_tpu_torch.checkpoints.convert import (
        is_mpp_state,
        jax_params_from_mpp_state_dict,
        jax_params_from_state_dict,
        load_torch_state_dict,
        save_params_npz,
    )
    from surface_vision_transformers_tpu_torch.train.runner import load_state_dict_any

    if args.src.endswith(".npz") and args.dst.endswith((".pt", ".pth")):
        state = load_state_dict_any(args.src, args.depth)
        torch.save({k: v.detach().cpu().contiguous() for k, v in state.items()}, args.dst)
        print(f"wrote reference-layout state dict: {args.dst} ({len(state)} keys)")
    elif args.src.endswith((".pt", ".pth")) and args.dst.endswith(".npz"):
        state = load_torch_state_dict(args.src)
        if any(k.startswith(("stages.", "encoder.")) for k in state):
            raise SystemExit("an MS-SiT state dict needs its model to map back: "
                             "the port's runs write params npz files themselves")
        tree = (jax_params_from_mpp_state_dict(state, args.depth) if is_mpp_state(state)
                else jax_params_from_state_dict(state, args.depth))
        save_params_npz(args.dst, {"params": tree})
        print(f"wrote npz params: {args.dst}")
    else:
        raise SystemExit("unsupported conversion; use .npz -> .pt/.pth or .pt/.pth -> .npz")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="SiT checkpoint format converter and serving "
                                "export (PyTorch/CUDA)")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", default=None)
    p.add_argument("--depth", type=int, default=12, help="transformer depth of the checkpoint")
    p.add_argument("--serve", default=None, metavar="DIR",
                   help="export a serving artifact to DIR (requires --config)")
    p.add_argument("--config", default=None, help="experiment YAML for --serve (the model)")
    p.add_argument("--set", nargs="*", default=[],
                   help="config overrides for --serve (key=value, values read as YAML)")
    p.add_argument("--batch-sizes", default="1,8,256")
    p.add_argument("--quant", default="none", choices=["none", "int8"])
    p.add_argument("--plain", action="store_true",
                   help="export the modular model (aten operators, either device) instead of "
                        "the kernels")
    p.add_argument("--device", default="cuda",
                   help="device to export on (default cuda; there is no fallback)")
    args = p.parse_args(argv)

    if args.serve:
        if not args.config:
            raise SystemExit("--serve requires --config")
        _serve(args)
        return
    if not args.dst:
        raise SystemExit("--dst is required (or use --serve DIR)")
    _convert(args)


if __name__ == "__main__":
    main()
