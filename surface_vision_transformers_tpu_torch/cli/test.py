"""Batched test-time evaluation CLI::

    python -m surface_vision_transformers_tpu_torch.cli.test cfg.yml \
        [--set testing.path_to_ckpt=run/best_params.npz] [--device cuda] [--multihost]

Prints the results dict (n, split, mae) and writes results.csv next to the
checkpoint (rank 0 alone prints and writes under ``--multihost``; each
rank serves the whole split). SiT and MS-SiT configs (e.g. ``configs/training/
mssit_scan_age.yml``, with a params npz of an MS-SiT tree) alike: bfloat16
serves through the kernels (``--set tpu.quant=int8`` for W8A8 blocks where a
stage is wide enough), ``--set tpu.compute_dtype=float32`` through the
modular model.
"""

from surface_vision_transformers_tpu_torch.cli._common import parse_config
from surface_vision_transformers_tpu_torch.parallel.multihost import is_primary


def main(argv=None) -> None:
    raw, device = parse_config("SiT and MS-SiT test-time evaluation (PyTorch/CUDA)", argv)
    from surface_vision_transformers_tpu_torch.train.runner import run_testing
    from surface_vision_transformers_tpu_torch.utils.config import from_dict

    results = run_testing(from_dict(raw), device=device)
    if is_primary():
        print(results)


if __name__ == "__main__":
    main()
