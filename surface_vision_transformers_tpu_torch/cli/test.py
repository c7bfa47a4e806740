"""Batched test-time evaluation CLI::

    python -m surface_vision_transformers_tpu_torch.cli.test cfg.yml \
        [--set testing.path_to_ckpt=run/best_params.npz] [--device cuda]

Prints the results dict (n, split, mae) and writes results.csv next to the
checkpoint.
"""

from surface_vision_transformers_tpu_torch.cli._common import parse_config


def main(argv=None) -> None:
    raw, device = parse_config("SiT test-time evaluation (PyTorch/CUDA)", argv)
    from surface_vision_transformers_tpu_torch.train.runner import run_testing
    from surface_vision_transformers_tpu_torch.utils.config import from_dict

    results = run_testing(from_dict(raw), device=device)
    print(results)


if __name__ == "__main__":
    main()
