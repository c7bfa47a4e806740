"""MPP pretraining CLI::

    python -m surface_vision_transformers_tpu_torch.cli.pretrain mpp.yml \
        [--set training.epochs=10] [--device cuda] [--resume RUN_DIR] [--multihost]

Forces the MPP task (``SSL: mpp``), runs ``train.runner.run_training`` and
prints its results dict (``--multihost``: as ``cli.train``); the run folder under
``logging.folder_to_save_model`` gets ``best_params.npz`` and
``encoder_best_params.npz`` (the encoder alone, for ``cli.train`` with
``training.load_weights_ssl``).
"""

from surface_vision_transformers_tpu_torch.cli._common import parse_config
from surface_vision_transformers_tpu_torch.parallel.multihost import is_primary


def main(argv=None) -> None:
    raw, device, resume = parse_config("SiT masked-patch / MS-SiT masked-window pretraining "
                               "(PyTorch/CUDA)", argv,
                                       with_resume=True)
    raw.setdefault("SSL", "mpp")  # force the MPP task
    from surface_vision_transformers_tpu_torch.train.runner import run_training
    from surface_vision_transformers_tpu_torch.utils.config import from_dict

    results = run_training(from_dict(raw), device=device, resume_from=resume)
    if is_primary():
        print(results)


if __name__ == "__main__":
    main()
