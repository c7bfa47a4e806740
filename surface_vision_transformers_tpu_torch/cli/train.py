"""Supervised training CLI::

    python -m surface_vision_transformers_tpu_torch.cli.train cfg.yml \
        [--set training.epochs=10] [--device cuda] [--resume RUN_DIR] [--multihost]

Under torchrun, with ``--multihost``, every rank trains its share of each
batch on the mesh ``tpu.mesh_{data,fsdp,model,pipe}`` lays out (data
parallelism over every rank by default; the axes compose, e.g. DP x FSDP x
TP on eight ranks with ``--set tpu.mesh_fsdp=2 --set tpu.mesh_model=2``)::

    torchrun --nproc_per_node N -m surface_vision_transformers_tpu_torch.cli.train \
        cfg.yml --multihost [--set tpu.mesh_fsdp=F] [--set tpu.mesh_model=M]

Runs ``train.runner.run_training`` and prints its results dict (rank 0
alone under several processes); the run folder lands under
``logging.folder_to_save_model``.
"""

from surface_vision_transformers_tpu_torch.cli._common import parse_config
from surface_vision_transformers_tpu_torch.parallel.multihost import is_primary


def main(argv=None) -> None:
    raw, device, resume = parse_config("SiT / MS-SiT supervised phenotype-regression training "
                               "(PyTorch/CUDA)", argv,
                                       with_resume=True)
    from surface_vision_transformers_tpu_torch.train.runner import run_training
    from surface_vision_transformers_tpu_torch.utils.config import from_dict

    exp = from_dict(raw)
    if exp.is_pretraining:
        raise SystemExit("config contains a pretraining_mpp block; use cli.pretrain")
    results = run_training(exp, device=device, resume_from=resume)
    if is_primary():
        print(results)


if __name__ == "__main__":
    main()
