"""surface_vision_transformers_tpu_torch -- the PyTorch / CUDA port of
``surface_vision_transformers_tpu`` for NVIDIA Hopper GPUs.

This slice serves SiT models: the patch table, the npy splits and
checkpoints are read with numpy; the patch embedding and head are plain
PyTorch; every transformer block runs through hand-written CUDA kernels
(``ops.fused_block``) built from ``csrc/`` on first use. The JAX package
stays the reference; this package never imports JAX.

Entry point::

    python -m surface_vision_transformers_tpu_torch.cli.test cfg.yml --device cuda

Importing the package loads no submodule and builds nothing.
"""

__version__ = "0.1.0"
