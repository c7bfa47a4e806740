"""surface_vision_transformers_tpu_torch -- the PyTorch / CUDA port of
``surface_vision_transformers_tpu`` for NVIDIA Hopper GPUs.

It serves and trains SiT models (supervised regression): the patch table,
the npy splits and checkpoints are read with numpy; the patch embedding,
head, losses and optimizers are plain PyTorch; every transformer block runs
through hand-written CUDA kernels (``ops.fused_block``), forward and
backward, built from ``csrc/`` on first use. The JAX package stays the
reference; this package never imports JAX.

Entry points::

    python -m surface_vision_transformers_tpu_torch.cli.train cfg.yml --device cuda
    python -m surface_vision_transformers_tpu_torch.cli.test cfg.yml --device cuda

Importing the package loads no submodule and builds nothing.
"""

__version__ = "0.1.0"
