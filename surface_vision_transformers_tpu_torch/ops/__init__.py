"""Tensor ops of the port: patch embedding (plain PyTorch) and the
transformer-block kernels (CUDA, built on first use; see ``fused_block``)."""
