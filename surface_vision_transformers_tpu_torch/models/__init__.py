"""Models: the eager SiT and its fused serving forward."""
