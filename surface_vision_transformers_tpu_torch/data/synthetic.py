"""Synthetic surface datasets (the port's copy of
``surface_vision_transformers_tpu.data.synthetic.make_regression_dataset``,
numpy only): a planted label -> channel-intensity relationship, so training
demonstrably learns without private data. The same seed gives the same
arrays as the JAX package's generator.
"""

from __future__ import annotations

import numpy as np


def make_regression_dataset(
    n: int,
    *,
    num_channels: int = 4,
    num_patches: int = 320,
    num_vertices: int = 153,
    raw_vertices: int | None = None,
    label_range: tuple[float, float] = (26.0, 45.0),
    noise: float = 0.1,
    seed: int = 0,
):
    """(data, labels): the label modulates the channel intensities through
    a fixed random spatial footprint, so a linear readout of patch features
    predicts it. data is (n, C, L, V), or (n, C, G) raw per-vertex arrays
    when ``raw_vertices`` is given; labels are uniform in ``label_range``."""
    rng = np.random.default_rng(seed)
    lo, hi = label_range
    labels = rng.uniform(lo, hi, size=n).astype(np.float32)
    t = (labels - lo) / (hi - lo)

    if raw_vertices is not None:
        shape_rest = (num_channels, raw_vertices)
    else:
        shape_rest = (num_channels, num_patches, num_vertices)

    base = rng.standard_normal((1, *shape_rest), dtype=np.float32)
    footprint = rng.standard_normal((1, *shape_rest), dtype=np.float32)
    eps = rng.standard_normal((n, *shape_rest), dtype=np.float32) * noise
    data = base + t.reshape(-1, *([1] * len(shape_rest))) * footprint + eps
    return data.astype(np.float32), labels
