"""Serving artifacts: the serving step exported with ``torch.export``
(``artifact.export_serving``, ``load_serving``, ``make_serving_fn``), and
the serving kernels as torch operators (``svt_ops``)."""

_ARTIFACT = ("export_serving", "load_serving", "make_serving_fn")


def __getattr__(name):
    # the artifact module reaches the models, which reach this package's
    # svt_ops through the kernels: imported when first asked for
    if name in _ARTIFACT:
        from surface_vision_transformers_tpu_torch.serving import artifact

        return getattr(artifact, name)
    raise AttributeError(name)
