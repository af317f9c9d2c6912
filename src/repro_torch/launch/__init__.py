"""Serving and training on the port: the ``(data, model)`` rank layout, the
batched decode engine, the step builders, the trainer and the dry run
(counterpart of ``repro.launch``); ``specs``: the reference's partition
rule; ``placement``: the dense and MoE families' train and serve state
placed by it (``train_placement``, ``serve_placement``, ``cache_placement``, loaded
on first use: ``placement`` imports the models, which import
``launch.mesh``); ``dist``: the ``torch.distributed`` world the
distributed collective backend runs in."""

__all__ = ["cache_placement", "serve_placement", "train_placement"]


def __getattr__(name):
    if name in __all__:
        from repro_torch.launch import placement

        return getattr(placement, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
