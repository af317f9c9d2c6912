"""Serving and training on the port: the ``(data, model)`` rank layout, the
batched decode engine, the step builders, the trainer and the dry run
(counterpart of ``repro.launch``); ``specs``: the reference's partition
rule; ``placement``: the dense family's train state placed by it;
``dist``: the ``torch.distributed`` world the distributed collective
backend runs in."""
