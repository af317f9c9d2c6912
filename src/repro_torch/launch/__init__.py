"""Serving on the port: the ``(data, model)`` rank layout and the batched
decode engine (counterpart of ``repro.launch``'s ``mesh`` and ``serve``);
``dist``: the ``torch.distributed`` world the distributed collective
backend runs in."""
