"""Step builders shared by the trainer and the server (counterpart of
``repro.launch.steps``).

``build_train_step`` gives ``train_step(params, opt_state, batch) ->
(params, opt_state, {"loss", "gnorm"})``: the loss and its gradients (by
``backward``, accumulated over ``cfg.microbatches`` slices of the batch and
divided by their count, as the reference's ``lax.scan``), then one AdamW
step.  ``params`` is the model's :class:`~repro_torch.models.transformer.LM`
(or its ``tree()``); it and the state are updated in place and returned.
``abstract_opt_state`` and ``abstract_caches`` give the AdamW state and
the decode caches on ``torch.device("meta")`` (shapes and dtypes, nothing
allocated), where the reference gives ``jax.eval_shape`` results.  The
reference's sharding helpers (``resolve_spec``, ``_named``,
``_batch_shardings``) and ``lower_cell`` have no twin here: the port does
not shard and lowers no XLA program (``launch.dryrun`` runs the steps on
meta tensors instead).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.models.common import ParamTree, tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

__all__ = ["abstract_caches", "abstract_opt_state", "build_decode_step", "build_prefill_step", "build_train_step"]


def _to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) on ``device``; a host array
    goes to the card through pinned memory, so the copy does not stall
    the host."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def build_train_step(model: Model, layout=None, opt_cfg: AdamWConfig = AdamWConfig()):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``cfg.microbatches > 1`` enables gradient accumulation: the batch runs
    in slices, which divides activation memory by the slice count.  A
    parameter the loss does not reach keeps ``grad`` ``None``, which the
    update takes as a zero gradient (the reference's zeros)."""
    loss_fn = model.loss_fn(layout)
    m = max(1, model.cfg.microbatches)

    def train_step(params, opt_state, batch):
        tree = params.tree() if isinstance(params, ParamTree) else params
        leaves = tree_leaves(tree)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        batch = _to_device(batch, leaves[0].device)
        if m == 1:
            loss = loss_fn(tree, batch)
            loss.backward()
            loss = loss.detach()
        else:
            b = next(iter(batch.values())).shape[0]
            if b % m:
                raise ValueError(f"the batch ({b}) does not split into {m} microbatches")
            loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for i in range(m):
                l = loss_fn(tree, {k: v[i * (b // m):(i + 1) * (b // m)] for k, v in batch.items()})
                l.backward()  # accumulates into .grad in the parameters' dtype, as the scan's sum
                loss_sum = loss_sum + l.detach()
            loss = loss_sum / m
            with torch.no_grad():
                for p in leaves:
                    if p.grad is not None:
                        p.grad.div_(m)
        grads = tree_map(lambda p: p.grad, tree)
        _, opt_state, gnorm = adamw_update(tree, grads, opt_state, opt_cfg)
        for p in leaves:
            p.grad = None
        return params, opt_state, {"loss": loss, "gnorm": gnorm}

    return train_step


def build_prefill_step(model: Model, layout=None):
    return model.prefill_fn(layout)


def build_decode_step(model: Model, layout=None):
    return model.decode_fn(layout)


def abstract_opt_state(model: Model, opt_cfg: AdamWConfig = AdamWConfig()):
    """The AdamW state of :meth:`Model.abstract` on the meta device (no
    allocation): ``adamw_init`` itself, so the masters and residuals the
    config asks for are there too."""
    return adamw_init(model.abstract(), opt_cfg)


def abstract_caches(model: Model, batch: int, max_len: int):
    """The decode caches on the meta device (no allocation)."""
    return model.init_caches(batch, max_len, device="meta")
