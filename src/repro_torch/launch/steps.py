"""Step builders shared by the trainer and the server (counterpart of
``repro.launch.steps``).

``build_train_step`` gives ``train_step(params, opt_state, batch) ->
(params, opt_state, {"loss", "gnorm"})``: the loss and its gradients (by
``backward``, accumulated over ``cfg.microbatches`` slices of the batch and
divided by their count, as the reference's ``lax.scan``), then one AdamW
step.  ``params`` is the model's :class:`~repro_torch.models.transformer.LM`
(or its ``tree()``); it and the state are updated in place and returned.
Over a ``torch.distributed`` world (``comm=``, or the layout's ``comm``)
the step takes the GLOBAL batch in every process, keeps the rows of the
process's data groups (:func:`data_rows`), and averages the gradient and
the loss over the data groups with ``comm.grad_all_reduce``: processes that
hold the same rows (model peers of one group) contribute once, so every
process ends the step with the same parameters and AdamW state, bit for
bit.

Given placed parameters (``launch.placement``: each leaf the blocks of
the layout's ranks the process holds, the reference's sharded state) the
same ``train_step`` runs the placed step instead: tensor parallelism over
``model`` and FSDP over ``data``, on the placement's backend; or, for the
encoder-decoder under ``dp_over_model``, every weight whole on every rank
(FSDP's ``data`` where the config asks) and the rows over ``(data,
model)``.  Every process takes the GLOBAL batch and each rank its row
group's rows (its data group's, or under ``dp_over_model`` its own
block, ``Ranks.row_groups``); each microbatch is a slice of the global
batch, split over the row groups, as the reference's scan slices it.  The
gradients of a microbatch accumulate in the blocks (an FSDP leaf's
``reduce_scatter``'d over ``data`` in its gather's backward pass), a leaf
replicated over a batch axis is ``psum``'d over it once, and AdamW
updates each rank's blocks with the norm counted once over the world.
Under an MoE's ``rafi_ep`` plane the router, the experts and the norm that
feeds them get no gradient (the plane carries none), nor does qwen2-vl's
``embed`` when ``embeds`` replace the lookup: their ``grad`` stays None
through ``reduce`` and the norm, and AdamW decays them alone with their
moments at zero, as the reference's zero gradients do.  The
encoder-decoder split over ``model`` is the dense family's step: rows
over ``data``, the encoder and the decoder tensor-parallel.
Whole parameters keep the unsharded step above.
``build_prefill_step`` and ``build_decode_step`` return the model's
``prefill`` and ``decode`` functions as they are: the placement lives in
the data here too.  Given serve-placed parameters
(``placement.serve_placement``: FSDP dropped, split over ``model`` and
replicated over ``data``; whole under ``dp_over_model``) and, for
decode, placed caches (``placement.cache_placement``: the slots over
``data``, the sequence over ``model``), they run ``api.placed_prefill``
/ ``api.placed_decode`` on the placement's backend; every process takes
the global batch or token (and an encoder-decoder's global memory) and
returns the whole ``(B, V)`` logits.
``abstract_opt_state`` and ``abstract_caches`` give the AdamW state and
the decode caches on ``torch.device("meta")`` (shapes and dtypes, nothing
allocated), where the reference gives ``jax.eval_shape`` results.  The
reference's sharding helpers (``resolve_spec``, ``_named``) are
``launch.specs`` and ``launch.placement``; ``_batch_shardings`` is the
placed step's row split, and ``lower_cell`` has no twin (the port lowers
no XLA program: ``launch.dryrun`` runs the steps on meta tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.models.common import ParamTree, tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

__all__ = ["abstract_caches", "abstract_opt_state", "build_decode_step", "build_prefill_step", "build_train_step",
           "data_rows"]


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


def _uses_layout(cfg) -> bool:
    """Whether the model's layers run on the layout's ranks (the
    ``rafi_ep`` MoE plane); a dense model's data groups are the processes."""
    return cfg.kind == "moe" and cfg.moe_dispatch == "rafi_ep"


def data_rows(model: Model, layout, comm, batch: int) -> Tuple[int, int, int, bool]:
    """``(lo, hi, holders, lead)``: the rows ``[lo, hi)`` of a global batch
    of ``batch`` rows this process trains on, how many processes hold
    distinct rows, and whether this process is the first of those holding
    its rows.  A model on the layout's ranks takes its data groups' rows
    (``Layout.data_block``: replicated over a group's processes when a
    process holds part of a group); any other model splits the batch over
    the processes.  Without a world: the whole batch, one holder."""
    if comm is None:
        return 0, batch, 1, True
    if layout is not None and _uses_layout(model.cfg):
        layout = dataclasses.replace(layout, comm=comm)
        lo, hi = layout.data_block(batch)
        replicas = layout.replicas()
        return lo, hi, comm.world // replicas, comm.index % replicas == 0
    if batch % comm.world:
        raise ValueError(f"the batch ({batch}) does not split over {comm.world} processes")
    per = batch // comm.world
    return comm.index * per, (comm.index + 1) * per, comm.world, True


def build_train_step(model: Model, layout=None, opt_cfg: AdamWConfig = AdamWConfig(), *, comm=None):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``cfg.microbatches > 1`` enables gradient accumulation: the batch runs
    in slices, which divides activation memory by the slice count.  A
    parameter the loss does not reach keeps ``grad`` ``None``, which the
    update takes as a zero gradient (the reference's zeros).  ``comm`` (or
    ``layout.comm``) makes it a data-parallel step over a world (module
    docstring)."""
    comm = comm if comm is not None else getattr(layout, "comm", None)
    if comm is not None and layout is not None:
        layout = dataclasses.replace(layout, comm=comm)
    loss_fn = model.loss_fn(layout)
    m = max(1, model.cfg.microbatches)

    def train_step(params, opt_state, batch):
        if getattr(params, "placement", None) is not None:
            return _placed_step(loss_fn, m, opt_cfg, params, opt_state, batch)
        tree = params.tree() if isinstance(params, ParamTree) else params
        leaves = tree_leaves(tree)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        lo, hi, holders, lead = data_rows(model, layout, comm, next(iter(batch.values())).shape[0])
        batch = _to_device({k: v[lo:hi] for k, v in batch.items()}, leaves[0].device)
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
        if comm is not None:
            loss = _average_over_groups(comm, leaves, loss, holders, lead)
        grads = tree_map(lambda p: p.grad, tree)
        _, opt_state, gnorm = adamw_update(tree, grads, opt_state, opt_cfg)
        for p in leaves:
            p.grad = None
        return params, opt_state, {"loss": loss, "gnorm": gnorm}

    return train_step


def _average_over_groups(comm, leaves, loss, holders: int, lead: bool):
    """The gradients (in place) and the loss averaged over the distinct
    holders of rows: one sum over the world, to which a process that holds
    another's rows adds zeros, then a division by the holder count (the
    microbatch average's order: the sum, then the division)."""
    with torch.no_grad():
        grads = [p.grad for p in leaves if p.grad is not None]
        total = loss.detach().to(torch.float32).reshape(1).clone()
        if not lead:
            for g in grads:
                g.zero_()
            total.zero_()
        comm.grad_all_reduce(grads + [total])
        for g in grads:
            g.div_(holders)
        return total[0] / holders


def _placed_step(loss_fn, m: int, opt_cfg: AdamWConfig, params, opt_state, batch):
    """One step on placed parameters (module docstring); ``params`` and
    ``opt_state`` updated in place."""
    placement = params.placement
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    dev = leaves[0].device
    batch = _to_device(batch, dev)
    ranks = placement.ranks(dev)
    b = next(iter(batch.values())).shape[0]
    G = ranks.row_groups
    if b % (m * G):
        raise ValueError(f"the batch ({b}) does not split into {m} microbatches over {ranks.row_groups_in_words()}")
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(m):
        per_rank = loss_fn(params, {k: v[i * (b // m):(i + 1) * (b // m)] for k, v in batch.items()})
        per_rank.sum().backward()  # each rank's row group's gradient, in its own blocks
        loss = loss + ranks.psum_rows(per_rank.detach())[0] / G
    loss = loss / m
    with torch.no_grad():
        grads = placement.reduce(params, ranks, float(G * m))
    sumsq = lambda gs: placement.sumsq(gs, ranks)
    _, opt_state, gnorm = adamw_update(params, grads, opt_state, opt_cfg, sumsq=sumsq)
    for p in leaves:
        p.grad = None
    return params, opt_state, {"loss": loss, "gnorm": gnorm}


def build_prefill_step(model: Model, layout=None):
    """``prefill(params, batch)``: whole or serve-placed parameters."""
    return model.prefill_fn(layout)


def build_decode_step(model: Model, layout=None):
    """``decode(params, token, caches)``: whole parameters and caches, or
    serve-placed parameters and placed caches."""
    return model.decode_fn(layout)


def abstract_opt_state(model: Model, opt_cfg: AdamWConfig = AdamWConfig()):
    """The AdamW state of :meth:`Model.abstract` on the meta device (no
    allocation): ``adamw_init`` itself, so the masters and residuals the
    config asks for are there too."""
    return adamw_init(model.abstract(), opt_cfg)


def abstract_caches(model: Model, batch: int, max_len: int):
    """The decode caches on the meta device (no allocation)."""
    return model.init_caches(batch, max_len, device="meta")
