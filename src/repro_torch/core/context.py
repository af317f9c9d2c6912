"""Host-side RaFI context (paper §3.4) over rank-stacked queues.

``RafiContext`` owns the static configuration (item type, capacities,
exchange backend, marshal mode), builds the rank-stacked queues and wraps
the collective entry points.  The paper's host operations:

  resizeRayQueues(N)   → ``capacity`` / ``peer_capacity`` in the constructor
  getDeviceInterface() → ``core.queue`` (enqueue / get_incoming / num_incoming)
  forwardRays()        → :meth:`forward_rays` (one round) and
                         :meth:`run_until_done` (the whole drive loop)

There is no mesh: R ranks share one device, each a row of the leading axis
(or, with ``comm=`` a ``core.collectives.DistributedCollectives``, each
process of a ``torch.distributed`` world holds its block of them and every
queue is that block: ``launch.dist``);
a multi-tier layout for ``exchange="hierarchical"`` is given as
``level_sizes`` (``core.collectives.node_layout`` / ``pod_layout`` /
``joint_tiers`` give the reference's meshes).  The context's ``comm``
records every collective its entry points issue.  Under
``overflow="retain"`` both entry points also return the per-lane ``age``,
and with ``telemetry`` the round's ``RoundStats`` or the drive's
``StatsRing`` last, as the reference's context does.  ``flow="credit"``
(with ``emit_reserve``) turns on the backpressure law; the drive's
callable takes an optional third argument, a ``(R,) bool`` rank-health
mask (the reference's ``with_health``).  While a tracer is
installed (``obs.trace``) every drive is one ``drive.run_until_done`` span.

:func:`queue_from_reference` and :func:`queue_to_reference` carry queue
state across from the JAX package's global layout (``(R·C, …)`` leaves, as
``repro.core.context.RafiContext.global_queue`` gives them) and back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core import queue as Q
from repro_torch.core import termination as term
from repro_torch.core import types as T
from repro_torch.core.collectives import backend
from repro_torch.core.forwarding import ForwardConfig, forward_work
from repro_torch.obs import trace as OT

__all__ = ["RafiContext", "queue_from_reference", "queue_to_reference"]


class RafiContext:
    """A typed work-forwarding context over ``num_ranks`` stacked ranks."""

    def __init__(
        self,
        num_ranks: int,
        proto: Any,
        *,
        capacity: int,
        peer_capacity: int = 0,
        exchange: str = "padded",
        marshal: str = "sort",
        sort_method: str = "pack",
        fast_size: int = 0,
        node_capacity: int = 0,
        level_sizes=(),
        level_capacities=(),
        telemetry: bool = False,
        telemetry_window: int = 16,
        telemetry_buckets: int = 8,
        overflow: str = "drop",
        pipeline_shards: int = 1,
        flow: str = "open",
        emit_reserve: int = -1,
        device=None,
        comm=None,
    ):
        self.proto = proto
        self.item_nbytes = T.item_nbytes(proto)
        self.device = compat.resolve_device(device)
        self.cfg = ForwardConfig(
            num_ranks=num_ranks, capacity=capacity, peer_capacity=peer_capacity,
            exchange=exchange, marshal=marshal, sort_method=sort_method,
            fast_size=fast_size, node_capacity=node_capacity,
            level_sizes=tuple(level_sizes), level_capacities=tuple(level_capacities),
            telemetry=telemetry, telemetry_window=telemetry_window, telemetry_buckets=telemetry_buckets,
            overflow=overflow, pipeline_shards=pipeline_shards, flow=flow, emit_reserve=emit_reserve,
        )
        self.comm = backend(comm)
        self.comm.local_ranks(num_ranks)  # refuse a rank count the world cannot split

    @property
    def num_ranks(self) -> int:
        return self.cfg.num_ranks

    @property
    def local_ranks(self) -> int:
        """The ranks this process holds: ``num_ranks`` on the stacked
        backend, ``num_ranks / world`` over a distributed one."""
        return self.comm.local_ranks(self.cfg.num_ranks)

    def make_queue(self) -> Q.WorkQueue:
        """Empty queues of the process's ranks on the context's device."""
        return Q.make_queue(
            self.proto, self.cfg.capacity, num_ranks=self.local_ranks, device=self.device
        )

    def forward_rays(self) -> Callable[[Q.WorkQueue], Tuple]:
        """The paper's ``forwardRays()``: ``q -> (forwarded_queue, total)``,
        plus the per-lane ``age`` under retain (each standalone call starts
        ages fresh; the drive is where ages thread across rounds), the
        ``(R, R)`` credits under credit flow (each standalone call starts
        fully credited) and the round's ``RoundStats`` with telemetry."""
        cfg, comm = self.cfg, self.comm

        def step(q: Q.WorkQueue):
            return forward_work(q, cfg, comm=comm)

        return step

    def run_until_done(self, round_fn: Callable, *, max_rounds: int = 64) -> Callable:
        """The drive: ``(q0, aux0[, health]) -> (q, aux, rounds, done)``;
        ``done`` is True when the global in-flight count hit zero, False
        when ``max_rounds`` truncated the run with work in flight.  Under
        retain the final per-lane ``age`` follows ``done``; with telemetry
        the ``StatsRing`` of the drive's last ``telemetry_window`` rounds is
        the last output (feed it to ``telemetry.summarize`` /
        ``tune.plan_capacities``).  ``health``, an optional ``(R,) bool``
        mask, re-addresses traffic away from unhealthy ranks for the whole
        drive (``core.health``)."""
        cfg, comm = self.cfg, self.comm

        def drive(q0: Q.WorkQueue, aux0: Any, health=None):
            kw = dict(max_rounds=max_rounds, health=health, comm=comm)
            if not OT.enabled():
                return term.run_until_done(round_fn, q0, aux0, cfg, **kw)
            with OT.span(
                "drive.run_until_done", OT.CAT_DRIVE, exchange=cfg.exchange, flow=cfg.flow,
                overflow=cfg.overflow, max_rounds=max_rounds, num_ranks=self.num_ranks,
            ) as sp:
                out = term.run_until_done(round_fn, q0, aux0, cfg, **kw)
                sp.set(rounds=out[2], done=out[3])
            return out

        return drive


def _field(tree: Any, name: str):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def queue_from_reference(
    np_tree: Any,
    dest,
    count,
    drops,
    num_ranks: int,
    proto: Any,
    *,
    device=None,
) -> Q.WorkQueue:
    """The port's stacked queue from the reference's global queue layout.

    ``np_tree`` holds ``(R·C, …)`` leaves (a dataclass or a dict of arrays)
    that are matched to ``proto``'s fields BY NAME; ``dest`` is ``(R·C,)``,
    ``count``/``drops`` ``(R,)``.  Leaves keep their bits (uint32 words and
    floats alike)."""
    dev = compat.resolve_device(device)
    R = num_ranks

    def conv(a, like: torch.Tensor):
        a = np.asarray(a)
        want = torch.empty(0, dtype=like.dtype).numpy().dtype
        # same width: reinterpret the bits (uint32 words → int32); else cast
        a = a.view(want) if a.dtype.itemsize == want.itemsize else a.astype(want)
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
        return t.reshape((R, -1) + tuple(like.shape)).to(dev)

    items = type(proto)(**{
        f.name: conv(_field(np_tree, f.name), getattr(proto, f.name))
        for f in dataclasses.fields(proto)
    })
    to_i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32).copy()).to(dev)
    return Q.WorkQueue(
        items=items,
        dest=to_i32(dest).reshape(R, -1),
        count=to_i32(count).reshape(R),
        drops=to_i32(drops).reshape(R),
    )


def queue_to_reference(q: Q.WorkQueue) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of :func:`queue_from_reference`: ``(fields {name: (R·C, …)},
    dest (R·C,), count (R,), drops (R,))`` as numpy arrays."""
    flat = lambda t: t.detach().cpu().reshape((-1,) + tuple(t.shape[2:])).numpy()
    fields = {f.name: flat(getattr(q.items, f.name)) for f in dataclasses.fields(q.items)}
    return (
        fields,
        q.dest.detach().cpu().reshape(-1).numpy(),
        q.count.detach().cpu().numpy(),
        q.drops.detach().cpu().numpy(),
    )
