"""repro_torch.core — the work-forwarding infrastructure over rank-stacked
tensors (the counterpart of ``repro.core``).

Device interface: WorkQueue, make_queue, enqueue, get_incoming,
  num_incoming, clear, DISCARD.
Host context: RafiContext, ForwardConfig, forward_work, run_until_done,
  rebalance, cycle_step / deliver_by_cycling (the ring alternative),
  StackedCollectives and DistributedCollectives (the collective layer,
  rank-stacked or over a torch.distributed world, and its call recorder).
Recovery: health_table / remap_dest (the rank-draining destination remap),
  run_checkpointed / resume_run / conservation_check (the segmented,
  checkpointed drive and its watchdog).
Item typing: work_item, item_nbytes, pack_payload, unpack_payload.
"""
from repro_torch.core.collectives import DistributedCollectives, StackedCollectives
from repro_torch.core.context import RafiContext, queue_from_reference, queue_to_reference
from repro_torch.core.cycling import cycle_step, deliver_by_cycling
from repro_torch.core.forwarding import ForwardConfig, forward_work
from repro_torch.core.health import health_table, remap_dest
from repro_torch.core.queue import (
    DISCARD,
    WorkQueue,
    clear,
    enqueue,
    get_incoming,
    make_queue,
    num_incoming,
)
from repro_torch.core.rebalance import rebalance
from repro_torch.core.recovery import conservation_check, resume_run, run_checkpointed
from repro_torch.core.termination import run_until_done
from repro_torch.core.types import (
    PackSpec,
    batched_zeros,
    item_nbytes,
    pack_payload,
    pack_spec,
    unpack_payload,
    work_item,
)

__all__ = [
    "DISCARD",
    "DistributedCollectives",
    "ForwardConfig",
    "PackSpec",
    "RafiContext",
    "StackedCollectives",
    "WorkQueue",
    "batched_zeros",
    "clear",
    "conservation_check",
    "cycle_step",
    "deliver_by_cycling",
    "enqueue",
    "forward_work",
    "get_incoming",
    "health_table",
    "item_nbytes",
    "make_queue",
    "num_incoming",
    "pack_payload",
    "pack_spec",
    "queue_from_reference",
    "queue_to_reference",
    "rebalance",
    "remap_dest",
    "resume_run",
    "run_checkpointed",
    "run_until_done",
    "unpack_payload",
    "work_item",
]
