"""Quickstart on the PyTorch port: the work-forwarding core in ~80 lines.

Sections 1–3 of ``examples/quickstart.py`` (telemetry stays off until the
port has it): define a work-item type, emit items to destination ranks from
a per-rank round kernel, and drive the computation to distributed
termination with the sort-free ``marshal="scatter"`` round.  All R ranks
are rows of one rank-stacked tensor on one device.  Section 4 drives the
same computation through the lossless law (``overflow="retain"``, peer
slots too small for the traffic) and the hierarchical route on a 2×4
(node, device) layout: the same deposits, nothing dropped.

Runs on the CUDA card; ``--cpu`` runs the plain PyTorch path.
Run:  PYTHONPATH=src python examples/quickstart_torch.py [--cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch.core import DISCARD, ForwardConfig, enqueue, make_queue, run_until_done, work_item
from repro_torch.core.collectives import node_layout

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch versions of the kernels)")
args = ap.parse_args()
device = "cpu" if args.cpu else "cuda"
if device == "cuda" and not torch.cuda.is_available():
    raise SystemExit("no CUDA device is available; pass --cpu to run the plain PyTorch path")


def section(n, title):
    print(f"== {n}. {title}")


# 1. A work item is any dataclass of tensors — RaFI never looks inside (§3.1).
section(1, "work-item type")


@work_item
@dataclasses.dataclass
class Ray:
    value: torch.Tensor
    hops: torch.Tensor


PROTO = Ray(value=torch.zeros(()), hops=torch.zeros((), dtype=torch.int32))
R, CAP = 8, 128
cfg = ForwardConfig(num_ranks=R, capacity=CAP, exchange="padded", marshal="scatter")

# 2. A per-rank "kernel", here for all ranks at once: read incoming work,
#    emit outgoing work (§3.3).
section(2, "per-rank round kernel")
me = torch.arange(R, device=device)[:, None]
lane = torch.arange(CAP, device=device)[None, :]


def round_fn(q_in, acc, rnd):
    valid = lane < q_in.count[:, None]
    items = q_in.items
    moved = Ray(value=items.value * 0.5, hops=items.hops + 1)
    keep = valid & (moved.hops < 4)  # retire after 4 hops
    dest = torch.where(keep, (me + 1) % R, DISCARD).to(torch.int32)  # ring forwarding
    out = enqueue(make_queue(PROTO, CAP, num_ranks=R, device=device), moved, dest, valid)
    acc = acc + torch.where(valid & ~keep, moved.value, 0.0).sum(dim=1)
    return out, acc


# 3. Drive to distributed termination (§4.2.3): one host sync a round.
section(3, "drive to distributed termination")


def seed_queue():
    q0 = make_queue(PROTO, CAP, num_ranks=R, device=device)
    four = torch.ones(R, 4, device=device)
    return enqueue(q0, Ray(value=four * (me + 1), hops=torch.zeros(R, 4, dtype=torch.int32, device=device)),
                   me.expand(R, 4).to(torch.int32), four > 0)


def drive(c, max_rounds=16):
    return run_until_done(round_fn, seed_queue(), torch.zeros(R, device=device), c, max_rounds=max_rounds)


q, acc, rounds, _done = drive(cfg)
print(f"deposited per rank: {acc.cpu().numpy()}")
print(f"rounds to distributed termination: {rounds}")
expected = sum((r + 1) * 4 for r in range(R)) * 0.5**4
print(f"total deposited: {float(acc.sum()):.3f}  (expected {expected:.3f})")
assert abs(float(acc.sum()) - expected) < 1e-3

# 4. The lossless law and the hierarchical route.  ``overflow="retain"``
#    keeps every row a clamp would cut at the front of its queue and
#    retries it next round, oldest first; with 1-row peer slots the ring
#    now takes more rounds, and deposits the same.  The hierarchical route
#    ships each hop fastest tier first over a (node, device) layout.
section(4, "lossless and hierarchical drives")
for label, c in (
    ("retain, 1-row peer slots", ForwardConfig(R, CAP, peer_capacity=1, marshal="scatter", overflow="retain")),
    ("hierarchical 2x4", ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=node_layout(2, 4))),
    ("hierarchical 2x4, retain", ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=node_layout(2, 4),
                                               level_capacities=(1, 1), overflow="retain")),
):
    q, acc2, rounds2, done2, *_age = drive(c, max_rounds=64)
    print(f"{label}: total deposited {float(acc2.sum()):.3f} in {rounds2} rounds, "
          f"drops {int(q.drops.sum())}, done {done2}")
    assert torch.equal(acc2, acc) and int(q.drops.sum()) == 0 and done2
print("OK")
