"""Quickstart on the PyTorch port: the work-forwarding core in ~100 lines.

Sections 1–6 of ``examples/quickstart.py``: define a work-item type, emit
items to destination ranks from a per-rank round kernel, drive the
computation to distributed termination with the sort-free
``marshal="scatter"`` round and the flight recorder on
(``telemetry=True``), read the recorder's summary back, run the same drive
pipelined (``pipeline_shards=2``), bit-exact with the bulk one, and drive
the chaos harness's sustained overload open against credit flow under the
span tracer; section 7 then exports that trace as Perfetto JSON and reads
the two overload runs back through the flight-data analyzer
(``obs.report``), which flags the open run, and only it, as degraded.  All
R ranks are rows of one rank-stacked tensor on one device.  Section 5b
drives the computation of sections 1–3 through the lossless law
(``overflow="retain"``, peer slots too small for the traffic) and the
hierarchical route on a 2×4 (node, device) layout: the same deposits,
nothing dropped.

Runs on the CUDA card; ``--cpu`` runs the plain PyTorch path.  Under
``torchrun`` sections 1–5b spread the 8 ranks over the world's processes
(``launch.dist``: gloo with ``--cpu``, NCCL with a card per process), each
holding its block of ranks, and process 0 prints the same lines; sections
6–7 (the chaos driver and the flight report) run on process 0 alone, on
the stacked backend.
Run:  PYTHONPATH=src python examples/quickstart_torch.py [--cpu]
      PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 2 \
          examples/quickstart_torch.py --cpu
"""
import argparse
import dataclasses
import os
import sys
import tempfile

import torch

from repro_torch import telemetry as TM
from repro_torch.chaos import run_scenario, sustained_overload
from repro_torch.core import DISCARD, ForwardConfig, enqueue, make_queue, run_until_done, work_item
from repro_torch.core.collectives import StackedCollectives, node_layout
from repro_torch.launch import dist
from repro_torch.obs import report as OR
from repro_torch.obs import trace as OT

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch versions of the kernels)")
args = ap.parse_args()
device = "cpu" if args.cpu else "cuda"
if device == "cuda" and not torch.cuda.is_available():
    raise SystemExit("no CUDA device is available; pass --cpu to run the plain PyTorch path")
# under torchrun: this process's block of the ranks, and only process 0 prints
comm = dist.init_world(device) if "WORLD_SIZE" in os.environ else StackedCollectives()
if device == "cuda":
    device = f"cuda:{os.environ.get('LOCAL_RANK', 0)}"
LEAD = comm.index == 0
if not LEAD:
    sys.stdout = open(os.devnull, "w")


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
cfg = ForwardConfig(num_ranks=R, capacity=CAP, exchange="padded", marshal="scatter", telemetry=True)

# 2. A per-rank "kernel", here for all ranks at once: read incoming work,
#    emit outgoing work (§3.3).
section(2, "per-rank round kernel")
me = comm.ranks(R, device)[:, None]  # the global ids of this process's ranks
L = me.shape[0]
lane = torch.arange(CAP, device=device)[None, :]


def round_fn(q_in, acc, rnd):
    valid = lane < q_in.count[:, None]
    items = q_in.items
    moved = Ray(value=items.value * 0.5, hops=items.hops + 1)
    keep = valid & (moved.hops < 4)  # retire after 4 hops
    dest = torch.where(keep, (me + 1) % R, DISCARD).to(torch.int32)  # ring forwarding
    out = enqueue(make_queue(PROTO, CAP, num_ranks=L, device=device), moved, dest, valid)
    acc = acc + torch.where(valid & ~keep, moved.value, 0.0).sum(dim=1)
    return out, acc


# 3. Drive to distributed termination (§4.2.3): one host sync a round.  With
#    telemetry on, the StatsRing of the last W rounds rides the drive.
section(3, "drive to distributed termination")


def seed_queue():
    q0 = make_queue(PROTO, CAP, num_ranks=L, device=device)
    four = torch.ones(L, 4, device=device)
    return enqueue(q0, Ray(value=four * (me + 1), hops=torch.zeros(L, 4, dtype=torch.int32, device=device)),
                   me.expand(L, 4).to(torch.int32), four > 0)


def drive(c, max_rounds=16):
    q, acc, *rest = run_until_done(round_fn, seed_queue(), torch.zeros(L, device=device), c,
                                   max_rounds=max_rounds, comm=comm)
    # every rank's deposits, drops and ring rows, in every process (host summaries)
    return (dist.gather_tree(q, comm), comm.gather_all(acc), *dist.gather_tree(tuple(rest), comm))


q, acc, rounds, _done, ring = drive(cfg)
print(f"deposited per rank: {acc.cpu().numpy()}")
print(f"rounds to distributed termination: {rounds}")
expected = sum((r + 1) * 4 for r in range(R)) * 0.5**4
print(f"total deposited: {float(acc.sum()):.3f}  (expected {expected:.3f})")
assert abs(float(acc.sum()) - expected) < 1e-3

# 4. Read the flight recorder back on the host: what the burst's traffic
#    looked like, and what repro_torch.tune would size the send slots to.
section(4, "telemetry summary")
summary = TM.summarize(ring, tier_capacities=TM.tier_capacities(cfg))
print(
    f"telemetry: {summary['rounds']} rounds recorded, "
    f"max segment demand {summary['demand_max'][0]} "
    f"(peer slots sized {summary['tier_capacities'][0]}), "
    f"clamp drops {summary['drops']}"
)
assert summary["drops"] == 0

# 5. The overlap law: ``pipeline_shards=S`` splits every peer segment into S
#    micro-shards, each on its own payload + count collective pair.
#    Pipelining changes the schedule, never the answer: the same drive is
#    bit-exact with the bulk one.
section(5, "pipelined overlap, bit-exact")
q2, acc2, rounds2, _done2, _ring2 = drive(dataclasses.replace(cfg, pipeline_shards=2))
assert torch.equal(acc2, acc) and rounds2 == rounds
print(f"pipelined (S=2) drive bit-exact with bulk: {float(acc2.sum()):.3f}")

# 5b. The lossless law and the hierarchical route.  ``overflow="retain"``
#    keeps every row a clamp would cut at the front of its queue and
#    retries it next round, oldest first; with 1-row peer slots the ring
#    now takes more rounds, and deposits the same.  The hierarchical route
#    ships each hop fastest tier first over a (node, device) layout.
section("5b", "lossless and hierarchical drives")
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

# 6. The backpressure law: under sustained overload, open flow ships rows
#    its receivers must clamp — wire spent on work that is thrown away.
#    ``flow="credit"`` piggybacks each receiver's free space on the count
#    collective and gates senders on it, so every shipped row lands: slower
#    to drain (credits are one round stale), but goodput 1.0 and no loss.
#    The chaos driver runs the scenario through the drive loop, captured
#    under the span tracer (host side only: every number is unchanged).
dist.destroy_world()
if not LEAD:  # sections 6-7 run on process 0 alone, on the stacked backend
    sys.exit(0)
section(6, "backpressure under sustained overload")
sc = sustained_overload()  # 2 of 8 ranks hot: concentration that persists
results = {}
with OT.capture() as tracer:
    for flow in ("open", "credit"):
        r = results[flow] = run_scenario(
            sc.num_ranks, sc, capacity=16, max_rounds=256, flow=flow, overflow="retain", pipeline_shards=4,
            device=device,
        )
        print(
            f"overload [{flow:6s}]: delivered {r['delivered_total']}/{r['emitted']}"
            f" in {r['rounds']} rounds, goodput {r['goodput']:.3f}, drops {r['drops']}"
        )
        if flow == "open":
            assert r["goodput"] < 0.9  # wire wasted on clamped rows
        else:
            assert r["goodput"] == 1.0 and r["drops"] == 0 and r["done"]
print(f"traced {len(tracer.select(name='chaos.run_scenario'))} scenario spans, {len(tracer.events)} events")

# 7. The observation law: the burst above became flight data.  Export the
#    host span timeline as Perfetto JSON (load it at ui.perfetto.dev), write
#    the chaos runs into a capture file, and let the analyzer re-derive the
#    ledger and flag the degraded run — open flow, and only open flow.
section(7, "observation law: trace export + flight-data report")
outdir = tempfile.mkdtemp(prefix="rafi_quickstart_")
trace_path = os.path.join(outdir, "trace.perfetto.json")
tracer.save(trace_path)
print(f"perfetto timeline: {trace_path} ({len(tracer.events)} events)")

capture_path = os.path.join(outdir, "capture.json")
OR.save_capture(
    capture_path,
    [
        OR.chaos_capture(f"{sc.name}_{flow}", results[flow], flow=flow, tier_capacities=(4,), capacity=16)
        for flow in ("open", "credit")
    ],
    meta={"source": "quickstart_torch"},
)
report = OR.analyze(OR.load_capture(capture_path))
print(OR.render(report))
print(f"degraded_runs: {report['degraded_runs']}")
assert report["degraded_runs"] == [f"{sc.name}_open"]
print("OK")
