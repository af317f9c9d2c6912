"""Process set-up for the distributed collective backend.

A ``torch.distributed`` world of W processes runs the port's R ranks as W
contiguous blocks of ``L = R / W`` ranks (``core.collectives.
DistributedCollectives``): process p holds ranks ``[p·L, (p+1)·L)``, and
every rank-stacked tensor it handles is that block.

  init_world(device, world=, rank=, store=)
      sets up the default process group and returns the backend.  Under
      ``torchrun`` it reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``;
      otherwise the caller gives ``world``, ``rank`` and a ``file://``
      store.  A CUDA device sets up NCCL on ``cuda:{LOCAL_RANK}``; gloo is
      set up only when the caller asks for ``device="cpu"``.  There is no
      fallback: a missing card or a failing NCCL is an error, never a quiet
      switch to gloo or to the CPU.  NCCL takes one process per card.
  spawn_world(fn, world, device=, timeout_s=)
      runs ``fn(comm, *args)`` in ``world`` spawned processes (tests, the
      chip smoke run): one thread a child, a ``file://`` store in a fresh
      temporary directory (no TCP port to compete for), a time limit after
      which every child is killed, and a child that raises fails the call.
  shard_tree(tree, comm, R), gather_tree(tree, comm)
      the backend's ``comm.shard_tree`` and ``comm.gather_tree``: a
      rank-stacked pytree (a ``WorkQueue``, a carry, a ``StatsRing``) cut to
      the process's block, and the blocks gathered back into the whole tree
      in every process (off the call recorder).

Run the examples as a world:
``python -m torch.distributed.run --standalone --nproc_per_node 2
examples/streamlines_demo_torch.py --cpu``.
"""
from __future__ import annotations

import datetime
import inspect
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.collectives import DistributedCollectives

__all__ = ["destroy_world", "gather_tree", "init_world", "shard_tree", "spawn_world"]


_TIMEOUT = datetime.timedelta(seconds=600)  # a collective that waits longer fails


def init_world(device=None, *, world: Optional[int] = None, rank: Optional[int] = None,
               store: Optional[str] = None) -> DistributedCollectives:
    """Set up the default process group and return its backend.

    ``device``: None or a CUDA device → NCCL on ``cuda:{LOCAL_RANK}``;
    ``"cpu"`` → gloo.  Under ``torchrun`` (``RANK`` and ``WORLD_SIZE``
    set, ``world`` not given) the rendezvous is torchrun's; otherwise
    ``world``, ``rank`` and ``store`` (an ``init_method`` URL such as
    ``file:///tmp/x/store``) are required."""
    dev = torch.device("cuda" if device is None else device)
    env = os.environ
    if world is None and "RANK" in env and "WORLD_SIZE" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        local_rank, init_method = int(env.get("LOCAL_RANK", rank)), "env://"
    else:
        if world is None or rank is None or store is None:
            raise ValueError("init_world needs world, rank and store outside torchrun")
        local_rank, init_method = rank, store
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    kw = {}
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_world: no CUDA device is available for NCCL; pass device='cpu' for gloo")
        if not dist.is_nccl_available():
            raise RuntimeError("init_world: this torch has no NCCL backend")
        dev = torch.device("cuda", local_rank if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        backend = "nccl"
        if "device_id" in inspect.signature(dist.init_process_group).parameters:
            kw["device_id"] = dev  # bind the communicator to the card now, not at the first call
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_world: no backend for device {dev}")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, timeout=_TIMEOUT, **kw)
    return DistributedCollectives(world=world, index=rank)


def destroy_world() -> None:
    """Tear down the default process group, if one is set up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _child(fn, index: int, world: int, device, store: str, out_dir: str, args: Sequence[Any]) -> None:
    torch.set_num_threads(1)
    try:
        comm = init_world(device, world=world, rank=index, store=store)
        try:
            res = fn(comm, *args)
        finally:
            destroy_world()
        with open(os.path.join(out_dir, f"result_{index}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"error_{index}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_world(fn: Callable, world: int, *, args: Sequence[Any] = (), device="cpu",
                timeout_s: float = 120.0) -> List[Any]:
    """Run ``fn(comm, *args)`` in ``world`` spawned processes and return
    their results, process 0 first.  ``fn`` must be importable (a module
    function) and its result picklable.  A child that exits with an error
    fails the call at once (the others are killed); a world that has not
    finished within ``timeout_s`` is killed whole."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rafi_world_")
    store = "file://" + os.path.join(tmp, "store")
    procs = [ctx.Process(target=_child, args=(fn, i, world, device, store, tmp, tuple(args)))
             for i in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                # the others fail in turn as their peer goes: give them a
                # moment, so that the first error is among those reported
                grace = time.monotonic() + 2.0
                while time.monotonic() < grace and any(p.exitcode is None for p in procs):
                    time.sleep(0.02)
                raise RuntimeError(f"a world of {world} failed:\n" + "\n".join(
                    f"process {i}: " + (open(err).read() if os.path.exists(err) else f"exit code {p.exitcode}")
                    for i, p in enumerate(procs) if p.exitcode not in (None, 0)
                    for err in [os.path.join(tmp, f"error_{i}.txt")]))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {world} did not finish within {timeout_s} s; killed")
            time.sleep(0.02)
        out = []
        for i in range(world):
            with open(os.path.join(tmp, f"result_{i}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def shard_tree(tree: Any, comm, num_ranks: int) -> Any:
    """``comm.shard_tree(tree, num_ranks)``: the process's block of a
    rank-stacked tree."""
    return comm.shard_tree(tree, num_ranks)


def gather_tree(tree: Any, comm) -> Any:
    """``comm.gather_tree(tree)``: the whole rank-stacked tree in every
    process, off the call recorder."""
    return comm.gather_tree(tree)
