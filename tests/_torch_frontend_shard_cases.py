"""The placed stub-frontend runs ``tests/test_torch_frontend_shard_dist.py``
makes in every process of a gloo world, and once on the stacked backend in
the test's own process, from seed-0 weights of the smoke configs: a few
placed seamless-m4t-medium decode steps from seeded caches and a seeded
memory on layout (2, 4), under ``dp_over_model`` and split over ``model``
(``SM_TP``, the smoke config as it ships) (a process holds one data
group: the gathers and sums over ``model`` stay in the process, the
logits' rows cross it); and two placed train steps of each arch on (2,
4): qwen2-vl with ``fsdp`` on ``embeds`` and ``labels`` (the FSDP gathers
and ``reduce_scatter``s cross the processes), seamless under
``dp_over_model`` (each leaf's flat ``psum`` over every rank crosses
them) and split over ``model`` (the gradients' ``psum``s over ``data``
cross them).  Every process returns the same numpy arrays: each decode step's
logits and the caches gathered whole; each train step's loss and
gradient norm and the parameters and AdamW moments gathered whole.  This
module imports neither ``jax`` nor ``repro``.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import placement as PL
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import Layout
from repro_torch.launch.steps import build_train_step
from repro_torch.models.api import build_model
from repro_torch.optim import AdamWConfig, adamw_init

VL, SM = "qwen2-vl-72b", "seamless-m4t-medium"
SM_TP = SM + "-tp"  # seamless's smoke config as it ships: split over model, no dp_over_model
TRAIN = (VL, SM, SM_TP)
B, T, FRAMES, DEPTHS, DECODE_STEPS = 8, 16, 8, (0, 3, 5, 9, 1, 7, 2, 4), 4
TRAIN_STEPS = 2
OPT = dict(lr=1e-3, warmup_steps=2, eps=1e-6)


def _cfg(arch, **changes):
    extra = {"dp_over_model": True} if arch == SM else {}
    return dataclasses.replace(get_smoke_config(SM if arch == SM_TP else arch), **extra, **changes)


def _flat(prefix, tree):
    return {f"{prefix}.{'.'.join(p)}": t.detach().numpy().copy() for p, t in S.named_leaves(tree)}


def decode(comm, arch=SM) -> dict:
    """``DECODE_STEPS`` placed seamless decode steps (``arch``: ``SM`` or
    ``SM_TP``) of the global token batch against a seeded global memory,
    from seeded caches (numpy, the same in every process)."""
    model = build_model(_cfg(arch))
    layout = Layout(2, 4, comm=comm)
    params = PL.serve_placement(model, layout).place(model.init(torch.Generator().manual_seed(0), device="cpu"))
    cp = PL.cache_placement(model, layout, B, T)
    rng = np.random.default_rng(7)
    whole = model.init_caches(B, T, device="cpu")
    for path, t in S.named_leaves(whole):
        fill = np.broadcast_to(np.asarray(DEPTHS, np.int32), t.shape) if path[-1] == "pos" else \
            rng.standard_normal(tuple(t.shape)).astype(np.float32)
        t.copy_(torch.from_numpy(np.array(fill)))
    caches = cp.place(whole)
    memory = torch.from_numpy(rng.standard_normal((B, FRAMES, model.cfg.d_model)).astype(np.float32))
    step = model.decode_fn()
    out = {}
    for i in range(DECODE_STEPS):
        token = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (B, 1)).astype(np.int32))
        logits, caches = step(params, token, caches, memory)
        out[f"logits{i}"] = logits.numpy().copy()
    out.update(_flat("caches", cp.gather(caches)))
    return out


def batch(cfg, seed) -> dict:
    """A global train batch: qwen2-vl's ``tokens``, ``embeds`` and
    ``labels``, seamless's ``frames`` and ``tokens``."""
    rng = np.random.default_rng(seed)
    if cfg.kind == "encdec":
        return {"frames": rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (B, 12)).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32),
            "embeds": rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (4, 15)).astype(np.int32)}


def train(comm, arch: str) -> dict:
    """``TRAIN_STEPS`` placed steps of the global batches (qwen2-vl with
    ``fsdp``)."""
    model = build_model(_cfg(arch, fsdp=arch == VL))
    placement = PL.train_placement(model, Layout(2, 4, comm=comm))
    params = placement.place(model.init(torch.Generator().manual_seed(0), device="cpu"))
    opt = adamw_init(params, AdamWConfig(**OPT))
    step = build_train_step(model, None, AdamWConfig(**OPT))
    losses, gnorms = [], []
    for i in range(TRAIN_STEPS):
        params, opt, met = step(params, opt, batch(model.cfg, 40 + i))
        losses.append(float(met["loss"]))
        gnorms.append(float(met["gnorm"]))
    out = {"losses": np.asarray(losses, np.float32), "gnorms": np.asarray(gnorms, np.float32)}
    for kind, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"])):
        out.update(_flat(kind, placement.gather(tree)))
    return out


def run_all(comm) -> dict:
    """The decode run and every train run."""
    out = {"decode": decode(comm), "decode_tp": decode(comm, SM_TP)}
    for arch in TRAIN:
        out[f"train_{arch}"] = train(comm, arch)
    return out
