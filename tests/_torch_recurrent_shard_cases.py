"""The placed recurrent runs ``tests/test_torch_recurrent_shard_dist.py``
makes in every process of a gloo world, and once on the stacked backend in
the test's own process: the smoke configs of recurrentgemma-2b and
rwkv6-3b from seed-0 weights, over ``comm``: a few placed decode steps
from seeded caches on layout (2, 4) (a process holds one data group), and
recurrentgemma's also on (1, 8) (the model tier, ξ's gather with it,
crosses the processes); and two placed train steps with ``fsdp`` on (2,
4) (the FSDP gathers and ``reduce_scatter``s cross the processes).  Every
process returns the same numpy arrays: each decode step's logits and the
caches gathered whole; each train step's loss and gradient norm and the
parameters and AdamW moments gathered whole.  This module imports
neither ``jax`` nor ``repro``.
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

DECODE = (("rwkv6-3b", (2, 4)), ("recurrentgemma-2b", (2, 4)), ("recurrentgemma-2b", (1, 8)))
TRAIN = ("rwkv6-3b", "recurrentgemma-2b")
B, T, DEPTHS, DECODE_STEPS = 4, 16, (0, 3, 5, 9), 4
TRAIN_STEPS, BATCH = 2, (4, 16)
OPT = dict(lr=1e-3, warmup_steps=2, eps=1e-6)


def _flat(prefix, tree):
    return {f"{prefix}.{'.'.join(p)}": t.detach().numpy().copy() for p, t in S.named_leaves(tree)}


def decode(comm, arch: str, layout) -> dict:
    """``DECODE_STEPS`` placed decode steps of the global token batch from
    seeded caches (numpy, the same in every process)."""
    model = build_model(get_smoke_config(arch))
    layout = Layout(*layout, comm=comm)
    params = PL.serve_placement(model, layout).place(model.init(torch.Generator().manual_seed(0), device="cpu"))
    cp = PL.cache_placement(model, layout, B, T)
    rng = np.random.default_rng(7)
    whole = model.init_caches(B, T, device="cpu")
    for path, t in S.named_leaves(whole):
        fill = np.broadcast_to(np.asarray(DEPTHS, np.int32), t.shape) if path[-1] == "pos" else \
            rng.standard_normal(tuple(t.shape)).astype(np.float32)
        t.copy_(torch.from_numpy(np.array(fill)))
    caches = cp.place(whole)
    step = model.decode_fn()
    out = {}
    for i in range(DECODE_STEPS):
        token = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (B, 1)).astype(np.int32))
        logits, caches = step(params, token, caches)
        out[f"logits{i}"] = logits.numpy().copy()
    out.update(_flat("caches", cp.gather(caches)))
    return out


def train(comm, arch: str) -> dict:
    """``TRAIN_STEPS`` placed steps with ``fsdp`` of the global batches."""
    model = build_model(dataclasses.replace(get_smoke_config(arch), fsdp=True))
    placement = PL.train_placement(model, Layout(2, 4, comm=comm))
    params = placement.place(model.init(torch.Generator().manual_seed(0), device="cpu"))
    opt = adamw_init(params, AdamWConfig(**OPT))
    step = build_train_step(model, None, AdamWConfig(**OPT))
    losses, gnorms = [], []
    for i in range(TRAIN_STEPS):
        tokens = np.random.default_rng(40 + i).integers(0, model.cfg.vocab_size, BATCH).astype(np.int32)
        params, opt, met = step(params, opt, {"tokens": tokens})
        losses.append(float(met["loss"]))
        gnorms.append(float(met["gnorm"]))
    out = {"losses": np.asarray(losses, np.float32), "gnorms": np.asarray(gnorms, np.float32)}
    for kind, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"])):
        out.update(_flat(kind, placement.gather(tree)))
    return out


def run_all(comm) -> dict:
    """Every decode and train run."""
    out = {}
    for arch, layout in DECODE:
        out[f"decode_{arch}_{layout[0]}x{layout[1]}"] = decode(comm, arch, layout)
    for arch in TRAIN:
        out[f"train_{arch}"] = train(comm, arch)
    return out
