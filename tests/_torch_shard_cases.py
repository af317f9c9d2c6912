"""The placed train runs ``tests/test_torch_shard_dist.py`` makes in every
process of a gloo world, and once on the stacked backend in the test's own
process: a few steps of a dense smoke config with its state placed on the
``(2, 4)`` layout, over ``comm``.  Every process returns the same numpy
arrays: each step's loss and gradient norm, the parameters and AdamW
moments gathered whole, and its call record.  This module imports neither
``jax`` nor ``repro``.
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

ARCH, STEPS, BATCH = "qwen2-7b", 2, (4, 16)
OPT = dict(lr=1e-3, warmup_steps=2, eps=1e-6)
RUNS = {"fsdp": dict(fsdp=True), "fsdp_micro2": dict(fsdp=True, microbatches=2), "tp_only": dict(fsdp=False)}


def batches(vocab: int) -> list:
    """The global token batches, from numpy: the same in every process."""
    return [np.random.default_rng(40 + i).integers(0, vocab, BATCH).astype(np.int32) for i in range(STEPS)]


def placed_run(comm, name: str, wrong_data_psum: bool = False) -> dict:
    """``STEPS`` placed steps of ``ARCH``'s smoke config with ``RUNS[name]``
    on layout (2, 4) over ``comm`` (None: stacked), from seed-0 weights.
    ``wrong_data_psum`` plants a fault: the gradient of a leaf replicated
    over ``data`` left unsummed over it."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), **RUNS[name])
    model = build_model(cfg)
    placement = PL.train_placement(model, Layout(2, 4, comm=comm))
    if wrong_data_psum:
        reduce = placement.reduce

        def skip(placed, ranks, scale):
            return reduce(placed, dataclasses.replace(ranks, layout=dataclasses.replace(ranks.layout, data=1)), scale)

        object.__setattr__(placement, "reduce", skip)
    params = placement.place(model.init(torch.Generator().manual_seed(0), device="cpu"))
    opt = adamw_init(params, AdamWConfig(**OPT))
    step = build_train_step(model, None, AdamWConfig(**OPT))
    placement.comm.reset()
    losses, gnorms = [], []
    for tokens in batches(cfg.vocab_size):
        params, opt, met = step(params, opt, {"tokens": tokens})
        losses.append(float(met["loss"]))
        gnorms.append(float(met["gnorm"]))
    calls = sorted([c.kind, -1 if c.tier is None else c.tier, list(c.shape), c.nbytes, n]
                   for c, n in placement.comm.calls.items())
    out = {"losses": np.asarray(losses, np.float32), "gnorms": np.asarray(gnorms, np.float32), "calls": calls,
           "step": int(opt["step"])}
    for kind, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"])):
        out.update({f"{kind}.{'.'.join(p)}": t.detach().numpy().copy()
                    for p, t in S.named_leaves(placement.gather(tree))})
    return out


def run_all(comm) -> dict:
    """Every run of ``RUNS``, and the planted fault of ``fsdp`` off."""
    out = {name: placed_run(comm, name) for name in RUNS}
    out["tp_only_wrong_data_psum"] = placed_run(comm, "tp_only", wrong_data_psum=True)
    return out
