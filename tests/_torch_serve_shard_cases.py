"""The placed serving run ``tests/test_torch_serve_shard_dist.py`` makes
in every process of a gloo world, and once on the stacked backend in the
test's own process: ``BatchedEngine`` on qwen2-7b's smoke config with its
parameters serve-placed on the ``(2, 4)`` layout over ``comm``, from
seed-0 weights.  Every process returns the same: the token lists, the
last step's whole logits, and its call record.  This module imports
neither ``jax`` nor ``repro``.
"""
import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import placement as PL
from repro_torch.launch.mesh import Layout
from repro_torch.launch.serve import BatchedEngine, Request
from repro_torch.models.api import build_model

ARCH, SLOTS, MAX_LEN, N_REQ = "qwen2-7b", 8, 32, 10


def requests(vocab: int) -> list:
    """The requests, from numpy: the same in every process."""
    rng = np.random.default_rng(12)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(2, 9))).astype(np.int32),
                    max_new_tokens=int(rng.integers(2, 8))) for i in range(N_REQ)]


def serve(comm) -> dict:
    """The placed engine's run over ``comm`` (None: stacked)."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    placement = PL.serve_placement(model, Layout(2, 4, comm=comm))
    params = placement.place(model.init(torch.Generator().manual_seed(0), device="cpu"))
    engine = BatchedEngine(model, params, slots=SLOTS, max_len=MAX_LEN, device="cpu")
    step, last = engine.step_fn, []

    def keep(params, token, caches):
        logits, caches = step(params, token, caches)
        last[:] = [logits.numpy().copy()]
        return logits, caches

    engine.step_fn = keep
    placement.comm.reset()
    tokens = engine.run(requests(cfg.vocab_size))
    calls = sorted([c.kind, -1 if c.tier is None else c.tier, list(c.shape), n] for c, n in placement.comm.calls.items())
    return {"tokens": tokens, "last_logits": last[0], "steps": engine.steps, "calls": calls}
