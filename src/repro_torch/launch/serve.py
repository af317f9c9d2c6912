"""Batched serving loop (counterpart of ``repro.launch.serve``).

A fixed pool of decode slots: requests with heterogeneous remaining lengths
occupy batch slots; each engine step decodes one token for every slot.
Prompts are replayed token by token (slots step in lockstep, so admission
happens between steps); the next token is the greedy argmax (the first
index on ties, as ``jnp.argmax``); a finished slot is refilled from the
queue.  Empty slots still step, feeding token 0, as in the reference: under
MoE their tokens are routed and compete for expert capacity.

Over a ``torch.distributed`` world (the layout's ``comm``) the engine runs
the layout ``(1, tp)``: one data group whose tp model ranks spread over
the processes.  Every process holds every slot and runs the dense layers on
all of them; the MoE plane routes its ranks' token slices and joins the
group's outputs with its ``all_gather``, so every process computes the same
logits, bit for bit, and admits and retires requests on them alike: the
slot tables stay equal and every process issues the same collectives.

Given placed parameters (``launch.placement.serve_placement``) the engine
serves on their layout ``(data, model)``, on its backend: its caches are
made already placed (``cache_placement``: the slots over ``data``, the
sequence over ``model``), each step is ``api.placed_decode``, and every
process holds every slot's host state and the same whole logits, so the
slot tables stay equal here too.  Over a world of W processes process p
holds ranks ``[p·L, (p+1)·L)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import compat
from repro_torch.models.api import Model

__all__ = ["BatchedEngine", "Request", "reset_slot"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray         # (L,) int32
    max_new_tokens: int = 16
    output: Optional[List[int]] = None


def reset_slot(caches, slot: int):
    """Zero a slot's decode positions so a freed slot can be reused by a
    new request — stale KV rows past pos are masked out.  Out of place, as
    the reference's ``.at[].set``.  As there, a recurrent layer's state (an
    RWKV ``S``, an RG-LRU ``h`` and conv tail) is left as the last request
    left it: the next request in the slot starts from it.  On placed
    caches slot s is row ``s % (slots/data)`` of data group ``s //
    (slots/data)``, reset on every model rank of that group."""
    placement = getattr(caches, "placement", None)
    groups = None if placement is None else placement.layout.local_ranks() // placement.layout.model

    def visit(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = visit(v)
            elif k == "pos":
                out[k] = v.clone()
                if groups is None:
                    out[k][..., slot] = 0
                else:  # (L, …, b): the rows of the rank's group
                    b = v.shape[-1]
                    out[k][(groups == slot // b).to(v.device), ..., slot % b] = 0
            else:
                out[k] = v
        return out

    out = visit(caches)
    return out if placement is None else caches.like(out)


class BatchedEngine:
    """Slot-synchronous engine: all slots step together; finished slots are
    refilled from the queue.  ``layout`` is the MoE dispatch's rank layout
    (the reference's ``mesh``); placed parameters carry their own, and a
    ``layout`` beside them must be it.  ``device`` where the caches and
    tokens live (``None``: the CUDA card), which must be the parameters'
    device.  Each step's MoE drops are kept in ``step_drops`` (0-d
    tensors, read without a sync until the caller reads them)."""

    def __init__(self, model: Model, params, *, slots: int = 4, max_len: int = 128, layout=None, device=None):
        if model.cfg.kind == "encdec":
            # the reference's engine steps (params, token, caches); an
            # encoder-decoder's step also needs the encoder memory
            raise ValueError("BatchedEngine serves decoder-only models; an encdec step needs the encoder memory "
                             "(Model.decode_fn)")
        placement = getattr(params, "placement", None)
        self.cache_placement = None
        if placement is not None:
            from repro_torch.launch.placement import cache_placement

            if layout is not None and layout != placement.layout:
                raise ValueError(f"the layout {layout} differs from the placed parameters' {placement.layout}")
            if slots % placement.layout.data:
                raise ValueError(f"{slots} slots do not split over {placement.layout.data} data groups")
            self.cache_placement = cache_placement(model, placement.layout, slots, max_len)
            layout = None
        comm = getattr(layout, "comm", None)
        if comm is not None and comm.world > 1 and layout.data != 1:
            raise ValueError(f"over a world of {comm.world} processes the engine runs the layout (1, tp), "
                             f"not {layout}: every process holds every slot")
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = compat.resolve_device(device)
        self._step = model.decode_fn(layout=layout, drops=True)
        self.step_drops: List[torch.Tensor] = []
        self.steps = 0  # engine steps of the last run

    def step_fn(self, params, token, caches):
        """One decode step of every slot: (logits (B, V), new caches)."""
        logits, caches, drops = self._step(params, token, caches)
        self.step_drops.append(drops)
        return logits, caches

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {r.rid: [] for r in requests}
        pending = list(requests)
        if self.cache_placement is not None:
            caches = self.cache_placement.zeros(self.device)
        else:
            caches = self.model.init_caches(self.slots, self.max_len, device=self.device)
        slot_req: List[Optional[Request]] = [None] * self.slots
        left = np.zeros(self.slots, np.int64)
        cur = np.zeros((self.slots, 1), np.int32)
        self.step_drops = []

        # simple admission: prompts are replayed token-by-token
        prompt_pos = np.zeros(self.slots, np.int64)

        def admit():
            nonlocal caches
            for s in range(self.slots):
                if slot_req[s] is None and pending:
                    slot_req[s] = pending.pop(0)
                    left[s] = slot_req[s].max_new_tokens
                    prompt_pos[s] = 0
                    caches = reset_slot(caches, s)  # reuse slot: fresh prefix

        admit()
        steps = 0
        while any(r is not None for r in slot_req) and steps < 10_000:
            # feed either the next prompt token or the last generated token
            for s, req in enumerate(slot_req):
                if req is None:
                    cur[s, 0] = 0
                elif prompt_pos[s] < len(req.prompt):
                    cur[s, 0] = req.prompt[prompt_pos[s]]
            token = torch.from_numpy(cur.copy()).to(self.device)
            logits, caches = self.step_fn(self.params, token, caches)
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            for s, req in enumerate(slot_req):
                if req is None:
                    continue
                if prompt_pos[s] < len(req.prompt):
                    prompt_pos[s] += 1  # still consuming the prompt
                    if prompt_pos[s] == len(req.prompt):
                        cur[s, 0] = nxt[s]
                        out[req.rid].append(int(nxt[s]))
                        left[s] -= 1
                else:
                    cur[s, 0] = nxt[s]
                    out[req.rid].append(int(nxt[s]))
                    left[s] -= 1
                if left[s] <= 0 and prompt_pos[s] >= len(req.prompt):
                    slot_req[s] = None
            admit()
            steps += 1
        self.steps = steps
        return out

    def load_signal(self, slot_req, left) -> int:
        """Remaining tokens across slots — the rebalance metric."""
        return int(sum(max(0, l) for l in left))
