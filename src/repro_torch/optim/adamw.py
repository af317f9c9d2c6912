"""AdamW (counterpart of ``repro.optim.adamw``).

The state is ``{"m", "v", "step"[, "master", "residual"]}``: m and v in
float32 for every parameter, keyed like the parameter tree, so a checkpoint
crosses between the packages.  The update follows the reference's
arithmetic leaf by leaf: linear warmup, the global-norm clip, bias
corrections, decoupled weight decay, optional float32 masters and bf16
gradient compression with error feedback.  A ``None`` gradient is a zero
one, which is what the reference computes for a parameter the loss does
not reach (the MoE leaves behind the ``rafi_ep`` dispatch, whose items
travel as 32-bit words): its update is weight decay alone.

Unlike the reference's pure function, :func:`adamw_update` writes the new
parameters and state into the tensors it is given, one leaf at a time under
``torch.no_grad()``, so that at most a few float32 temporaries of one leaf
are alive at once.  Placed parameters (``launch.placement.Placed``: each
leaf the local ranks' blocks) get a placed state, ``m`` and ``v`` (and
the masters and residuals) placed as their parameters and ``step`` whole,
the placement of the reference's ``opt_state_specs``: every rank updates
its own blocks, and the global norm comes from ``sumsq`` (the placement's
count of every element once over the world).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.models.common import ParamTree, tree_map
from repro_torch.optim.grad_compress import compress_one, init_residuals

__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    f32_master: bool = False
    compress_grads: bool = False  # bf16 gradient reduction + error feedback


def _tree(params):
    return params.tree() if isinstance(params, ParamTree) else params


def _flat(tree) -> List[Any]:
    """The leaves in the reference's order (keys sorted), ``None`` kept."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flat(tree[k])]
    return [tree]


def adamw_init(params, cfg: AdamWConfig):
    """Zeros for m and v (float32), step 0, and the optional masters and
    residuals, on the parameters' device."""
    tree = _tree(params)
    like = getattr(tree, "like", lambda t: t)  # a placed tree's state is placed as it is
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = _flat(tree)[0].device
    state = {"m": like(tree_map(zeros32, tree)), "v": like(tree_map(zeros32, tree)),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.f32_master:
        state["master"] = like(tree_map(lambda p: p.detach().to(torch.float32, copy=True), tree))
    if cfg.compress_grads:
        state["residual"] = like(init_residuals(tree))
    return state


def _schedule(step, cfg: AdamWConfig):
    warm = torch.clamp(step.to(torch.float32) / max(cfg.warmup_steps, 1), max=1.0)
    return warm * cfg.lr


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, *,
                 sumsq: Optional[Callable[[List[Optional[torch.Tensor]]], torch.Tensor]] = None
                 ) -> Tuple[Any, Any, torch.Tensor]:
    """Returns ``(params, state, grad_global_norm)``, ``params`` and
    ``state`` updated in place; ``grads`` is a tree like the parameters'
    whose leaves may be ``None``.  ``sumsq`` (given the gradients in the
    leaf order, keys sorted) gives the sum of their squares over the
    world, for placed parameters; by default the local leaves' sum."""
    ps, gs = _flat(_tree(params)), _flat(grads)
    ms, vs = _flat(state["m"]), _flat(state["v"])
    if not len(ps) == len(gs) == len(ms) == len(vs):
        raise ValueError(f"{len(ps)} parameters, {len(gs)} gradients, {len(ms)} m and {len(vs)} v leaves")
    if cfg.compress_grads:
        # bf16 all-reduce payload with error feedback: the quantization
        # error re-enters next step's gradient
        for i, (g, r) in enumerate(zip(gs, _flat(state["residual"]))):
            gs[i], new_r = compress_one(g, r)
            r.copy_(new_r)
    if sumsq is not None:
        total = sumsq(gs)
    else:
        total = torch.zeros((), dtype=torch.float32, device=ps[0].device)
        for g in gs:
            if g is not None:
                g32 = g.to(torch.float32)
                total = total + torch.sum(g32 * g32)
    gnorm = torch.sqrt(total + 1e-20)
    scale = torch.clamp(cfg.grad_clip / gnorm, max=1.0)

    step = state["step"] + 1
    lr = _schedule(step, cfg)
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)

    bases = _flat(state["master"]) if cfg.f32_master else ps
    for p, base, g, m, v in zip(ps, bases, gs, ms, vs):
        if g is None:  # a zero gradient: b·m + (1 − b)·0
            m.mul_(cfg.b1)
            v.mul_(cfg.b2)
        else:
            g32 = g.to(torch.float32) * scale
            m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
            v.mul_(cfg.b2).add_((g32 * (1 - cfg.b2)).mul_(g32))
            del g32
        b32 = base.to(torch.float32)  # the float32 base itself when it is one
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps)).add_(b32 * cfg.weight_decay).mul_(lr)
        b32.sub_(delta)
        del delta
        if b32 is not p:
            p.copy_(b32)  # round to nearest even, as the reference's astype
    state["step"] = step
    return params, state, gnorm
