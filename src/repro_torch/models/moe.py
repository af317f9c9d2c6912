"""Mixture-of-Experts with RaFI forwarding as the dispatch plane
(counterpart of ``repro.models.moe``).

Under expert parallelism, routed tokens are *work items* that must migrate
to the rank owning their expert.  Two dispatch planes:

* ``rafi_ep`` (the paper's technique): experts are split over the model
  ranks of a :class:`~repro_torch.launch.mesh.Layout`.  Each rank takes its
  token slice, emits (hidden, slot, weight, expert, origin) items towards
  ``expert // experts_per_rank`` through the queue API, and one
  ``forward_work`` round moves them; local experts run, and a second round
  returns the results to the stored origin rank, where they are combined by
  router weight.  Top-k > 1 emits k items per token.
* ``dense_tp`` (baseline, no forwarding): every expert everywhere; dispatch
  is a local capacity-bucketed gather.

Both planes share the router and the capacity-factor drop rule (queue
overflow == token drop, counted).

No gradient crosses ``rafi_ep``: its items travel as 32-bit words, so the
router, the experts and the norm that feeds them get none, in the
reference (exact zeros) as here.  The plane runs without grad, so a
checkpoint's recompute in training stops before it.

The reference runs ``rafi_ep`` inside a ``shard_map`` over (data, model)
with its forwarding on the model axis.  Here the ``dp × tp`` ranks are
rank-stacked (rank ``g·tp + m`` is data group g, model rank m) and ONE
``forward_work`` over all of them carries the dp exchanges at once: every
destination lies in the sender's own group (``g·tp + expert // e_loc``),
so no row crosses a group, and the per-pair slot clamp and the receive
order (sources in rank order) are those of the reference's per-group
round.  The items carry what the reference's carry: ``src`` is the model
rank, and the return trip's destination is ``g·tp + src``.

Over a ``DistributedCollectives`` world (the layout's ``comm``) a process
holds its block of the ranks and the batch rows of their data groups
(``launch.mesh.Layout.data_block``): the router runs on its ranks' token
slices, its ranks' experts run on their buckets, the combine joins a
group's model-rank slices with one ``all_gather`` over the model tier (the
reference's), and the drops are one ``psum``.  The stacked backend runs
the same calls on every rank at once.

On placed parameters (``launch.placement``; :func:`moe_block_placed`) the
input is rank-stacked, ``(L, b, S, D)``: each local rank's data group's
rows, whole over ``model``, as the placed residual is.  Under ``rafi_ep``
each rank holds its own ``(E/model, D, F)`` experts and the plane is the
one above, its two rounds unchanged: the route takes the rank-stacked
rows, the experts run on the rank's blocks, and the combine gives every
rank its group's output.  Under ``dense_tp`` (:func:`moe_dense_tp_placed`)
every rank holds every expert's ``F/model`` columns: the GLU is
column-parallel, then row-parallel with one ``psum`` over ``model``.  Its
capacity is the reference's, over the whole (micro)batch: the reference
runs the plane on the logical global array, so a token's place in its
expert's bucket counts the rows of every data group before it.  A rank
learns the other groups' routing from one ``all_gather`` of the top-k ids
over ``data``, ranks every assignment globally and keeps its own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import DISCARD, ForwardConfig, StackedCollectives, enqueue, forward_work, make_queue, work_item
from repro_torch.core.collectives import backend
from repro_torch.launch.mesh import DATA_TIER
from repro_torch.models import parallel as P
from repro_torch.models.common import ModelConfig, ParamDef, ParamTree, activation

__all__ = [
    "MoE", "Route", "TokenItem", "moe_block", "moe_block_placed", "moe_defs", "moe_dense_tp", "moe_dense_tp_placed",
    "moe_rafi_ep", "rafi_ep_combine", "rafi_ep_dispatch", "rafi_ep_experts", "rafi_ep_return", "rafi_ep_route",
]


@work_item
@dataclasses.dataclass
class TokenItem:
    """A routed token in flight (the MoE 'ray')."""

    h: torch.Tensor       # (D,) hidden state
    slot: torch.Tensor    # () i32 original position in the sender's token slice
    weight: torch.Tensor  # () router weight, in the activations' dtype
    expert: torch.Tensor  # () i32 global expert id
    src: torch.Tensor     # () i32 origin model rank (the 'pixelID' for the return trip)


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamDef((d, e), scale=0.02),
        "wi": ParamDef((e, d, f)),
        "wg": ParamDef((e, d, f)),
        "wo": ParamDef((e, f, d), scale=1.0 / np.sqrt(f)),
    }


def _router(params, x2d, cfg: ModelConfig):
    """x2d (N, D) → (topk_idx (N,k) int32, topk_w (N,k)) with softmax over the top k;
    rank-stacked, x (L, N, D) and the router (L, D, E) → (L, N, k)."""
    logits = x2d.to(torch.float32) @ params["router"].to(torch.float32)
    w, idx = torch.topk(logits, cfg.top_k, dim=-1)
    w = torch.softmax(w, dim=-1)
    return idx.to(torch.int32), w.to(x2d.dtype)


def _expert_ffn(wi, wg, wo, x, act: str):
    """Batched per-expert GLU: x (E, C, D) → (E, C, D)."""
    gate = torch.matmul(x, wg)
    up = torch.matmul(x, wi)
    return torch.matmul(activation(gate, act) * up, wo)


def _expert_ffn_blocks(wi, wg, wo, x, act: str):
    """Each local rank's experts on its buckets: x ``(L, e, C, D)``, wi/wg
    ``(L, e, D, F)``, wo ``(L, e, F, D)`` → ``(L, e, C, D)``.  One batched
    GEMM over the ranks an expert: a layer's view of a stacked leaf has no
    flat ``(L·e)`` batch axis, and this reads each block where it lies."""
    return torch.stack([_expert_ffn(wi[:, j], wg[:, j], wo[:, j], x[:, j], act) for j in range(x.shape[1])], dim=1)


def _bucket_rows(e: torch.Tensor, valid: torch.Tensor, n_buckets: int):
    """Stable counting sort of the lanes of each row by bucket ``e`` (``(…,
    N)``, invalid lanes in the last bucket): each lane's position within
    its bucket — the reference's argsort / rank / segment-start steps."""
    n = e.shape[-1]
    order = torch.argsort(e, dim=-1, stable=True)
    ranked = torch.empty_like(order).scatter_(-1, order, torch.arange(n, device=e.device).expand_as(order))
    counts = torch.zeros(tuple(e.shape[:-1]) + (n_buckets,), dtype=torch.int64, device=e.device)
    counts.scatter_add_(-1, e, valid.to(torch.int64))
    seg = torch.cumsum(counts, dim=-1) - counts
    return ranked - torch.gather(seg, -1, e)


# ------------------------------------------------------------ dense_tp plane

def moe_dense_tp(params, x, cfg: ModelConfig):
    """Baseline: local capacity-bucketed dispatch, every expert local."""
    b, s, d = x.shape
    n = b * s
    x2 = x.reshape(n, d)
    idx, w = _router(params, x2, cfg)
    e, k = cfg.num_experts, cfg.top_k
    cap = int(np.ceil(n * k / e * cfg.capacity_factor))

    flat_e = idx.reshape(-1).to(torch.int64)                    # (N·k,)
    flat_t = torch.arange(n, device=x.device).repeat_interleave(k)  # token of each assignment
    flat_w = w.reshape(-1)
    pos_in_e = _bucket_rows(flat_e, torch.ones_like(flat_e, dtype=torch.bool), e)
    keep = pos_in_e < cap

    at = torch.where(keep, flat_e * cap + pos_in_e, e * cap)  # row e·cap: the dropped rows' trash
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[at] = x2[flat_t]
    out_buf = _expert_ffn(params["wi"], params["wg"], params["wo"], buf[:-1].reshape(e, cap, d), cfg.act)
    gathered = out_buf.reshape(e * cap, d)[torch.where(keep, at, 0)]
    contrib = torch.where(keep[:, None], gathered * flat_w[:, None], 0.0)
    y = torch.zeros((n, d), dtype=x.dtype, device=x.device).index_add_(0, flat_t, contrib)
    return y.reshape(b, s, d), torch.sum(~keep).to(torch.int32)


# ------------------------------------------------------------- rafi_ep plane

@dataclasses.dataclass
class Route:
    """The routed tokens of every rank, ready to enqueue (the reference's
    ``block`` up to its first ``enqueue``), and the plane's static sizes."""

    items: TokenItem          # leaves (R, n_emit, ...)
    dest: torch.Tensor        # (R, n_emit) int32 global destination rank
    mask: torch.Tensor        # (R, n_emit) bool: the lane carries a token
    fcfg: ForwardConfig
    dp: int
    tp: int
    e_loc: int
    n_all: int                # tokens of one data group
    n_loc: int                # tokens of one rank's slice
    cap_e: int                # rows of each expert's bucket
    shape: Tuple[int, int, int]  # x's (B, S, D): the process's rows; rank-stacked, a group's (b, S, D)
    comm: Any = None          # the backend the ranks run on (the layout's, resolved)
    first: int = 0            # the process's first rank: it holds ranks [first, first + L)
    ranked: bool = False      # rank-stacked rows and expert blocks (placed parameters)

    def to(self, device) -> "Route":
        """The same route on ``device`` (the dispatch's inputs only)."""
        items = TokenItem(**{f.name: getattr(self.items, f.name).to(device)
                             for f in dataclasses.fields(TokenItem)})
        return dataclasses.replace(self, items=items, dest=self.dest.to(device), mask=self.mask.to(device))

    @property
    def local_ranks(self) -> int:
        return self.dest.shape[0]

    def ranks(self, device) -> torch.Tensor:
        """``(L,)`` the global ids of the process's ranks."""
        return torch.arange(self.first, self.first + self.local_ranks, device=device)


def _proto(d: int, dtype) -> TokenItem:
    """One item's shapes and dtypes for ``make_queue``: on the meta device,
    so that a prototype allocates nothing on the host or the card."""
    meta = torch.device("meta")
    return TokenItem(
        h=torch.empty((d,), dtype=dtype, device=meta),
        slot=torch.empty((), dtype=torch.int32, device=meta),
        weight=torch.empty((), dtype=dtype, device=meta),
        expert=torch.empty((), dtype=torch.int32, device=meta),
        src=torch.empty((), dtype=torch.int32, device=meta),
    )


def rafi_ep_route(params, x, cfg: ModelConfig, *, layout) -> Route:
    """Each rank's token slice, routed: ``x`` (B, S, D) is split over the
    data groups (B/dp rows each) and replicated over the model ranks; model
    rank m takes tokens ``[m·n_loc, (m+1)·n_loc)`` of its group (lanes past
    the group's ``n_all`` tokens are masked).  Over a world ``x`` holds the
    process's groups' rows and only its ranks' slices are routed.
    Rank-stacked ``x`` ``(L, b, S, D)`` (placed parameters) holds each
    local rank's group's rows, and ``params["router"]`` each rank's whole
    ``(L, D, E)`` copy."""
    ranked = x.dim() == 4
    b, s, d = x.shape[-3:]
    dp, tp = layout.data, layout.model
    e, k = cfg.num_experts, cfg.top_k
    if e % tp:
        raise ValueError(f"experts ({e}) must divide the model ranks ({tp})")
    comm = backend(layout.comm)
    R = dp * tp
    e_loc = e // tp
    dev = x.device
    ranks = comm.ranks(R, dev)  # (L,) global ids: group r // tp, model rank r % tp
    L = ranks.shape[0]
    if ranked:
        if x.shape[0] != L:
            raise ValueError(f"rank-stacked rows for {x.shape[0]} ranks, the process holds {L}")
        n_all = b * s
        x2 = x.reshape(L, n_all, d)
        g_loc = torch.arange(L, device=dev)[:, None]  # each rank its own rows
        router = {"router": params["router"][0]}  # whole on every rank: the plane carries no gradient
    else:
        _, held, _ = layout.groups()  # the data groups of the process's ranks (all dp on the stacked backend)
        if b % held:
            raise ValueError(f"the batch ({b}) must divide over the data groups ({held} of {dp})")
        n_all = (b // held) * s
        x2 = x.reshape(held, n_all, d)
        g_loc = (ranks // tp - ranks[0] // tp)[:, None]  # the rank's group among the held ones
        router = params
    n_loc = -(-n_all // tp)
    gslot = (ranks % tp)[:, None] * n_loc + torch.arange(n_loc, device=dev)  # (L, n_loc)
    tok_ok = gslot < n_all
    xs = x2[g_loc, gslot.clamp(0, n_all - 1)]  # (L, n_loc, D)
    idx, w = _router(router, xs.reshape(L * n_loc, d), cfg)

    n_emit = n_loc * k
    cap_send = n_emit
    # every peer can receive at most its expert capacity
    cap_e = int(np.ceil(n_all * k / e * cfg.capacity_factor))
    cap_recv = cap_e * e_loc
    cap = max(cap_send, cap_recv)
    # per-(src,dst) slots sized for balanced routing (+2× slack), as the
    # reference sizes them; slot overflow drops are counted
    fcfg = ForwardConfig(R, cap, peer_capacity=min(cap, max(64, -(-2 * cap // tp))), exchange="padded")

    me = (ranks % tp).to(torch.int32)[:, None]  # model rank
    group = (ranks // tp).to(torch.int32)[:, None]
    items = TokenItem(
        h=xs.repeat_interleave(k, dim=1),
        slot=torch.arange(n_loc, dtype=torch.int32, device=dev).repeat_interleave(k).expand(L, n_emit),
        weight=w.reshape(L, n_emit),
        expert=idx.reshape(L, n_emit),
        src=me.expand(L, n_emit),
    )
    dest = (group * tp + items.expert // e_loc).to(torch.int32)
    return Route(items=items, dest=dest, mask=tok_ok.repeat_interleave(k, dim=1), fcfg=fcfg, dp=dp, tp=tp,
                 e_loc=e_loc, n_all=n_all, n_loc=n_loc, cap_e=cap_e, shape=(b, s, d), comm=comm,
                 first=comm.rank_offset(R), ranked=ranked)


def rafi_ep_dispatch(route: Route):
    """The first round, on the route's backend: tokens travel to their
    experts' owners.  Returns the delivered queue."""
    dev = route.dest.device
    d = route.shape[2]
    q = make_queue(_proto(d, route.items.h.dtype), route.fcfg.capacity, num_ranks=route.local_ranks, device=dev)
    q = enqueue(q, route.items, route.dest, route.mask)
    q, _ = forward_work(q, route.fcfg, comm=route.comm)  # §4.2 — tokens travel to expert owners
    return q


def rafi_ep_experts(params, q, route: Route, cfg: ModelConfig):
    """Local expert compute with per-expert capacity buckets (on a ranked
    route, each rank's own ``(L, e_loc, …)`` expert blocks).  Returns the
    return trip's ``(items, dest, mask)`` and the bucket drops (of the
    process's ranks)."""
    L, C = route.local_ranks, route.fcfg.capacity
    tp, e_loc, cap_e, d = route.tp, route.e_loc, route.cap_e, route.shape[2]
    dev = q.dest.device
    lane = torch.arange(C, device=dev)[None, :]
    valid = lane < q.count[:, None]
    it = q.items
    ranks = route.ranks(dev)
    me = (ranks % tp)[:, None]
    group = (ranks // tp).to(torch.int32)[:, None]
    le = torch.where(valid, it.expert.to(torch.int64) - me * e_loc, e_loc)  # local expert id
    le = torch.clamp(le, 0, e_loc)
    pos = _bucket_rows(torch.where(valid, le, e_loc), valid, e_loc + 1)
    keep = valid & (pos < cap_e) & (le < e_loc)
    drops_cap = torch.sum(valid & ~keep)

    trash = e_loc * cap_e
    at = torch.where(keep, le * cap_e + pos, trash)  # (R, C) row of the rank's bucket buffer
    buf = torch.zeros((L, trash + 1, d), dtype=it.h.dtype, device=dev)
    buf.scatter_(1, at[:, :, None].expand(L, C, d), it.h)
    x = buf[:, :trash].reshape(L, e_loc, cap_e, d)
    if route.ranked:
        out = _expert_ffn_blocks(params["wi"], params["wg"], params["wo"], x, cfg.act)
    else:
        out = _expert_ffn_stacked(params, x, route, cfg.act)
    hout = torch.gather(out.reshape(L, trash, d), 1, torch.where(keep, at, 0)[:, :, None].expand(L, C, d))

    # return trip: dest = the stored origin rank of the sender's group (the 'pixelID' pattern)
    back = TokenItem(h=hout, slot=it.slot, weight=it.weight, expert=it.expert, src=it.src)
    dest = torch.where(keep, group * tp + it.src, DISCARD).to(torch.int32)
    return back, dest, valid, drops_cap


def _expert_ffn_stacked(params, buf, route: Route, act: str):
    """``buf (L, e_loc, cap_e, D)`` through each rank's local experts: the
    process's ranks are T model ranks of each of G data groups (all of
    them, T = tp and G = dp, on the stacked backend).  Those ranks' slice
    of the ``(E, D, F)`` weights is viewed as ``(T·e_loc, D, F)`` and
    shared by the groups: the groups' rows are stacked along each expert's
    token axis, so no weight is copied per group."""
    tp, e_loc = route.tp, route.e_loc
    L, _, cap_e, d = buf.shape
    T = min(L, tp)
    G, m0 = L // T, route.first % tp
    w = {k: params[k][m0 * e_loc:(m0 + T) * e_loc] for k in ("wi", "wg", "wo")}
    x = buf.reshape(G, T * e_loc, cap_e, d).transpose(0, 1).reshape(T * e_loc, G * cap_e, d)
    y = _expert_ffn(w["wi"], w["wg"], w["wo"], x, act)
    return y.reshape(T * e_loc, G, cap_e, d).transpose(0, 1).reshape(L, e_loc, cap_e, d)


def rafi_ep_return(route: Route, back: TokenItem, dest, valid):
    """The second round, on the route's backend: results travel back to
    their origin ranks."""
    d = route.shape[2]
    q2 = make_queue(_proto(d, back.h.dtype), route.fcfg.capacity, num_ranks=route.local_ranks, device=dest.device)
    q2 = enqueue(q2, back, dest, valid)
    q2, _ = forward_work(q2, route.fcfg, comm=route.comm)
    return q2


def rafi_ep_combine(q2, route: Route):
    """Each rank's returned results, weighted and added at their slots,
    then the model ranks' slices joined back into ``(B, S, D)`` by one
    ``all_gather`` over the model tier, the reference's over its model
    axis, held once a data group (``per_group``); on a ranked route held
    by every rank, ``(L, b, S, D)``."""
    L, C = route.local_ranks, route.fcfg.capacity
    n_loc, d, tp = route.n_loc, route.shape[2], route.tp
    dev = q2.dest.device
    valid2 = torch.arange(C, device=dev)[None, :] < q2.count[:, None]
    r = q2.items
    contrib = torch.where(valid2[:, :, None], r.h * r.weight[:, :, None], 0.0)
    at = torch.where(valid2, r.slot.to(torch.int64), n_loc)  # slot n_loc: trash
    ys = torch.zeros((L, n_loc + 1, d), dtype=r.h.dtype, device=dev)
    ys.scatter_add_(1, at[:, :, None].expand(L, C, d), contrib)
    if route.ranked:  # each rank its group's slices: (L, tp, n_loc, D)
        y_all = route.comm.all_gather(ys[:, :n_loc], digits=(route.dp, tp), tier=1)
        return y_all.reshape(L, tp * n_loc, d)[:, :route.n_all].reshape((L,) + tuple(route.shape))
    # each held group's slices once, in rank order: (groups, tp, n_loc, D)
    y_all = route.comm.all_gather(ys[:, :n_loc], digits=(route.dp, tp), tier=1, per_group=True)
    y_all = y_all.reshape(-1, tp * n_loc, d)[:, :route.n_all]
    return y_all.reshape(route.shape)


def moe_rafi_ep(params, x, cfg: ModelConfig, *, layout, comm: Optional[StackedCollectives] = None):
    """Paper-technique dispatch: forwarding over the model ranks.  Returns
    ``(y (B, S, D), drops)``, drops the tokens lost to the expert buckets
    and to both rounds' queues (``drops_cap + q.drops + q2.drops``, summed
    over ranks by one ``psum``).  ``comm``, where given, replaces the
    layout's backend.  Rank-stacked ``x`` ``(L, b, S, D)`` and rank blocks
    of the parameters give ``y`` ``(L, b, S, D)`` (module docstring)."""
    if comm is not None:
        layout = dataclasses.replace(layout, comm=comm)
    route = rafi_ep_route(params, x, cfg, layout=layout)
    q = rafi_ep_dispatch(route)
    back, dest, valid, drops_cap = rafi_ep_experts(params, q, route, cfg)
    q2 = rafi_ep_return(route, back, dest, valid)
    y = rafi_ep_combine(q2, route)
    per_rank = (q.drops + q2.drops).to(torch.int64)
    per_rank[0] += drops_cap  # the process's bucket drops ride its first rank's entry
    return y, route.comm.psum(per_rank).to(torch.int32)


def moe_block(params, x, cfg: ModelConfig, *, layout=None):
    if cfg.moe_dispatch == "rafi_ep":
        if layout is None:
            raise ValueError("rafi_ep dispatch needs the layout")
        with torch.no_grad():  # the plane carries no gradient (module docstring)
            return moe_rafi_ep(params, x, cfg, layout=layout)
    return moe_dense_tp(params, x, cfg)


def _global_buckets(idx, cfg: ModelConfig, ranks):
    """``dense_tp``'s buckets over the whole (micro)batch: ``idx`` ``(L,
    n, k)`` each rank's group's top-k ids → ``(pos (L, n·k), cap,
    drops)``, each own assignment's place in its expert's bucket among
    every group's (in row order, the groups gathered over ``data``), the
    capacity of the whole batch's ``G·n`` tokens, and the batch's drops
    (the same on every rank)."""
    L, n, k = idx.shape
    G, e = ranks.data, cfg.num_experts
    cap = int(np.ceil(G * n * k / e * cfg.capacity_factor))
    ids = ranks.comm.all_gather(idx, digits=ranks.digits, tier=DATA_TIER) if G > 1 else idx[:, None]
    flat = ids.reshape(L, G * n * k).to(torch.int64)
    pos_all = _bucket_rows(flat, torch.ones_like(flat, dtype=torch.bool), e)
    own = ranks.group.to(idx.device)[:, None] * (n * k) + torch.arange(n * k, device=idx.device)
    return torch.gather(pos_all, 1, own), cap, torch.sum(pos_all[0] >= cap).to(torch.int32)


def moe_dense_tp_placed(params, x, cfg: ModelConfig, ranks):
    """:func:`moe_dense_tp` on every local rank (``models.parallel``): x
    ``(L, b, S, D)`` each rank's group's rows, whole over ``model``; the
    router ``(L, D, E)`` whole; wi/wg ``(L, E, D, F/model)`` column-
    parallel, wo ``(L, E, F/model, D)`` row-parallel, the weighted combine
    summed over ``model``.  The capacity and each assignment's place in
    its expert's bucket are the reference's over the whole (micro)batch
    (module docstring), so the drops, the same on every rank, are the
    reference's.  Returns ``(y (L, b, S, D), drops)``.

    The router weights pass through ``copy_model``: each rank's experts
    give a part of the output, so a weight's gradient is the sum of the
    ranks' parts.  The router itself reads the input as it is, the experts
    through ``copy_model``."""
    L, b, s, d = x.shape
    n, e, k = b * s, cfg.num_experts, cfg.top_k
    idx, w = _router(params, x.reshape(L, n, d), cfg)  # each rank's router copy: one product a rank
    with torch.no_grad():
        pos, cap, drops = _global_buckets(idx, cfg, ranks)
    keep = pos < cap
    flat_e = idx.reshape(L, n * k).to(torch.int64)
    flat_t = torch.arange(n, device=x.device).repeat_interleave(k)  # token of each assignment
    at = torch.where(keep, flat_e * cap + pos, e * cap)  # row e·cap: the dropped rows' trash
    xc = P.copy_model(x, ranks).reshape(L, n, d)
    buf = torch.zeros((L, e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.scatter(1, at[:, :, None].expand(L, n * k, d), xc[:, flat_t])
    out = _expert_ffn_blocks(params["wi"], params["wg"], params["wo"], buf[:, :-1].reshape(L, e, cap, d), cfg.act)
    gathered = torch.gather(out.reshape(L, e * cap, d), 1, torch.where(keep, at, 0)[:, :, None].expand(L, n * k, d))
    wk = P.copy_model(w, ranks).reshape(L, n * k)
    contrib = torch.where(keep[:, :, None], gathered * wk[:, :, None], 0.0)
    y = torch.zeros((L, n, d), dtype=x.dtype, device=x.device).index_add(1, flat_t, contrib)
    return P.psum_model(y, ranks).reshape(L, b, s, d), drops


def moe_block_placed(params, x, cfg: ModelConfig, ranks):
    """:func:`moe_block` on placed parameters: x ``(L, b, S, D)``, the
    rank's blocks of the MoE leaves, ``ranks`` a ``models.parallel.Ranks``
    (module docstring).  Returns ``(y (L, b, S, D), drops)``, the drops
    summed over every rank as the reference sums its shards'."""
    if cfg.moe_dispatch == "rafi_ep":
        with torch.no_grad():  # the plane carries no gradient (module docstring)
            return moe_rafi_ep(params, x, cfg, layout=ranks.layout)
    return moe_dense_tp_placed(params, x, cfg, ranks)


class MoE(ParamTree):
    """The MoE parameters (``router``, ``wi``, ``wg``, ``wo``), stacked or
    not; ``forward`` is :func:`moe_block` on layer ``index``'s weights."""

    def __init__(self, cfg: ModelConfig, *, defs=None, dtype=None, device=None):
        super().__init__(moe_defs(cfg) if defs is None else defs, dtype=dtype or cfg.torch_dtype, device=device)
        self.cfg = cfg

    def forward(self, x, *, layout=None, index=None):
        return moe_block(self.tree(index), x, self.cfg, layout=layout)
