"""Collectives over the rank axis, in two backends behind the same methods.

The port's R logical ranks are rows of the leading axis of every
rank-stacked tensor.  :class:`StackedCollectives` holds all R rows in one
process and turns each collective the reference issues inside
``shard_map`` into a tensor operation on that axis.
:class:`DistributedCollectives` spreads them over a ``torch.distributed``
world of W processes (gloo on the CPU, NCCL on the card; ``launch.dist``
sets it up): W divides R, and process ``p`` holds the contiguous block of
ranks ``[p·L, (p+1)·L)``, ``L = R / W``, so the digits of every tier
layout keep their meaning.  Every rank-stacked tensor's leading axis is
then the process's L local ranks; what the stacked backend holds once,
without the rank axis (a ``psum`` or ``pmin`` result, the count matrix a
control plane builds from an ``all_gather``), is held replicated in every
process.  Process p's output of every method equals rows ``[p·L,
(p+1)·L)`` of the stacked output on the same global input, bit for bit;
the stacked backend is the world of one process.  Shapes below are the
stacked ones; read L for the leading R:

  all_to_all(x)   x (R_src, R_dst, ...) → out[dst, src] = x[src, dst]
                  (``jax.lax.all_to_all``, ``stages.a2a``)
  all_to_all(x, digits=, tier=l)
                  the same over ONE tier of a multi-tier rank layout:
                  x (R, A_l, ...), block j of rank r goes to the peer whose
                  digit l is j and whose other digits are r's
                  (``stages.a2a`` over mesh axis l)
  all_gather(x)   x (R, ...) → (R, R, ...): every rank sees every row
                  (a broadcast view, no copy)
  all_gather(x, digits=, tier=l)
                  the same within ONE tier's group: x (R, ...) → (R, A_l,
                  ...), rank r sees the A_l ranks that share every digit
                  of r but digit l, in digit-l order
  all_gather(x, digits=, tier=l, per_group=True)
                  the same, held once a group: x (R, ...) → (G, A_l, ...),
                  the tier-l groups of the local ranks in group order
                  (what every rank of a group would see; a view where the
                  tier is the fastest and whole groups are local)
  ragged_all_to_all(x, output, input_offsets=, send_sizes=,
                  output_offsets=, recv_sizes=)
                  x (R, C, W) → (R, capacity, W): sender s's rows
                  [input_offsets[s, d], + send_sizes[s, d]) land on
                  receiver d at [output_offsets[s, d], …)
                  (``jax.lax.ragged_all_to_all``, the MPI_Alltoallv of the
                  ragged exchange); each table's axis of the ranks a
                  process holds is local: input_offsets and send_sizes
                  (L_src, R_dst), output_offsets (R_src, L_dst), recv_sizes
                  (L_dst, R_src)
  ppermute(x)     x (R, ...) → out[(i + 1) % R] = x[i]: the node-major
                  ring hop of ``repro.core.cycling`` (``jax.lax.ppermute``)
  psum(x)         x (R, ...) → the sum over ranks; the replicated result is
                  held once, without the rank axis
  psum(x, digits=, tier=l)
                  the sum within each tier-l group, held per rank: (R, ...)
  pmin(x)         x (R, ...) → the minimum over ranks, held once
                  (``jax.lax.pmin``)
  reduce_scatter(x, digits=, tier=l)
                  x (R, A_l, ...) → (R, ...): rank r receives the sum over
                  its tier-l group of block ``digit_l(r)`` of every member,
                  summed in digit order (``jax.lax.psum_scatter``; the
                  gradient of a tier ``all_gather``, the FSDP gradient)
  grad_all_reduce(tensors)
                  the data-parallel gradient sum over the world's processes,
                  in place (the compiler's reduction over the data axis in
                  the reference's train step); a no-op on the stacked
                  backend, whose one process already holds every group

Rank identity.  A site that asks "which rank am I" reads
``comm.ranks(R, device)`` (the global ids of the local ranks),
``comm.rank_offset(R)`` or ``comm.local(t, dim)`` (the local slice of a
replicated table's rank axis), never ``torch.arange(R)``; ``tier_digit``
and the group tables take those ids.  ``comm.local_ranks(R)`` is L.
``comm.shard_tree(tree, R)`` and ``comm.gather_tree(tree)`` cut a
rank-stacked pytree to the local block and gather it back whole (off the
recorder).  An entry point's ``comm=None`` is resolved by :func:`backend`
alone: None is a fresh ``StackedCollectives``.

Both backends count their calls in ``calls``, a Counter keyed by
:class:`Call` (kind, bytes, shape, tier): a long drive adds counts, not
entries.  The port has no lowered HLO to audit, so the recorder is how the
collective budget is guarded: on ``exchange="padded"`` a round issues
exactly one payload ``all_to_all`` and one count ``all_to_all``, on
``exchange="hierarchical"`` one of each per non-trivial tier (a call's
``tier`` names it), on ``exchange="ragged"`` one ``ragged_all_to_all`` and
one count ``all_gather``.  The kinds are ``all_to_all``,
``ragged_all_to_all``, ``all_gather``, ``ppermute``, ``psum``, ``pmin``,
``reduce_scatter`` (the placed train step's only user) and
``grad_all_reduce``.  A call counts once per process, however many
``torch.distributed`` operations carry it; its shape is the local
block's, and its bytes are the local block's, so the bytes summed over
the world equal the stacked call's.  A ``ragged_all_to_all`` call records
its static result bytes, ``(capacity, W)`` words a rank, as the
reference's HLO reader counts the op.  ``host_reads`` counts the
device-to-host reads a backend makes: none on the stacked backend, and on
the distributed one exactly one per ``ragged_all_to_all`` (its split
sizes, which gloo and NCCL take as Python lists) and none elsewhere.

Tier layouts.  A multi-tier rank axis is a tuple of digit sizes, slowest
first; rank ``r``'s digits are lexicographic, slowest-major (``r = (d_0·A_1
+ d_1)·A_2 + …``, the ``jax.lax.axis_index`` of the reference's flattened
mesh axes).  :func:`node_layout`, :func:`pod_layout` and
:func:`joint_tiers` give the reference's test meshes (``launch/mesh.py``'s
``make_node_mesh``, ``make_pod_mesh``, and a tier that groups several mesh
axes) as such layouts.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Callable, Counter, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.marshal import ops as marshal_ops

__all__ = [
    "Call", "DistributedCollectives", "StackedCollectives", "backend", "grad_buckets", "joint_tiers", "node_layout",
    "pod_layout", "tier_digit",
]


@dataclasses.dataclass(frozen=True)
class Call:
    kind: str  # "all_to_all" | "ragged_all_to_all" | "all_gather" | "ppermute" | "psum" | "pmin" | "grad_all_reduce"
    nbytes: int  # bytes of the stacked input (every rank's contribution)
    shape: Tuple[int, ...]
    tier: Optional[int] = None  # the tier of a one-tier call


def node_layout(nodes: int = 2, devices_per_node: int = 4) -> Tuple[int, int]:
    """The (node, device) layout of ``make_node_mesh``: node-major ranks."""
    return (nodes, devices_per_node)


def pod_layout(pods: int = 2, nodes: int = 2, devices_per_node: int = 2) -> Tuple[int, int, int]:
    """The (pod, node, device) layout of ``make_pod_mesh``."""
    return (pods, nodes, devices_per_node)


def joint_tiers(layout: Sequence[int], groups: Sequence[Sequence[int]]) -> Tuple[int, ...]:
    """Tier sizes of a layout whose consecutive axes are grouped into joint
    tiers: ``joint_tiers((2, 2, 2), ((0, 1), (2,))) == (4, 2)``, the
    reference's ``axis_name=(("pod", "node"), "device")``.  Grouping
    consecutive slowest-major digits keeps every rank's index."""
    flat = [a for g in groups for a in g]
    if flat != list(range(len(layout))):
        raise ValueError(f"groups {groups} must cover the axes 0..{len(layout) - 1} in order")
    return tuple(math.prod(layout[a] for a in g) for g in groups)


def tier_digit(level_sizes: Sequence[int], tier: int, device=None, ranks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every rank's digit on ``tier`` (``(R,)`` int64): the stacked form of
    ``jax.lax.axis_index(axis_name[tier])``; with ``ranks`` (global ids,
    e.g. ``comm.ranks(R)``) only those ranks' digits."""
    stride = math.prod(level_sizes[tier + 1:])
    r = torch.arange(math.prod(level_sizes), device=device) if ranks is None else ranks.to(torch.int64)
    return (r // stride) % level_sizes[tier]


def _group_members(level_sizes: Sequence[int], tier: int, device=None,
                   ranks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(R, A_l)`` int64: the ranks of every rank's tier-``tier`` group,
    in digit order (rank r's digit l replaced by 0 … A_l − 1); with
    ``ranks``, only those ranks' rows."""
    stride = math.prod(level_sizes[tier + 1:])
    r = torch.arange(math.prod(level_sizes), device=device) if ranks is None else ranks.to(torch.int64)
    base = r - tier_digit(level_sizes, tier, ranks=r) * stride
    return base[:, None] + torch.arange(level_sizes[tier], device=r.device)[None, :] * stride


class _RankBlock:
    """The rank identity of a process holding ``world``'s ``index``-th
    contiguous block of ranks (the stacked backend: the one block)."""

    world: int = 1
    index: int = 0

    def local_ranks(self, num_ranks: int) -> int:
        """L: the ranks this process holds."""
        if num_ranks % self.world:
            raise ValueError(f"{num_ranks} ranks do not split over a world of {self.world} processes")
        return num_ranks // self.world

    def rank_offset(self, num_ranks: int) -> int:
        """The global id of the process's first rank."""
        return self.index * self.local_ranks(num_ranks)

    def ranks(self, num_ranks: int, device=None) -> torch.Tensor:
        """``(L,)`` int64: the global ids of the local ranks."""
        lo = self.rank_offset(num_ranks)
        return torch.arange(lo, lo + self.local_ranks(num_ranks), device=device)

    def local(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The local ranks' slice of a replicated tensor's global rank axis
        ``dim`` (the whole tensor on the stacked backend)."""
        if self.world == 1:
            return x
        n = x.shape[dim]
        return x.narrow(dim, self.rank_offset(n), self.local_ranks(n))

    def gather_all(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows ``(R, ...)``, off the recorder (host summaries
        and tests): on the stacked backend, ``x`` itself."""
        return x

    def shard_tree(self, tree: Any, num_ranks: int) -> Any:
        """The process's block of a rank-stacked tree: every tensor leaf with
        a leading axis of ``num_ranks`` cut to the local ranks; 0-d leaves
        and the rest pass through."""
        return _map_tensors(lambda t: self.local(t) if t.dim() > 0 and t.shape[0] == num_ranks else t, tree)

    def gather_tree(self, tree: Any) -> Any:
        """The whole rank-stacked tree (a ``WorkQueue``, a carry, a
        ``StatsRing``) in every process: every tensor leaf's leading axis of
        local ranks gathered over the world (0-d leaves pass through).  Off
        the recorder."""
        return _map_tensors(lambda t: self.gather_all(t) if t.dim() > 0 else t, tree)

    def _record(self, kind: str, x: torch.Tensor, tier: Optional[int] = None) -> None:
        self.calls[Call(kind, x.numel() * x.element_size(), tuple(x.shape), tier)] += 1

    def barrier(self) -> None:
        """Wait for every process of the world (none to wait for on the
        stacked backend): a file one process writes is read by the others
        only after it."""

    def count(self, kind: str, *, tier: Optional[int] = None) -> int:
        """Calls of ``kind``; with ``tier``, only that tier's."""
        return sum(n for c, n in self.calls.items()
                   if c.kind == kind and (tier is None or c.tier == tier))

    def reset(self) -> None:
        self.calls.clear()
        self.host_reads = 0


@dataclasses.dataclass
class StackedCollectives(_RankBlock):
    """Rank-stacked collectives with a call recorder: every rank in this
    process."""

    calls: Counter[Call] = dataclasses.field(default_factory=collections.Counter)
    host_reads: int = 0  # always 0: the stacked backend never reads the device

    def all_to_all(
        self, x: torch.Tensor, *, digits: Optional[Sequence[int]] = None, tier: Optional[int] = None
    ) -> torch.Tensor:
        """Flat: ``x (R_src, R_dst, ...)``.  With ``digits`` (the tier
        layout) and ``tier`` l: ``x (R, A_l, ...)``, the swap along digit
        l — in the digit view ``(A_0, …, A_{L-1}, A_l, ...)`` axes l and L
        trade places."""
        if digits is None:
            if x.dim() < 2 or x.shape[0] != x.shape[1]:
                raise ValueError(f"all_to_all takes (R_src, R_dst, ...), got {tuple(x.shape)}")
            self._record("all_to_all", x)
            return x.transpose(0, 1).contiguous()
        digits = tuple(digits)
        if x.dim() < 2 or x.shape[0] != math.prod(digits) or x.shape[1] != digits[tier]:
            raise ValueError(
                f"a tier-{tier} all_to_all over {digits} takes (R, A_l, ...), got {tuple(x.shape)}"
            )
        self._record("all_to_all", x, tier)
        rest = tuple(x.shape[2:])
        view = x.reshape(digits + (digits[tier],) + rest)
        return view.transpose(tier, len(digits)).reshape(x.shape).contiguous()

    def ragged_all_to_all(
        self,
        x: torch.Tensor,  # (R, C, W) every sender's rows, segments in destination order
        output: Optional[torch.Tensor],  # (R, capacity, W), or None
        *,
        input_offsets: torch.Tensor,  # (R_src, R_dst)
        send_sizes: torch.Tensor,  # (R_src, R_dst)
        output_offsets: torch.Tensor,  # (R_src, R_dst): where s's block lands on d
        recv_sizes: torch.Tensor,  # (R_dst, R_src)
        capacity: Optional[int] = None,
    ) -> torch.Tensor:
        """The stacked ``ragged_all_to_all`` (every table ``(R, R)``): receiver ``d``'s rows
        ``[output_offsets[s, d], + recv_sizes[d, s])`` become sender ``s``'s
        rows from ``input_offsets[s, d]``; every other row is ``output``'s
        (with ``output=None``, of shape ``(R, capacity, W)``, those rows
        carry no contract).  ``send_sizes[s, d]`` must equal ``recv_sizes[d,
        s]`` and each receiver's landing intervals must be disjoint and in
        source order, as the replicated control plane gives them; nothing
        is checked on the device.

        One output-driven gather over the flattened ``(R·C, W)`` rows, no
        host sync and no data-dependent shape: receiver ``d``'s lane ``j``
        finds its source ``s`` by a search over column ``d``'s landing
        starts and reads row ``s·C + input_offsets[s, d] + j −
        output_offsets[s, d]`` (K1 ``gather_rows``).  The index math is
        int32, so ``R·C + capacity`` must stay below 2^31."""
        del send_sizes  # the receiver's view (recv_sizes) drives the gather
        R, C, W = x.shape
        cap = output.shape[1] if output is not None else capacity
        if cap is None:
            raise ValueError("ragged_all_to_all needs output or capacity")
        if R * C + cap >= 2**31:
            raise ValueError(f"ragged_all_to_all: {R} x {C} rows and {cap} lanes overflow its int32 row index")
        for name, t in (("input_offsets", input_offsets), ("output_offsets", output_offsets),
                        ("recv_sizes", recv_sizes)):
            if tuple(t.shape) != (R, R):
                raise ValueError(f"ragged_all_to_all: {name} must be ({R}, {R}), got {tuple(t.shape)}")
        if output is not None and tuple(output.shape) != (R, cap, W):
            raise ValueError(f"ragged_all_to_all: output must be ({R}, {cap}, {W}), got {tuple(output.shape)}")
        self.calls[Call("ragged_all_to_all", R * cap * W * x.element_size(), (R, cap, W))] += 1
        i32 = lambda t: t.to(torch.int32)
        starts = i32(output_offsets).transpose(0, 1).contiguous()  # (R_dst, R_src)
        lane = torch.arange(cap, dtype=torch.int32, device=x.device).expand(R, cap).contiguous()
        s = (torch.searchsorted(starts, lane, right=True) - 1).clamp_(min=0)  # the lane's source rank
        # the flat row that lane 0 of each landing interval would read
        base = torch.arange(R, dtype=torch.int32, device=x.device)[None, :] * C + i32(input_offsets).T - starts
        src = torch.gather(base, 1, s) + lane
        out = marshal_ops.gather_rows(x.reshape(1, R * C, W), src.reshape(1, R * cap)).view(R, cap, W)
        if output is None:
            return out
        landed = (lane >= torch.gather(starts, 1, s)) & (lane < torch.gather(starts + i32(recv_sizes), 1, s))
        return torch.where(landed[:, :, None], out, output)

    def all_gather(
        self, x: torch.Tensor, *, digits: Optional[Sequence[int]] = None, tier: Optional[int] = None,
        per_group: bool = False,
    ) -> torch.Tensor:
        """Flat: ``(R, ...) → (R, R, ...)``.  With ``digits`` and ``tier``
        l: ``(R, ...) → (R, A_l, ...)``, each rank's tier-l group; with
        ``per_group``, ``(R / A_l, A_l, ...)``, each group once."""
        if digits is None:
            self._record("all_gather", x)
            return x.unsqueeze(0).expand((x.shape[0],) + tuple(x.shape))
        self._record("all_gather", x, tier)
        if per_group:
            return _by_group(x, tuple(digits), tier)
        return x[_group_members(digits, tier, x.device)]

    def ppermute(self, x: torch.Tensor) -> torch.Tensor:
        """The ring hop: rank i's ``x[i]`` lands on rank ``(i + 1) % R``."""
        self._record("ppermute", x)
        return torch.roll(x, 1, dims=0)

    def psum(
        self, x: torch.Tensor, *, digits: Optional[Sequence[int]] = None, tier: Optional[int] = None
    ) -> torch.Tensor:
        """Flat: the sum over ranks, held once.  With ``digits`` and
        ``tier``: each rank's tier-group sum, held per rank."""
        if digits is None:
            self._record("psum", x)
            return x.sum(dim=0, dtype=x.dtype)
        self._record("psum", x, tier)
        return x[_group_members(digits, tier, x.device)].sum(dim=1, dtype=x.dtype)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        self._record("pmin", x)
        return x.amin(dim=0)

    def reduce_scatter(self, x: torch.Tensor, *, digits: Sequence[int], tier: int) -> torch.Tensor:
        """``(R, A_l, ...) → (R, ...)``: rank r's block ``digit_l(r)``
        summed over its tier-l group, in digit order."""
        digits = tuple(digits)
        _check_scatter(x, digits, tier, self.local_ranks(math.prod(digits)))
        self._record("reduce_scatter", x, tier)
        R = x.shape[0]
        rows = _group_members(digits, tier, x.device)  # (R, A_l)
        cols = tier_digit(digits, tier, x.device)[:, None].expand(R, digits[tier])
        return x[rows, cols].sum(dim=1, dtype=x.dtype)

    def grad_all_reduce(self, tensors: Sequence[torch.Tensor]) -> None:
        """One process holds every data group: nothing to reduce, no call."""


def backend(comm=None):
    """The backend an entry point runs on: ``comm``, or a fresh
    ``StackedCollectives`` for None."""
    return StackedCollectives() if comm is None else comm


def _map_tensors(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf of a tree of dataclasses, dicts,
    tuples and lists; other leaves pass through."""
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map_tensors(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _check_scatter(x: torch.Tensor, digits: Tuple[int, ...], tier: int, local: int) -> None:
    if x.dim() < 2 or x.shape[0] != local or x.shape[1] != digits[tier]:
        raise ValueError(f"a tier-{tier} reduce_scatter over {digits} takes (L, A_l, ...), got {tuple(x.shape)}")


def _by_group(x: torch.Tensor, digits: Tuple[int, ...], tier: int) -> torch.Tensor:
    """``(R, ...) → (R / A_l, A_l, ...)``: the tier-l groups of a whole rank
    axis in group order (the order of each group's first rank), each
    group's ranks in digit-l order; a view when l is the fastest tier."""
    rest = tuple(x.shape[1:])
    view = x.reshape(digits + rest).movedim(tier, len(digits) - 1)
    return view.reshape((-1, digits[tier]) + rest)


# what a tensor of each dtype travels as in an off-recorder gather: gloo
# moves no unsigned words wider than a byte, and NCCL no booleans
_WIRE = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64, torch.bool: torch.uint8}
# a gradient bucket: bounds the flat copy a bucket makes beside the gradients
_GRAD_BUCKET_BYTES = 1 << 28


def grad_buckets(tensors: Sequence[torch.Tensor]) -> list:
    """``tensors`` in runs of one dtype and at most ``_GRAD_BUCKET_BYTES``
    (a larger tensor a run of its own): the buckets of
    ``DistributedCollectives.grad_all_reduce``, one call each."""
    buckets, cur, size, dtype = [], [], 0, None
    for t in tensors:
        nb = t.numel() * t.element_size()
        if cur and (t.dtype != dtype or size + nb > _GRAD_BUCKET_BYTES):
            buckets.append(cur)
            cur, size = [], 0
        cur.append(t)
        size, dtype = size + nb, t.dtype
    if cur:
        buckets.append(cur)
    return buckets


def _block_plan(digits: Tuple[int, ...], tier: int, world: int, index: int):
    """The static plan of a tier ``all_to_all`` on process ``index``:
    ``(send_order, send_splits, recv_splits, recv_index)``.  The local
    blocks ``(i, j)`` (rank i's block for digit j, flattened ``i·A + j``)
    are sent grouped by destination process, in ``send_order`` (None: the
    identity), ``send_splits[q]`` of them to process q; the blocks that
    arrive come in source order, ``recv_splits[p]`` from process p, and
    ``recv[recv_index]`` puts them in the output's ``(i, a)`` order."""
    R, A = math.prod(digits), digits[tier]
    L = R // world
    stride = math.prod(digits[tier + 1:])
    digit = lambda r: (r // stride) % A
    dest = lambda r, j: r + (j - digit(r)) * stride

    def sends(p):  # (local block, destination) in send order
        blocks = [(i * A + j, dest(p * L + i, j)) for i in range(L) for j in range(A)]
        return sorted(blocks, key=lambda b: b[1] // L)  # stable: (i, j) order within a process

    mine = sends(index)
    order = [b for b, _ in mine]
    send_splits = [sum(1 for _, g in mine if g // L == q) for q in range(world)]
    recv_splits, recv_index, k = [], [None] * (L * A), 0
    for p in range(world):
        n = 0
        for b, g in sends(p):
            if g // L != index:
                continue
            r = p * L + b // A
            recv_index[(g - index * L) * A + digit(r)] = k
            k, n = k + 1, n + 1
        recv_splits.append(n)
    assert None not in recv_index
    return (None if order == sorted(order) else order), send_splits, recv_splits, recv_index


@dataclasses.dataclass
class DistributedCollectives(_RankBlock):
    """The collectives over a ``torch.distributed`` world: this process is
    process ``index`` of ``world`` and holds ranks ``[index·L, (index+1)·L)``
    (module docstring).  Made by ``launch.dist.init_world``, which sets up
    the default process group first; every process must issue the same
    calls in the same order."""

    world: int = 1
    index: int = 0
    calls: Counter[Call] = dataclasses.field(default_factory=collections.Counter)
    host_reads: int = 0
    _plans: dict = dataclasses.field(default_factory=dict, repr=False)

    def _a2a_blocks(self, x: torch.Tensor, digits: Tuple[int, ...], tier: int) -> torch.Tensor:
        L, A = x.shape[0], x.shape[1]
        key = (digits, tier, str(x.device))
        if key not in self._plans:
            order, ss, rs, ri = _block_plan(digits, tier, self.world, self.index)
            as_idx = lambda v: None if v is None else torch.tensor(v, dtype=torch.int64, device=x.device)
            self._plans[key] = (as_idx(order), ss, rs, None if ri == sorted(ri) else as_idx(ri))
        order, ss, rs, ri = self._plans[key]
        blocks = x.contiguous().reshape(L * A, -1)
        send = blocks if order is None else blocks.index_select(0, order)
        recv = torch.empty((sum(rs), blocks.shape[1]), dtype=blocks.dtype, device=x.device)
        dist.all_to_all_single(recv, send, output_split_sizes=rs, input_split_sizes=ss)
        out = recv if ri is None else recv.index_select(0, ri)
        return out.reshape(x.shape)

    def all_to_all(
        self, x: torch.Tensor, *, digits: Optional[Sequence[int]] = None, tier: Optional[int] = None
    ) -> torch.Tensor:
        """Flat: ``x (L, R_dst, ...)``; tier: ``x (L, A_l, ...)``.  ONE
        ``all_to_all_single`` whose split sizes follow from the static
        layout (no host read), between a local regroup by destination
        process and a local reorder of what arrives."""
        if digits is None:
            R = x.shape[1] if x.dim() >= 2 else 0
            if x.dim() < 2 or x.shape[0] != self.local_ranks(R):
                raise ValueError(f"all_to_all takes (L_src, R_dst, ...), got {tuple(x.shape)}")
            self._record("all_to_all", x)
            return self._a2a_blocks(x, (R,), 0)
        digits = tuple(digits)
        if x.dim() < 2 or x.shape[0] != self.local_ranks(math.prod(digits)) or x.shape[1] != digits[tier]:
            raise ValueError(
                f"a tier-{tier} all_to_all over {digits} takes (L, A_l, ...), got {tuple(x.shape)}"
            )
        self._record("all_to_all", x, tier)
        return self._a2a_blocks(x, digits, tier)

    def ragged_all_to_all(
        self,
        x: torch.Tensor,  # (L, C, W) the local senders' rows
        output: Optional[torch.Tensor],  # (L, capacity, W), or None
        *,
        input_offsets: torch.Tensor,  # (L_src, R_dst)
        send_sizes: torch.Tensor,  # (L_src, R_dst)
        output_offsets: torch.Tensor,  # (R_src, L_dst): where s's block lands on my d
        recv_sizes: torch.Tensor,  # (L_dst, R_src)
        capacity: Optional[int] = None,
    ) -> torch.Tensor:
        """The ragged exchange over processes: ONE ``all_to_all_single``
        with split sizes per process pair.  The split sizes must be Python
        lists, so ``send_sizes`` and ``recv_sizes`` are read to the host in
        one read (``host_reads``); ``send_sizes[s, d] == recv_sizes[d, s]``
        must hold across the world, as the replicated control plane gives
        them.  The rows are packed in (destination process, sender,
        destination) order with one K1 ``gather_rows`` and landed with
        another, output-driven as the stacked version lands them: receiver
        ``d``'s lane ``j`` finds its source by a search over its landing
        starts.  Rows a block carries past ``capacity`` are cut on
        landing."""
        L, C, W = x.shape
        R = L * self.world
        cap = output.shape[1] if output is not None else capacity
        if cap is None:
            raise ValueError("ragged_all_to_all needs output or capacity")
        for name, t, shape in (("input_offsets", input_offsets, (L, R)), ("send_sizes", send_sizes, (L, R)),
                               ("output_offsets", output_offsets, (R, L)), ("recv_sizes", recv_sizes, (L, R))):
            if tuple(t.shape) != shape:
                raise ValueError(f"ragged_all_to_all: {name} must be {shape}, got {tuple(t.shape)}")
        if output is not None and tuple(output.shape) != (L, cap, W):
            raise ValueError(f"ragged_all_to_all: output must be ({L}, {cap}, {W}), got {tuple(output.shape)}")
        if L * C + cap >= 2**31:
            raise ValueError(f"ragged_all_to_all: {L} x {C} rows and {cap} lanes overflow its int32 row index")
        self.calls[Call("ragged_all_to_all", L * cap * W * x.element_size(), (L, cap, W))] += 1
        dev, i32 = x.device, (lambda t: t.to(torch.int32))
        P = self.world
        # the one device-to-host read: both size tables at once
        sizes = torch.stack([i32(send_sizes), i32(recv_sizes)]).cpu()
        self.host_reads += 1
        send_splits = sizes[0].reshape(L, P, L).sum(dim=(0, 2)).tolist()  # rows to each process
        recv_splits = sizes[1].reshape(L, P, L).sum(dim=(0, 2)).tolist()  # rows from each process
        n_send, n_recv = sum(send_splits), sum(recv_splits)

        # pack: block (q, i, d) is sender i's rows toward d, d on process q
        order = lambda t: t.reshape(L, P, L).permute(1, 0, 2).reshape(-1)
        blk_size = order(i32(send_sizes))
        flat_base = torch.arange(L, dtype=torch.int32, device=dev)[:, None] * C + i32(input_offsets)
        blk_src = order(flat_base)
        if n_send:
            incl = torch.cumsum(blk_size, 0, dtype=torch.int32)
            t = torch.arange(n_send, dtype=torch.int32, device=dev)
            b = torch.searchsorted(incl, t, right=True)
            src = blk_src[b] + t - (incl - blk_size)[b]
            send = marshal_ops.gather_rows(x.reshape(1, L * C, W), src[None])[0]
        else:
            send = x.new_empty((0, W))
        recv = torch.empty((n_recv, W), dtype=x.dtype, device=dev)
        dist.all_to_all_single(recv, send, output_split_sizes=recv_splits, input_split_sizes=send_splits)
        if n_recv == 0:  # a row for the landing gather to read; no lane lands
            recv = x.new_zeros((1, W))

        # land: the arrivals come in (source rank, my receiver) order
        rsz = i32(recv_sizes).transpose(0, 1).contiguous()  # (R_src, L_dst)
        rstart = (torch.cumsum(rsz.reshape(-1), 0, dtype=torch.int32) - rsz.reshape(-1)).reshape(R, L).T  # (L, R)
        starts = i32(output_offsets).transpose(0, 1).contiguous()  # (L_dst, R_src)
        lane = torch.arange(cap, dtype=torch.int32, device=dev).expand(L, cap).contiguous()
        s = (torch.searchsorted(starts, lane, right=True) - 1).clamp_(min=0)
        at = lambda t: torch.gather(t, 1, s)
        src = at(rstart) + lane - at(starts)
        out = marshal_ops.gather_rows(recv[None], src.reshape(1, L * cap))[0].view(L, cap, W)
        if output is None:
            return out
        landed = (lane >= at(starts)) & (lane < at(starts + i32(recv_sizes)))
        return torch.where(landed[:, :, None], out, output)

    def gather_all(self, x: torch.Tensor) -> torch.Tensor:
        """``(L, ...) → (R, ...)``: every rank's rows, in every process, off
        the recorder: for host summaries after a run and for tests, never
        inside a round.  Unsigned words and booleans travel as the signed
        words of their width (gloo moves no ``uint32``)."""
        dtype = x.dtype
        x = x.contiguous().view(_WIRE.get(dtype, dtype))
        out = torch.empty((x.shape[0] * self.world,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, x)
        return out.view(dtype)

    def barrier(self) -> None:
        dist.barrier()

    def all_gather(
        self, x: torch.Tensor, *, digits: Optional[Sequence[int]] = None, tier: Optional[int] = None,
        per_group: bool = False,
    ) -> torch.Tensor:
        """Flat: ``(L, ...) → (L, R, ...)`` (a broadcast view of the gathered
        rows); tier: ``(L, ...) → (L, A_l, ...)``, the local ranks' groups
        picked from the gathered rows; with ``per_group``, ``(G, A_l, ...)``,
        the groups of the local ranks once each, in group order (when the
        tier is the fastest and the process holds whole groups, its own
        rows: nothing crosses a process)."""
        if digits is None:
            full = self.gather_all(x)
            self._record("all_gather", x)
            return full.unsqueeze(0).expand((x.shape[0],) + tuple(full.shape))
        self._record("all_gather", x, tier)
        digits = tuple(digits)
        R, L, A = math.prod(digits), x.shape[0], digits[tier]
        if per_group and tier == len(digits) - 1 and L % A == 0:
            return _by_group(x, (L // A, A), 1)
        full = self.gather_all(x)
        ranks = self.ranks(R, x.device)
        if not per_group:
            return full[_group_members(digits, tier, ranks=ranks)]
        stride = math.prod(digits[tier + 1:])
        group = ranks // (A * stride) * stride + ranks % stride  # a rank's group, in group order
        return _by_group(full, digits, tier)[torch.unique(group)]

    def ppermute(self, x: torch.Tensor) -> torch.Tensor:
        """The ring hop: a local roll, and one ``batch_isend_irecv`` pair that
        moves the last local rank's block to the next process's first
        rank (none at a world of one)."""
        self._record("ppermute", x)
        if self.world == 1:
            return torch.roll(x, 1, dims=0)
        last = x[-1:].contiguous()
        first = torch.empty_like(last)
        ops = [dist.P2POp(dist.isend, last, (self.index + 1) % self.world),
               dist.P2POp(dist.irecv, first, (self.index - 1) % self.world)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return torch.cat([first, x[:-1]], dim=0)

    def psum(
        self, x: torch.Tensor, *, digits: Optional[Sequence[int]] = None, tier: Optional[int] = None
    ) -> torch.Tensor:
        """Flat: held once, replicated.  An integer sum is the local sum,
        then an ``all_reduce(SUM)`` (exact in any order); a floating one
        gathers every rank's rows and sums them in the stacked order, so it
        equals the stacked sum bit for bit (a frame buffer's merge).  Tier:
        the group gathered and summed in the stacked order, held per local
        rank."""
        if digits is None:
            self._record("psum", x)
            if x.is_floating_point() or x.is_complex():
                return self.gather_all(x).sum(dim=0, dtype=x.dtype)
            total = x.sum(dim=0, dtype=x.dtype)
            dist.all_reduce(total, op=dist.ReduceOp.SUM)
            return total
        self._record("psum", x, tier)
        R = math.prod(digits)
        full = self.gather_all(x)
        return full[_group_members(digits, tier, ranks=self.ranks(R, x.device))].sum(dim=1, dtype=x.dtype)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        """The local minimum, then an ``all_reduce(MIN)``: held once."""
        self._record("pmin", x)
        low = x.amin(dim=0)
        dist.all_reduce(low, op=dist.ReduceOp.MIN)
        return low

    def reduce_scatter(self, x: torch.Tensor, *, digits: Sequence[int], tier: int) -> torch.Tensor:
        """``(L, A_l, ...) → (L, ...)``: the tier ``all_to_all``'s one
        ``all_to_all_single`` (block j of rank r to the member whose digit
        is j), then each rank's A_l arrivals summed in digit order, the
        stacked order: equal to the stacked result bit for bit."""
        digits = tuple(digits)
        _check_scatter(x, digits, tier, self.local_ranks(math.prod(digits)))
        self._record("reduce_scatter", x, tier)
        return self._a2a_blocks(x, digits, tier).sum(dim=1, dtype=x.dtype)

    def grad_all_reduce(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum ``tensors`` over the world's processes, in place: flattened
        into buckets of one dtype and at most ``_GRAD_BUCKET_BYTES`` (a
        tensor larger than that is a bucket of its own), one ``all_reduce(SUM)``
        a bucket, each recorded as a ``grad_all_reduce`` call, so the
        round's call budget is untouched.  A bucket of one contiguous
        tensor is reduced where it lies; the others through one flat copy.
        Every process ends with the same bits."""
        for b in grad_buckets(tensors):
            if len(b) == 1 and b[0].is_contiguous():  # reduced where it lies: no copy
                self._record("grad_all_reduce", b[0].view(-1))
                dist.all_reduce(b[0], op=dist.ReduceOp.SUM)
                continue
            flat = torch.cat([t.reshape(-1) for t in b])
            self._record("grad_all_reduce", flat)
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
            at = 0
            for t in b:
                t.copy_(flat[at:at + t.numel()].view(t.shape))
                at += t.numel()
