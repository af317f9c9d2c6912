"""Tensor-parallel arithmetic on placed parameters: the rank context and the
differentiable collectives of the placed train step.

A placed step (``launch.placement``) runs every rank of a ``(data,
model)`` layout that the process holds at once, rank-stacked: every
activation and every parameter block has a leading axis of the L local
ranks.  Rank ``(g, m)`` computes data group g's rows with model rank m's
blocks, as a device of the reference's mesh does under GSPMD: the residual
stream whole on every model rank, the heads, the hidden units and the
vocabulary split over ``model``.

The collectives are those of Megatron-style tensor parallelism, over a
tier of the layout's digits (``core.collectives``), each with the
gradient its forward implies (``psum_model`` and ``copy_model`` only where
weights are split over ``model``, :attr:`Ranks.tensor_parallel`; under
``dp_over_model`` every weight is whole and both are the identity):

  psum_model(x)       the sum over the model ranks of a data group
                      (a row-parallel product's partial sums); backward:
                      the gradient as it is
  copy_model(x)       x as it is, on the input of a column-parallel
                      product; backward: the model ranks' partial
                      gradients summed
  gather(x, tier, d)  the tier's blocks of x concatenated along dimension
                      d (an FSDP weight over ``data``, keys or values cut
                      through a head over ``model``); backward: a
                      ``reduce_scatter`` over the tier

Each rank's loss is its data group's (under ``dp_over_model``, whose
weights are whole on every rank, its own rows', :attr:`Ranks.row_groups`);
the backward pass from every rank's loss at once then gives each rank
the gradient of its group's loss for its blocks, as each device of the
reference's mesh computes it.  An
axis of one rank issues no call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.launch.mesh import DATA_TIER, MODEL_TIER

__all__ = ["DATA_TIER", "MODEL_TIER", "Ranks", "copy_model", "gather", "mm", "pick_model", "psum_model"]


@dataclasses.dataclass(frozen=True)
class Ranks:
    """The ranks a process holds on a ``launch.mesh.Layout`` (its ``comm``
    the resolved backend): ``ids``, ``(L,)`` int64 global ids on the step's
    device.  ``rows_over_model``: the batch rows run over ``model`` too
    (the reference's ``dp_over_model``: every weight whole on every rank),
    so each rank holds a row block of its own (:attr:`row_groups`)."""

    layout: Any
    ids: torch.Tensor
    rows_over_model: bool = False

    @property
    def comm(self):
        return self.layout.comm

    @property
    def data(self) -> int:
        return self.layout.data

    @property
    def model(self) -> int:
        return self.layout.model

    @property
    def digits(self) -> Tuple[int, int]:
        return self.layout.digits

    @property
    def group(self) -> torch.Tensor:
        """``(L,)``: each local rank's data group."""
        return self.layout.coords(self.ids)[0]

    @property
    def mrank(self) -> torch.Tensor:
        """``(L,)``: each local rank's model rank."""
        return self.layout.coords(self.ids)[1]

    def size(self, tier: int) -> int:
        return self.digits[tier]

    @property
    def row_groups(self) -> int:
        """The blocks a global batch's rows are cut into, major-first as
        the reference's batch sharding cuts them: the data groups, or
        ``data·model`` under ``rows_over_model`` (``P(('data',
        'model'))``)."""
        return self.data * self.model if self.rows_over_model else self.data

    @property
    def row_group(self) -> torch.Tensor:
        """``(L,)``: the row block each local rank computes: its data
        group's, or under ``rows_over_model`` its own (its global id)."""
        return self.ids if self.rows_over_model else self.group

    @property
    def tensor_parallel(self) -> bool:
        """Whether weights are split over ``model`` (more than one model
        rank, the rows not over it): the row-parallel sums and the copies
        of :func:`psum_model` and :func:`copy_model` are then calls."""
        return self.model > 1 and not self.rows_over_model

    def row_groups_in_words(self) -> str:
        """The row groups, for a refusal."""
        if self.rows_over_model:
            return f"{self.data} data groups x {self.model} model ranks (dp_over_model: the rows run over both)"
        return f"{self.data} data groups"

    def psum_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``(L, …)`` summed over the row groups, held per rank: over
        ``data``, or under ``rows_over_model`` over every rank (one flat
        ``psum``); a single row group issues no call."""
        if self.row_groups == 1:
            return x
        if self.rows_over_model:
            return self.comm.psum(x).expand_as(x)
        return self.comm.psum(x, digits=self.digits, tier=DATA_TIER)


class _PsumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks):
        return ranks.comm.psum(x, digits=ranks.digits, tier=MODEL_TIER)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks):
        ctx.ranks = ranks
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        r = ctx.ranks
        return r.comm.psum(g.contiguous(), digits=r.digits, tier=MODEL_TIER), None


def _merge(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``(L, A, *block)`` → ``(L, *block)`` with dimension ``dim`` of the
    block (0-based, without the rank axis) A times longer."""
    y = x.movedim(1, dim + 1)
    return y.reshape(y.shape[:dim + 1] + (-1,) + y.shape[dim + 3:])


def _split(x: torch.Tensor, parts: int, dim: int) -> torch.Tensor:
    """The inverse of :func:`_merge`: ``(L, *block)`` → ``(L, A, *block/A)``."""
    n = x.shape[dim + 1]
    y = x.reshape(x.shape[:dim + 1] + (parts, n // parts) + x.shape[dim + 2:])
    return y.movedim(dim + 1, 1).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, tier, dim):
        ctx.ranks, ctx.tier, ctx.dim = ranks, tier, dim
        return _merge(ranks.comm.all_gather(x.contiguous(), digits=ranks.digits, tier=tier), dim)

    @staticmethod
    def backward(ctx, g):
        r = ctx.ranks
        parts = _split(g, r.size(ctx.tier), ctx.dim)
        return r.comm.reduce_scatter(parts, digits=r.digits, tier=ctx.tier), None, None, None


def psum_model(x: torch.Tensor, ranks: Ranks) -> torch.Tensor:
    return _PsumModel.apply(x, ranks) if ranks.tensor_parallel else x


def copy_model(x: torch.Tensor, ranks: Ranks) -> torch.Tensor:
    return _CopyModel.apply(x, ranks) if ranks.tensor_parallel else x


def gather(x: torch.Tensor, ranks: Ranks, tier: int, dim: int) -> torch.Tensor:
    """``(L, *block)`` → ``(L, *block)`` with block dimension ``dim`` whole
    over ``tier``."""
    return x if ranks.size(tier) == 1 else _Gather.apply(x, ranks, tier, dim)


def pick_model(x: torch.Tensor, ranks: Ranks) -> torch.Tensor:
    """``(L, ..., n)`` → ``(L, ..., n / model)``: each rank's own block of
    the last dimension (a tensor whole over ``model`` cut back to the
    rank's columns)."""
    M = ranks.model
    if not ranks.tensor_parallel:
        return x
    blk = x.reshape(x.shape[:-1] + (M, x.shape[-1] // M))
    idx = ranks.mrank.view((-1,) + (1,) * (x.dim() - 1) + (1,)).expand(blk.shape[:-2] + (1, blk.shape[-1]))
    return torch.gather(blk, -2, idx).squeeze(-2)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each rank's ``x @ w``: x ``(L, ..., k)``, w ``(L, k, n)`` → ``(L, ...,
    n)``, one batched GEMM (no broadcast copy of w)."""
    L, k = x.shape[0], x.shape[-1]
    return torch.bmm(x.reshape(L, -1, k), w).reshape(x.shape[:-1] + (w.shape[-1],))
