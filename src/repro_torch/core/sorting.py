"""Sort-by-destination plan (§4.2.1) over rank-stacked tensors.

Keys ``(dest << idx_bits) | lane`` pack into 32 bits whenever
``bit_length(R+1) + bit_length(C-1) <= 32``; the port holds them in int64 so
``torch.sort`` orders keys with the top bit set correctly.  Sorting the
unique keys is a stable sort on the sanitised destination.  Invalid items
(lane >= count, dest < 0 or dest >= R) get destination R and sort to the
tail.  Every function takes ``dest (B, C)`` and ``count (B,)``: one row per
rank.  These are the plain-tensor formulations: the forwarding round plans
through kernel K3 (``kernels/sort_keys``, the ``"pack"`` keys) or kernel K4
(``kernels/bucket_scatter``, whose plain version is
:func:`destination_rank`).

The hierarchical route's keys are lexicographic N-level bit-fields
``(d_0, …, d_{L-1}, slot)`` (:func:`pack_keys_hierarchical`).  Global ranks
are lexicographic in the tier digits, so their order is the flat key order:
the route's sort plan goes through K3 like the flat one
(``kernels/sort_keys.ops.sort_permutation_hierarchical``), and only the key
width check (:func:`hierarchical_key_bits`) is the N-level layout's own.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = [
    "destination_histogram",
    "destination_rank",
    "hierarchical_key_bits",
    "pack_keys",
    "pack_keys_hierarchical",
    "segment_bounds_from_histogram",
    "segment_bounds_from_sorted",
    "segment_offsets",
    "sort_permutation",
    "sort_permutation_hierarchical",
    "unpack_keys",
    "unpack_keys_hierarchical",
]


def _idx_bits(capacity: int) -> int:
    return max(1, (capacity - 1).bit_length())


def _sanitized(dest: torch.Tensor, count: torch.Tensor, num_ranks: int) -> torch.Tensor:
    lane = torch.arange(dest.shape[-1], device=dest.device)
    valid = (lane[None, :] < count[:, None]) & (dest >= 0) & (dest < num_ranks)
    return torch.where(valid, dest, num_ranks).to(torch.int64)


def pack_keys(dest: torch.Tensor, count: torch.Tensor, num_ranks: int) -> torch.Tensor:
    """(dest, lane) packed into uint32 key values held as int64; invalid
    lanes get dest = num_ranks."""
    cap = dest.shape[-1]
    ib = _idx_bits(cap)
    if (num_ranks + 1).bit_length() + ib > 32:
        raise ValueError(
            f"packed key needs {(num_ranks + 1).bit_length()}+{ib} bits > 32; "
            "use method='argsort'"
        )
    lane = torch.arange(cap, dtype=torch.int64, device=dest.device)
    return (_sanitized(dest, count, num_ranks) << ib) | lane[None, :]


def unpack_keys(keys: torch.Tensor, capacity: int, num_ranks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_keys` → (dest, lane), int32."""
    del num_ranks
    ib = _idx_bits(capacity)
    return (keys >> ib).to(torch.int32), (keys & ((1 << ib) - 1)).to(torch.int32)


def destination_histogram(dest: torch.Tensor, count: torch.Tensor, num_ranks: int) -> torch.Tensor:
    """``(B, num_ranks+1)`` int32 counts per destination; slot R = invalid."""
    d = _sanitized(dest, count, num_ranks)
    hist = torch.zeros(dest.shape[0], num_ranks + 1, dtype=torch.int32, device=dest.device)
    return hist.scatter_add_(1, d, torch.ones_like(d, dtype=torch.int32))


def destination_rank(
    dest: torch.Tensor, count: torch.Tensor, num_ranks: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bucket-scatter marshal plan in one pass over the destinations.

    Returns ``(d_clean, rank, hist)``: the sanitised destination ``(B, C)``
    (invalid lanes → R), each lane's stable rank among earlier lanes with the
    same sanitised destination ``(B, C)``, and the ``(B, R+1)`` histogram —
    all int32.  ``off[d_clean] + rank`` is the §4.2.1 stable sort's
    placement, with no keys and no sort: the one-hot exclusive prefix sum
    over the lane axis (kernel K4's plain version).
    """
    d = _sanitized(dest, count, num_ranks)
    onehot = (d[:, :, None] == torch.arange(num_ranks + 1, device=dest.device)).to(torch.int32)
    excl = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    rank = torch.gather(excl, 2, d[:, :, None])[:, :, 0]
    return d.to(torch.int32), rank, onehot.sum(dim=1, dtype=torch.int32)


def segment_offsets(send_counts: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis → start of each segment."""
    return torch.cumsum(send_counts, dim=-1, dtype=send_counts.dtype) - send_counts


def segment_bounds_from_histogram(send_counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(begin, end) of every rank's segment, in O(R) from the histogram."""
    off = segment_offsets(send_counts)
    return off, off + send_counts


def segment_bounds_from_sorted(sorted_dest: torch.Tensor, num_ranks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's §4.2.2-step-1 boundary detection, kept for
    cross-validation: ``(begin, end)`` of each rank's segment, ``(B, R)``
    int32, found by comparing neighbours of the sorted destinations, with
    the gaps of ranks that received nothing filled by the next segment's
    begin.  ``end - begin`` equals the histogram counts."""
    rows, n = sorted_dest.shape
    dev = sorted_dest.device
    i = torch.arange(n, dtype=torch.int32, device=dev).expand(rows, n)
    edge = lambda v: torch.full((rows, 1), v, dtype=sorted_dest.dtype, device=dev)
    prev = torch.cat([edge(-1), sorted_dest[:, :-1]], dim=1)
    nxt = torch.cat([sorted_dest[:, 1:], edge(num_ranks + 1)], dim=1)
    d = torch.clamp(sorted_dest, 0, num_ranks).to(torch.int64)
    # each begin/end is found by exactly one lane; slot R collects the rest
    begin = torch.full((rows, num_ranks + 1), -1, dtype=torch.int32, device=dev)
    end = torch.full((rows, num_ranks + 1), -1, dtype=torch.int32, device=dev)
    begin.scatter_reduce_(1, torch.where(sorted_dest != prev, d, num_ranks), i, "amax")
    end.scatter_reduce_(1, torch.where(sorted_dest != nxt, d, num_ranks), i + 1, "amax")
    begin, end = begin[:, :num_ranks], end[:, :num_ranks]
    # gap fill, from the last rank down: an empty rank begins and ends
    # where the next non-empty segment begins (the valid total at the tail)
    nxt_begin = ((sorted_dest >= 0) & (sorted_dest < num_ranks)).sum(dim=1, dtype=torch.int32)
    for r in range(num_ranks - 1, -1, -1):
        begin[:, r] = torch.where(begin[:, r] < 0, nxt_begin, begin[:, r])
        end[:, r] = torch.where(end[:, r] < 0, nxt_begin, end[:, r])
        nxt_begin = begin[:, r]
    return begin, end


def sort_permutation(
    dest: torch.Tensor, count: torch.Tensor, num_ranks: int, *, method: str = "pack"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """§4.2.1 key sort WITHOUT touching the payload.

    Returns ``(perm, sorted_dest, send_counts)``: ``perm[b, i]`` is the
    source lane of sorted position ``i`` (stable by sanitised destination),
    and ``send_counts`` the ``(B, R+1)`` histogram.
    """
    cap = dest.shape[-1]
    if method == "pack":
        keys = pack_keys(dest, count, num_ranks)
        d_sorted, perm = unpack_keys(torch.sort(keys, dim=-1).values, cap, num_ranks)
    elif method == "argsort":
        d = _sanitized(dest, count, num_ranks)
        perm = torch.sort(d, dim=-1, stable=True).indices.to(torch.int32)
        d_sorted = torch.gather(d, 1, perm.to(torch.int64)).to(torch.int32)
    else:
        raise ValueError(f"unknown sort method {method!r}")
    return perm, d_sorted, destination_histogram(dest, count, num_ranks)


def _field_bits(n_values: int) -> int:
    return max(1, (n_values - 1).bit_length())


def _level_bits(level_sizes: Tuple[int, ...]) -> list:
    """Bit widths of the N-level key's digit fields, slowest first (the
    slowest field also holds the invalid marker ``A_0``)."""
    return [_field_bits(level_sizes[0] + 1)] + [_field_bits(a) for a in level_sizes[1:]]


def hierarchical_key_bits(level_sizes: Tuple[int, ...], capacity: int) -> list:
    """:func:`_level_bits`; raises where the key with its
    ``idx_bits(capacity)`` slot field exceeds 32 bits, as the reference's
    ``pack_keys_hierarchical`` does."""
    ib = _idx_bits(capacity)
    bits = _level_bits(level_sizes)
    if sum(bits) + ib > 32:
        raise ValueError(
            f"hierarchical key needs {'+'.join(map(str, bits))}+{ib} bits > 32; "
            "use method='argsort'"
        )
    return bits


def pack_keys_hierarchical(dest: torch.Tensor, count: torch.Tensor, level_sizes) -> torch.Tensor:
    """Lexicographic N-level keys ``(d_0, …, d_{L-1}, slot)`` held as int64
    (uint32 values): one bit-field per tier, slowest on top.  Invalid lanes
    get slowest digit ``A_0`` and sort past every valid key."""
    level_sizes = tuple(int(a) for a in level_sizes)
    cap = dest.shape[-1]
    bits = hierarchical_key_bits(level_sizes, cap)
    num_ranks = math.prod(level_sizes)
    lane = torch.arange(cap, dtype=torch.int64, device=dest.device)
    valid = (lane[None, :] < count[:, None]) & (dest >= 0) & (dest < num_ranks)
    d = torch.where(valid, dest, 0).to(torch.int64)
    key = lane[None, :].expand_as(d)
    shift = _idx_bits(cap)
    # fastest digit sits just above the slot bits; slowest ends up on top
    for a, b in zip(reversed(level_sizes[1:]), reversed(bits[1:])):
        key = key | ((d % a) << shift)
        d = d // a
        shift += b
    return key | (torch.where(valid, d, level_sizes[0]) << shift)


def unpack_keys_hierarchical(keys: torch.Tensor, capacity: int, level_sizes):
    """Inverse of :func:`pack_keys_hierarchical` → ``((d_0, …, d_{L-1}),
    slot)``, int32, digits slowest first."""
    level_sizes = tuple(int(a) for a in level_sizes)
    ib = _idx_bits(capacity)
    bits = _level_bits(level_sizes)
    slot = (keys & ((1 << ib) - 1)).to(torch.int32)
    digits, shift = [], ib
    for b in reversed(bits[1:]):
        digits.append(((keys >> shift) & ((1 << b) - 1)).to(torch.int32))
        shift += b
    digits.append((keys >> shift).to(torch.int32))
    return tuple(reversed(digits)), slot


def sort_permutation_hierarchical(
    dest: torch.Tensor, count: torch.Tensor, level_sizes, *, method: str = "pack"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The N-level route's ONE key sort: ``(perm (B, C), count_tensor (B,
    *level_sizes))``, ``perm`` the flat destination order (ranks are
    lexicographic in the digits) and ``count_tensor`` the per-destination
    histogram shaped by tier."""
    level_sizes = tuple(int(a) for a in level_sizes)
    num_ranks = math.prod(level_sizes)
    cap = dest.shape[-1]
    if method == "pack":
        keys = pack_keys_hierarchical(dest, count, level_sizes)
        _digits, perm = unpack_keys_hierarchical(torch.sort(keys, dim=-1).values, cap, level_sizes)
    elif method == "argsort":
        d = _sanitized(dest, count, num_ranks)
        perm = torch.sort(d, dim=-1, stable=True).indices.to(torch.int32)
    else:
        raise ValueError(f"unknown sort method {method!r}")
    hist = destination_histogram(dest, count, num_ranks)
    return perm, hist[:, :num_ranks].reshape((dest.shape[0],) + level_sizes)
