"""The port's sort-free scatter marshal (K4, K5), compaction (K6) and
two-pass marshal (K7) against the JAX reference.

Kernels: on the CPU each wrapper runs its plain PyTorch version, held
against the JAX ``ref.py`` and the Pallas kernel called standalone with
``interpret=True``, on the cases of ``tests/test_kernels.py``.  Rounds: the
port's scatter rounds against the reference's ``use_pallas=False`` rounds
under ``shard_map`` on the 8-device mesh, on the cases of
``tests/test_core_scatter.py``, and against the port's own sort and onehot
rounds.  Everything here moves or counts data: counts, drops, totals, ranks
and every lane below ``count`` must be equal bit for bit (tolerance: none).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.core import ForwardConfig as JForwardConfig
from repro.core import RafiContext as JRafiContext
from repro.core import queue as JQ
from repro.core import run_until_done as j_run_until_done
from repro.core import sorting as JS
from repro.core import stages as JST
from repro.core import work_item as j_work_item
from repro.kernels.bucket_scatter import kernel as JBK
from repro.kernels.bucket_scatter import ops as JBO
from repro.kernels.bucket_scatter import ref as JBR
from repro.kernels.compact import kernel as JCK
from repro.kernels.compact import ops as JCO
from repro.kernels.compact import ref as JCR
from repro.kernels.marshal import kernel as JMK
from repro.kernels.marshal import ops as JMO
from repro.kernels.marshal import ref as JMR
from repro_torch import kernels as KN
from repro_torch.core import (
    DISCARD,
    ForwardConfig,
    RafiContext,
    StackedCollectives,
    WorkQueue,
    enqueue,
    forward_work,
    make_queue,
    work_item,
)
from repro_torch.core import sorting as TS
from repro_torch.core import stages as TST
from repro_torch.kernels.bucket_scatter import ops as BS
from repro_torch.kernels.compact import ops as CO
from repro_torch.kernels.marshal import ops as MO
from repro_torch.kernels.sort_keys import ops as SO

R, CAP = 8, 64
U32 = lambda a: np.asarray(a).view(np.uint32)
T32 = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _words(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


# -------------------------------------------------------------------- K4
@pytest.mark.parametrize("cap,tile", [(64, 16), (256, 256), (96, 32), (192, 64), (128, 128)])
@pytest.mark.parametrize("num_ranks", [4, 8, 64])
def test_k4_plain_equals_ref_and_pallas(cap, tile, num_ranks):
    """d_clean, in-bucket rank and histogram, two rows (one with count < C,
    destinations with DISCARD and out-of-range lanes): bit-equal to
    ``ref.rank_and_histogram`` and to the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(cap + num_ranks)
    dest = rng.integers(-2, num_ranks + 2, (2, cap)).astype(np.int32)
    count = np.array([cap, rng.integers(0, cap + 1)], np.int32)
    got = BS.rank_and_histogram(torch.from_numpy(dest), torch.from_numpy(count), num_ranks=num_ranks)
    assert [t.dtype for t in got] == [torch.int32] * 3
    assert got[2].shape == (2, num_ranks + 1)
    for b in range(2):
        args = (jnp.asarray(dest[b]), jnp.int32(count[b]))
        want = JBR.rank_and_histogram(*args, num_ranks=num_ranks)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
    pallas = JBK.rank_and_histogram(jnp.asarray(dest[1]), jnp.int32(count[1]), num_ranks=num_ranks,
                                    tile=tile, interpret=True)
    for g, w in zip(got, pallas):
        np.testing.assert_array_equal(g[1].numpy(), np.asarray(w))


def test_k4_all_discard_and_empty_rows():
    """All-DISCARD and count-0 rows: every lane lands in bucket R, ranked
    0..C-1 in lane order."""
    dest = np.full((2, 32), DISCARD, np.int32)
    dest[1] = 3
    count = np.array([32, 0], np.int32)
    d, rank, hist = BS.rank_and_histogram(torch.from_numpy(dest), torch.from_numpy(count), num_ranks=4)
    assert bool((d == 4).all())
    np.testing.assert_array_equal(rank.numpy(), np.tile(np.arange(32), (2, 1)))
    np.testing.assert_array_equal(hist.numpy(), [[0, 0, 0, 0, 32]] * 2)


# -------------------------------------------------------------------- K5
@pytest.mark.parametrize("n,slots,W", [(64, 64, 3), (256, 80, 9), (100, 64, 1)])
def test_k5_plain_equals_ref_and_pallas(n, slots, W):
    """Out-of-range positions on either side are dropped; unclaimed slots
    are zero.  Bit-equal per row to ref and to the Pallas kernel."""
    rng = np.random.default_rng(n + slots)
    src = _words(rng, (2, n, W))
    # distinct valid positions on some lanes, the rest negative or past the end
    pos = np.where(rng.random((2, n)) < 0.5, rng.integers(-3, 0, (2, n)), slots + rng.integers(0, 3, (2, n)))
    for b in range(2):
        lanes = rng.permutation(n)[: min(n, slots) - 2]
        pos[b, lanes] = rng.permutation(slots)[: len(lanes)]
    pos = pos.astype(np.int32)
    got = BS.scatter_rows(T32(src), torch.from_numpy(pos), num_slots=slots)
    assert got.shape == (2, slots, W)
    for b in range(2):
        want = JBR.scatter_rows(jnp.asarray(src[b]), jnp.asarray(pos[b]), num_slots=slots)
        pallas = JBK.scatter_rows(jnp.asarray(src[b]), jnp.asarray(pos[b]), num_slots=slots, interpret=True)
        np.testing.assert_array_equal(U32(got[b].numpy()), np.asarray(want))
        np.testing.assert_array_equal(U32(got[b].numpy()), np.asarray(pallas))


def test_k5_negative_positions_are_dropped():
    """Negative positions land in the trash, never wrap to a valid slot."""
    src = torch.ones(1, 4, 2, dtype=torch.int32)
    pos = torch.tensor([[-1, -4, 1, 9]], dtype=torch.int32)
    want = np.zeros((4, 2), np.uint32)
    want[1] = 1
    np.testing.assert_array_equal(U32(BS.scatter_rows(src, pos, num_slots=4)[0].numpy()), want)
    pallas = JBK.scatter_rows(jnp.ones((4, 2), jnp.uint32), jnp.asarray(pos[0].numpy()), num_slots=4,
                              interpret=True)
    np.testing.assert_array_equal(np.asarray(pallas), want)


def test_k4_k5_reproduce_sort_placement():
    """Scattering every row to ``off[d_clean] + rank`` gives key pack +
    sort + gather on the valid prefix, and K4's histogram is K3's."""
    cap, nr, W = 256, 16, 7
    rng = np.random.default_rng(21)
    dest = torch.from_numpy(rng.integers(-1, nr + 1, (2, cap)).astype(np.int32))
    count = torch.tensor([200, cap], dtype=torch.int32)
    packed = T32(_words(rng, (2, cap, W)))
    d_clean, rank, hist = BS.rank_and_histogram(dest, count, num_ranks=nr)
    off = torch.cumsum(hist[:, :nr], 1, dtype=torch.int32) - hist[:, :nr]
    pos = torch.gather(off, 1, d_clean.clamp(0, nr - 1).long()) + rank
    got = BS.scatter_rows(packed, torch.where(d_clean < nr, pos, cap), num_slots=cap)
    perm, _, khist = SO.sort_permutation(dest, count, nr)
    want = MO.gather_rows(packed, perm)
    np.testing.assert_array_equal(hist.numpy(), khist.numpy())
    for b in range(2):
        n = int(hist[b, :nr].sum())
        np.testing.assert_array_equal(got[b, :n].numpy(), want[b, :n].numpy())


# -------------------------------------------------------------------- K6
@pytest.mark.parametrize("cap,tile", [(32, 8), (512, 128), (2048, 2048), (48, 16)])
def test_k6_plain_equals_ref_and_pallas(cap, tile):
    rng = np.random.default_rng(cap)
    mask = rng.random((3, cap)) < 0.4
    mask[2] = False
    pos, total = CO.compact_positions(torch.from_numpy(mask))
    assert pos.dtype == total.dtype == torch.int32 and total.shape == (3,)
    for b in range(3):
        rpos, rtot = JCR.compact_positions(jnp.asarray(mask[b]))
        kpos, ktot = JCK.compact_positions(jnp.asarray(mask[b]), tile=tile, interpret=True)
        np.testing.assert_array_equal(pos[b].numpy(), np.asarray(rpos))
        np.testing.assert_array_equal(pos[b].numpy(), np.asarray(kpos))
        assert int(total[b]) == int(rtot[0]) == int(ktot[0])


def test_k6_positions_are_the_stable_append():
    """Emitted lanes get exactly 0..k-1 in lane order; the total is k."""
    rng = np.random.default_rng(7)
    mask = torch.from_numpy(rng.random((5, 64)) < rng.random((5, 1)))
    pos, total = CO.compact_positions(mask)
    for b in range(5):
        m = mask[b].numpy()
        np.testing.assert_array_equal(pos[b].numpy()[m], np.arange(m.sum()))
        assert int(total[b]) == m.sum()


# (rows, n, Pallas tile): the cases the single-pass K6 branches on (its
# tiles hold 8192 lanes).  Row 0 is all true and row 1 all false wherever
# there are two rows or more.
K6_CASES = {
    "n_below_16": (1, 7, 7),
    "two_rows_n_below_16": (2, 13, 13),
    "ragged_n_mod_16_three_tiles_b9": (9, 3 * 8192 + 8, 6146),
    "odd_n_three_tiles_b9": (9, 3 * 8192 + 5, 523),
    "aligned_three_tiles": (3, 3 * 8192, 8192),
    "aligned_four_tiles_plus_16": (2, 3 * 8192 + 16, 6148),
}


def _k6_mask(rows, n, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((rows, n)) < rng.random((rows, 1))
    if rows >= 2:
        mask[0], mask[1] = True, False
    return mask


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_k6_plain_equals_ref_and_pallas_on_kernel_branches(case):
    """Positions and totals bit-equal to ``ref.compact_positions`` and the
    Pallas kernel, at n < 16, n % 16 != 0, odd n, n over three of the
    kernel's 8192-lane tiles, all-true and all-false rows, B = 1 and B = 9."""
    rows, n, tile = K6_CASES[case]
    mask = _k6_mask(rows, n, n)
    pos, total = CO.compact_positions(torch.from_numpy(mask))
    assert pos.shape == (rows, n) and total.shape == (rows,)
    for b in range(rows):
        rpos, rtot = JCR.compact_positions(jnp.asarray(mask[b]))
        kpos, ktot = JCK.compact_positions(jnp.asarray(mask[b]), tile=tile, interpret=True)
        np.testing.assert_array_equal(pos[b].numpy(), np.asarray(rpos))
        np.testing.assert_array_equal(pos[b].numpy(), np.asarray(kpos))
        assert int(total[b]) == int(rtot[0]) == int(ktot[0])
    if rows >= 2:
        assert int(total[0]) == n and int(total[1]) == 0


_INVALID, _AGGREGATE, _INCLUSIVE = 0, 1, 2


def _bytes_to_bits(words):
    """csrc/compact.cu bytes_to_bits: each byte of a uint32 word to 0/1."""
    return ((((words & 0x7F7F7F7F) + 0x7F7F7F7F) | words) & 0x80808080) >> 7


def _lookback(agg, rng):
    """A numpy model of ``csrc/lookback.cuh``'s decoupled look-back over the
    independent tile sequences of ``agg (S, n_tiles)``, with the tiles'
    steps interleaved in a random order: each tile publishes its aggregate
    (tile 0 its inclusive prefix), then reads 32 predecessors a window,
    waits while any lane up to the nearest inclusive one is unpublished,
    sums those lanes, and moves 32 tiles back until it meets an inclusive
    prefix.  Returns each tile's exclusive prefix and the number of waits."""
    seqs, n_tiles = agg.shape
    flag = np.full((seqs, n_tiles), _INVALID)
    value = np.zeros((seqs, n_tiles), np.int64)
    prefix = np.zeros((seqs, n_tiles), np.int64)
    todo = {(b, t): [False, t - 1, 0] for b in range(seqs) for t in range(n_tiles)}
    spins = 0
    while todo:
        key = list(todo)[rng.integers(len(todo))]
        (b, t), st = key, todo[key]
        if not st[0]:  # publish
            st[0] = True
            flag[b, t], value[b, t] = (_INCLUSIVE if t == 0 else _AGGREGATE), agg[b, t]
            if t == 0:
                del todo[key]
            continue
        j = st[1] - np.arange(32)
        f = np.where(j >= 0, flag[b, np.maximum(j, 0)], _INCLUSIVE)
        v = np.where(j >= 0, value[b, np.maximum(j, 0)], 0)
        inc = sum(1 << k for k in range(32) if f[k] == _INCLUSIVE)
        upto = ((inc & -inc) << 1) - 1 if inc else 0xFFFFFFFF
        unready = sum(1 << k for k in range(32) if f[k] == _INVALID)
        if unready & upto:
            spins += 1
            continue
        st[2] += int(sum(v[k] for k in range(32) if upto >> k & 1))
        if inc:
            prefix[b, t] = st[2]
            flag[b, t], value[b, t] = _INCLUSIVE, st[2] + agg[b, t]
            del todo[key]
        else:
            st[1] -= 32
    return prefix, spins


def _k6_single_pass(mask_u8, warps, rng):
    """A numpy model of ``csrc/compact.cu``'s compact_kernel with ``warps``
    warps a tile: lane i of a tile is byte i % 4 of thread (i / 4) % 32's
    group (i / 128) % 8 in warp i / 1024; mask bytes turned to 0/1 four at a
    time; group counts scanned over the warp's threads, then over the groups
    and the warps; and the tiles' prefixes from :func:`_lookback`."""
    rows, n = mask_u8.shape
    tile = warps * 1024
    n_tiles = -(-n // tile)
    padded = np.zeros((rows, n_tiles * tile), np.uint8)
    padded[:, :n] = mask_u8
    bits = _bytes_to_bits(padded.view("<u4")).view(np.uint8).reshape(rows, n_tiles, warps, 8, 32, 4)
    count = bits.sum(-1, dtype=np.int64)  # (row, tile, warp, group, thread)
    incl = np.cumsum(count, -1)
    group_total = incl[..., -1]
    warp_total = group_total.sum(-1)
    agg = warp_total.sum(-1)
    prefix, spins = _lookback(agg, rng)
    warp_base = prefix[:, :, None] + np.cumsum(warp_total, -1) - warp_total
    group_base = warp_base[..., None] + np.cumsum(group_total, -1) - group_total
    thread_base = group_base[..., None] + incl - count
    pos = thread_base[..., None] + np.cumsum(bits, -1, dtype=np.int64) - bits
    return pos.reshape(rows, -1)[:, :n], prefix[:, -1] + agg[:, -1], spins


@pytest.mark.parametrize("rows,n,warps,seed", [(3, 100 * 1024 + 13, 1, 0), (2, 40 * 1024, 1, 1),
                                                (4, 9, 1, 2), (1, 35 * 2048 + 6, 2, 3)])
def test_k6_single_pass_lookback_model_equals_ref(rows, n, warps, seed):
    """The kernel's scheme modelled in numpy, at tiles of one or two warps
    so that a row holds up to 101 tiles and the look-back crosses several
    32-tile windows; mask bytes other than 0 and 1 count as true.  Positions
    and totals equal ``ref.compact_positions`` of the mask != 0, whatever
    order the tiles' steps run in."""
    rng = np.random.default_rng(seed)
    mask_u8 = np.where(rng.random((rows, n)) < 0.5, rng.integers(1, 256, (rows, n)), 0).astype(np.uint8)
    if rows >= 2:
        mask_u8[1] = 0
    pos, total, spins = _k6_single_pass(mask_u8, warps, rng)
    for b in range(rows):
        rpos, rtot = JCR.compact_positions(jnp.asarray(mask_u8[b] != 0))
        np.testing.assert_array_equal(pos[b], np.asarray(rpos))
        assert int(total[b]) == int(rtot[0])
    if n > 33 * warps * 1024:
        assert spins > 0  # some tile really found an unpublished predecessor


@pytest.mark.cuda
def test_cuda_k6_single_pass_equals_plain_on_kernel_branches():
    """On the card: K6 bit-equal to its plain version on every case of
    ``K6_CASES``, on rows of 100 tiles (look-back across several 32-tile
    windows), on 300 rows, on a mask that starts off a 16-byte boundary
    (the byte loads) and over repeated calls (a new epoch each)."""
    from repro_torch import compat as port_compat

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    if port_compat.nvcc_path() is None:
        pytest.skip("needs nvcc to build the CUDA kernels")
    dev = torch.device("cuda")
    masks = [torch.from_numpy(_k6_mask(rows, n, n)) for rows, n, _ in K6_CASES.values()]
    masks += [torch.from_numpy(_k6_mask(4, 100 * 8192 + 3, 5)), torch.from_numpy(_k6_mask(300, 5000, 6))]
    for mask in masks:
        for _ in range(3):
            for a, b in zip(CO.compact_positions(mask.to(dev)), CO.compact_positions_plain(mask)):
                assert torch.equal(a.cpu(), b), tuple(mask.shape)
    flat = torch.from_numpy(np.random.default_rng(7).random(1 + 3 * 8192) < 0.5)
    odd = flat.to(dev)[1:].view(3, 8192)  # data pointer 1 byte past an aligned block
    for a, b in zip(CO.compact_positions(odd), CO.compact_positions_plain(flat[1:].view(3, 8192))):
        assert torch.equal(a.cpu(), b)


def _k4_single_pass(dest, count, num_ranks, warps, rng):
    """A numpy model of ``csrc/bucket_scatter.cu``'s rank_hist_kernel with
    ``warps`` warps a tile: warp w of tile t owns lanes (t * warps + w) *
    1024 + 32 k + l (step k, lane l); a step's lanes of one bucket rank by
    the warp's running count plus their earlier lanes in the step (the
    ``__match_any_sync`` group), then the count moves by the group's size;
    warp bases by an exclusive scan over the warps; each (row, bucket) a
    tile sequence for :func:`_lookback`; the last tile's prefix plus its
    aggregate is the histogram."""
    rows, cap = dest.shape
    nb, tile = num_ranks + 1, warps * 1024
    n_tiles = -(-cap // tile)
    lane = np.arange(cap)
    valid = (lane < count[:, None]) & (dest >= 0) & (dest < num_ranks)
    d = np.full((rows, n_tiles * tile), -1, np.int64)  # -1 past the row's end
    d[:, :cap] = np.where(valid, dest, num_ranks)
    d = d.reshape(rows, n_tiles, warps, 32, 32)
    running = np.zeros((rows, n_tiles, warps, nb), np.int64)
    in_warp = np.zeros_like(d)
    earlier = np.tri(32, k=-1, dtype=bool)  # [l, j]: lane j before lane l
    for k in range(32):
        dk = d[..., k, :]
        group_before = ((dk[..., :, None] == dk[..., None, :]) & earlier).sum(-1)
        base = np.take_along_axis(running, np.maximum(dk, 0), axis=-1)
        in_warp[..., k, :] = np.where(dk >= 0, base + group_before, 0)
        running += (dk[..., None] == np.arange(nb)).sum(-2)
    warp_base = np.cumsum(running, axis=2) - running
    agg = running.sum(axis=2)  # (row, tile, bucket)
    prefix, spins = _lookback(agg.transpose(0, 2, 1).reshape(rows * nb, n_tiles), rng)
    prefix = prefix.reshape(rows, nb, n_tiles).transpose(0, 2, 1)
    at = np.maximum(d, 0)
    rank = (np.take_along_axis(prefix[:, :, None, None, :], at, -1)
            + np.take_along_axis(warp_base[:, :, :, None, :], at, -1) + in_warp)
    cut = lambda a: a.reshape(rows, -1)[:, :cap]
    return cut(d), cut(rank), prefix[:, -1] + agg[:, -1], spins


# (rows, lanes, warps a tile, R, seed): a ragged last tile, fewer lanes than
# one tile, R = 1, R + 1 below and above 32, look-back windows crossed
K4_MODEL_CASES = [(2, 3 * 8192 + 77, 8, 8, 0), (3, 700, 8, 8, 1), (2, 40 * 1024 + 5, 1, 40, 2),
                  (1, 35 * 2048, 2, 1, 3), (3, 5000, 3, 63, 4), (2, 34 * 1024 + 1000, 1, 8, 5)]


@pytest.mark.parametrize("rows,cap,warps,num_ranks,seed", K4_MODEL_CASES)
def test_k4_single_pass_lookback_model_equals_ref(rows, cap, warps, num_ranks, seed):
    """The kernel's scheme modelled in numpy, over destinations with
    DISCARD and out-of-range lanes, counts below, at and past C, and an
    all-DISCARD row: d_clean, rank and histogram bit-equal to
    ``ref.rank_and_histogram``, whatever order the tiles' steps run in."""
    rng = np.random.default_rng(seed)
    dest = rng.integers(-3, num_ranks + 3, (rows, cap)).astype(np.int32)
    count = rng.integers(0, cap + 5, rows).astype(np.int32)
    count[0] = cap
    if rows >= 2:
        dest[1] = DISCARD
    d_clean, rank, hist, spins = _k4_single_pass(dest, count, num_ranks, warps, rng)
    for b in range(rows):
        want = JBR.rank_and_histogram(jnp.asarray(dest[b]), jnp.int32(count[b]), num_ranks=num_ranks)
        for got, w in zip((d_clean[b], rank[b], hist[b]), want):
            np.testing.assert_array_equal(got, np.asarray(w))
    if -(-cap // (warps * 1024)) > 33:
        assert spins > 0  # some tile really found an unpublished predecessor


@pytest.mark.cuda
def test_cuda_k4_single_pass_equals_plain_on_kernel_branches():
    """On the card: K4 bit-equal to its plain version on all-DISCARD rows,
    count 0, count < C and count > C, out-of-range destinations, a ragged
    last tile, fewer lanes than a tile, more tiles than one wave (8 rows of
    128 tiles), R = 1, R + 1 > 32, R + 1 = 12,288 (3 warps a tile, dynamic
    shared memory above 48 KB), and across the epoch counter's wrap (the
    scratch cleared, then reused)."""
    from repro_torch import compat as port_compat

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    if port_compat.nvcc_path() is None:
        pytest.skip("needs nvcc to build the CUDA kernels")
    dev = torch.device("cuda")
    rng = np.random.default_rng(15)
    cases = [(4, 3 * 8192 + 77, 8), (3, 700, 8), (8, 1 << 20, 8), (2, 40 * 1024 + 5, 1),
             (3, 5000, 40), (2, 50000, 12287), (1, 1, 8)]

    def check(dest, count, num_ranks):
        args = (torch.from_numpy(dest), torch.from_numpy(count))
        got = BS.rank_and_histogram(*(a.to(dev) for a in args), num_ranks=num_ranks)
        for a, b in zip(got, BS.rank_and_histogram_plain(*args, num_ranks=num_ranks)):
            assert torch.equal(a.cpu(), b), (dest.shape, num_ranks)

    for rows, cap, num_ranks in cases:
        dest = rng.integers(-3, num_ranks + 3, (rows, cap)).astype(np.int32)
        count = rng.integers(0, cap + 5, rows).astype(np.int32)
        count[0] = cap
        if rows >= 3:
            dest[1], count[2] = DISCARD, 0
        check(dest, count, num_ranks)
    ent = KN._LOOKBACK[dev.index or 0]
    ent[1] = KN.LOOKBACK_EPOCHS - 1  # the next calls take the last epoch, then 1, then 2
    dest = rng.integers(-1, 9, (4, 9000)).astype(np.int32)
    for _ in range(3):
        check(dest, np.full(4, 9000, np.int32), 8)
    assert ent[1] == 2


def test_k6_compact_equals_reference():
    """The dense-pack helper: packed lanes and counts, with overflow past
    the capacity dropped."""
    @j_work_item
    @dataclasses.dataclass
    class JV:
        x: jax.Array

    @work_item
    @dataclasses.dataclass
    class TV:
        x: torch.Tensor

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 128, 2)).astype(np.float32)
    mask = rng.random((2, 128)) < 0.3
    out, count = CO.compact(TV(x=torch.from_numpy(x)), torch.from_numpy(mask), 24)
    for b in range(2):
        jout, jcount = JCO.compact(JV(x=jnp.asarray(x[b])), jnp.asarray(mask[b]), 24)
        assert int(count[b]) == int(jcount)
        n = int(jcount)
        np.testing.assert_array_equal(U32(out.x[b, :n].numpy()), U32(np.asarray(jout.x)[:n]))


def test_enqueue_takes_its_append_slots_from_k6(monkeypatch):
    """``enqueue`` plans through K6's wrapper (which launches the kernel on
    CUDA tensors); the queue is the same as without the spy."""
    calls = []
    real = CO.compact_positions

    def spy(mask):
        calls.append(tuple(mask.shape))
        return real(mask)

    monkeypatch.setattr(CO, "compact_positions", spy)

    @work_item
    @dataclasses.dataclass
    class V:
        x: torch.Tensor

    q = make_queue(V(x=torch.zeros(2)), 8, num_ranks=3, device="cpu")
    vals = torch.arange(3 * 6 * 2, dtype=torch.float32).reshape(3, 6, 2)
    dest = torch.tensor([[0, -1, 1, 2, 0, 1]] * 3, dtype=torch.int32)
    q = enqueue(q, V(x=vals), dest, torch.ones(3, 6, dtype=torch.bool))
    assert calls == [(3, 6)]
    assert q.count.tolist() == [5, 5, 5]
    np.testing.assert_array_equal(q.items.x[0, :5].numpy(), vals[0, [0, 2, 3, 4, 5]].numpy())


# -------------------------------------------------------------------- K7
@pytest.mark.parametrize("cap,nr,S,D", [(64, 4, 16, 3), (256, 8, 8, 11), (128, 16, 8, 1)])
def test_k7_plain_equals_ref_and_pallas(cap, nr, S, D):
    """Segment copy with offsets clipped to [0, C-S]: bit-equal."""
    rng = np.random.default_rng(nr * S)
    flat = rng.normal(size=(2, cap, D)).astype(np.float32)
    offs = []
    for _ in range(2):
        counts = rng.multinomial(cap // 2, np.ones(nr) / nr)
        offs.append(np.concatenate([[0], np.cumsum(counts)[:-1]]))
    off = np.asarray(offs, np.int32)
    off[1, -1] = cap  # past C-S: clipped
    got = MO.marshal(T32(flat), torch.from_numpy(off), num_ranks=nr, slot=S)
    assert got.shape == (2, nr, S, D)
    for b in range(2):
        want = JMR.marshal(jnp.asarray(flat[b]), jnp.asarray(off[b]), num_ranks=nr, slot=S)
        pallas = JMK.marshal(jnp.asarray(flat[b]), jnp.asarray(off[b]), num_ranks=nr, slot=S, interpret=True)
        np.testing.assert_array_equal(U32(got[b].numpy()), U32(np.asarray(want)))
        np.testing.assert_array_equal(U32(got[b].numpy()), U32(np.asarray(pallas)))


def test_k7_rejects_a_slot_past_the_capacity():
    with pytest.raises(ValueError, match="exceeds capacity"):
        MO.marshal(torch.zeros(1, 4, 2, dtype=torch.int32), torch.zeros(1, 2, dtype=torch.int32),
                   num_ranks=2, slot=5)


def test_fused_marshal_equals_sort_then_marshal():
    """K1's single-pass marshal (perm composed into the gather) equals the
    two-pass path, K3 + sort + K7, on every valid row."""
    nr, S, W = 4, 8, 5
    rng = np.random.default_rng(11)
    packed = T32(_words(rng, (2, 64, W)))
    dest = torch.from_numpy(rng.integers(-1, nr, (2, 64)).astype(np.int32))
    count = torch.tensor([64, 40], dtype=torch.int32)
    perm, _, hist = SO.sort_permutation(dest, count, nr)
    fused = TST.padded_send_buffer(packed, perm, hist[:, :nr], num_ranks=nr, peer_capacity=S)
    off = torch.cumsum(hist[:, :nr], 1, dtype=torch.int32) - hist[:, :nr]
    two_pass = MO.marshal(MO.gather_rows(packed, perm), off, num_ranks=nr, slot=S)
    valid = torch.arange(S) < torch.clamp(hist[:, :nr], max=S)[:, :, None]
    valid &= (off <= 64 - S)[:, :, None]  # a segment starting past C-S is clipped in K7
    assert int(valid.sum()) > 0
    np.testing.assert_array_equal(two_pass[valid].numpy(), fused[valid].numpy())


def test_marshal_items_and_unmarshal_items_equal_reference():
    """The per-leaf wrappers over an item pytree (float and int leaves)."""
    @j_work_item
    @dataclasses.dataclass
    class JIt:
        a: jax.Array
        b: jax.Array

    @work_item
    @dataclasses.dataclass
    class TIt:
        a: torch.Tensor
        b: torch.Tensor

    rng = np.random.default_rng(12)
    nr, S, cap = 4, 6, 32
    a = rng.normal(size=(1, cap, 3)).astype(np.float32)
    b = rng.integers(-99, 99, (1, cap)).astype(np.int32)
    off = np.array([[0, 5, 12, 20]], np.int32)
    got = MO.marshal_items(TIt(torch.from_numpy(a), torch.from_numpy(b)), torch.from_numpy(off),
                           num_ranks=nr, slot=S)
    want = JMO.marshal_items(JIt(jnp.asarray(a[0]), jnp.asarray(b[0])), jnp.asarray(off[0]),
                             num_ranks=nr, slot=S, interpret=True)
    np.testing.assert_array_equal(U32(got.a[0].numpy()), U32(np.asarray(want.a)))
    np.testing.assert_array_equal(got.b[0].numpy(), np.asarray(want.b))
    counts = np.array([[5, 0, 6, 3]], np.int32)
    roff = (np.cumsum(counts, 1) - counts).astype(np.int32)
    back = MO.unmarshal_items(got, torch.from_numpy(roff), torch.from_numpy(counts), capacity=12)
    jback = JMO.unmarshal_items(want, jnp.asarray(roff[0]), jnp.asarray(counts[0]), capacity=12,
                                interpret=True)
    np.testing.assert_array_equal(U32(back.a[0].numpy()), U32(np.asarray(jback.a)))
    np.testing.assert_array_equal(back.b[0].numpy(), np.asarray(jback.b))


# ----------------------------------------------------------- core/sorting
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_destination_rank_and_sorted_bounds_equal_reference(seed):
    """``destination_rank`` (incl. a 3-hot-destination case) and the
    neighbour-compare ``segment_bounds_from_sorted`` (incl. empty ranks):
    bit-equal per rank to ``repro.core.sorting``."""
    rng = np.random.default_rng(seed)
    hi = 3 if seed == 2 else R + 2
    dest = rng.integers(-2, hi, (R, CAP)).astype(np.int32)
    count = rng.integers(0, CAP + 1, R).astype(np.int32)
    td, tc = torch.from_numpy(dest), torch.from_numpy(count)
    got = TS.destination_rank(td, tc, R)
    _, d_sorted, _ = TS.sort_permutation(td, tc, R)
    begin, end = TS.segment_bounds_from_sorted(d_sorted, R)
    for b in range(R):
        want = JS.destination_rank(jnp.asarray(dest[b]), jnp.asarray(count[b]), R)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
        _, jds, _ = JS.sort_permutation(jnp.asarray(dest[b]), jnp.asarray(count[b]), R)
        jb, je = JS.segment_bounds_from_sorted(jds, R)
        np.testing.assert_array_equal(begin[b].numpy(), np.asarray(jb))
        np.testing.assert_array_equal(end[b].numpy(), np.asarray(je))


def test_compact_rows_equals_reference():
    rng = np.random.default_rng(13)
    src = _words(rng, (2, 40, 3))
    mask = rng.random((2, 40)) < 0.45
    out, slot, kept = BS.compact_rows(T32(src), torch.from_numpy(mask))
    for b in range(2):
        jout, jslot, jkept = JBO.compact_rows(jnp.asarray(src[b]), jnp.asarray(mask[b]), interpret=True)
        np.testing.assert_array_equal(U32(out[b].numpy()), np.asarray(jout))
        np.testing.assert_array_equal(slot[b].numpy(), np.asarray(jslot))
        assert int(kept[b]) == int(jkept)


def test_scatter_send_buffer_equals_reference_kernel_path():
    """The scatter branch of ``padded_send_buffer`` (rank >= S dropped):
    the whole ``(R, S, W)`` buffer, zeros included, bit-equal to the
    reference's kernel path (``use_pallas=True``, standalone)."""
    rng = np.random.default_rng(14)
    S, W = 5, 4
    dest = rng.integers(-1, R, (2, CAP)).astype(np.int32)
    count = np.array([CAP, 50], np.int32)
    packed = _words(rng, (2, CAP, W))
    d_clean, rank, hist = BS.rank_and_histogram(torch.from_numpy(dest), torch.from_numpy(count), num_ranks=R)
    got = TST.padded_send_buffer(T32(packed), None, hist[:, :R], num_ranks=R, peer_capacity=S,
                                 marshal="scatter", dest_clean=d_clean, dest_rank=rank)
    for b in range(2):
        want = JST.padded_send_buffer(
            jnp.asarray(packed[b]), None, jnp.asarray(hist[b, :R].numpy()), num_ranks=R,
            peer_capacity=S, use_pallas=True, marshal="scatter",
            dest_clean=jnp.asarray(d_clean[b].numpy()), dest_rank=jnp.asarray(rank[b].numpy()),
        )
        np.testing.assert_array_equal(U32(got[b].numpy()), np.asarray(want))


# ------------------------------------------------------- scatter rounds
@j_work_item
@dataclasses.dataclass
class JItem:
    val: jax.Array
    src: jax.Array


@work_item
@dataclasses.dataclass
class TItem:
    val: torch.Tensor
    src: torch.Tensor


def _jax_fn(mesh, cfg):
    """The reference's ``forward_work`` under ``shard_map`` (the helper of
    ``tests/test_core_scatter.py``)."""
    def fwd(val, dest, counts):
        me = jax.lax.axis_index("data")
        q = JQ.WorkQueue(items=JItem(val=val, src=me * jnp.ones(CAP, jnp.int32)), dest=dest,
                         count=counts[0], drops=jnp.zeros((), jnp.int32))
        from repro.core import forward_work as j_forward_work

        nq, total = j_forward_work(q, cfg)
        return nq.items.val, nq.items.src, nq.count[None], nq.drops[None], total

    return jax.jit(compat.shard_map(fwd, mesh=mesh, in_specs=(P("data"),) * 3,
                                    out_specs=(P("data"),) * 4 + (P(),)))


def _port_round(cfg, counts, dest, val, comm=None):
    me = torch.arange(R, dtype=torch.int32)[:, None].expand(R, CAP)
    q = WorkQueue(items=TItem(val=torch.from_numpy(val), src=me.contiguous()), dest=torch.from_numpy(dest),
                  count=torch.from_numpy(counts), drops=torch.zeros(R, dtype=torch.int32))
    nq, total = forward_work(q, cfg, comm=comm)
    return nq.items.val.numpy(), nq.items.src.numpy(), nq.count.numpy(), nq.drops.numpy(), int(total)


def _same(a, b, counts, dest):
    np.testing.assert_array_equal(a[2].reshape(-1), b[2].reshape(-1))
    np.testing.assert_array_equal(a[3].reshape(-1), b[3].reshape(-1))
    assert int(a[4]) == int(b[4])
    for r in range(R):
        n = int(a[2].reshape(-1)[r])
        np.testing.assert_array_equal(U32(a[0].reshape(R, CAP)[r, :n]), U32(b[0].reshape(R, CAP)[r, :n]))
        np.testing.assert_array_equal(a[1].reshape(R, CAP)[r, :n], b[1].reshape(R, CAP)[r, :n])
    lane = np.arange(CAP)[None, :]
    emitted = int(((lane < counts[:, None]) & (dest >= 0) & (dest < R)).sum())
    assert int(a[2].sum()) + int(a[3].sum()) == emitted, "conservation"


_ROUND_CASES = {
    "uniform_0": dict(seed=0), "uniform_1": dict(seed=1), "uniform_2": dict(seed=2),
    "hot_spot": dict(hot=True), "all_discard": dict(discard=True),
    "sender_overflow": dict(seed=5, three=True, S=3),
}


def _inputs(seed=0, hot=False, discard=False, three=False, S=0):
    rng = np.random.default_rng(seed)
    counts = np.full(R, CAP, np.int32) if (hot or discard or three) else rng.integers(0, CAP + 1, R).astype(np.int32)
    dest = rng.integers(-1, 3 if three else R, (R, CAP)).astype(np.int32)
    if hot:
        dest[:] = 0
    if discard:
        dest[:] = DISCARD
    val = rng.normal(size=(R, CAP)).astype(np.float32)
    return counts, dest, val, S


@pytest.fixture(scope="module")
def jax_rounds(mesh8):
    cache = {}

    def get(exchange, marshal, S):
        key = (exchange, marshal, S)
        if key not in cache:
            kw = {"peer_capacity": S} if S else {}
            cache[key] = _jax_fn(mesh8, JForwardConfig("data", R, CAP, exchange=exchange,
                                                        marshal=marshal, **kw))
        return cache[key]

    return get


@pytest.mark.parametrize("case", list(_ROUND_CASES))
def test_scatter_round_equals_reference(jax_rounds, case):
    """Port scatter round == reference scatter round (``use_pallas=False``)
    at the default peer slots (the sender clamp fires), and at ample slots
    the port's scatter round == the reference onehot oracle."""
    counts, dest, val, S = _inputs(**_ROUND_CASES[case])
    args = (jnp.asarray(val.reshape(-1)), jnp.asarray(dest.reshape(-1)), jnp.asarray(counts))
    want = [np.asarray(x) for x in jax_rounds("padded", "scatter", S)(*args)]
    got = _port_round(ForwardConfig(R, CAP, marshal="scatter", peer_capacity=S), counts, dest, val)
    _same(got, want, counts, dest)
    if case == "sender_overflow":
        assert got[3].sum() > 0  # the clamp really fired
    oracle = [np.asarray(x) for x in jax_rounds("onehot", "sort", 0)(*args)]
    ample = _port_round(ForwardConfig(R, CAP, marshal="scatter", peer_capacity=CAP), counts, dest, val)
    _same(ample, oracle, counts, dest)


@pytest.mark.parametrize("case", ["uniform_0", "hot_spot", "sender_overflow"])
def test_scatter_round_equals_port_sort_and_onehot(case):
    """Scatter == the port's own sort round (same slots, every lane < count
    and the send buffer's valid rows) and, at ample slots, == onehot."""
    counts, dest, val, S = _inputs(**_ROUND_CASES[case])
    scatter = _port_round(ForwardConfig(R, CAP, marshal="scatter", peer_capacity=S), counts, dest, val)
    sort = _port_round(ForwardConfig(R, CAP, peer_capacity=S), counts, dest, val)
    _same(scatter, sort, counts, dest)
    ample = _port_round(ForwardConfig(R, CAP, marshal="scatter", peer_capacity=CAP), counts, dest, val)
    onehot = _port_round(ForwardConfig(R, CAP, exchange="onehot"), counts, dest, val)
    _same(ample, onehot, counts, dest)


def test_onehot_scatter_mode_equals_its_sort_mode_and_reference(jax_rounds):
    """The oracle's scatter mode (placement by ``scatter_rows``) against its
    sort mode and the reference's onehot scatter round."""
    counts, dest, val, _ = _inputs(seed=9)
    args = (jnp.asarray(val.reshape(-1)), jnp.asarray(dest.reshape(-1)), jnp.asarray(counts))
    sc = _port_round(ForwardConfig(R, CAP, exchange="onehot", marshal="scatter"), counts, dest, val)
    _same(sc, _port_round(ForwardConfig(R, CAP, exchange="onehot"), counts, dest, val), counts, dest)
    _same(sc, [np.asarray(x) for x in jax_rounds("onehot", "scatter", 0)(*args)], counts, dest)


def test_scatter_round_plans_through_k4_and_issues_one_payload_collective(monkeypatch):
    """The scatter round calls K4's and K5's wrappers once each and never
    K3's or K1's, and moves one payload + one count ``all_to_all``;
    ``sort_method`` is not read."""
    import repro_torch.core.forwarding as FW
    import repro_torch.core.stages as STG

    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(FW.bs_ops, "rank_and_histogram", spy("K4", BS.rank_and_histogram))
    monkeypatch.setattr(STG.bs_ops, "scatter_rows", spy("K5", BS.scatter_rows))
    monkeypatch.setattr(FW.sk_ops, "sort_permutation", spy("K3", SO.sort_permutation))
    monkeypatch.setattr(STG.marshal_ops, "fused_marshal", spy("K1", MO.fused_marshal))
    counts, dest, val, _ = _inputs(seed=3)
    comm = StackedCollectives()
    for method in ("pack", "argsort"):
        _port_round(ForwardConfig(R, CAP, marshal="scatter", sort_method=method), counts, dest, val, comm=comm)
    assert calls == ["K4", "K5"] * 2
    assert sorted(c.shape for c in comm.calls.elements() if c.kind == "all_to_all") == \
        [(R, R, 1), (R, R, 1), (R, R, 16, 2), (R, R, 16, 2)]


# ------------------------------------------------------------ the drive
@j_work_item
@dataclasses.dataclass
class JHop:
    val: jax.Array
    hops: jax.Array
    uid: jax.Array


@work_item
@dataclasses.dataclass
class THop:
    val: torch.Tensor
    hops: torch.Tensor
    uid: torch.Tensor


HOP_C, HOP_N, HOP_S = 16, 12, 3


def test_context_scatter_drive_equals_reference(mesh8):
    """``RafiContext(marshal="scatter")`` through ``run_until_done`` ==
    the reference context's scatter drive: rounds, done, drops, retired-uid
    sums and the final queue's lanes < count."""
    rng = np.random.default_rng(19)
    inp = {"val": rng.normal(size=(R * HOP_N, 2)).astype(np.float32),
           "hops": rng.integers(1, 7, R * HOP_N).astype(np.int32),
           "uid": np.arange(R * HOP_N, dtype=np.int32) * 5,
           "dest": rng.integers(0, R, R * HOP_N).astype(np.int32)}
    jproto = JHop(val=jnp.zeros(2), hops=jnp.zeros((), jnp.int32), uid=jnp.zeros((), jnp.int32))
    jctx = JRafiContext(mesh8, jproto, capacity=HOP_C, peer_capacity=HOP_S, marshal="scatter")

    def jround(q_in, acc, rnd):
        me = jax.lax.axis_index("data")
        valid = jnp.arange(HOP_C) < q_in.count
        it = q_in.items
        hops = it.hops - 1
        keep = valid & (hops > 0)
        dest = jnp.where(keep, (me + 1 + it.uid) % R, DISCARD).astype(jnp.int32)
        acc = acc + jnp.sum(jnp.where(valid & ~keep, it.uid, 0))
        return JQ.enqueue(JQ.make_queue(jproto, HOP_C), JHop(it.val, hops, it.uid), dest, valid), acc

    def jdrive(val, hops, uid, dest):
        q0 = JQ.enqueue(JQ.make_queue(jproto, HOP_C), JHop(val, hops, uid), dest, jnp.ones(HOP_N, bool))
        q, acc, rounds, done = j_run_until_done(jround, q0, jnp.zeros((), jnp.int32), jctx.cfg, max_rounds=32)
        return q.count[None], q.drops[None], rounds[None], done[None], acc[None], q.items.val, q.items.uid

    f = jax.jit(compat.shard_map(jdrive, mesh=mesh8, in_specs=(P("data"),) * 4, out_specs=(P("data"),) * 7))
    jc, jd, jr, jdone, jacc, jval, juid = [np.asarray(o) for o in
                                          f(*(jnp.asarray(inp[k]) for k in ("val", "hops", "uid", "dest")))]

    tproto = THop(val=torch.zeros(2), hops=torch.zeros((), dtype=torch.int32), uid=torch.zeros((), dtype=torch.int32))
    ctx = RafiContext(R, tproto, capacity=HOP_C, peer_capacity=HOP_S, marshal="scatter", device="cpu")
    assert ctx.cfg.marshal == "scatter"
    me = torch.arange(R, dtype=torch.int32)[:, None]
    lane = torch.arange(HOP_C)

    def round_fn(q_in, acc, rnd):
        valid = lane[None, :] < q_in.count[:, None]
        it = q_in.items
        hops = it.hops - 1
        keep = valid & (hops > 0)
        dest = torch.where(keep, (me + 1 + it.uid) % R, DISCARD).to(torch.int32)
        acc = acc + torch.where(valid & ~keep, it.uid, 0).sum(dim=1, dtype=torch.int32)
        out = enqueue(ctx.make_queue(), THop(it.val, hops, it.uid), dest, valid)
        return out, acc

    st = lambda a: torch.from_numpy(a.reshape((R, HOP_N) + a.shape[1:]).copy())
    q0 = enqueue(ctx.make_queue(), THop(st(inp["val"]), st(inp["hops"]), st(inp["uid"])), st(inp["dest"]),
                 torch.ones(R, HOP_N, dtype=torch.bool))
    q, acc, rounds, done = ctx.run_until_done(round_fn, max_rounds=32)(q0, torch.zeros(R, dtype=torch.int32))
    assert rounds == int(jr[0]) and done == bool(jdone[0]) and done
    np.testing.assert_array_equal(q.count.numpy(), jc)
    np.testing.assert_array_equal(q.drops.numpy(), jd)
    assert q.drops.sum() > 0  # the peer-slot clamp fired along the way
    np.testing.assert_array_equal(acc.numpy(), jacc)
    for r in range(R):
        n = int(jc[r])
        sl = slice(r * HOP_C, r * HOP_C + n)
        np.testing.assert_array_equal(U32(q.items.val[r, :n].numpy()), U32(jval[sl]))
        np.testing.assert_array_equal(q.items.uid[r, :n].numpy(), juid[sl])


# ----------------------------------------------------- dispatch, no fallback
def test_new_wrappers_take_plain_path_only_for_cpu_tensors():
    """The four wrappers added after the first six, as those
    (``test_torch_kernels``): plain for CPU or all-meta tensors, a mix of
    devices raises, no launch counted."""
    from test_torch_kernels import plain_dispatch_cases

    plain_dispatch_cases([
        ("rank_and_histogram", lambda t: BS.rank_and_histogram(t(1, 4), t(1), num_ranks=2)),
        ("scatter_rows", lambda t: BS.scatter_rows(t(1, 4, 3), t(1, 4), num_slots=4)),
        ("compact_positions", lambda t: CO.compact_positions(t(1, 4, dt=torch.bool))),
        ("marshal", lambda t: MO.marshal(t(1, 4, 3), t(1, 2), num_ranks=2, slot=2)),
    ])
    assert set(KN.kernel_wrappers()) == {
        "gather_rows", "unmarshal", "pack_and_histogram", "rank_and_histogram",
        "scatter_rows", "compact_positions", "marshal", "rk4_step", "pairwise_accel", "track",
    }
    assert KN.launch_counts() == dict.fromkeys(KN.launch_counts(), 0)
