"""The port's kernel wrappers against the JAX reference.

On the CPU each wrapper runs its plain PyTorch version; that version is held
against the JAX ``ref.py`` AND the Pallas kernel called standalone with
``interpret=True``.  K1, K2 and K3 move or count data: bit for bit.  K8 is
float arithmetic: rtol 1e-6 with an atol of 1e-6 for components near zero
(the libm of torch and of XLA may differ by an ulp per sin/cos).  K9 sums
its sources in another order than XLA: rtol = atol = 2e-5, the bound of
``tests/test_kernels.py`` between the Pallas kernel and its ``ref.py``.  K10:
``t`` within rtol 1e-6 and every status equal, that file's bound too (an
ulp of ``exp``/``log1p`` could flip a near-tie, and none lies in these
inputs).  Tests marked ``cuda`` hold the CUDA kernels against the plain
versions on a card and skip here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.delta_tracking import kernel as JDK
from repro.kernels.delta_tracking import ref as JDR
from repro.kernels.marshal import kernel as JMK
from repro.kernels.marshal import ref as JMR
from repro.kernels.nbody_forces import kernel as JNK
from repro.kernels.nbody_forces import ref as JNR
from repro.kernels.rk4_advect import kernel as JRK
from repro.kernels.rk4_advect import ref as JRR
from repro.kernels.sort_keys import kernel as JSK
from repro.kernels.sort_keys import ops as JSO
from repro.kernels.sort_keys import ref as JSR
from repro_torch import kernels as KN
from repro_torch.core import sorting as TS
from repro_torch.kernels import build
from repro_torch.kernels.delta_tracking import ops as DO
from repro_torch.kernels.marshal import ops as MO
from repro_torch.kernels.nbody_forces import ops as NO
from repro_torch.kernels.rk4_advect import ops as RO
from repro_torch.kernels.sort_keys import ops as SO

U32 = lambda a: np.asarray(a).view(np.uint32)


def _dest_rows(rng, rows, cap, num_ranks):
    """Destinations with DISCARD and out-of-range lanes, counts below C."""
    dest = rng.integers(-2, num_ranks + 3, (rows, cap)).astype(np.int32)
    count = rng.integers(0, cap + 1, rows).astype(np.int32)
    count[0] = cap
    return dest, count


# ------------------------------------------------------------------- K3
@pytest.mark.parametrize("num_ranks,cap,idx_bits", [(8, 256, 8), (3, 64, 6), (8, 256, 28)],
                         ids=["r8", "r3", "key_edge_32bit"])
def test_k3_plain_equals_ref_and_pallas(num_ranks, cap, idx_bits):
    """Keys (low 32 bits) and histogram: bit-equal.  ``key_edge_32bit`` has
    bit_length(R+1) + idx_bits == 32, so invalid keys have the top bit set."""
    rng = np.random.default_rng(3)
    dest, count = _dest_rows(rng, 3, cap, num_ranks)
    keys, hist = SO.pack_and_histogram(
        torch.from_numpy(dest), torch.from_numpy(count), num_ranks=num_ranks, idx_bits=idx_bits
    )
    assert keys.dtype == torch.int64 and hist.shape == (3, num_ranks + 1)
    for b in range(3):
        jk, jh = JSR.pack_and_histogram(jnp.asarray(dest[b]), jnp.asarray(count[b]),
                                        num_ranks=num_ranks, idx_bits=idx_bits)
        pk, ph = JSK.pack_and_histogram(jnp.asarray(dest[b]), jnp.asarray(count[b]),
                                        num_ranks=num_ranks, idx_bits=idx_bits,
                                        tile=cap, interpret=True)
        low = (keys[b] & 0xFFFFFFFF).numpy().astype(np.uint32)
        np.testing.assert_array_equal(low, np.asarray(jk))
        np.testing.assert_array_equal(low, np.asarray(pk))
        np.testing.assert_array_equal(hist[b].numpy(), np.asarray(jh))
        np.testing.assert_array_equal(hist[b].numpy(), np.asarray(ph))
    if idx_bits == 28:
        assert (keys >= 2**31).any()  # the sign-bit keys really occur
        order = torch.sort(keys, dim=1).values
        assert bool((order[:, 1:] > order[:, :-1]).all())  # ordered as uint32


def test_k3_sort_permutation_equals_reference_ops():
    """perm, sorted dest and histogram: bit-equal to the reference's
    Pallas-path ``sort_permutation`` and to the port's own plain methods."""
    rng = np.random.default_rng(4)
    R, C = 8, 128
    dest, count = _dest_rows(rng, R, C, R)
    td, tc = torch.from_numpy(dest), torch.from_numpy(count)
    perm, d_sorted, hist = SO.sort_permutation(td, tc, R)
    for b in range(R):
        jp, jd, jh = JSO.sort_permutation(jnp.asarray(dest[b]), jnp.asarray(count[b]), R,
                                          interpret=True)
        np.testing.assert_array_equal(perm[b].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(d_sorted[b].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(hist[b].numpy(), np.asarray(jh))
    for method in ("pack", "argsort"):
        p2, d2, h2 = TS.sort_permutation(td, tc, R, method=method)
        np.testing.assert_array_equal(p2.numpy(), perm.numpy())
        np.testing.assert_array_equal(d2.numpy(), d_sorted.numpy())
        np.testing.assert_array_equal(h2.numpy(), hist.numpy())


def test_sorting_keys_and_segment_bounds_equal_reference():
    """pack/unpack keys, histogram and segment bounds of the port's
    ``core.sorting`` against ``repro.core.sorting``, per rank.  Bit-equal."""
    from repro.core import sorting as JS

    rng = np.random.default_rng(10)
    R, C = 8, 64
    dest, count = _dest_rows(rng, R, C, R)
    td, tc = torch.from_numpy(dest), torch.from_numpy(count)
    keys = TS.pack_keys(td, tc, R)
    d, lane = TS.unpack_keys(keys, C, R)
    hist = TS.destination_histogram(td, tc, R)
    begin, end = TS.segment_bounds_from_histogram(hist[:, :R])
    for b in range(R):
        jk = JS.pack_keys(jnp.asarray(dest[b]), jnp.asarray(count[b]), R)
        jd, jl = JS.unpack_keys(jk, C, R)
        jh = JS.destination_histogram(jnp.asarray(dest[b]), jnp.asarray(count[b]), R)
        jb, je = JS.segment_bounds_from_histogram(jh[:R])
        np.testing.assert_array_equal(keys[b].numpy().astype(np.uint32), np.asarray(jk))
        np.testing.assert_array_equal(d[b].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(lane[b].numpy(), np.asarray(jl))
        np.testing.assert_array_equal(hist[b].numpy(), np.asarray(jh))
        np.testing.assert_array_equal(begin[b].numpy(), np.asarray(jb))
        np.testing.assert_array_equal(end[b].numpy(), np.asarray(je))


# ------------------------------------------------------------------- K1
def test_k1_plain_equals_ref_and_pallas():
    """Out-of-range row indices clip to [0, C-1]; output bit-equal."""
    rng = np.random.default_rng(5)
    B, C, W, N = 2, 48, 11, 40
    src = rng.integers(0, 2**32, (B, C, W), dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(-5, C + 5, (B, N)).astype(np.int32)
    out = MO.gather_rows(torch.from_numpy(src.view(np.int32)), torch.from_numpy(idx))
    assert out.shape == (B, N, W) and out.dtype == torch.int32
    for b in range(B):
        want = np.asarray(JMR.gather_rows(jnp.asarray(src[b]), jnp.asarray(idx[b])))
        pallas = np.asarray(JMK.gather_rows(jnp.asarray(src[b]), jnp.asarray(idx[b]),
                                            interpret=True))
        np.testing.assert_array_equal(U32(out[b].numpy()), want)
        np.testing.assert_array_equal(U32(out[b].numpy()), pallas)


# ------------------------------------------------------------------- K2
@pytest.mark.parametrize("capacity", [64, 20], ids=["fits", "counts_past_capacity"])
def test_k2_plain_equals_ref_and_pallas(capacity):
    """Receive compaction with exclusive-prefix offsets; with capacity 20
    the blocks overflow and the tail is cut (§3.3).  Bit-equal."""
    rng = np.random.default_rng(6)
    B, G, S, W = 3, 4, 8, 5
    recv = rng.integers(0, 2**32, (B, G, S, W), dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(0, S + 1, (B, G)).astype(np.int32)
    counts[0] = S  # rank 0 receives full blocks: 32 rows > 20
    off = (np.cumsum(counts, axis=1) - counts).astype(np.int32)
    out = MO.unmarshal(torch.from_numpy(recv.view(np.int32)), torch.from_numpy(off),
                       torch.from_numpy(counts), capacity=capacity)
    assert out.shape == (B, capacity, W)
    for b in range(B):
        args = (jnp.asarray(recv[b]), jnp.asarray(off[b]), jnp.asarray(counts[b]))
        want = np.asarray(JMR.unmarshal(*args, capacity=capacity))
        pallas = np.asarray(JMK.unmarshal(*args, capacity=capacity, interpret=True))
        np.testing.assert_array_equal(U32(out[b].numpy()), want)
        np.testing.assert_array_equal(U32(out[b].numpy()), pallas)


def test_k2_plain_clips_offsets_like_ref():
    """Offsets below 0 or past capacity clip to [0, capacity] as ref does
    (non-overlapping blocks, so the scatter order cannot matter)."""
    recv = np.arange(2 * 3 * 4, dtype=np.uint32).reshape(1, 2, 3, 4) + 1
    off = np.array([[-3, 10]], np.int32)
    counts = np.array([[3, 3]], np.int32)
    out = MO.unmarshal(torch.from_numpy(recv.view(np.int32)), torch.from_numpy(off),
                       torch.from_numpy(counts), capacity=12)
    want = JMR.unmarshal(jnp.asarray(recv[0]), jnp.asarray(off[0]), jnp.asarray(counts[0]),
                         capacity=12)
    np.testing.assert_array_equal(U32(out[0].numpy()), np.asarray(want))


# The cases the output-driven K2 branches on: (G, S, W, capacity, offsets,
# counts) per rank, two ranks each.  cap·W % 4 == 0 takes the kernel's int4
# stores, anything else its scalar stores.
K2_CASES = {
    "spills_past_capacity": (3, 8, 11, 20, [[0, 8, 14], [0, 6, 12]], [[8, 6, 8], [6, 6, 8]]),
    "offsets_past_capacity_and_negative": (3, 6, 5, 16, [[-4, 20, 3], [16, -1, 40]], [[5, 6, 6], [6, 2, 3]]),
    "counts_past_slot_zero_negative": (4, 5, 15, 24, [[0, 5, 10, 15], [0, 3, 3, 9]], [[9, 0, -3, 5], [-1, 5, 7, 0]]),
    "one_block": (1, 9, 11, 12, [[2], [0]], [[9], [4]]),
    "capw_not_multiple_of_4": (2, 7, 5, 13, [[0, 7], [1, 5]], [[7, 7], [4, 6]]),
    "overlapping_last_block_wins": (4, 6, 11, 16, [[0, 2, 2, -3], [5, 1, 0, 4]], [[6, 6, 3, 2], [9, 6, -1, 6]]),
    "w15_exclusive_prefix": (4, 16, 15, 40, [[0, 10, 23, 39], [0, 0, 16, 16]], [[10, 13, 16, 4], [0, 16, 0, 16]]),
}


def _k2_case(name):
    g, s, w, cap, off, counts = K2_CASES[name]
    rng = np.random.default_rng(len(name))
    recv = rng.integers(0, 2**32, (2, g, s, w), dtype=np.uint64).astype(np.uint32)
    return recv, np.array(off, np.int32), np.array(counts, np.int32), cap


def _k2_reference(recv, off, counts, cap):
    """Per rank: ``ref.unmarshal`` and the Pallas kernel in interpret mode."""
    outs = []
    for b in range(recv.shape[0]):
        args = (jnp.asarray(recv[b]), jnp.asarray(off[b]), jnp.asarray(counts[b]))
        want = np.asarray(JMR.unmarshal(*args, capacity=cap))
        np.testing.assert_array_equal(np.asarray(JMK.unmarshal(*args, capacity=cap, interpret=True)), want)
        outs.append(want)
    return np.stack(outs)


def _k2_output_driven(recv, off, counts, cap):
    """A numpy model of ``csrc/marshal.cu``'s unmarshal_kernel: the word
    table [start_g, end_g) and base_g = g·S·W − start_g, then 4 output words
    at a time, each taken from the highest g whose range covers it (reading
    recv word base_g + e), or 0."""
    rows, g_blocks, slot, w = recv.shape
    out = np.empty((rows, cap * w), np.uint32)
    for b in range(rows):
        o = np.clip(off[b].astype(np.int64), 0, cap)
        n = np.clip(counts[b].astype(np.int64), 0, slot)
        start, end = o * w, np.minimum(o + n, cap) * w
        base = np.arange(g_blocks) * slot * w - start
        flat = recv[b].reshape(-1)
        for e0 in range(0, cap * w, 4):
            src, todo = [-1] * 4, 0xF
            for g in range(g_blocks - 1, -1, -1):
                if not todo:
                    break
                lo, hi = (int(np.clip(x - e0, 0, 4)) for x in (start[g], end[g]))
                if lo >= hi:
                    continue
                cover = ((1 << hi) - 1) & ~((1 << lo) - 1)
                for k in range(4):
                    if cover & todo & (1 << k):
                        src[k] = int(base[g]) + e0 + k
                todo &= ~cover
            for k in range(min(4, cap * w - e0)):
                out[b, e0 + k] = flat[src[k]] if src[k] >= 0 else 0
    return out.reshape(rows, cap, w)


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_plain_equals_ref_and_pallas_on_kernel_branches(case):
    """The plain version on every case the kernel branches on: bit-equal to
    ``ref.unmarshal`` and the Pallas kernel (overlapping blocks: the last
    one wins in all three)."""
    recv, off, counts, cap = _k2_case(case)
    out = MO.unmarshal(torch.from_numpy(recv.view(np.int32)), torch.from_numpy(off),
                       torch.from_numpy(counts), capacity=cap)
    np.testing.assert_array_equal(U32(out.numpy()), _k2_reference(recv, off, counts, cap))


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_output_driven_index_math_equals_ref(case):
    """The kernel's index math (word ranges, scan from the highest block,
    source base) modelled in numpy: bit-equal to the reference."""
    recv, off, counts, cap = _k2_case(case)
    np.testing.assert_array_equal(_k2_output_driven(recv, off, counts, cap),
                                  _k2_reference(recv, off, counts, cap))


_FRONTS = {"inside": [3, 17], "at_capacity": [40, 0], "past_capacity": [55, 9]}


@pytest.mark.parametrize("front", sorted(_FRONTS))
def test_k2_with_a_front_equals_reference(front):
    """The retain round's receive compaction (``compact_blocks`` with
    ``front=``): offsets shifted by a front inside ``(0, capacity)``, at
    ``capacity`` and past it.  Output, new counts and drops equal the
    reference's ``compact_blocks`` per rank; the output-driven kernel's
    numpy model gives the same words, with rows ``[0, front)`` zero."""
    from repro.core import stages as JST
    from repro_torch.core import stages as TST

    recv, _off, counts, cap = _k2_case("w15_exclusive_prefix")
    fr = np.array(_FRONTS[front], np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    out, new_count, drops = TST.compact_blocks(t(recv.view(np.int32)), t(counts), cap, front=t(fr))
    for b in range(recv.shape[0]):
        jo, jn, jd = JST.compact_blocks(jnp.asarray(recv[b]), jnp.asarray(counts[b]), cap,
                                        use_pallas=False, front=jnp.asarray(fr[b]))
        np.testing.assert_array_equal(U32(out[b].numpy()), np.asarray(jo))
        assert (int(new_count[b]), int(drops[b])) == (int(jn), int(jd))
        assert not U32(out[b, :min(fr[b], cap)].numpy()).any()
    shifted = np.cumsum(counts, 1).astype(np.int32) - counts + fr[:, None]
    np.testing.assert_array_equal(_k2_output_driven(recv, shifted, counts, cap), U32(out.numpy()))
    if front == "past_capacity":
        assert int(new_count[0]) == 0 and int(drops[0]) == int(counts[0].sum())


# ------------------------------------------------------------------- K8
@pytest.mark.parametrize("field_id", [RO.ABC, RO.TORNADO, RO.TAYLOR_GREEN],
                         ids=["abc", "tornado", "taylor_green"])
def test_k8_plain_matches_ref_and_pallas(field_id):
    """rtol 1e-6, atol 1e-6 (see the module docstring)."""
    rng = np.random.default_rng(7)
    pos = rng.uniform(0.0, 2 * np.pi, (96, 3)).astype(np.float32)
    params = (1.0, 0.8, 0.6)
    new_pos, vel = RO.rk4_step(torch.from_numpy(pos), dt=0.1, field_id=field_id, params=params)
    jn, jv = JRR.rk4_step(jnp.asarray(pos), dt=0.1, field_id=field_id, params=params)
    pn, pv = JRK.rk4_step(jnp.asarray(pos), dt=0.1, field_id=field_id, params=params,
                          tile=32, interpret=True)
    for got, want in ((new_pos, jn), (vel, jv), (new_pos, pn), (vel, pv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _k8_thread_map(n, base, threads, max_blocks):
    """A numpy model of ``csrc/rk4_advect.cu``'s particle-to-thread map: the
    grid's thread i (grid-stride) takes 4-particle group g = i, i + stride,
    ...: floats 12g .. 12g+11 of pos, particle 4g + k in slot k; a whole
    group whose base lies on 16 bytes (``base``: pos's start in floats past
    a 16-byte boundary) moves as three 16-byte accesses, the rest as 4-byte
    ones.  Returns, per float of pos, the (thread, slot, group) that reads
    it, and whether it moves in a 16-byte access."""
    groups = -(-n // 4)
    stride = min(-(-groups // threads), max_blocks) * threads
    f = np.arange(3 * n)
    g = f // 12
    whole = 12 * g + 12 <= 3 * n
    vec = whole & ((base + 12 * g) % 4 == 0)
    return g % stride, (f % 12) // 3, g, vec


@pytest.mark.parametrize("n", [1, 4, 5, 1023, 4 * 256 * 3 + 2])
@pytest.mark.parametrize("base", [0, 1, 2, 3])
@pytest.mark.parametrize("threads,max_blocks", [(256, 132 * 64), (32, 2)], ids=["grid", "grid_stride"])
def test_k8_thread_map_covers_every_particle_once(n, base, threads, max_blocks):
    """Every particle is read and written exactly once, all three of its
    floats by one thread in one slot; 16-byte accesses only at 16-byte
    addresses and only in whole groups; the tail group of a ragged N and a
    base off 16 bytes take 4-byte accesses."""
    thread, slot, group, vec = _k8_thread_map(n, base, threads, max_blocks)
    particle = 4 * group + slot
    np.testing.assert_array_equal(np.bincount(particle, minlength=n), np.full(n, 3))
    np.testing.assert_array_equal(particle, np.arange(3 * n) // 3)  # a particle's floats, in order
    per = lambda a: a.reshape(n, 3)
    assert (per(thread) == per(thread)[:, :1]).all() and (per(slot) == per(slot)[:, :1]).all()
    starts = (base + np.arange(3 * n))[vec]
    assert (starts.reshape(-1, 4)[:, 0] % 4 == 0).all()  # each 16-byte access starts aligned
    assert vec.sum() % 12 == 0 and vec.all() == (base == 0 and n % 4 == 0)


# ------------------------------------------------------------------- K9
@pytest.mark.parametrize("n,m,ti,tj", [(64, 64, 16, 16), (128, 256, 128, 128), (96, 32, 32, 32)])
def test_k9_plain_matches_ref_and_pallas(n, m, ti, tj):
    """The shapes of ``tests/test_kernels.py``; rtol = atol = 2e-5."""
    rng = np.random.default_rng(n + m)
    xi = rng.normal(size=(n, 3)).astype(np.float32)
    xj = rng.normal(size=(m, 3)).astype(np.float32)
    mj = rng.random(m).astype(np.float32)
    got = NO.pairwise_accel(*map(torch.from_numpy, (xi, xj, mj)))
    assert got.shape == (n, 3) and got.dtype == torch.float32
    want = JNR.pairwise_accel(jnp.asarray(xi), jnp.asarray(xj), jnp.asarray(mj))
    pallas = JNK.pairwise_accel(jnp.asarray(xi), jnp.asarray(xj), jnp.asarray(mj),
                                ti=ti, tj=tj, interpret=True)
    for ref in (want, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_k9_batched_and_chunked_equal_unbatched_bit_for_bit(monkeypatch):
    """A B = 3 call equals three unbatched calls, and a chunked evaluation
    equals an unchunked one, bit for bit: a target's sum over M does not
    depend on the other targets or rows of the call."""
    rng = np.random.default_rng(9)
    xi = torch.from_numpy(rng.normal(size=(3, 70, 3)).astype(np.float32))
    xj = torch.from_numpy(rng.normal(size=(3, 133, 3)).astype(np.float32))
    mj = torch.from_numpy(rng.random((3, 133)).astype(np.float32))
    batched = NO.pairwise_accel(xi, xj, mj, eps2=1e-3)
    assert batched.shape == (3, 70, 3)
    for b in range(3):
        one = NO.pairwise_accel(xi[b], xj[b], mj[b], eps2=1e-3)
        assert torch.equal(batched[b], one)
    for rows in (1, 7, 64):  # targets per chunk: temporaries of rows · (3, 133, 3) floats
        monkeypatch.setattr(NO, "_TEMP_BYTES", rows * 3 * 133 * 12)
        assert torch.equal(NO.pairwise_accel(xi, xj, mj, eps2=1e-3), batched)


def test_k9_zero_mass_sources_are_inert():
    """All-zero masses give zeros (``tests/test_kernels.py``), and zero-mass
    sources appended to a source list change no bit of the result."""
    xj = torch.from_numpy(np.random.default_rng(1).normal(size=(16, 3)).astype(np.float32))
    assert torch.equal(NO.pairwise_accel(torch.zeros(8, 3), xj, torch.zeros(16)), torch.zeros(8, 3))
    rng = np.random.default_rng(2)
    xi = torch.from_numpy(rng.normal(size=(2, 10, 3)).astype(np.float32))
    xj = torch.from_numpy(rng.normal(size=(2, 64, 3)).astype(np.float32))
    mj = torch.from_numpy(rng.random((2, 64)).astype(np.float32))
    mj[:, 32:] = 0.0
    np.testing.assert_allclose(NO.pairwise_accel(xi, xj, mj).numpy(),
                               NO.pairwise_accel(xi, xj[:, :32], mj[:, :32]).numpy(), rtol=2e-6, atol=1e-6)


def test_k9_wrapper_rejects_bad_shapes_and_types():
    f = lambda *s: torch.zeros(*s)
    with pytest.raises(ValueError, match="pairwise_accel takes"):
        NO.pairwise_accel(f(2, 4, 3), f(3, 5, 3), f(3, 5))
    with pytest.raises(ValueError, match="pairwise_accel takes"):
        NO.pairwise_accel(f(4, 3), f(5, 3), f(4))
    with pytest.raises(TypeError, match="float32"):
        NO.pairwise_accel(f(4, 3), f(5, 3).double(), f(5))
    with pytest.raises(ValueError, match="eps2"):
        NO.pairwise_accel(f(4, 3), f(5, 3), f(5), eps2=0.0)


# ------------------------------------------------------------------ K10
def _track_inputs(rng, n, steps, g):
    """The inputs of ``tests/test_kernels.py::test_delta_tracking_matches_ref``."""
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t0 = np.zeros(n, np.float32)
    texit = (rng.random(n) * 4 + 0.5).astype(np.float32)
    u = rng.random((n, steps, 2)).astype(np.float32)
    blobs = np.concatenate(
        [rng.normal(size=(g, 3)), rng.random((g, 1)) + 0.3, rng.random((g, 1)) * 2], axis=1
    ).astype(np.float32)
    return o, d, t0, texit, u, blobs


@pytest.mark.parametrize("n,steps,g", [(64, 4, 4), (256, 8, 8), (128, 1, 2)])
def test_k10_plain_matches_ref_and_pallas(n, steps, g):
    """``t`` within rtol 1e-6, statuses equal, against ``ref.track`` and the
    Pallas kernel in interpret mode."""
    args = _track_inputs(np.random.default_rng(n + steps), n, steps, g)
    t, status = DO.track(*map(torch.from_numpy, args), majorant=4.0, steps=steps)
    assert t.dtype == torch.float32 and status.dtype == torch.int32
    jargs = tuple(map(jnp.asarray, args))
    for jt, js in (JDR.track(*jargs, majorant=4.0, steps=steps),
                   JDK.track(*jargs, majorant=4.0, steps=steps, tile=32, interpret=True)):
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6)
        np.testing.assert_array_equal(status.numpy(), np.asarray(js))
    assert {DO.STILL, DO.HIT, DO.EXITED} <= set(status.tolist()) or steps == 1


def test_k10_all_rays_exit_in_an_empty_field():
    """Zero density and an exit just past the origin: every ray EXITED
    (``tests/test_kernels.py::test_delta_tracking_statuses_are_consistent``)."""
    n = 128
    u = torch.from_numpy(np.random.default_rng(0).random((n, 4, 2)).astype(np.float32))
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand(n, 3)
    blobs = torch.tensor([[0.0, 0.0, 0.0, 1.0, 0.0]])
    t, s = DO.track(torch.zeros(n, 3), d, torch.zeros(n), torch.full((n,), 0.01), u, blobs,
                    majorant=1.0, steps=4)
    assert bool((s == DO.EXITED).all())
    assert bool((t > 0.0).all())


def test_k10_wrapper_rejects_bad_shapes_and_steps():
    z = torch.zeros
    with pytest.raises(ValueError, match="track takes"):
        DO.track(z(4, 3), z(4, 3), z(4), z(5), z(4, 2, 2), z(1, 5), majorant=1.0, steps=2)
    with pytest.raises(ValueError, match="steps"):
        DO.track(z(4, 3), z(4, 3), z(4), z(4), z(4, 2, 2), z(1, 5), majorant=1.0, steps=3)
    with pytest.raises(TypeError, match="float32"):
        DO.track(z(4, 3), z(4, 3), z(4), z(4), z(4, 2, 2).double(), z(1, 5), majorant=1.0, steps=2)


def _vopat_track_inputs(width, height, steps, seed):
    """K10's inputs at the VoPaT scene: the camera rays of a ``width`` x
    ``height`` image that enter [0,1]³, from the domain entry to the domain
    exit, ``fields.default_blobs(6, 0)`` and its majorant, uniforms from
    numpy."""
    from repro_torch.apps import fields as F

    o, d = F.camera_rays(width, height)
    t_in, inside = F.ray_domain_entry(o, d)
    o, d, t0 = o[inside].contiguous(), d[inside].contiguous(), t_in[inside].contiguous()
    t_exit, _, _ = F.ray_box_exit(o, d, t0, torch.zeros_like(t0), torch.ones_like(t0))
    blobs = torch.from_numpy(F.default_blobs(6, 0))
    u = torch.from_numpy(np.random.default_rng(seed).random((o.shape[0], steps, 2)).astype(np.float32))
    return (o, d, t0, t_exit.contiguous(), u, blobs), F.majorant(blobs)


def _near_ties(o, d, t0, t_exit, u, blobs, maj, steps):
    """Rays whose plain walk meets |u₁·μ̄ − σ| < 1e-5·μ̄ at a step where the
    ray is still tracking and inside its exit (``chip_smoke.py``'s rule: an
    ulp of ``expf`` or ``log1pf`` may flip such a step)."""
    mu = torch.tensor(np.float32(maj), device=t0.device)
    t, status = t0, torch.zeros_like(t0, dtype=torch.int32)
    tie = torch.zeros_like(t0, dtype=torch.bool)
    for k in range(steps):
        active = status == DO.STILL
        t_new = t - torch.log1p(-u[:, k, 0]) / mu
        sigma = DO.density(o + t_new[:, None] * d, blobs)
        inside = active & (t_new < t_exit)
        tie |= inside & ((u[:, k, 1] * mu - sigma).abs() < 1e-5 * mu)
        t = torch.where(active, t_new, t)
        status = torch.where(active & ~inside, DO.EXITED,
                             torch.where(inside & (u[:, k, 1] * mu < sigma), DO.HIT, status)).to(torch.int32)
    return tie


def _assert_track_close(t, status, want_t, want_status, tie):
    """``t`` within rtol 1e-6 and statuses equal, except on near-ties."""
    t, status, want_t, want_status, tie = (np.asarray(x) for x in (t, status, want_t, want_status, tie))
    np.testing.assert_allclose(t[~tie], want_t[~tie], rtol=1e-6, atol=0.0)
    np.testing.assert_array_equal(status[~tie], want_status[~tie])


def test_k10_plain_matches_ref_and_pallas_at_the_vopat_scene():
    """At the VoPaT scene (camera rays of a 32x32 image, the default 6
    blobs and their majorant, K = 8): ``t`` within rtol 1e-6 and statuses
    equal, but for near-ties, against ``ref.track`` and the Pallas kernel in
    interpret mode; every status occurs."""
    args, maj = _vopat_track_inputs(32, 32, 8, seed=16)
    t, status = DO.track(*args, majorant=maj, steps=8)
    tie = _near_ties(*args, maj, 8)
    jargs = tuple(jnp.asarray(a.numpy()) for a in args)
    for jt, js in (JDR.track(*jargs, majorant=maj, steps=8),
                   JDK.track(*jargs, majorant=maj, steps=8, tile=32, interpret=True)):
        _assert_track_close(t, status, np.asarray(jt), np.asarray(js), tie)
    assert {DO.STILL, DO.HIT, DO.EXITED} <= set(status.tolist())
    assert int(tie.sum()) < 0.01 * t.numel()


@pytest.mark.parametrize("scene", ["vopat", "random_blobs"])
def test_k10_plain_invariant_under_a_permutation_of_the_rays(scene):
    """A ray's result does not depend on where it sits: the plain version on
    permuted rays gives the permuted results, bit for bit, and so on
    ``args[k:]`` (the property the kernel's lane refill must keep)."""
    if scene == "vopat":
        args, maj = _vopat_track_inputs(48, 40, 8, seed=3)
    else:
        args, maj = tuple(map(torch.from_numpy, _track_inputs(np.random.default_rng(5), 3001, 8, 6))), 4.0
    t, status = DO.track(*args, majorant=maj, steps=8)
    perm = torch.from_numpy(np.random.default_rng(11).permutation(t.numel()))
    tp, sp = DO.track(*(a[perm] for a in args[:5]), args[5], majorant=maj, steps=8)
    assert torch.equal(tp.view(torch.int32), t[perm].view(torch.int32)) and torch.equal(sp, status[perm])
    for k in (1, 3):
        tk, sk = DO.track(*(a[k:] for a in args[:5]), args[5], majorant=maj, steps=8)
        assert torch.equal(tk.view(torch.int32), t[k:].view(torch.int32)) and torch.equal(sk, status[k:])


# ------------------------------------------------------- dispatch, no fallback
def _same_shapes(a, b):
    a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
    return [(tuple(t.shape), t.dtype) for t in a] == [(tuple(t.shape), t.dtype) for t in b]


def plain_dispatch_cases(cases):
    """Each wrapper given all-meta inputs traces its plain version (meta
    outputs shaped as the CPU call's, no launch); given CPU and meta tensors
    together it raises; nothing falls back."""
    KN.reset_launch_counts()
    for name, call in cases:
        made = []

        def meta_input(*s, dt=torch.int32):
            made.append(s)
            return torch.empty(*s, dtype=dt, device="meta")

        meta = call(meta_input)
        cpu = call(lambda *s, dt=torch.int32: torch.zeros(*s, dtype=dt))
        outs = meta if isinstance(meta, tuple) else (meta,)
        assert all(t.device.type == "meta" for t in outs) and _same_shapes(meta, cpu), name
        if len(made) < 2:  # one input tensor: no mix to refuse
            continue
        first = [True]

        def mixed(*s, dt=torch.int32):  # the first input on the CPU, the rest on meta
            on_cpu, first[0] = first[0], False
            return torch.zeros(*s, dtype=dt) if on_cpu else torch.empty(*s, dtype=dt, device="meta")

        with pytest.raises(ValueError, match="CPU tensors run the plain"):
            call(mixed)
    assert KN.launch_counts() == dict.fromkeys(KN.launch_counts(), 0)


def test_wrappers_take_plain_path_only_for_cpu_tensors():
    """The plain version runs for CPU tensors and for meta tensors (a
    shape-only trace: a meta tensor has no data to launch a kernel on);
    a mix of devices raises; nothing falls back to the plain version, and
    no launch is counted."""
    f32 = torch.float32
    plain_dispatch_cases([
        ("gather_rows", lambda t: MO.gather_rows(t(1, 4, 3), t(1, 2))),
        ("unmarshal", lambda t: MO.unmarshal(t(1, 2, 2, 3), t(1, 2), t(1, 2), capacity=4)),
        ("pack_and_histogram", lambda t: SO.pack_and_histogram(t(1, 4), t(1), num_ranks=2, idx_bits=2)),
        ("rk4_step", lambda t: RO.rk4_step(t(4, 3, dt=f32), dt=0.1)),
        ("pairwise_accel", lambda t: NO.pairwise_accel(t(2, 4, 3, dt=f32), t(2, 5, 3, dt=f32), t(2, 5, dt=f32))),
        ("track", lambda t: DO.track(t(4, 3, dt=f32), t(4, 3, dt=f32), t(4, dt=f32), t(4, dt=f32),
                                     t(4, 2, 2, dt=f32), t(1, 5, dt=f32), majorant=1.0, steps=2)),
    ])


def test_kernel_build_raises_without_nvcc(monkeypatch):
    """Without a CUDA toolkit the library load raises; it never degrades."""
    from repro_torch import compat

    monkeypatch.setattr(compat, "nvcc_path", lambda: None)
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR / "__absent__")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load({})
    assert build._LIB is None


def test_kernel_library_name_hashes_sources_and_headers(monkeypatch, tmp_path):
    """The library's name changes with any source and with any header the
    sources include (``lookback.cuh``), so an edited header is never served
    by a stale library; the headers are hashed, not compiled."""
    assert (build.CSRC / "lookback.cuh").exists()
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build._sources()] == ["a.cu"]
    before = build._lib_path()
    (tmp_path / "h.cuh").write_text("// two\n")
    after = build._lib_path()
    (tmp_path / "a.cu").write_text('#include "h.cuh" // edited\n')
    assert len({before, after, build._lib_path()}) == 3


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from repro_torch import compat

    if compat.nvcc_path() is None:
        pytest.skip("needs nvcc to build the CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions(cuda_device):
    """On the card: K1-K7 bit-equal to their plain versions (K4 with
    DISCARD, out-of-range lanes and count < C; K5 with negative and
    past-the-end positions; K6 on a ragged tile edge; K7 with a clipped
    offset), K8 within 1e-5 absolute (nvcc contracts to FMA); K9 within
    rtol = atol = 2e-5 (another summation order; a ragged source tile and
    B = 3 in one launch); K10 with ``t`` within rtol 1e-6 and statuses equal
    (the same rounded operations and libm calls on both sides)."""
    from repro_torch.kernels.bucket_scatter import ops as BS
    from repro_torch.kernels.compact import ops as CO

    rng = np.random.default_rng(8)
    dev = cuda_device
    dest, count = _dest_rows(rng, 4, 3000, 8)
    args = (torch.from_numpy(dest), torch.from_numpy(count))
    for a, b in zip(BS.rank_and_histogram(*(t.to(dev) for t in args), num_ranks=8),
                    BS.rank_and_histogram_plain(*args, num_ranks=8)):
        assert torch.equal(a.cpu(), b)
    src = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (2, 100, 11), dtype=np.int32))
    pos = np.where(rng.random((2, 100)) < 0.5, -2, 90).astype(np.int32)
    for b in range(2):
        lanes = rng.permutation(100)[:60]
        pos[b, lanes] = rng.permutation(80)[:60]
    pos = torch.from_numpy(pos)
    assert torch.equal(BS.scatter_rows(src.to(dev), pos.to(dev), num_slots=80).cpu(),
                       BS.scatter_rows_plain(src, pos, num_slots=80))
    mask = torch.from_numpy(rng.random((3, 4096 * 2 + 77)) < 0.3)
    for a, b in zip(CO.compact_positions(mask.to(dev)), CO.compact_positions_plain(mask)):
        assert torch.equal(a.cpu(), b)
    off = torch.tensor([[0, 10, 40, 70], [5, 5, 64, 90]], dtype=torch.int32)
    assert torch.equal(MO.marshal(src.to(dev), off.to(dev), num_ranks=4, slot=16).cpu(),
                       MO.marshal_plain(src, off, num_ranks=4, slot=16))
    dest, count = _dest_rows(rng, 4, 512, 8)
    args = (torch.from_numpy(dest), torch.from_numpy(count))
    kk = SO.pack_and_histogram(*(a.to(dev) for a in args), num_ranks=8, idx_bits=9)
    kp = SO.pack_and_histogram_plain(*args, num_ranks=8, idx_bits=9)
    for a, b in zip(kk, kp):
        assert torch.equal(a.cpu(), b)
    src = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (2, 64, 11), dtype=np.int32))
    idx = torch.from_numpy(rng.integers(-3, 70, (2, 100)).astype(np.int32))
    assert torch.equal(MO.gather_rows(src.to(dev), idx.to(dev)).cpu(), MO.gather_rows_plain(src, idx))
    recv = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (2, 3, 16, 5), dtype=np.int32))
    counts = torch.from_numpy(rng.integers(0, 17, (2, 3)).astype(np.int32))
    off = torch.cumsum(counts, 1, dtype=torch.int32) - counts
    got = MO.unmarshal(recv.to(dev), off.to(dev), counts.to(dev), capacity=30).cpu()
    assert torch.equal(got, MO.unmarshal_plain(recv, off, counts, capacity=30))
    pos = torch.from_numpy(rng.uniform(0, 2 * np.pi, (1000, 3)).astype(np.float32))
    for fid in (RO.ABC, RO.TORNADO, RO.TAYLOR_GREEN):
        kn, kv = RO.rk4_step(pos.to(dev), dt=0.1, field_id=fid)
        pn, pv = RO.rk4_step_plain(pos.to(dev), dt=0.1, field_id=fid)
        assert float((kn - pn).abs().max()) <= 1e-5
        assert float((kv - pv).abs().max()) <= 1e-5
    xi = torch.from_numpy(rng.normal(size=(3, 300, 3)).astype(np.float32))
    xj = torch.from_numpy(rng.normal(size=(3, 777, 3)).astype(np.float32))
    mj = torch.from_numpy(rng.random((3, 777)).astype(np.float32))
    got = NO.pairwise_accel(xi.to(dev), xj.to(dev), mj.to(dev), eps2=1e-3).cpu()
    np.testing.assert_allclose(got.numpy(), NO.pairwise_accel_plain(xi, xj, mj, eps2=1e-3).numpy(),
                               rtol=2e-5, atol=2e-5)
    args = tuple(map(torch.from_numpy, _track_inputs(rng, 5000, 8, 6)))
    kt, ks = DO.track(*(a.to(dev) for a in args), majorant=4.0, steps=8)
    pt, ps = DO.track_plain(*(a.to(dev) for a in args), majorant=4.0, steps=8)
    np.testing.assert_allclose(kt.cpu().numpy(), pt.cpu().numpy(), rtol=1e-6)
    assert torch.equal(ks.cpu(), ps.cpu())


@pytest.mark.cuda
def test_cuda_k8_within_tolerance_and_lane_invariant(cuda_device):
    """On the card: K8 within 1e-5 of its plain version on all three fields
    at a ragged N, and bit-equal to itself on ``pos[k:]`` against ``pos``
    for k = 0..3 (each particle in another thread, slot, alignment and, at
    the end, the 4-byte tail path), also where some coordinates are large
    enough for sincosf's slow range reduction: the lane invariance the
    streamlines oracle needs."""
    dev = cuda_device
    rng = np.random.default_rng(9)
    pos = torch.from_numpy(rng.uniform(0, 2 * np.pi, (100003, 3)).astype(np.float32)).to(dev)
    far = pos.clone()
    far[::97] *= 1e5
    for fid in (RO.ABC, RO.TORNADO, RO.TAYLOR_GREEN):
        kn, kv = RO.rk4_step(pos, dt=0.1, field_id=fid)
        pn, pv = RO.rk4_step_plain(pos, dt=0.1, field_id=fid)
        assert float((kn - pn).abs().max()) <= 1e-5 and float((kv - pv).abs().max()) <= 1e-5
        for p in (pos, far):
            whole = RO.rk4_step(p, dt=0.1, field_id=fid)
            for k in range(4):
                part = RO.rk4_step(p[k:], dt=0.1, field_id=fid)
                assert all(torch.equal(a, b[k:]) for a, b in zip(part, whole)), (fid, k)


@pytest.mark.cuda
def test_cuda_k2_output_driven_equals_plain_on_kernel_branches(cuda_device):
    """On the card: K2 bit-equal to its plain version on every case of
    ``K2_CASES`` (int4 and scalar stores, aligned and unaligned source
    words, overlapping blocks) and at a Fig-8-like shape with many 4-word
    groups a thread; more than 1024 blocks a rank raise before a launch."""
    dev = cuda_device
    for case in sorted(K2_CASES):
        recv, off, counts, cap = _k2_case(case)
        args = (torch.from_numpy(recv.view(np.int32)), torch.from_numpy(off), torch.from_numpy(counts))
        got = MO.unmarshal(*(a.to(dev) for a in args), capacity=cap).cpu()
        assert torch.equal(got, MO.unmarshal_plain(*args, capacity=cap)), case
    rng = np.random.default_rng(11)
    for w, cap in ((11, 9000), (5, 9001), (15, 4099)):
        recv = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (3, 8, 2048, w), dtype=np.int32))
        counts = torch.from_numpy(rng.integers(-5, 2100, (3, 8)).astype(np.int32))
        off = torch.cumsum(counts.clamp(min=0), 1, dtype=torch.int32) - counts.clamp(min=0)
        got = MO.unmarshal(recv.to(dev), off.to(dev), counts.to(dev), capacity=cap).cpu()
        assert torch.equal(got, MO.unmarshal_plain(recv, off, counts, capacity=cap)), (w, cap)
    z = torch.zeros(1, 1025, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="1025 received blocks"):
        MO.unmarshal(torch.zeros(1, 1025, 1, 1, dtype=torch.int32, device=dev), z, z, capacity=4)


@pytest.mark.cuda
def test_cuda_k10_lane_invariant(cuda_device):
    """On the card: K10 bit-equal to itself on ``args[k:]`` against
    ``args`` for k = 0..3 and on a random permutation of the rays: each ray
    then sits in another lane and another span and is taken at another
    refill, so this holds the lane refill to per-ray arithmetic (as the K8
    test does for K8), at the VoPaT scene and on random blobs."""
    dev = cuda_device
    cases = [_vopat_track_inputs(320, 320, 8, seed=4),
             (tuple(map(torch.from_numpy, _track_inputs(np.random.default_rng(12), 50000, 8, 6))), 4.0)]
    for args, maj in cases:
        args = tuple(a.to(dev) for a in args)
        t, status = DO.track(*args, majorant=maj, steps=8)
        for k in range(4):
            tk, sk = DO.track(*(a[k:] for a in args[:5]), args[5], majorant=maj, steps=8)
            assert torch.equal(tk.view(torch.int32), t[k:].view(torch.int32)), k
            assert torch.equal(sk, status[k:]), k
        perm = torch.from_numpy(np.random.default_rng(13).permutation(t.numel())).to(dev)
        tp, sp = DO.track(*(a[perm] for a in args[:5]), args[5], majorant=maj, steps=8)
        assert torch.equal(tp.view(torch.int32), t[perm].view(torch.int32))
        assert torch.equal(sp, status[perm])


@pytest.mark.cuda
def test_cuda_k10_ragged_vopat_scene_matches_plain(cuda_device):
    """On the card, at a ragged N (100,003 VoPaT-scene rays: spans that do
    not divide it) and at steps < K: ``t`` within rtol 1e-6 and statuses
    equal to the plain version but on near-ties, which stay under 0.01% of
    the rays (``chip_smoke.py``'s check); steps = 0 returns t0, STILL; and
    uniforms off an 8-byte boundary give the same answer."""
    dev = cuda_device
    args, maj = _vopat_track_inputs(420, 420, 8, seed=6)
    args = tuple(a[:100003].contiguous() for a in args[:5]) + (args[5],)
    assert args[0].shape[0] == 100003
    args = tuple(a.to(dev) for a in args)
    for steps in (8, 5):
        kt, ks = DO.track(*args, majorant=maj, steps=steps)
        pt, ps = DO.track_plain(*args, majorant=maj, steps=steps)
        tie = _near_ties(*args, maj, steps)
        _assert_track_close(kt.cpu(), ks.cpu(), pt.cpu(), ps.cpu(), tie.cpu())
        assert int((ks != ps).sum()) < 1e-4 * ks.numel()
    kt, ks = DO.track(*args, majorant=maj, steps=0)
    assert torch.equal(kt, args[2]) and not bool(ks.any())
    # uniforms off an 8-byte boundary (the kernel reads a step's pair as one word)
    flat = torch.empty(args[4].numel() + 1, device=dev)
    odd = flat[1:].view(args[4].shape)
    odd.copy_(args[4])
    assert odd.data_ptr() % 8 == 4
    got = DO.track(*args[:4], odd, args[5], majorant=maj, steps=8)
    want = DO.track(*args, majorant=maj, steps=8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_k10_divisions_bit_equal_to_ieee_division(cuda_device):
    """On the card: the kernel's two divisions (Markstein's correction from
    the correctly rounded reciprocal, with ``__fdiv_rn`` outside its range)
    are bit-equal to IEEE float32 division on 2^24 random pairs over the
    ranges the rays meet and on the edges of the range check: ``a / b`` as
    ``log1p(−u₀) / μ̄`` and ``(−0.5·a) / (b·b)`` as a blob's
    ``(−0.5·r²) / s²``."""
    dev = cuda_device
    rng = np.random.default_rng(14)
    n = 2**24
    mag = (64.0 * np.exp2(-30.0 * rng.random(n)) * (1 - 0.5 * rng.random(n))).astype(np.float32)
    edges = np.array([0.0, -0.0, 1e-45, -1e-45, 2.0**-60, -(2.0**-60), 2.0**-59, 2.0**-61, 2.0**60,
                      -(2.0**61), 3e38, -3e38, np.inf, -np.inf, 1.0, -16.635532], np.float32)
    odd = np.array([15.357529, 0.05, 2.0**-61, 2.0**61], np.float32)
    for a, b in ((-mag, rng.uniform(1.0, 64.0, n)), (mag, rng.uniform(0.05, 0.15, n))):
        b = b.astype(np.float32)
        a = np.concatenate([a, np.repeat(edges, len(odd)), a[:4096] * np.float32(2.0**-100)])
        b = np.concatenate([b, np.tile(odd, len(edges)), b[:4096]])
        q, q_gauss = DO._quotients(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
        with np.errstate(all="ignore"):
            want, want_gauss = a / b, (np.float32(-0.5) * a) / (b * b)
        assert np.array_equal(q.cpu().numpy().view(np.uint32), want.view(np.uint32))
        assert np.array_equal(q_gauss.cpu().numpy().view(np.uint32), want_gauss.view(np.uint32))


@pytest.mark.cuda
def test_cuda_k2_with_a_front_equals_plain(cuda_device):
    """On the card: ``compact_blocks`` with a retain front inside ``(0,
    capacity)``, at it and past it — K2 bit-equal to the CPU round's plain
    version, counts and drops equal."""
    from repro_torch.core import stages as TST

    dev = cuda_device
    rng = np.random.default_rng(12)
    recv = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (4, 8, 2048, 11), dtype=np.int32))
    counts = torch.from_numpy(rng.integers(0, 2049, (4, 8)).astype(np.int32))
    cap = 9000
    front = torch.tensor([1, 4321, cap, cap + 77], dtype=torch.int32)
    got = TST.compact_blocks(recv.to(dev), counts.to(dev), cap, front=front.to(dev))
    want = TST.compact_blocks(recv, counts, cap, front=front)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_cuda_round_refuses_more_k2_blocks_before_any_launch(cuda_device):
    """A hierarchical layout whose last stage would hand K2 1,025 blocks a
    rank raises before the round launches anything."""
    from repro_torch.core import ForwardConfig, WorkQueue, forward_work

    dev = cuda_device
    R = 1025
    cfg = ForwardConfig(R, 2, exchange="hierarchical", level_sizes=(R, 1))
    q = WorkQueue(items=torch.zeros(R, 2, 3, device=dev), dest=torch.zeros(R, 2, dtype=torch.int32, device=dev),
                  count=torch.full((R,), 2, dtype=torch.int32, device=dev),
                  drops=torch.zeros(R, dtype=torch.int32, device=dev))
    KN.reset_launch_counts()
    with pytest.raises(ValueError, match="1025 received blocks"):
        forward_work(q, cfg)
    assert sum(KN.launch_counts().values()) == 0
