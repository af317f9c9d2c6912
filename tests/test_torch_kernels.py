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


# ------------------------------------------------------- dispatch, no fallback
def test_wrappers_take_plain_path_only_for_cpu_tensors():
    """A tensor on neither the CPU nor a CUDA device raises; nothing falls
    back to the plain version, and no launch is counted."""
    KN.reset_launch_counts()
    meta = lambda *s: torch.empty(*s, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU tensors run the plain"):
        MO.gather_rows(meta(1, 4, 3), meta(1, 2))
    with pytest.raises(ValueError, match="CPU tensors run the plain"):
        MO.unmarshal(meta(1, 2, 2, 3), meta(1, 2), meta(1, 2), capacity=4)
    with pytest.raises(ValueError, match="CPU tensors run the plain"):
        SO.pack_and_histogram(meta(1, 4), meta(1), num_ranks=2, idx_bits=2)
    with pytest.raises(ValueError, match="CPU tensors run the plain"):
        RO.rk4_step(torch.empty(4, 3, device="meta"), dt=0.1)
    with pytest.raises(ValueError, match="CPU tensors run the plain"):
        MO.gather_rows(torch.zeros(1, 4, 3, dtype=torch.int32), meta(1, 2))  # mixed
    fmeta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="CPU tensors run the plain"):
        NO.pairwise_accel(fmeta(2, 4, 3), fmeta(2, 5, 3), fmeta(2, 5))
    with pytest.raises(ValueError, match="CPU tensors run the plain"):
        DO.track(fmeta(4, 3), fmeta(4, 3), fmeta(4), fmeta(4), fmeta(4, 2, 2), fmeta(1, 5), majorant=1.0, steps=2)
    assert KN.launch_counts() == dict.fromkeys(KN.launch_counts(), 0)


def test_kernel_build_raises_without_nvcc(monkeypatch):
    """Without a CUDA toolkit the library load raises; it never degrades."""
    from repro_torch import compat

    monkeypatch.setattr(compat, "nvcc_path", lambda: None)
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR / "__absent__")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load({})
    assert build._LIB is None


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
