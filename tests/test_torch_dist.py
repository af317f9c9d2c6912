"""The port's ``torch.distributed`` backend (``DistributedCollectives``,
``launch.dist``) in gloo worlds on the CPU, against the stacked backend and
the JAX reference.

``R = 8`` ranks in worlds of 1, 2, 4 and 8 processes (L = 8, 4, 2, 1 ranks
a process; 8 is the reference's own layout, one rank a device).  Each world
is started once (a module fixture, ``spawn_world`` with a 120-s limit) and
runs every case of ``tests/_torch_dist_cases.py`` in every process, writing
each process's arrays to ``.npz``; the stacked backend runs the same cases
here.  Tolerance: none.  Every array a process holds for its ranks must
equal its rows of the stacked run, and every array it holds whole must
equal the stacked one, bit for bit, on queue lanes below ``count``.  The
cases are every route and option of the round, the drop and retain drives,
cycling, rebalance, a health mask, streamlines and N-body.  Each process's
call record must have the stacked record's kinds, tiers and counts at its
block's shape, with the bytes summed over the world equal to the stacked
bytes.  ``host_reads`` must be one per ragged payload call and zero
elsewhere.

Against the reference: the padded round in both marshals and the
hierarchical 2×4 round equal the JAX rounds on ``mesh8`` and the 2×4 node
mesh bit for bit in the worlds of 4 and 8, and one streamlines field
equals the JAX app within ``tests/test_torch_streamlines.py``'s 1e-4.  The
drives match the numpy twin and ``expected_by_rank`` in every world, and
each streamlines run equals its single-rank oracle exactly.

Failures: a process that raises ends its world with an error, a world that
hangs is killed at its limit, and ``init_world`` on CUDA raises here rather
than set up gloo.  The streamlines and quickstart examples under
``torchrun`` with 2 CPU processes print the single-process lines.
"""
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import _torch_dist_cases as DC
from repro.apps import streamlines as jsl
from repro.core import ForwardConfig as JForwardConfig
from repro.launch.mesh import make_node_mesh
from repro_torch import chaos as TC
from repro_torch.apps import streamlines as SL
from repro_torch.core import StackedCollectives
from repro_torch.core.collectives import DistributedCollectives
from repro_torch.launch import dist as LD
from test_torch_hierarchical import AXES, _jax, _inputs
from test_torch_types_queue import _imports

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLDS = (1, 2, 4, 8)
WORLD_TIMEOUT_S = 120
CASES = sorted(DC.CASES)
R = DC.R


def _jax_inputs():
    """The reference's inputs: a random round (``test_torch_hierarchical``'s
    generator) and seeds drawn as ``repro.apps.streamlines`` draws them."""
    key = jax.random.PRNGKey(0)
    seeds = np.asarray(jax.random.uniform(key, (DC.STREAMLINES["num_particles"], 3), minval=0.5,
                                          maxval=jsl.TWO_PI - 0.5))
    return {"jax_round": _inputs(11, "random", -1), "streamline_seeds": seeds}


@pytest.fixture(scope="module")
def inputs():
    return _jax_inputs()


@pytest.fixture(scope="module")
def stacked(inputs):
    return {name: DC.run_case(StackedCollectives(), name, inputs) for name in CASES}


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """Each world's per-process results, ``{world: {case: [npz of p]}}``;
    the worlds run one after the other, each once."""
    out = {}
    for w in WORLDS:
        d = tmp_path_factory.mktemp(f"world{w}")
        LD.spawn_world(DC.run_cases, w, args=(str(d), CASES, inputs), timeout_s=WORLD_TIMEOUT_S)
        out[w] = {name: [dict(np.load(d / f"{name}.p{p}.npz")) for p in range(w)] for name in CASES}
    return out


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.dtype.kind in "fiub" and a.size else a


def _same(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype, f"{what}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}"
    assert np.array_equal(_bits(a), _bits(b)), what


def _whole(res, key):
    """A ``rank.*`` array of a world, the processes' blocks in order."""
    return np.concatenate([r[key] for r in res])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_world_equals_stacked(worlds, stacked, world, case):
    want = stacked[case]
    for p, got in enumerate(worlds[world][case]):
        keys = {k for k in want if k.startswith(("rank.", "world."))}
        assert keys == {k for k in got if k.startswith(("rank.", "world."))}
        for k in sorted(keys):
            if k.startswith("rank."):
                L = want[k].shape[0] // world
                _same(got[k], want[k][p * L:(p + 1) * L], f"process {p} {k}")
            else:
                _same(got[k], want[k], f"process {p} {k}")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_world_records_the_stacked_calls(worlds, stacked, world, case):
    """Kinds, tiers and counts as the stacked record's, each process at its
    block's shape; bytes summed over the world equal the stacked bytes; one
    host read per ragged payload call."""
    want = json.loads(str(stacked[case]["calls"]))
    assert int(stacked[case]["host_reads"]) == 0
    L = R // world

    def bytes_by_call(calls, into):
        for k, t, s, b, n in calls:
            into[(k, t, tuple(s[1:]), n)] = into.get((k, t, tuple(s[1:]), n), 0) + b
        return into

    summed = {}
    for p, got in enumerate(worlds[world][case]):
        calls = json.loads(str(got["calls"]))
        shapes = sorted([k, t, [L] + s[1:], n] for k, t, s, _b, n in want)
        assert sorted([k, t, s, n] for k, t, s, _b, n in calls) == shapes, f"process {p}"
        bytes_by_call(calls, summed)
        ragged = sum(n for k, *_rest, n in calls if k == "ragged_all_to_all")
        assert int(got["host_reads"]) == ragged, f"process {p}: host reads"
    assert summed == bytes_by_call(want, {})


@pytest.mark.parametrize("world", WORLDS)
def test_host_reads_one_per_ragged_round(worlds, world):
    reads = lambda case: {int(r["host_reads"]) for r in worlds[world][case]}
    for case in ("round_padded_sort", "round_padded_scatter", "round_onehot_sort", "round_hier_2x4_sort",
                 "round_hier_2x2x2_scatter", "round_credit_padded", "drive_retain", "cycle_sort_drop"):
        assert reads(case) == {0}, case
    for case in ("round_ragged_sort", "round_ragged_scatter", "round_credit_ragged", "round_telemetry_ragged"):
        assert reads(case) == {1}, case
    assert reads("round_shards2_ragged") == {2}


@pytest.mark.parametrize("overflow", ["drop", "retain"])
@pytest.mark.parametrize("world", WORLDS)
def test_drive_delivers_the_schedule(worlds, world, overflow):
    """``run_until_done`` over the world: every row of
    ``rotating_hotspot`` delivered once (``expected_by_rank``), nothing
    dropped; the retain drive forward for forward as the numpy twin."""
    sc = DC.drive_scenario()
    res = worlds[world][f"drive_{overflow}"]
    delivered = _whole(res, "rank.drive.delivered")
    np.testing.assert_array_equal(delivered, TC.expected_by_rank(sc))
    assert _whole(res, "rank.drive.drops").sum() == 0 and bool(res[0]["world.drive.done"])
    if overflow == "retain":
        sim = TC.simulate_flat_retain(sc, peer_capacity=DC.DRIVE["slots"]["retain"], capacity=DC.DRIVE["capacity"])
        assert sim["done"] and sim["drops"] == 0 and int(res[0]["world.drive.rounds"]) == sim["rounds"]
        np.testing.assert_array_equal(res[0]["world.drive.retained_trace"], sim["retained_trace"])
        np.testing.assert_array_equal(res[0]["world.drive.age_trace"], sim["age_trace"])
        assert max(sim["retained_trace"]) > 0  # the clamp really held rows back


@pytest.mark.parametrize("field", sorted(DC.FIELDS))
@pytest.mark.parametrize("world", WORLDS)
def test_streamlines_equal_their_oracle(worlds, world, field):
    cfg = SL.StreamlineConfig(field_id=DC.FIELDS[field], **DC.STREAMLINES)
    orc = SL.oracle(cfg, device="cpu")
    for res in worlds[world][f"streamlines_{field}"]:
        _same(res["world.traces"], orc, "traces against the single-rank oracle")
        assert int(res["world.drops"]) == 0


@pytest.mark.parametrize("case", sorted(DC.JAX_ROUNDS))
@pytest.mark.parametrize("world", [4, 8])
def test_round_equals_reference(worlds, inputs, mesh8, world, case):
    """The round in a gloo world against the JAX round (``use_pallas=False``)
    on the same inputs: counts, drops, total and every lane below count."""
    val, dest, counts = inputs["jax_round"]
    kw = dict(DC.JAX_ROUNDS[case])
    if kw.get("exchange") == "hierarchical":
        mesh, axes = make_node_mesh(2, 4), AXES
        jcfg = JForwardConfig(axes, R, DC.CAP, **kw)
    else:
        mesh, axes = mesh8, "data"
        jcfg = JForwardConfig("data", R, DC.CAP, **kw)
    want = _jax(mesh, jcfg, axes, val, dest, counts)
    res = worlds[world][case]
    got = (_whole(res, "rank.val"), _whole(res, "rank.src"), _whole(res, "rank.count"), _whole(res, "rank.drops"),
           int(res[0]["world.total"]))
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert got[4] == want[4] and int(got[3].sum()) > 0  # a clamp fired
    for r in range(R):
        n = int(got[2][r])
        np.testing.assert_array_equal(got[0][r, :n].view(np.uint32), want[0][r, :n].view(np.uint32))
        np.testing.assert_array_equal(got[1][r, :n], want[1][r, :n])


@pytest.mark.parametrize("world", [4, 8])
def test_streamlines_equal_reference(worlds, inputs, mesh8, world):
    """One field in a gloo world against the JAX app from the same seeds:
    the same finite mask, lengths and stats, positions within 1e-4."""
    jcfg = jsl.StreamlineConfig(field_id=DC.FIELDS["abc"], **DC.STREAMLINES)
    want, want_len, want_stats = jsl.run(mesh8, jcfg, use_pallas_rk4=False)
    res = worlds[world]["streamlines_reference_seeds"][0]
    got = res["world.traces"]
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    m = np.isfinite(got)
    assert np.abs(got[m] - want[m]).max() <= 1e-4
    np.testing.assert_array_equal(res["world.lengths"], want_len)
    assert (int(res["world.rounds"]), int(res["world.drops"])) == (want_stats["rounds"], want_stats["drops"])


def test_a_failing_process_ends_its_world():
    """Process 0's ``enqueue`` check raises while process 1 waits in the
    round's collective: the world ends with process 0's error, not a hang."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="dest >= num_ranks"):
        LD.spawn_world(DC.bad_destination, 2, timeout_s=60)
    assert time.monotonic() - t0 < 60


def test_a_hung_world_is_killed_at_its_limit():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="a world of 2"):
        LD.spawn_world(DC.hang, 2, timeout_s=5)
    assert time.monotonic() - t0 < 30


def test_init_world_on_cuda_raises_without_a_card(tmp_path):
    """No card here: NCCL cannot be set up, and ``init_world`` raises
    instead of setting up gloo or falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import torch.distributed as dist

    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LD.init_world(device, world=1, rank=0, store=f"file://{tmp_path}/store")
        assert not dist.is_initialized()


@pytest.mark.parametrize("path", ["tests/_torch_dist_cases.py", "src/repro_torch/launch/dist.py",
                                  "src/repro_torch/core/collectives.py", "tests/_torch_dist_paths_cases.py",
                                  "src/repro_torch/launch/mesh.py", "src/repro_torch/launch/steps.py"])
def test_world_code_imports_neither_jax_nor_the_reference(path):
    """What the world's processes import: the port, torch and numpy."""
    for mod in _imports(ROOT / path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod


def test_backend_refusals():
    comm = DistributedCollectives(world=2, index=1)
    assert (comm.local_ranks(8), comm.rank_offset(8)) == (4, 4)
    assert comm.ranks(8).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="do not split"):
        comm.local_ranks(7)
    stacked = StackedCollectives()
    assert (stacked.local_ranks(8), stacked.rank_offset(8), stacked.host_reads) == (8, 0, 0)
    assert stacked.ranks(8).tolist() == list(range(8))


EXAMPLE_ARGS = {"train_lm_torch.py": ["--steps", "3", "--batch", "2", "--seq", "32", "--ckpt-every", "0"]}


def _example(name, *, world=None, ckpt_dir=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    cmd = [sys.executable, str(ROOT / "examples" / name), "--cpu"] + EXAMPLE_ARGS.get(name, [])
    if ckpt_dir is not None:
        cmd += ["--ckpt-dir", str(ckpt_dir)]
    if world:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={world}"] + cmd[1:]
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("name", ["streamlines_demo_torch.py", "quickstart_torch.py", "vopat_render_torch.py",
                                  "serve_lm_torch.py", "train_lm_torch.py"])
def test_example_under_torchrun_prints_the_single_process_lines(name, tmp_path):
    """Process 0 of a world of two prints the single process's lines; a
    wall time (``1.6s``) is the one thing that may differ."""
    ckpt = (lambda k: tmp_path / k) if name == "train_lm_torch.py" else (lambda k: None)
    one, two = _example(name, ckpt_dir=ckpt("one")), _example(name, world=2, ckpt_dir=ckpt("two"))
    (out1, err1), (out2, err2) = one.communicate(timeout=180), two.communicate(timeout=180)
    assert one.returncode == 0, err1[-2000:]
    assert two.returncode == 0, err2[-2000:]
    lines = lambda out: [re.sub(r"\b\d+\.\d+s\b", "<wall>", ln) for ln in out.splitlines()
                         if not ln.startswith(("perfetto timeline", "traced "))]
    assert lines(out2) == lines(out1)
    if name == "streamlines_demo_torch.py":
        assert sum(ln.endswith("-> OK") for ln in lines(out2)) == 3
    elif name == "quickstart_torch.py":
        assert out2.rstrip().endswith("OK")
    elif name == "vopat_render_torch.py":
        assert "bitwise identical across rank counts: True" in out2
    elif name == "serve_lm_torch.py":
        assert out2.count("served 10 requests through 4 slots") == 2
    else:
        assert "steps 0-2: loss" in out2
