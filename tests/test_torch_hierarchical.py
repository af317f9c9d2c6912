"""The port's N-level hierarchical route against the JAX reference.

* The cases of ``tests/test_core_hierarchical.py`` (2×4, 4×2, 2×2×2, hot
  spot, discard-only, tight slots, degenerate tiers, a joint tier): the
  port's round against the JAX round on the same mesh (its XLA path,
  ``use_pallas=False``; the Pallas path fails inside ``shard_map`` on this
  JAX, ROADMAP R2), and against the port's onehot oracle where no stage
  clamp can fire — counts, drops, totals and every lane ``< count``, bit
  for bit.
* The ``test_config_*`` validation cases, with the tier count taken from
  ``level_sizes`` (the port has no mesh axis names).
* The hierarchical rounds of ``tests/test_pipeline.py::
  test_hierarchical_bitexact`` at S=1, drop and retain (mid-route parking
  included), against JAX; the collective budget on the call recorder.
* The lossless drives of ``tests/test_chaos.py::test_hierarchical_retain_*``
  against ``expected_by_rank`` (a JAX retain drive does not run on this
  JAX, ROADMAP R4).

Tolerance: none — everything here moves or counts data.
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
from repro.core import WorkQueue as JWorkQueue
from repro.core import forward_work as j_forward_work
from repro.core import work_item as j_work_item
from repro.launch.mesh import make_node_mesh, make_pod_mesh
from repro_torch import chaos as TC
from repro_torch.core import (
    DISCARD,
    ForwardConfig,
    RafiContext,
    StackedCollectives,
    WorkQueue,
    enqueue,
    forward_work,
    work_item,
)
from repro_torch.core import collectives as TCOLL
from repro_torch.core import sorting as TS

from test_torch_retain import (
    CAP as RCAP,
    jax_round,
    pattern_dest,
    port_round,
    assert_same_round,
    scenario_drive,
)

R, CAP = 8, 64
AXES, AXES3 = ("node", "device"), ("pod", "node", "device")


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


_JAX_FNS = {}


def _jax(mesh, cfg, axes, val, dest, counts):
    """``test_core_hierarchical._make_fn``'s round: (val, src, count,
    drops, total) as numpy."""
    key = (cfg, tuple(mesh.shape.items()))
    if key not in _JAX_FNS:
        def fwd(items_val, d, c):
            me = jax.lax.axis_index(axes)
            q = JWorkQueue(items=JItem(val=items_val, src=me * jnp.ones(CAP, jnp.int32)),
                           dest=d, count=c[0], drops=jnp.zeros((), jnp.int32))
            nq, total = j_forward_work(q, cfg)
            return nq.items.val, nq.items.src, nq.count[None], nq.drops[None], total

        _JAX_FNS[key] = jax.jit(compat.shard_map(
            fwd, mesh=mesh, in_specs=(P(axes),) * 3, out_specs=(P(axes),) * 4 + (P(),)))
    out = _JAX_FNS[key](jnp.asarray(val).reshape(-1), jnp.asarray(dest).reshape(-1), jnp.asarray(counts))
    v, s, c, d, t = (np.asarray(x) for x in out)
    return v.reshape(R, CAP), s.reshape(R, CAP), c, d, int(t)


def _port(cfg, val, dest, counts, comm=None):
    q = WorkQueue(
        items=TItem(val=torch.from_numpy(val), src=torch.arange(R, dtype=torch.int32)[:, None].expand(R, CAP).contiguous()),
        dest=torch.from_numpy(dest), count=torch.from_numpy(counts), drops=torch.zeros(R, dtype=torch.int32),
    )
    nq, total = forward_work(q, cfg, comm=comm)
    return nq.items.val.numpy(), nq.items.src.numpy(), nq.count.numpy(), nq.drops.numpy(), int(total)


def _same(a, b):
    np.testing.assert_array_equal(a[2], b[2], err_msg="per-rank counts")
    np.testing.assert_array_equal(a[3], b[3], err_msg="per-rank drops")
    assert a[4] == b[4], "termination total"
    for r in range(R):
        n = int(a[2][r])
        np.testing.assert_array_equal(a[0][r, :n].view(np.uint32), b[0][r, :n].view(np.uint32))
        np.testing.assert_array_equal(a[1][r, :n], b[1][r, :n])


def _ample(sizes):
    """Per-tier capacities so large no stage clamp can fire (stage l's
    buffer holds at most CAP · prod(faster sizes) rows)."""
    caps, mult = [], 1
    for a in reversed(sizes):
        caps.append(CAP * mult)
        mult *= a
    return tuple(reversed(caps))


def _inputs(seed, kind="random", lo=0):
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(R, CAP)).astype(np.float32)
    if kind == "hotspot":
        return val, np.zeros((R, CAP), np.int32), np.full(R, CAP, np.int32)
    if kind == "discard":
        return np.zeros((R, CAP), np.float32), np.full((R, CAP), DISCARD, np.int32), np.full(R, CAP, np.int32)
    counts = rng.integers(0, CAP + 1, R).astype(np.int32)
    dest = rng.integers(lo, R, (R, CAP)).astype(np.int32)
    if kind == "skew":
        dest[::2] = 0  # half the ranks route everything to rank 0
    return val, dest, counts


# (id, mesh factory, JAX axis_name, level_sizes, caps: "ample" | "default" | tuple, inputs)
CASES = [
    ("2x4-random", lambda: make_node_mesh(2, 4), AXES, (2, 4), "ample", (11, "random", -1)),
    ("2x4-random-b", lambda: make_node_mesh(2, 4), AXES, (2, 4), "ample", (12, "random", -1)),
    ("4x2-random", lambda: make_node_mesh(4, 2), AXES, (4, 2), "ample", (13, "random", 0)),
    ("2x4-hotspot", lambda: make_node_mesh(2, 4), AXES, (2, 4), "ample", (1, "hotspot", 0)),
    ("2x4-discard-only", lambda: make_node_mesh(2, 4), AXES, (2, 4), "ample", (0, "discard", 0)),
    ("2x4-tight-slots", lambda: make_node_mesh(2, 4), AXES, (2, 4), "default", (14, "skew", 0)),
    ("1x8-single-node", lambda: make_node_mesh(1, 8), AXES, (1, 8), "ample", (9, "random", 0)),
    ("8x1-single-lane", lambda: make_node_mesh(8, 1), AXES, (8, 1), "ample", (18, "hotspot", 0)),
    ("2x2x2-random", lambda: make_pod_mesh(2, 2, 2), AXES3, (2, 2, 2), "ample", (15, "random", -1)),
    ("2x2x2-hotspot", lambda: make_pod_mesh(2, 2, 2), AXES3, (2, 2, 2), "ample", (3, "hotspot", 0)),
    ("2x2x2-tight-slots", lambda: make_pod_mesh(2, 2, 2), AXES3, (2, 2, 2), "default", (16, "skew", 0)),
    ("1x2x4", lambda: make_pod_mesh(1, 2, 4), AXES3, (1, 2, 4), "ample", (7, "random", 0)),
    ("2x1x4", lambda: make_pod_mesh(2, 1, 4), AXES3, (2, 1, 4), "ample", (7, "hotspot", 0)),
    ("2x4x1", lambda: make_pod_mesh(2, 4, 1), AXES3, (2, 4, 1), "ample", (7, "random", 0)),
    ("1x1x8", lambda: make_pod_mesh(1, 1, 8), AXES3, (1, 1, 8), "ample", (10, "hotspot", 0)),
    ("8x1x1", lambda: make_pod_mesh(8, 1, 1), AXES3, (8, 1, 1), "ample", (10, "random", 0)),
    ("1x8x1", lambda: make_pod_mesh(1, 8, 1), AXES3, (1, 8, 1), "ample", (10, "random", 0)),
    ("joint-(pod,node)x device", lambda: make_pod_mesh(2, 2, 2), (("pod", "node"), "device"),
     (4, 2), (2 * CAP, CAP), (17, "random", 0)),
]


@pytest.mark.parametrize("marshal", ["sort", "scatter"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_hierarchical_round_equals_reference(case, marshal):
    name, mesh_fn, axes, sizes, caps, (seed, kind, lo) = case
    caps = _ample(sizes) if caps == "ample" else (() if caps == "default" else caps)
    val, dest, counts = _inputs(seed, kind, lo)
    flat_axes = AXES3 if axes[0] == ("pod", "node") else axes
    jcfg = JForwardConfig(axes, R, CAP, exchange="hierarchical", level_sizes=sizes,
                          level_capacities=caps, marshal=marshal)
    want = _jax(mesh_fn(), jcfg, flat_axes, val, dest, counts)
    comm = StackedCollectives()
    tcfg = ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=sizes, level_capacities=caps,
                         marshal=marshal)
    got = _port(tcfg, val, dest, counts, comm=comm)
    _same(got, want)
    lane = np.arange(CAP)[None, :]
    emitted = int(((lane < counts[:, None]) & (dest >= 0) & (dest < R)).sum())
    assert int(got[2].sum()) + int(got[3].sum()) == emitted, "conservation"
    if kind == "skew":
        assert got[3].sum() > 0  # a stage clamp really fired
    else:
        _same(got, _port(ForwardConfig(R, CAP, exchange="onehot", marshal=marshal), val, dest, counts))
    # the per-tier budget: one payload and one count all_to_all per non-trivial tier
    tiers = sorted(l for l, a in enumerate(sizes) if a > 1)
    a2a = [c for c in comm.calls.elements() if c.kind == "all_to_all"]
    assert sorted(c.tier for c in a2a) == sorted(tiers * 2)
    assert comm.count("psum") == 1 and len(list(comm.calls.elements())) == 2 * len(tiers) + 1
    if len(tiers) == 1:  # a single non-trivial tier is the flat padded round
        flat = _port(ForwardConfig(R, CAP, peer_capacity=tcfg.level_capacities[tiers[0]], marshal=marshal),
                     val, dest, counts)
        _same(got, flat)


# ------------------------------------------------------- retain, S=1 (pipeline)
HIER = [
    ("2level", lambda: make_node_mesh(2, 4), AXES, (2, 4), (6, 8)),
    ("3level", lambda: make_pod_mesh(2, 2, 2), AXES3, (2, 2, 2), (4, 6, 8)),
]


@pytest.mark.parametrize("traffic", [("hotspot", 3), ("uniform", 0)], ids=["hotspot3", "uniform0"])
@pytest.mark.parametrize("overflow", ["drop", "retain"])
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
@pytest.mark.parametrize("hier", HIER, ids=[h[0] for h in HIER])
def test_hierarchical_pipeline_round_equals_reference(hier, marshal, overflow, traffic):
    """``test_pipeline.py::test_hierarchical_bitexact``'s bulk round (S=1):
    uneven per-tier capacities, rows parked mid-route under retain;
    counts, drops, destinations, item bits and ages, bit for bit."""
    _name, mesh_fn, axes, sizes, caps = hier
    dest = pattern_dest(*traffic)
    inp, want = jax_round(mesh_fn(), JForwardConfig(axes, R, RCAP, exchange="hierarchical", level_sizes=sizes,
                                                    level_capacities=caps, marshal=marshal,
                                                    overflow=overflow), dest)
    got = port_round(ForwardConfig(R, RCAP, exchange="hierarchical", level_sizes=sizes,
                                   level_capacities=caps, marshal=marshal, overflow=overflow), inp)
    assert_same_round(got, want)
    if overflow == "retain":
        assert got["drops"].sum() == 0 or traffic[0] == "hotspot"
        # rows held: retained lanes carry a destination
        held = sum(int((got["dest"][r, :got["count"][r]] >= 0).sum()) for r in range(R))
        assert held > 0


def test_hierarchical_retain_parks_mid_route():
    """2×4, every rank floods rank 3 (node 0, device 3) with 24 rows.  The
    fast tier (8 slots a peer) ships 8 and spills 16 at each source; rank 7
    (node 1, device 3) then holds node 1's 32 rows for rank 3, and the slow
    tier (6 slots) ships 6 and parks 26 there, mid-route, with destination
    3 and age 1.  Retention adds no collective."""
    sizes, caps = (2, 4), (6, 8)
    inp = jax_round(make_node_mesh(2, 4), JForwardConfig(AXES, R, RCAP, exchange="hierarchical",
                                                         level_sizes=sizes, level_capacities=caps),
                    pattern_dest("hotspot", 3))[0]
    calls, res = {}, {}
    for overflow in ("drop", "retain"):
        comm = StackedCollectives()
        res[overflow] = port_round(ForwardConfig(R, RCAP, exchange="hierarchical", level_sizes=sizes,
                                                 level_capacities=caps, overflow=overflow), inp, comm=comm)
        calls[overflow] = comm.calls
    assert calls["drop"] == calls["retain"]
    got = res["retain"]
    assert got["count"].tolist() == [16, 16, 16, 54, 16, 16, 16, 42] and got["drops"].sum() == 0
    assert (got["dest"][7, :42] == 3).all() and (got["age"][7, :42] == 1).all()
    assert res["drop"]["drops"].tolist() == [16, 16, 16, 42, 16, 16, 16, 42]


def test_stage_hook_marks_every_tier_and_the_merge():
    """``on_stage`` names each hierarchical stage with its tier (fastest
    first) and the retain merge; the round is the same without it."""
    val, dest, counts = _inputs(5, "random", 0)
    cfg = ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=(2, 4), overflow="retain")
    q = WorkQueue(items=TItem(val=torch.from_numpy(val), src=torch.zeros(R, CAP, dtype=torch.int32)),
                  dest=torch.from_numpy(dest), count=torch.from_numpy(counts), drops=torch.zeros(R, dtype=torch.int32))
    names = []
    marked = forward_work(q, cfg, on_stage=names.append)
    stages = ["SpillExtract", "Marshal", "CountExchange", "PayloadExchange"]
    assert names == (["plan", "pack"] + [f"{n}@1" for n in stages + ["AdvanceTier"]]
                     + [f"{n}@0" for n in stages + ["Unmarshal"]] + ["merge", "unpack", "psum"])
    plain = forward_work(q, cfg)
    assert torch.equal(marked[0].count, plain[0].count) and torch.equal(marked[2], plain[2])
    assert torch.equal(marked[0].items.val, plain[0].items.val) and torch.equal(marked[0].dest, plain[0].dest)


# -------------------------------------------------------------- the drives
HIER_CAP = 256
HIER_DRIVES = [("2level", (2, 4), (8, 8)), ("3level", (2, 2, 2), (8, 8, 8))]
SCENARIOS = {sc.name: sc for sc in TC.all_scenarios(R)}


@pytest.mark.parametrize("hier", HIER_DRIVES, ids=[h[0] for h in HIER_DRIVES])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_hierarchical_retain_drive_is_lossless(hier, name):
    """``test_chaos.py::test_hierarchical_retain_is_lossless``: a clamped row
    parks where it is and resumes next round; the schedule's checksums
    arrive exactly, with zero drops, on every scenario."""
    _id, sizes, caps = hier
    sc = SCENARIOS[name]
    res = scenario_drive(sc, ForwardConfig(R, HIER_CAP, exchange="hierarchical", level_sizes=sizes,
                                           level_capacities=caps, overflow="retain"), max_rounds=128)
    np.testing.assert_array_equal(res["delivered"], TC.expected_by_rank(sc))
    assert res["drops"] == 0 and res["done"] and res["resident"] == 0 and res["bad_ballast"] == 0
    assert res["retained_trace"][-1] == 0
    if name == "convergecast":
        assert max(res["retained_trace"]) > 0  # the clamps really bit


@pytest.mark.parametrize("hier", HIER_DRIVES, ids=[h[0] for h in HIER_DRIVES])
def test_hierarchical_retain_drive_scatter_equals_sort(hier):
    """``test_chaos.py::test_hierarchical_retain_scatter_marshal`` on the
    convergecast: lossless, and the scatter drive equal to the sort drive
    round for round."""
    _id, sizes, caps = hier
    sc = SCENARIOS["convergecast"]
    res = {m: scenario_drive(sc, ForwardConfig(R, HIER_CAP, exchange="hierarchical", level_sizes=sizes,
                                               level_capacities=caps, marshal=m, overflow="retain"),
                             max_rounds=128) for m in ("sort", "scatter")}
    np.testing.assert_array_equal(res["scatter"]["delivered"], TC.expected_by_rank(sc))
    assert res["scatter"]["drops"] == 0 and res["scatter"]["done"]
    for k in ("delivered", "rounds", "retained_trace", "age_trace"):
        np.testing.assert_array_equal(np.asarray(res["sort"][k]), np.asarray(res["scatter"][k]), err_msg=k)


def test_rafi_context_hierarchical_joint_tier():
    """A joint tier end to end through ``RafiContext``: the reference's
    ``axis_name=(("pod", "node"), "device")`` is ``level_sizes=(4, 2)``."""
    sizes = TCOLL.joint_tiers(TCOLL.pod_layout(2, 2, 2), ((0, 1), (2,)))
    assert sizes == (4, 2) and TCOLL.node_layout() == (2, 4)
    ctx = RafiContext(R, TItem(val=torch.zeros(()), src=torch.zeros((), dtype=torch.int32)),
                      capacity=CAP, exchange="hierarchical", level_sizes=sizes, device="cpu")
    assert ctx.cfg.level_sizes == (4, 2)
    me = torch.arange(R, dtype=torch.int32)[:, None]
    q = enqueue(ctx.make_queue(), TItem(val=torch.arange(4.0) + me * 10, src=me.expand(R, 4)),
                (me + torch.arange(4)) % R, torch.ones(R, 4, dtype=torch.bool))
    nq, total = ctx.forward_rays()(q)
    assert int(total) == R * 4 and int(nq.count.sum()) == R * 4
    assert ctx.comm.count("all_to_all", tier=0) == ctx.comm.count("all_to_all", tier=1) == 2


# ------------------------------------------------------------ the sort plan
@pytest.mark.parametrize("sizes", [(2, 4), (4, 2), (2, 2, 2), (1, 8), (2, 1, 4)], ids=str)
def test_hierarchical_keys_equal_reference(sizes):
    """N-level keys, their inverse and the sort plan against the
    reference's XLA functions; the permutation is the flat order."""
    from repro.core import sorting as JS

    rng = np.random.default_rng(sum(sizes))
    dest = rng.integers(-1, R + 2, (R, CAP)).astype(np.int32)
    count = rng.integers(0, CAP + 1, R).astype(np.int32)
    tkeys = TS.pack_keys_hierarchical(torch.from_numpy(dest), torch.from_numpy(count), sizes)
    tdig, tslot = TS.unpack_keys_hierarchical(tkeys, CAP, sizes)
    tperm, tcnt = TS.sort_permutation_hierarchical(torch.from_numpy(dest), torch.from_numpy(count), sizes)
    fperm = TS.sort_permutation(torch.from_numpy(dest), torch.from_numpy(count), R)[0]
    np.testing.assert_array_equal(tperm.numpy(), fperm.numpy())
    for r in range(R):
        jk = JS.pack_keys_hierarchical(jnp.asarray(dest[r]), jnp.asarray(count[r]), sizes)
        np.testing.assert_array_equal(tkeys[r].numpy(), np.asarray(jk).astype(np.int64))
        jd, js = JS.unpack_keys_hierarchical(jk, CAP, sizes)
        np.testing.assert_array_equal(tslot[r].numpy(), np.asarray(js))
        for a, b in zip(tdig, jd):
            np.testing.assert_array_equal(a[r].numpy(), np.asarray(b))
        jp, jc = JS.sort_permutation_hierarchical(jnp.asarray(dest[r]), jnp.asarray(count[r]), sizes)
        np.testing.assert_array_equal(tperm[r].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tcnt[r].numpy(), np.asarray(jc))


def test_hierarchical_key_width_refusal_equals_reference():
    """The same configurations are refused for a key past 32 bits."""
    from repro.core import sorting as JS

    sizes, cap = (1024, 1024), 2**12
    d, c = np.zeros((1, cap), np.int32), np.full(1, cap, np.int32)
    with pytest.raises(ValueError, match="bits > 32"):
        JS.pack_keys_hierarchical(jnp.asarray(d[0]), jnp.asarray(c[0]), sizes)
    with pytest.raises(ValueError, match="bits > 32"):
        TS.pack_keys_hierarchical(torch.from_numpy(d), torch.from_numpy(c), sizes)
    TS.hierarchical_key_bits((2, 4), cap)  # a narrow key passes


# -------------------------------------------------------- config validation
def test_config_rejects_flat_layout():
    """The reference refuses a one-axis hierarchical mesh; here a one-tier
    ``level_sizes``."""
    with pytest.raises(ValueError, match="slowest"):
        ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=(8,))


def test_config_rejects_missing_fast_size():
    with pytest.raises(ValueError, match="fast_size"):
        ForwardConfig(R, CAP, exchange="hierarchical")


def test_config_rejects_non_dividing_fast_size():
    with pytest.raises(ValueError, match="divide"):
        ForwardConfig(R, CAP, exchange="hierarchical", fast_size=3)


def test_config_three_tiers_from_level_sizes():
    cfg = ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=(2, 2, 2))
    jcfg = JForwardConfig(AXES3, R, CAP, exchange="hierarchical", level_sizes=(2, 2, 2))
    for f in ("level_sizes", "level_capacities", "fast_size", "peer_capacity", "node_capacity"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.peer_capacity == cfg.level_capacities[-1] and cfg.node_capacity == cfg.level_capacities[0]


def test_config_rejects_bad_level_sizes():
    with pytest.raises(ValueError, match="multiply"):
        ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=(2, 2, 4))
    with pytest.raises(ValueError, match=">= 1"):
        ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=(0, 8))
    with pytest.raises(ValueError, match="contradicts"):
        ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=(2, 4), fast_size=2)
    with pytest.raises(ValueError, match="one segment size per"):
        ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=(2, 2, 2), level_capacities=(8, 8))
    with pytest.raises(ValueError, match="contradicts"):
        ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=(2, 4), level_capacities=(8, 8),
                      peer_capacity=16)
    with pytest.raises(ValueError, match="contradicts"):
        ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=(2, 4), level_capacities=(8, 8),
                      node_capacity=16)
    with pytest.raises(ValueError, match=">= 1"):
        ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=(2, 4), level_capacities=(0, 8))


def test_config_rejects_hierarchical_fields_on_flat_backends():
    for exchange in ("padded", "onehot"):
        for kw in (dict(fast_size=4), dict(node_capacity=8), dict(level_sizes=(2, 4)),
                   dict(level_capacities=(8, 8))):
            with pytest.raises(ValueError, match="hierarchical"):
                ForwardConfig(R, CAP, exchange=exchange, **kw)


def test_config_pipeline_shards_must_divide_every_tier():
    """Checked before the refusal of ``pipeline_shards > 1`` (item 9)."""
    with pytest.raises(ValueError, match="must divide every"):
        ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=(2, 4), level_capacities=(6, 9),
                      pipeline_shards=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=(2, 4), level_capacities=(6, 8),
                      pipeline_shards=2)


def test_default_capacities_match_reference():
    """Defaults and aliases as the reference derives them, field for field."""
    for kw in (dict(fast_size=4), dict(fast_size=2), dict(fast_size=4, peer_capacity=7, node_capacity=11),
               dict(level_sizes=(2, 4), level_capacities=(5, 9)), dict(level_sizes=(4, 2), peer_capacity=3)):
        cfg = ForwardConfig(R, CAP, exchange="hierarchical", **kw)
        jcfg = JForwardConfig(AXES, R, CAP, exchange="hierarchical", **kw)
        for f in ("level_sizes", "level_capacities", "fast_size", "peer_capacity", "node_capacity"):
            assert getattr(cfg, f) == getattr(jcfg, f), (kw, f)
