"""The port's recovery law (``repro_torch.core.recovery``, ``repro_torch.ckpt``
and ``repro_torch.chaos.run_scenario_checkpointed``) against the JAX
package, the reference's own relayout and the numpy twins.

* Drop mode, where the JAX drive runs: the port's result dicts equal
  ``repro.chaos``'s key for key, its checkpoints equal the reference's
  leaf for leaf (order, shape, dtype, ``meta``; contents with lanes past
  ``count`` masked, which carry no contract), and a JAX checkpoint resumed
  by the port ends where JAX's uninterrupted run ends.
* Retain, hierarchical, pipelined and credit drives (whose JAX drives do
  not run on this JAX, ROADMAP R1/R4): interrupted and uninterrupted runs
  publish equal SHA-256 digests at every common boundary, deliver
  ``expected_by_rank``, and follow ``simulate_flat_retain`` /
  ``simulate_flat_credit`` round for round.
* The elastic relayout equals ``repro.core.recovery._elastic_restore`` on
  random carries and on a real boundary, and an 8 → 4 resume loses nothing.
* The watchdog and the resume refusals raise what the reference raises,
  class and message.

Tolerance: none — every value here is moved or counted, never reduced.
"""
import shutil
import types

import jax
import numpy as np
import pytest
import torch

from repro.chaos import driver as JD
from repro.chaos import scenarios as JS
from repro.core import ForwardConfig as JForwardConfig
from repro.core import WorkQueue as JWorkQueue
from repro.core import recovery as JREC
from repro_torch import chaos as TC
from repro_torch import ckpt
from repro_torch.chaos import driver as TD
from repro_torch.core import ForwardConfig, RafiContext, WorkQueue, make_queue
from repro_torch.core import recovery as TREC

pytestmark = pytest.mark.recovery

R, S, FLAT_CAP = 8, 2, 128
CPU = dict(device="cpu")


def _same_value(a, b) -> bool:
    if isinstance(a, (str, bool)) or a is None:
        return a == b
    return np.asarray(a).shape == np.asarray(b).shape and np.array_equal(np.asarray(a), np.asarray(b))


def assert_same_dict(got, want, skip=("ckpt_dir",)):
    assert sorted(k for k in got if k not in skip) == sorted(k for k in want if k not in skip)
    for k in want:
        if k not in skip:
            assert _same_value(got[k], want[k]), (k, got[k], want[k])


def assert_digests_agree(da, db, at_least=3):
    common = sorted(set(da) & set(db))
    assert len(common) >= at_least
    for step in common:
        assert da[step] == db[step], f"state diverged at boundary {step}"


def _like(ckpt_dir, step, **ctx_kw):
    """The port's on-disk carry of a ``_make_ctx(**ctx_kw)`` drive as a
    restored tree (tensors on the CPU)."""
    ctx = TD._make_ctx(R, **ctx_kw, **CPU)
    credit = ctx.cfg.flow == "credit"
    aux_like = tuple(np.zeros((R,), np.uint32) for _ in range(3)) + ((np.zeros((R,), np.int32),) if credit else ())
    return ckpt.restore_checkpoint(ckpt_dir, step, TREC._carry_like(ctx, aux_like), device="cpu")


def _masked(tree, C):
    """The carry's leaves with every queue lane at or past ``count`` zeroed
    (lanes past ``count`` carry no contract, ROADMAP R3)."""
    live = (torch.arange(C)[None, :] < tree["q"].count[:, None]).reshape(-1)
    q = tree["q"]

    def mask(t):
        return torch.where(live.reshape((-1,) + (1,) * (t.dim() - 1)), t, torch.zeros_like(t))

    out = dict(tree)
    out["q"] = WorkQueue(items=type(q.items)(uid=mask(q.items.uid), val=mask(q.items.val)), dest=mask(q.dest),
                         count=q.count, drops=q.drops)
    if "age" in tree:
        out["age"] = mask(tree["age"])
    return ckpt.tree_flatten(out)[0]


# -------------------------------------------------- drop mode against JAX
@pytest.fixture(scope="module")
def jax_drop(mesh8, tmp_path_factory):
    """JAX's drop-mode drives of ``capacity_drought()`` a marshal, run once:
    ``(run_scenario, uninterrupted checkpointed, preempted at 5, dir)``."""
    cache = {}

    def get(marshal):
        if marshal not in cache:
            d = tmp_path_factory.mktemp(f"jax_drop_{marshal}")
            kw = dict(capacity=FLAT_CAP, peer_capacity=S, overflow="drop", marshal=marshal)
            sc = JS.capacity_drought()
            ref = JD.run_scenario(mesh8, sc, **kw)
            a = JD.run_scenario_checkpointed(mesh8, sc, ckpt_dir=d / "a", checkpoint_every=3, keep=99, **kw)
            b = JD.run_scenario_checkpointed(mesh8, sc, ckpt_dir=d / "b", checkpoint_every=3, keep=99,
                                             preempt_at=5, **kw)
            cache[marshal] = (ref, a, b, d)
        return cache[marshal]

    return get


def _drop_kw(marshal):
    return dict(capacity=FLAT_CAP, peer_capacity=S, overflow="drop", marshal=marshal)


@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_preempt_resume_bitexact_flat_drop_equals_jax(tmp_path, jax_drop, marshal):
    """``test_preempt_resume_bitexact_flat[drop-*]`` on the port, held
    against JAX's drives: the three result dicts key for key, the
    boundaries, and every checkpoint leaf for leaf."""
    jref, ja, jb, jdir = jax_drop(marshal)
    sc = TC.capacity_drought()
    kw = dict(_drop_kw(marshal), **CPU)
    ref = TC.run_scenario(R, sc, **kw)
    a = TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path / "a", checkpoint_every=3, keep=99, **kw)
    b = TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path / "b", checkpoint_every=3, keep=99, preempt_at=5,
                                     **kw)
    assert b["preempted"] and not a["preempted"] and a["lost"] == b["lost"] == 0
    assert_same_dict(ref, jref)
    assert_same_dict(a, ja)
    assert_same_dict(b, jb)
    assert_digests_agree(TC.boundary_digests(tmp_path / "a"), TC.boundary_digests(tmp_path / "b"))
    for run in ("a", "b"):
        for step in a["steps"]:
            mt, mj = ckpt.load_manifest(tmp_path / run, step), ckpt.load_manifest(jdir / run, step)
            assert mt["meta"] == mj["meta"] and mt["step"] == mj["step"]
            assert [(e["file"], e["shape"], e["dtype"]) for e in mt["leaves"]] == \
                [(e["file"], e["shape"], e["dtype"]) for e in mj["leaves"]]
            kw_ctx = dict(_drop_kw(marshal))
            got, want = _like(tmp_path / run, step, **kw_ctx), _like(jdir / run, step, **kw_ctx)
            for x, y in zip(_masked(got, FLAT_CAP), _masked(want, FLAT_CAP)):
                assert x.dtype == y.dtype and torch.equal(x, y)
            # leaves with no lane past count are defined whole: their files
            # are the reference's byte for byte; the lane leaves (items,
            # dest) are reported, not held (R3)
            lanes = {i for i, e in enumerate(mj["leaves"]) if e["shape"][:1] == [R * FLAT_CAP]}
            same = {i for i, (et, ej) in enumerate(zip(mt["leaves"], mj["leaves"])) if et["sha256"] == ej["sha256"]}
            assert set(range(len(mj["leaves"]))) - lanes <= same
            print(f"{marshal} {run} boundary {step}: {len(same)} of {len(mj['leaves'])} leaves digest-equal to "
                  f"JAX's, lane leaves {sorted(lanes)} equal: {sorted(lanes & same)}")


@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_jax_drop_checkpoint_resumed_by_port_ends_as_jax(tmp_path, jax_drop, marshal):
    """The port restores JAX's round-3 checkpoint and finishes the drive:
    its result equals JAX's uninterrupted run, and its later boundaries
    equal JAX's leaf for leaf (lanes past ``count`` masked)."""
    _jref, ja, _jb, jdir = jax_drop(marshal)
    shutil.copytree(jdir / "a" / "step_00000003", tmp_path / "step_00000003")
    sc = TC.capacity_drought()
    ctx = TD._make_ctx(R, **_drop_kw(marshal), **CPU)
    res = TREC.resume_run(ctx, TD._make_round_fn(ctx, sc), tmp_path, step=3, checkpoint_every=3, keep=99,
                          aux_like=tuple(np.zeros((R,), np.uint32) for _ in range(3)))
    out = TD._result_dict(sc, res["q"], res["aux"], res["rounds"], res["done"], cfg=ctx.cfg, ring=res["ring"])
    assert_same_dict(out, ja, skip=("ckpt_dir", "steps", "preempted"))
    assert TD._steps(tmp_path) == ja["steps"][1:]
    for step in ja["steps"][1:]:
        got, want = _like(tmp_path, step, **_drop_kw(marshal)), _like(jdir / "a", step, **_drop_kw(marshal))
        for x, y in zip(_masked(got, FLAT_CAP), _masked(want, FLAT_CAP)):
            assert torch.equal(x, y)


# ------------------------------------------------ retain: digests and twin
def _retain_kw(**extra):
    return dict(capacity=FLAT_CAP, peer_capacity=S, overflow="retain", **CPU, **extra)


def assert_twin(res, sim):
    np.testing.assert_array_equal(res["delivered"], sim["delivered"])
    assert res["rounds"] == sim["rounds"]
    np.testing.assert_array_equal(res["retained_trace"], sim["retained_trace"])
    np.testing.assert_array_equal(res["age_trace"], sim["age_trace"])


@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_preempt_resume_bitexact_flat_retain(tmp_path, marshal):
    """``test_preempt_resume_bitexact_flat[retain-*]``: equal digests at
    every common boundary, ``expected_by_rank`` delivered, and the run,
    interrupted or not, is ``simulate_flat_retain``'s trajectory."""
    sc = TC.capacity_drought()
    kw = _retain_kw(marshal=marshal)
    ref = TC.run_scenario(R, sc, **kw)
    a = TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path / "a", checkpoint_every=3, keep=99, **kw)
    b = TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path / "b", checkpoint_every=3, keep=99, preempt_at=5,
                                     **kw)
    sim = TC.simulate_flat_retain(sc, peer_capacity=S, capacity=FLAT_CAP)
    assert b["preempted"] and not a["preempted"]
    for res in (ref, a, b):
        np.testing.assert_array_equal(res["delivered"], TC.expected_by_rank(sc))
        assert res["lost"] == 0 and res["drops"] == 0 and res["done"]
        assert_twin(res, sim)
    assert_digests_agree(TC.boundary_digests(tmp_path / "a"), TC.boundary_digests(tmp_path / "b"))
    assert a["steps"] == b["steps"]


def test_preempt_resume_bitexact_hierarchical(tmp_path):
    """The recovery law on the 2×2×2 route with telemetry and retain."""
    sc = TC.convergecast(R)
    kw = dict(capacity=256, exchange="hierarchical", level_sizes=(2, 2, 2), level_capacities=(8, 8, 8),
              overflow="retain", max_rounds=128, **CPU)
    a = TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path / "a", checkpoint_every=4, keep=99, **kw)
    b = TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path / "b", checkpoint_every=4, keep=99, preempt_at=6,
                                     **kw)
    assert b["preempted"]
    for res in (a, b):
        np.testing.assert_array_equal(res["delivered"], TC.expected_by_rank(sc))
        assert res["lost"] == 0 and res["drops"] == 0 and res["done"]
    assert_digests_agree(TC.boundary_digests(tmp_path / "a"), TC.boundary_digests(tmp_path / "b"))


def test_preempt_resume_bitexact_pipelined(tmp_path):
    """A pipelined drive (``pipeline_shards=2``) checkpoints and resumes
    with equal digests, and answers as the bulk drive and the twin do."""
    sc = TC.capacity_drought()
    ref = TC.run_scenario(R, sc, **_retain_kw())
    kw = _retain_kw(pipeline_shards=2)
    a = TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path / "a", checkpoint_every=3, keep=99, **kw)
    b = TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path / "b", checkpoint_every=3, keep=99, preempt_at=5,
                                     **kw)
    sim = TC.simulate_flat_retain(sc, peer_capacity=S, capacity=FLAT_CAP)
    assert b["preempted"] and not a["preempted"]
    for res in (a, b):
        np.testing.assert_array_equal(res["delivered"], ref["delivered"])
        assert res["rounds"] == ref["rounds"] and res["lost"] == 0
        assert_twin(res, sim)
    assert_digests_agree(TC.boundary_digests(tmp_path / "a"), TC.boundary_digests(tmp_path / "b"))


def test_checkpointing_does_not_change_the_answer(tmp_path):
    sc = TC.capacity_drought()
    nockpt = TC.run_scenario_checkpointed(R, sc, ckpt_dir=None, checkpoint_every=3, **_retain_kw())
    assert nockpt["steps"] == []
    withckpt = TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path, checkpoint_every=3, **_retain_kw())
    assert_same_dict(nockpt, withckpt, skip=("ckpt_dir", "steps"))
    assert_same_dict(nockpt, TC.run_scenario(R, sc, **_retain_kw()), skip=("ckpt_dir", "steps", "preempted"))
    assert_twin(nockpt, TC.simulate_flat_retain(sc, peer_capacity=S, capacity=FLAT_CAP))


def test_truncated_retain_run_returns_live_ages(tmp_path):
    """Rank 0 holds 6 rows for rank 1 behind a 2-row clamp and nothing else
    emits: after the initial forward and one body round, 2 rows remain
    retained on rank 0 having waited 2 forwards each.  The same through
    ``run_until_done`` and the checkpointed drive, and the age equals the
    twin's trace at that forward."""
    ctx = RafiContext(R, TD.chaos_proto(), capacity=FLAT_CAP, peer_capacity=S, overflow="retain", **CPU)

    def round_fn(q_in, acc, rnd):  # a pure consumer
        return make_queue(TD.chaos_proto(), FLAT_CAP, num_ranks=R, device="cpu"), acc + q_in.count

    def q0():
        q = make_queue(TD.chaos_proto(), FLAT_CAP, num_ranks=R, device="cpu")
        q.dest[0, :6] = 1
        q.count[0] = 6
        return q

    q, acc, rounds, done, age = ctx.run_until_done(round_fn, max_rounds=1)(q0(), torch.zeros(R, dtype=torch.int32))
    assert rounds == 1 and not done
    assert sorted(age[age > 0].tolist()) == [2, 2]
    assert int(q.count[0]) == 2 and q.dest[0, :2].tolist() == [1, 1]
    res = TREC.run_checkpointed(ctx, round_fn, q0(), torch.zeros(R, dtype=torch.int32), ckpt_dir=tmp_path,
                                checkpoint_every=1, max_rounds=1)
    assert res["rounds"] == 1 and not res["done"] and torch.equal(res["age"], age)
    assert torch.equal(res["q"].count, q.count) and torch.equal(res["aux"], acc)
    # two rows consumed at rank 1, two retained at rank 0, two arrived unread
    assert (res["emitted"], res["delivered"], int(res["q"].count.sum())) == (6, 2, 4)


# ------------------------------------------------------------ elastic restore
@pytest.mark.parametrize("name", ["capacity_drought", "convergecast"])
def test_elastic_restore_r8_to_r4_conserves(tmp_path, name):
    """Preempt on 8 ranks in the drain phase, resume on 4 at twice the
    capacity: the global checksums equal the schedule's, nothing lost or
    dropped (``…_worst_case_backlog`` for the convergecast)."""
    sc = TC.capacity_drought() if name == "capacity_drought" else TC.convergecast(R)
    res = TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path, checkpoint_every=3, keep=99, preempt_at=7,
                                       resume_ranks=4, resume_capacity=256, **_retain_kw())
    assert res["preempted"] and res["done"] and res["lost"] == 0 and res["drops"] == 0
    exp = TC.expected_by_rank(sc).astype(np.uint64)
    got = res["delivered"].astype(np.uint64)
    assert got.shape[0] == 4
    assert int(got[:, 0].sum()) == int(exp[:, 0].sum()) == sc.emitted == res["delivered_total"]
    assert int(got[:, 1].sum() % (1 << 32)) == int(exp[:, 1].sum() % (1 << 32))
    assert int(got[:, 2].sum() % (1 << 32)) == int(exp[:, 2].sum() % (1 << 32))


def _to_reference(tree):
    """A port tree on disk (tensors) as the reference's numpy carry."""
    q = tree["q"]
    out = {k: (tuple(a.numpy() for a in v) if k == "aux" else v.numpy())
           for k, v in tree.items() if k not in ("q", "ring")}
    out["q"] = JWorkQueue(items=JD.ChaosItem(uid=q.items.uid.numpy(), val=q.items.val.numpy()),
                          dest=q.dest.numpy(), count=q.count.numpy(), drops=q.drops.numpy())
    return out


def _to_port(tree):
    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    q = tree["q"]
    out = {k: (tuple(t(a) for a in v) if k == "aux" else t(v)) for k, v in tree.items() if k != "q"}
    out["q"] = WorkQueue(items=TD.ChaosItem(uid=t(q.items.uid), val=t(q.items.val)), dest=t(q.dest),
                         count=t(q.count), drops=t(q.drops))
    return out


def assert_same_relayout(old_np, R_old, C_old, R_new, C_new, **mode):
    jctx = types.SimpleNamespace(cfg=JForwardConfig("data", R_new, C_new, **mode), num_ranks=R_new)
    tctx = types.SimpleNamespace(cfg=ForwardConfig(R_new, C_new, **mode), num_ranks=R_new)
    want = JREC._elastic_restore(old_np, jctx, R_old=R_old, C_old=C_old, aux_restore=None)
    got = TREC._elastic_restore(_to_port(old_np), tctx, R_old=R_old, C_old=C_old, aux_restore=None)
    jl, tl = jax.tree.flatten(want)[0], ckpt.tree_flatten(got)[0]
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        j, t = np.asarray(j), t.numpy()
        assert j.shape == t.shape and j.dtype == t.dtype
        np.testing.assert_array_equal(t, j)
    return got


MODES = {
    "drop": dict(overflow="drop"),
    "drop_ring": dict(overflow="drop", telemetry=True, telemetry_window=5),
    "retain": dict(overflow="retain"),
    "retain_ring": dict(overflow="retain", telemetry=True, telemetry_window=5),
    "retain_credit_ring": dict(overflow="retain", flow="credit", telemetry=True, telemetry_window=5),
}
SHAPES = [(8, 32, 4, 32), (8, 16, 4, 8), (4, 16, 8, 16), (8, 32, 3, 64), (6, 8, 6, 4)]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "R{}C{}-R{}C{}".format(*s))
def test_relayout_equals_reference_on_random_carries(shape, mode):
    """The vectorised relayout against ``repro.core.recovery._elastic_restore``
    on a random carry: every output leaf, every lane, bit for bit.  The
    carries hold retained rows, residents (``dest`` DISCARD), destinations
    past the new rank count and, where the capacity shrinks, more rows
    than fit."""
    R_old, C_old, R_new, C_new = shape
    kw = MODES[mode]
    rng = np.random.default_rng(sum(shape) * 31 + len(mode))
    n = R_old * C_old
    old = {
        "q": JWorkQueue(
            items=JD.ChaosItem(uid=rng.integers(0, 1 << 30, n, dtype=np.int32),
                               val=rng.standard_normal((n, 2)).astype(np.float32)),
            dest=rng.integers(-1, max(R_old, R_new) + 2, n).astype(np.int32),
            count=rng.integers(0, C_old + 1, R_old).astype(np.int32),
            drops=rng.integers(0, 9, R_old).astype(np.int32),
        ),
        "aux": tuple(rng.integers(0, 1 << 32, R_old, dtype=np.uint64).astype(np.uint32) for _ in range(3)),
        "rnd": np.asarray(7, np.int32),
        "drops": rng.integers(0, 9, R_old).astype(np.int32),
        "emitted": rng.integers(0, 1 << 31, R_old).astype(np.int32),
        "delivered": rng.integers(0, 1 << 31, R_old).astype(np.int32),
    }
    old["total"] = np.asarray(old["q"].count.sum(), np.int32)
    if kw["overflow"] == "retain":
        old["age"] = rng.integers(0, 6, n).astype(np.int32)
    if kw.get("flow") == "credit":
        old["credits"] = rng.integers(-3, 9, R_old * R_old).astype(np.int32)
    got = assert_same_relayout(old, R_old, C_old, R_new, C_new, **kw)
    live = int(old["q"].count.sum())
    assert int(got["q"].count.sum()) + int((got["drops"].to(torch.int64) - TREC._fold_rank_counter(
        torch.from_numpy(old["drops"]), R_new).to(torch.int64)).sum()) == live


def test_relayout_of_a_drive_boundary_equals_reference(tmp_path):
    """The relayout of a real boundary (the convergecast's drain-phase
    checkpoint on 8 ranks, onto 4) equals the reference's."""
    sc = TC.convergecast(R)
    ctx = TD._make_ctx(R, **_retain_kw())
    halted = TREC.run_checkpointed(ctx, TD._make_round_fn(ctx, sc), TD._seed_queue(sc, FLAT_CAP, device="cpu"),
                                   TD._aux0(R, "cpu"), ckpt_dir=tmp_path, checkpoint_every=3, keep=99,
                                   halt_after_round=7)
    assert halted is None and TD._steps(tmp_path) == [0, 3, 6]
    old = _like(tmp_path, 6, capacity=FLAT_CAP, peer_capacity=S, overflow="retain")
    assert int(old["total"]) > 0
    old_np = _to_reference(old)
    cfg = TD._make_ctx(4, capacity=256, overflow="retain", **CPU).cfg
    assert_same_relayout(old_np, R, FLAT_CAP, 4, 256, overflow="retain", telemetry=True,
                         telemetry_window=cfg.telemetry_window)


def test_deficit_fill_equals_the_argmin_loop():
    rng = np.random.default_rng(5)
    for _ in range(50):
        load = rng.integers(0, 20, rng.integers(1, 9))
        k = int(rng.integers(0, 60))
        run, want = load.copy(), []
        for _ in range(k):
            d = int(np.argmin(run))
            want.append(d)
            run[d] += 1
        assert TREC._deficit_fill(torch.from_numpy(load), k).tolist() == want


# -------------------------------------------------------------- draining
def test_rank_brownout_loses_nothing_and_matches_twin(tmp_path):
    """Mid-burst brownout through the per-segment health schedule: the
    drive equals the twin fed the same segment-quantised mask."""
    sc = TC.rank_brownout()
    W = 3
    health = TC.brownout_mask(R, down=(2, 5), down_from=3)

    def twin_health(f):  # forward f >= 1 belongs to the segment from boundary W·((f-1)//W)
        return health(0) if f == 0 else health(W * ((f - 1) // W))

    sim = TC.simulate_flat_retain(sc, peer_capacity=S, capacity=FLAT_CAP, health=twin_health)
    res = TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path, checkpoint_every=W, keep=99, health=health,
                                       **_retain_kw())
    assert_twin(res, sim)
    assert res["lost"] == 0 and res["drops"] == 0 and res["done"]
    assert res["delivered_total"] == sc.emitted


def test_all_healthy_mask_is_bitidentical_to_no_mask():
    sc = TC.capacity_drought()
    a = TC.run_scenario(R, sc, **_retain_kw())
    b = TC.run_scenario(R, sc, health=np.ones(R, bool), **_retain_kw())
    assert_same_dict(a, b)


def test_constant_drain_matches_twin_and_starves_drained_ranks():
    sc = TC.capacity_drought()
    h = np.ones(R, bool)
    h[[2, 5]] = False
    sim = TC.simulate_flat_retain(sc, peer_capacity=S, capacity=FLAT_CAP, health=h)
    res = TC.run_scenario(R, sc, health=h, **_retain_kw())
    assert_twin(res, sim)
    assert res["drops"] == 0 and res["lost"] == 0 and res["done"]
    assert res["delivered"][2].sum() == 0 and res["delivered"][5].sum() == 0
    assert res["delivered_total"] == sc.emitted


# ------------------------------------------------------ watchdog, refusals
def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class and message are compared
        return type(e), str(e)
    return None


BOOKS = {
    "balanced": (dict(emitted=[10, 10], delivered=[7, 5], total=6, drops=[1, 1]), ""),
    "leak": (dict(emitted=[10, 10], delivered=[7, 5], total=5, drops=[1, 1]), "round 4"),
}


@pytest.mark.parametrize("case", sorted(BOOKS))
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_watchdog_raises_what_the_reference_raises(case, kind):
    books, where = BOOKS[case]
    np_books = {k: np.asarray(v, np.int32) for k, v in books.items()}
    port_books = np_books if kind == "numpy" else {k: torch.from_numpy(v) for k, v in np_books.items()}
    want = _raised(lambda: JREC.conservation_check(np_books, where=where))
    assert _raised(lambda: TREC.conservation_check(port_books, where=where)) == want
    assert (want is None) == (case == "balanced")
    if want is not None:
        assert want[0] is RuntimeError and "conservation violated at round 4" in want[1]


def test_resume_rejects_mismatched_context(tmp_path, mesh8):
    """A retain checkpoint refuses a drop-mode resume, and an empty
    directory has no checkpoint: the port raises what JAX's ``resume_run``
    raises on the same (port-written) directory."""
    sc = TC.capacity_drought()
    TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path, checkpoint_every=3, keep=99, preempt_at=5,
                                 **_retain_kw())
    ctx = TD._make_ctx(R, capacity=FLAT_CAP, peer_capacity=S, overflow="drop", **CPU)
    jctx = JD._make_ctx(mesh8, capacity=FLAT_CAP, peer_capacity=S, overflow="drop")
    aux_like = tuple(np.zeros((R,), np.uint32) for _ in range(3))
    for where in (tmp_path, tmp_path / "empty"):
        got = _raised(lambda: TREC.resume_run(ctx, TD._make_round_fn(ctx, sc), where, aux_like=aux_like))
        want = _raised(lambda: JREC.resume_run(jctx, JD._make_round_fn(jctx, JS.capacity_drought()), where,
                                               aux_specs=(jctx._spec,) * 3, aux_like=aux_like))
        assert got == want and got[0] in (ValueError, FileNotFoundError)
    assert "overflow" in _raised(lambda: TREC.resume_run(ctx, None, tmp_path, aux_like=aux_like))[1]


# ------------------------------------------------------- credit (backpressure)
def _credit_kw():
    return dict(capacity=16, peer_capacity=4, overflow="retain", flow="credit", max_rounds=256, **CPU)


def test_preempt_resume_credit_bitexact(tmp_path):
    """A credit drive preempted at a boundary and resumed publishes equal
    digests (credits included) and follows ``simulate_flat_credit``."""
    sc = TC.sustained_overload(R)
    ref = TC.run_scenario(R, sc, **_credit_kw())
    a = TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path / "a", checkpoint_every=8, keep=99, **_credit_kw())
    b = TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path / "b", checkpoint_every=8, keep=99, preempt_at=20,
                                     **_credit_kw())
    sim = TC.simulate_flat_credit(sc, peer_capacity=4, capacity=16, max_rounds=256)
    assert b["preempted"] and not a["preempted"]
    for res in (ref, a, b):
        assert_twin(res, sim)
        assert res["lost"] == 0 and res["drops"] == 0 and res["emitted"] == sim["emitted"]
    assert_digests_agree(TC.boundary_digests(tmp_path / "a"), TC.boundary_digests(tmp_path / "b"))
    man = ckpt.load_manifest(tmp_path / "a", 8)
    assert man["meta"]["flow"] == "credit" and [64] in [e["shape"] for e in man["leaves"]]  # credits (R·R,)


def test_resume_refuses_flow_mismatch(tmp_path, mesh8):
    sc = TC.sustained_overload(R)
    TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path, checkpoint_every=8, keep=99, **_credit_kw())
    kw = dict(capacity=16, peer_capacity=4, overflow="retain", flow="open", max_rounds=256)
    ctx = TD._make_ctx(R, **kw, **CPU)
    jctx = JD._make_ctx(mesh8, **kw)
    aux_like = tuple(np.zeros((R,), np.uint32) for _ in range(3))
    got = _raised(lambda: TREC.resume_run(ctx, lambda q, aux, rnd: (q, aux), tmp_path, aux_like=aux_like))
    want = _raised(lambda: JREC.resume_run(jctx, lambda q, aux, rnd: (q, aux), tmp_path,
                                           aux_specs=(jctx._spec,) * 3, aux_like=aux_like))
    assert got == want and got[0] is ValueError and "flow" in got[1]


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from repro_torch import compat as tcompat

    if tcompat.nvcc_path() is None:
        pytest.skip("needs nvcc to build the CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_preempt_resume_equals_uninterrupted(tmp_path, cuda_device):
    """``chip_smoke.py`` phase ``recovery`` (a) at the tests' size on the
    card: the preempted and resumed drive publishes the uninterrupted
    drive's digests, delivers ``expected_by_rank`` and answers as
    ``run_scenario`` and as the same drive on the CPU."""
    sc = TC.rotating_hotspot(R)
    kw = dict(capacity=FLAT_CAP, peer_capacity=S, overflow="retain", device=cuda_device)
    ref = TC.run_scenario(R, sc, **kw)
    a = TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path / "a", checkpoint_every=3, keep=99, **kw)
    b = TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path / "b", checkpoint_every=3, keep=99, preempt_at=5,
                                     **kw)
    none = TC.run_scenario_checkpointed(R, sc, ckpt_dir=None, checkpoint_every=3, **kw)
    cpu = TC.run_scenario_checkpointed(R, sc, ckpt_dir=tmp_path / "cpu", checkpoint_every=3, keep=99,
                                       **dict(kw, device="cpu"))
    assert b["preempted"]
    assert_digests_agree(TC.boundary_digests(tmp_path / "a"), TC.boundary_digests(tmp_path / "b"))
    for res in (a, b, none):
        np.testing.assert_array_equal(res["delivered"], TC.expected_by_rank(sc))
        assert res["lost"] == 0 and res["drops"] == 0 and res["rounds"] == ref["rounds"]
    assert_same_dict(none, ref, skip=("ckpt_dir", "steps", "preempted"))
    assert_same_dict(a, cpu)
