"""The paths beside the round on the port's ``torch.distributed`` backend,
in gloo worlds on the CPU, against the stacked backend and the JAX
reference: the chaos drives (open, checkpointed, preempted and resumed
across world sizes, elastic R 8 → 4), the capacity tuner, the phase
profiler, the VoPaT, lander and schlieren renders, and the LM's ``rafi_ep``
plane, serving engine and data-parallel train step.

``R = 8`` ranks in worlds of 1, 2, 4 and 8 processes.  Each world is
started once (a module fixture, ``spawn_world`` with a 300-s limit, world 4
first so that world 2 can resume what it halted) and runs its cases of
``tests/_torch_dist_paths_cases.py`` in every process; the stacked backend
runs every case here.

Bit for bit (tolerance: none): every ``rank.*`` array a process holds
equals its rows of the stacked run and every ``world.*`` array the stacked
one: the chaos results (the delivered checksums, the accounting, the
traces), the checkpoint digests of every boundary, the resumes (a world of
4's halted checkpoint resumed in a world of 2 and on the stacked backend,
the stacked one resumed in a world of 4, all equal to the uninterrupted
stacked run), the elastic resume on 4 ranks in a world of 2, the tuner's
capacities burst for burst, the phase list and the ranks each phase ran
on, the three apps' images and lander's deep-compositing image and
dropped fragments, the MoE layer's drops and dispatched counts, the
serving engine's tokens and drops.  Each process's call record has the
stacked record's kinds, tiers and counts at its block's shape, the bytes
summed over the world equal to the stacked bytes, one host read per
ragged payload call (the laws of one payload and one count call per mesh
axis per round, none added by telemetry, retain or observation, one count
column more under credit, hold per process as they hold stacked); the
train step adds one ``grad_all_reduce`` a step and nothing else.  A dense
train step in a world of 2 equals the stacked step at ``microbatches=2``
on the same global batch (parameters, AdamW state, losses: a sum of two
terms is commutative), and every process of a training world holds the
same parameters and AdamW state.

Within a stated float32 tolerance (a product on a slice of the rows may
round otherwise than on all of them; measured 0.0 here): the MoE layer's
output within 1e-5 of its largest |value| in worlds of 2, 4 and 8 against
the stacked layer, and in a world of 8 against JAX's on ``mesh24``; the
serving engine's logits within 1e-5 of their largest |value|; after 3 MoE
train steps the parameters and AdamW's two moments within 1e-5 of the
largest |value| of their kind (measured 1.3e-6, 3.7e-6 and 3.0e-6) and the
losses and each step's gradient norm within 1e-5 relative.

A dense world of 4 sums the gradient in another order than the stacked
run (four partial sums of one row each, then the world's sum).  How far
that moves three AdamW steps depends on the host: on which SGEMM kernel
MKL picks for the CPU's instruction set (and on ATen's vector width),
which fixes the order of a matmul's inner sum, not on the thread count
(1, 2, 4 and 8 threads read alike).  The first moments' largest gap,
relative to their largest |value|, read 5.2e-6 to 2.5e-4 on one host
across ``MKL_ENABLE_INSTRUCTIONS`` = SSE4_2, AVX, AVX2, AVX512 and
``ATEN_CPU_CAPABILITY=default``, so no fixed tolerance fits every host.
The test measures its bound on its own host instead: ``K = 4`` times the
gap between two valid orders of the stacked run itself (``microbatches``
1 and 2 on the same global batch), kind by kind (parameters, first
moments, second moments, losses, gradient norms), that gap taken no finer
than one float32 ulp at the kind's largest |value|.  The world's gap over
that own gap read at most 2.60 on those five settings (1.73, 1.53, 1.06,
1.0 and 0.71 by kind with MKL's AVX-512 kernels; 0.89, 2.60, 1.84, 1.0 and
1.71 with its AVX2 ones).  A planted fault, the world's gradient sum
divided by 3 holders instead of 4, makes the losses and the gradient
norms a third too large and falls outside that bound by four orders of
magnitude (the clipped step's moments and parameters do not see it).
A dense world of 2
from the reference's weights against the reference's data-parallel
``train_step`` on ``mesh24``: each step's loss within 1e-5, gradient norm
within 5e-4 relative, every parameter within lr / 2 (the bounds of
``tests/test_torch_train.py``).  Lander's image in a world of 8 within
``tests/test_torch_lander_schlieren.py``'s 1e-5 of JAX's on ``mesh8``.

Failures: a process that raises inside the checkpointed drive ends its
world with its error.  Launch counts need the card (phase ``dist_paths``
of ``chip_smoke.py``); on the CPU every wrapper runs its plain version.
"""
import json
import pickle
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_paths_cases as PC
from repro.apps import lander as JL
from repro.configs import get_smoke_config as jget_smoke
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.models import moe as JM
from repro.models.api import build_model as jbuild
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch.core import StackedCollectives
from repro_torch.launch import dist as LD

# a hang guard.  The checkpoint cases fsync every file they write: alone a
# world runs its cases in ~6 s, but under a full parallel test run on a
# shared disk a world of 2 spent 113 s in them (its slowest case 38.7 s)
WORLD_TIMEOUT_S = 300
R = PC.R
TOL = 1e-5
PAIRS = [(w, c) for w in PC.WORLD_ORDER for c in PC.WORLD_CASES[w]]


def _reference_weights():
    """The reference's dense smoke weights (``PRNGKey(0)``)."""
    return jbuild(jget_smoke(PC.DENSE_ARCH)).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def stacked_dir(tmp_path_factory):
    """The stacked backend's directory, with its halted retain drive and
    the reference's dense smoke weights as a pickle of numpy arrays."""
    d = tmp_path_factory.mktemp("stacked")
    PC.halt(StackedCollectives(), str(d / "halt"))
    with open(d / "reference_weights.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, _reference_weights()), f)
    return d


def _inputs(out_dir, stacked_dir, halt_world4=None):
    return {"out_dir": str(out_dir), "halt_stacked": str(stacked_dir / "halt"),
            "halt_world4": str(halt_world4 or stacked_dir / "halt"),
            "reference_weights": str(stacked_dir / "reference_weights.pkl")}


@pytest.fixture(scope="module")
def stacked(stacked_dir):
    return {name: PC.run_case(StackedCollectives(), name, _inputs(stacked_dir, stacked_dir)) for name in PC.CASES}


@pytest.fixture(scope="module")
def worlds(stacked_dir, tmp_path_factory):
    """Each world's per-process results, ``{world: {case: [npz of p]}}``,
    and world 4's halted checkpoint."""
    out, halted = {}, None
    for w in PC.WORLD_ORDER:
        d = tmp_path_factory.mktemp(f"world{w}")
        LD.spawn_world(PC.run_cases, w, args=(str(d), PC.WORLD_CASES[w], _inputs(d, stacked_dir, halted)),
                       timeout_s=WORLD_TIMEOUT_S)
        out[w] = {name: [dict(np.load(d / f"{name}.p{p}.npz")) for p in range(w)] for name in PC.WORLD_CASES[w]}
        if w == 4:
            halted = d / "halt.w4"
            out["halt_world4"] = halted
    return out


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.dtype.kind in "fiub" and a.size else a


def _same(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype, f"{what}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}"
    assert np.array_equal(_bits(a), _bits(b)), what


TOLERATED = {"world.logits"}  # held within tolerance below


@pytest.mark.parametrize("world,case", PAIRS)
def test_world_equals_stacked(worlds, stacked, world, case):
    want = stacked[case]
    for p, got in enumerate(worlds[world][case]):
        keys = {k for k in want if k.startswith(("rank.", "world."))} - TOLERATED
        assert keys == {k for k in got if k.startswith(("rank.", "world."))} - TOLERATED
        for k in sorted(keys):
            if k.startswith("rank."):
                L = want[k].shape[0] // world
                _same(got[k], want[k][p * L:(p + 1) * L], f"process {p} {k}")
            else:
                _same(got[k], want[k], f"process {p} {k}")


def _calls(npz, drop=("grad_all_reduce",)):
    return [c for c in json.loads(str(npz["calls"])) if c[0] not in drop]


@pytest.mark.parametrize("world,case", PAIRS)
def test_world_records_the_stacked_calls(worlds, stacked, world, case):
    """Kinds, tiers and counts as the stacked record's, each process at its
    block's shape; bytes summed over the world equal the stacked bytes; one
    host read per ragged payload call."""
    want = _calls(stacked[case])

    def bytes_by_call(calls, into):
        for k, t, s, b, n in calls:
            into[(k, t, tuple(s[1:]), n)] = into.get((k, t, tuple(s[1:]), n), 0) + b
        return into

    summed = {}
    for p, got in enumerate(worlds[world][case]):
        calls = _calls(got)
        # a layout's rank count (the serving engine's (1, 4)) splits the
        # same way as R: the block is the stacked leading axis over the world
        shapes = sorted([k, t, [s[0] // world] + s[1:], n] for k, t, s, _b, n in want)
        assert sorted([k, t, s, n] for k, t, s, _b, n in calls) == shapes, f"process {p}"
        bytes_by_call(calls, summed)
        ragged = sum(n for k, *_rest, n in calls if k == "ragged_all_to_all")
        assert int(got["host_reads"]) == ragged, f"process {p}: host reads"
    assert summed == bytes_by_call(want, {})


@pytest.mark.parametrize("name", sorted(PC.CHAOS))
def test_chaos_call_laws(stacked, name):
    """Per forward (the drive's rounds plus its initial one): one payload
    and one count ``all_to_all`` per tier, the count call one column wider
    under credit, one termination ``psum``; nothing from telemetry or
    retain (the worlds hold the same record per process, above)."""
    res = stacked[f"chaos_{name}"]
    fwd = int(res["world.chaos.rounds"]) + 1
    calls = json.loads(str(res["calls"]))
    tiers = len(PC.CHAOS[name][1].get("level_sizes", (R,)))
    a2a = [c for c in calls if c[0] == "all_to_all"]
    assert sum(n for *_x, n in a2a) == 2 * tiers * fwd
    assert sum(n for k, *_x, n in calls if k == "psum") == fwd and {c[0] for c in calls} == {"all_to_all", "psum"}
    if tiers == 1:  # the count call's columns: the counts, and the credit adverts under credit
        assert {c[2][-1] for c in a2a if len(c[2]) == 3} == ({2} if PC.CHAOS[name][1].get("flow") == "credit" else {1})
    assert int(res["world.chaos.lost"]) == 0
    if name == "drop":
        assert int(res["world.chaos.drops"]) > 0
    else:
        assert int(res["world.chaos.drops"]) == 0 and bool(res["world.chaos.done"])


def _resumed(res):
    return {k: v for k, v in res.items() if k.startswith(("world.chaos.", "world.ckpt."))}


@pytest.mark.parametrize("world,case", [(4, "resume_from_stacked"), (2, "resume_from_world4")])
def test_resume_equals_the_uninterrupted_stacked_run(worlds, stacked, world, case):
    """A drive halted at a boundary in one world (or stacked) and resumed in
    another: the result and every boundary's digests equal the
    uninterrupted stacked run's."""
    want = _resumed(stacked["ckpt_retain"])
    for p, got in enumerate(worlds[world][case]):
        got = _resumed(got)
        assert set(got) <= set(want) and "world.ckpt.digests" in got and "world.chaos.delivered" in got
        for k in got:
            _same(got[k], want[k], f"process {p} {k}")
    assert len(want["world.ckpt.steps"]) >= 4


def test_world4_halt_resumes_on_the_stacked_backend(worlds, stacked, tmp_path):
    halted = worlds[4]["halt"][0]
    _same(halted["world.halt.digests"], stacked["halt"]["world.halt.digests"], "the halted files")
    d = tmp_path / "resume"
    shutil.copytree(worlds["halt_world4"], d)
    got = _resumed(PC.resume(StackedCollectives(), str(d)))
    want = _resumed(stacked["ckpt_retain"])
    assert set(got) <= set(want) and "world.ckpt.digests" in got
    for k in got:
        _same(got[k], want[k], k)


def test_elastic_resume_in_a_world(worlds, stacked):
    """R 8 → 4 inside a world of 2: the stacked elastic run's result and
    digests (checked above), drained with nothing lost."""
    res = worlds[2]["elastic"][0]
    assert bool(res["world.chaos.preempted"]) and bool(res["world.chaos.done"])
    assert int(res["world.chaos.lost"]) == 0 and res["world.chaos.delivered"].shape == (4, 3)


@pytest.mark.parametrize("name", sorted(PC.TUNE_CFG))
def test_tuner_converges(stacked, name):
    res = stacked[f"tune_{name}"]
    assert bool(res["world.tune.converged"]) and int(res["world.tune.drops"][0]) > 0
    assert len(res["world.tune.drops"]) >= 2 and int(res["world.tune.drops"][-1]) == 0


@pytest.mark.parametrize("world", [2, 4])
def test_phases_time_the_process_ranks(worlds, stacked, world):
    """Each process times every phase once (the counting timer) on its own
    ranks' ids."""
    for name in PC.PHASES:
        for p, got in enumerate(worlds[world][f"phases_{name}"]):
            L = R // world
            assert got["rank.phases.ids"].tolist() == list(range(p * L, (p + 1) * L))
            assert int(got["world.phases.timed"]) == len(got["world.phases.keys"])


@pytest.mark.parametrize("world", PC.WORLD_ORDER)
def test_apps_render_what_the_stacked_apps_render(worlds, world):
    """Beyond equality with the stacked run: nothing dropped, and the deep
    compositor's artifacts at one fragment a pixel."""
    assert int(worlds[world]["vopat"][0]["world.drops"]) == 0
    assert int(worlds[world]["deep_1"][0]["world.dropped"]) > 0 == int(worlds[world]["deep_4"][0]["world.dropped"])
    assert np.abs(worlds[world]["deep_1"][0]["world.image"] - worlds[world]["deep_4"][0]["world.image"]).max() > 1e-3


def test_lander_in_a_world_of_8_equals_the_reference(worlds, mesh8):
    jimg, jst = JL.render_forwarding(mesh8, JL.LanderScene(**PC.LANDER_REFERENCE))
    got = worlds[8]["lander_reference"][0]
    np.testing.assert_allclose(got["world.image"], jimg, rtol=0, atol=TOL)
    assert (int(got["world.rounds"]), int(got["world.drops"])) == (jst["rounds"], jst["drops"])


def _world_rows(res, world, key):
    """A per-process array over the batch rows, whole: one process of each
    set that holds the same rows, in row order."""
    seen, parts = set(), []
    for r in res:
        lo, hi = (int(v) for v in r["proc.rows"])
        if (lo, hi) not in seen:
            seen.add((lo, hi))
            parts.append((lo, r[key]))
    return np.concatenate([a for _lo, a in sorted(parts, key=lambda t: t[0])])


@pytest.mark.parametrize("world", [2, 4, 8])
def test_moe_layer_within_tolerance_of_stacked(worlds, stacked, world):
    want = stacked["moe"]["proc.y"]
    got = _world_rows(worlds[world]["moe"], world, "proc.y")
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def test_moe_layer_in_a_world_of_8_equals_the_reference(worlds, mesh24):
    p, x = PC.moe_inputs()
    jcfg = jget_smoke(PC.MOE_ARCH)
    jy, jd = jax.jit(lambda p, x: JM.moe_rafi_ep(p, x, jcfg, mesh=mesh24))(jax.tree.map(jnp.asarray, p),
                                                                            jnp.asarray(x))
    got = _world_rows(worlds[8]["moe"], 8, "proc.y")
    np.testing.assert_allclose(got, np.asarray(jy), rtol=0, atol=TOL * np.abs(np.asarray(jy)).max())
    assert int(worlds[8]["moe"][0]["world.drops"]) == int(jd)


@pytest.mark.parametrize("world", [2, 4])
def test_serving_logits_within_tolerance(worlds, stacked, world):
    want = stacked["serve"]["world.logits"]
    for got in worlds[world]["serve"]:
        np.testing.assert_allclose(got["world.logits"], want, rtol=0, atol=TOL * np.abs(want).max())
    assert int(stacked["serve"]["world.steps"]) > 0


def _proc(res):
    return {k: v for k, v in res.items() if k.startswith("proc.") and k not in ("proc.seconds",)}


@pytest.fixture(scope="module")
def stacked_microbatches(tmp_path_factory):
    d = tmp_path_factory.mktemp("mb2")
    return PC.train_run(None, PC.DENSE_ARCH, str(d / "ckpt"), microbatches=2)


def test_dense_train_in_a_world_of_2_equals_the_microbatched_step(worlds, stacked_microbatches):
    for p, got in enumerate(worlds[2]["train_dense"]):
        assert sorted(_proc(got)) == sorted(f"proc.{k}" for k in stacked_microbatches)
        for k, v in stacked_microbatches.items():
            _same(got[f"proc.{k}"], v, f"process {p} {k}")


@pytest.mark.parametrize("world,case", [(2, "train_dense"), (4, "train_dense"), (2, "train_moe"), (8, "train_moe")])
def test_train_replicas_stay_equal(worlds, world, case):
    res = worlds[world][case]
    for p, got in enumerate(res):
        assert bool(got["proc.restored_equal"]), f"process {p}: the checkpoint process 0 wrote"
        for k, v in _proc(res[0]).items():
            _same(got[k], v, f"process {p} {k}")
    calls = [c for c in json.loads(str(res[0]["calls"])) if c[0] == "grad_all_reduce"]
    assert sum(n for *_x, n in calls) == PC.TRAIN["steps"] and len(calls) == 1  # one bucket: float32, small


# the dense world of 4 against K times the stacked run's own gap between two
# valid orders of the gradient sum (module docstring)
K = 4
KINDS = ("proc.params.", "proc.opt.m.", "proc.opt.v.")


def _kind_gaps(got, want, kinds=KINDS):
    """``{kind: (largest |got - want| over the kind's leaves, largest
    |want|)}``, with the losses and the gradient norms as kinds of their
    own."""
    out = {}
    for kind in kinds + ("proc.losses", "proc.gnorms"):
        keys = [k for k in want if k == kind or k.startswith(kind) and kind.endswith(".")]
        assert keys and all(got[k].shape == want[k].shape for k in keys), kind
        out[kind] = (max(float(np.abs(got[k] - want[k]).max()) for k in keys),
                     max(float(np.abs(want[k]).max()) for k in keys))
    return out


def beyond_measured_bound(got, want, microbatched):
    """The kinds of ``got`` (a world's dense train run) farther from
    ``want`` (the stacked run) than ``K`` times the stacked run's gap to
    itself at ``microbatches=2`` (``microbatched``), that gap taken no
    finer than one float32 ulp at the kind's largest |value|:
    ``{kind: (gap, bound)}``."""
    mine = _kind_gaps({f"proc.{k}": v for k, v in microbatched.items()}, want)
    out = {}
    for kind, (gap, scale) in _kind_gaps(got, want).items():
        bound = K * max(mine[kind][0], float(np.spacing(np.float32(scale))))
        if not gap <= bound:
            out[kind] = (gap, bound)
    return out


@pytest.mark.parametrize("world,case", [(4, "train_dense"), (2, "train_moe"), (8, "train_moe")])
def test_train_within_tolerance_of_stacked(worlds, stacked, stacked_microbatches, world, case):
    """The parameters and AdamW's first and second moments (leaf kind by
    leaf kind), the losses and the gradient norms near the stacked run's,
    the step equal.  The dense world of 4 sums the gradient in another
    order than the stacked run: within ``K`` times the stacked run's own
    gap at ``microbatches=2``, kind by kind (:func:`beyond_measured_bound`).
    The MoE worlds: within TOL of the largest |value| of their kind, the
    losses and norms within TOL relative.  Adam's update does not scale
    with the gradient, nor do the moments of a clipped step (every step
    here: the norms are 1.9-17, the clip 1); the norm before the clip and
    the averaged loss do, so a wrong divisor of the gradient sum shows in
    them (:func:`test_the_measured_bound_catches_a_wrong_holder_count`)."""
    want, got = _proc(stacked[case]), _proc(worlds[world][case][0])
    _same(got["proc.opt.step"], want["proc.opt.step"], "opt.step")
    if case == "train_dense":
        assert beyond_measured_bound(got, want, stacked_microbatches) == {}
        return
    for kind, (gap, scale) in _kind_gaps(got, want).items():
        assert scale > 0, kind
        if kind.endswith("."):
            assert gap <= TOL * scale, (kind, gap, scale)
    for k in ("proc.losses", "proc.gnorms"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=0, err_msg=k)


def test_the_measured_bound_catches_a_wrong_holder_count(worlds, stacked, stacked_microbatches):
    """A world of 4 whose gradient and loss sums are divided by 3
    holders, not 4: its gradient norms and losses, a third too large, fall
    outside the bound the dense world of 4 is held to (the clipped step's
    moments and parameters do not see the scale)."""
    want = _proc(stacked["train_dense"])
    bad = _proc(worlds[4]["train_dense_wrong_holders"][0])
    caught = beyond_measured_bound(bad, want, stacked_microbatches)
    assert {"proc.losses", "proc.gnorms"} <= set(caught), caught
    for k in ("proc.losses", "proc.gnorms"):
        np.testing.assert_allclose(bad[k] / want[k], 4 / 3, rtol=1e-3, err_msg=k)


def test_dense_train_in_a_world_of_2_is_the_reference_data_parallel_step(worlds, mesh24):
    """Three steps of the dense smoke config from the reference's weights,
    a world of 2 (each process half of every global batch, the gradient
    averaged over both) against the reference's jitted ``train_step`` on
    ``mesh24`` (the batch split over its data axis) on the same batches:
    each step's loss within 1e-5 and gradient norm within 5e-4 of itself,
    and every parameter within lr / 2, the bounds of
    ``tests/test_torch_train.py``'s step against the reference."""
    jcfg = jget_smoke(PC.DENSE_ARCH)
    jstep = jax.jit(jbuild_train_step(jbuild(jcfg), mesh24, JAdamWConfig(**PC.REF_OPT))[0])
    jp = _reference_weights()
    jopt = jadamw_init(jp, JAdamWConfig(**PC.REF_OPT))
    jloss, jgnorm = [], []
    for tokens in PC.reference_batches(jcfg.vocab_size):
        jp, jopt, jmet = jstep(jp, jopt, {"tokens": jnp.asarray(tokens)})
        jloss.append(float(jmet["loss"]))
        jgnorm.append(float(jmet["gnorm"]))
    jflat = {".".join(str(k.key) for k in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    for p, got in enumerate(worlds[2]["train_reference"]):
        np.testing.assert_allclose(got["proc.losses"], jloss, rtol=0, atol=1e-5, err_msg=f"process {p}")
        np.testing.assert_allclose(got["proc.gnorms"], jgnorm, rtol=5e-4, atol=0, err_msg=f"process {p}")
        names = {k[len("proc.params."):] for k in got if k.startswith("proc.params.")}
        assert names == set(jflat), f"process {p}"
        for name in names:
            np.testing.assert_allclose(got[f"proc.params.{name}"], jflat[name], rtol=0, atol=PC.REF_OPT["lr"] / 2,
                                       err_msg=f"process {p} {name}")


def test_a_failing_process_ends_its_world():
    """Process 1 raises in the checkpointed drive's check while process 0
    waits in the first round's collective: the world ends with the error."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="scenario is laid out for 4 ranks"):
        LD.spawn_world(PC.bad_scenario, 2, timeout_s=60)
    assert time.monotonic() - t0 < 60


def test_world_timings_fit_the_limit(worlds):
    """Every case of every world ran well inside the world's limit."""
    slowest = max(float(r["seconds"]) for w in PC.WORLD_ORDER for rs in worlds[w].values() for r in rs)
    assert slowest < WORLD_TIMEOUT_S / 4


def test_chip_smoke_phase_dist_paths_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.phase_dist_paths`` at a small size on the CPU, gloo at a
    world of one, host timers in place of the card's: every check passes."""
    import pathlib
    import sys

    import torch

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    def host_ms(fn, reps=1, warmup=0):
        t0 = time.perf_counter()
        for _ in range(max(reps, 1)):
            fn()
        return (time.perf_counter() - t0) * 1e3 / max(reps, 1)

    monkeypatch.setattr(cs, "cuda_ms", host_ms)
    monkeypatch.setattr(cs, "FAILURES", [])
    widths = dict(d_model=64, num_heads=8, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512)
    out, paths = cs.phase_dist_paths(torch.device("cpu"), E=1024, C=8192, S=256, TUNE=(8192, 768, 8, 64),
                                     FIG8_S=2048, APP_SIZE=16, widths=widths, SLOTS=4, MAX_LEN=32, BATCH=(8, 32),
                                     profile=False, reps=1)
    assert cs.FAILURES == [] and set(paths) == {"dist_paths"}
    assert out["decode_max_abs_logit_diff"] == 0.0 and out["train"]["nccl_calls"]["grad_all_reduce"] == 2
