"""The cases ``tests/test_torch_dist_paths.py`` runs in every process of a
gloo world, and once on the stacked backend in the test's own process: the
paths of the port that run on the distributed backend beside the round —
the chaos drives (open, checkpointed, preempted and resumed across world
sizes, elastic), the capacity tuner, the phase profiler, the VoPaT, lander
and schlieren renders, and the LM's ``rafi_ep`` plane, serving engine and
train step.

Each case is ``fn(comm, inputs) -> {key: numpy array}`` on ``R = 8`` ranks,
keys as in ``tests/_torch_dist_cases.py``: ``rank.*`` the process's block
on the leading axis, ``world.*`` what every process holds whole, ``proc.*``
what a process holds for itself (its batch rows, its timings).
:func:`run_cases` runs the cases in order, each after ``comm.reset()``,
and writes each one's arrays, call record and host reads to
``<out_dir>/<case>.p<process>.npz``.  ``inputs`` holds the directories the
resume cases read (a stacked run's halted checkpoint, another world's).
This module imports neither ``jax`` nor ``repro``.
"""
import dataclasses
import json
import os
import pickle
import shutil
import time

import numpy as np
import torch

from repro_torch import chaos as TC
from repro_torch import ckpt
from repro_torch.apps import lander as LA
from repro_torch.apps import schlieren as SC
from repro_torch.apps import vopat as VP
from repro_torch.chaos import driver as TD
from repro_torch.configs import get_smoke_config
from repro_torch.core import DISCARD, ForwardConfig, enqueue, make_queue, run_until_done, work_item
from repro_torch.core import recovery as REC
from repro_torch.launch.mesh import Layout
from repro_torch.launch.serve import BatchedEngine, Request
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.launch.steps import build_train_step
from repro_torch.launch.train import train
from repro_torch.models import moe as M
from repro_torch.models.api import build_model, params_from_jax
from repro_torch.models.common import tree_leaves
from repro_torch.obs.phases import profile_phases
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tune import TunePolicy, autotune_forward

R = 8
CPU = "cpu"

# ------------------------------------------------------------------ chaos
CHAOS = {  # name -> (scenario arguments, run_scenario keywords)
    "drop": (dict(rounds=6, emits_per_round=24), dict(capacity=128, peer_capacity=6, overflow="drop")),
    "retain": (dict(rounds=6, emits_per_round=24), dict(capacity=128, peer_capacity=4, overflow="retain")),
    "tiers_2x2x2": (dict(rounds=6, emits_per_round=24),
                    dict(capacity=128, exchange="hierarchical", level_sizes=(2, 2, 2), level_capacities=(24, 12, 6),
                         overflow="retain")),
    "credit": (dict(rounds=6, emits_per_round=24),
               dict(capacity=64, peer_capacity=8, overflow="retain", flow="credit")),
}
CKPT = dict(checkpoint_every=2, keep=99, max_rounds=64)
HALT_AT = 3  # the drive halts at the boundary of round 2
ELASTIC = dict(preempt_at=7, resume_ranks=4, resume_capacity=256, checkpoint_every=3)


def chaos_scenario(name="retain"):
    return TC.rotating_hotspot(R, **CHAOS[name][0])


def _result_out(res: dict, key: str) -> dict:
    """A chaos result dict as ``world.*`` arrays (strings and paths left out)."""
    out = {}
    for k, v in res.items():
        if k in ("scenario", "ckpt_dir"):
            continue
        out[f"world.{key}.{k}"] = np.asarray(v)
    return out


def _digests_out(ckpt_dir, key: str) -> dict:
    d = TD.boundary_digests(ckpt_dir)
    return {f"world.{key}.steps": np.asarray(sorted(d), np.int64),
            f"world.{key}.digests": np.asarray([h for s in sorted(d) for h in d[s]])}


def _chaos_case(name):
    def fn(comm, inputs):
        return _result_out(TC.run_scenario(R, chaos_scenario(name), device=CPU, comm=comm, **CHAOS[name][1]), "chaos")

    return fn


def _private_dir(comm, inputs, name):
    """A fresh directory for this world's case (``inputs["out_dir"]``),
    made by process 0 before the others look at it."""
    d = os.path.join(inputs["out_dir"], f"{name}.w{comm.world}")
    if comm.index == 0:
        shutil.rmtree(d, ignore_errors=True)
    comm.barrier()
    return d


def _ckpt_case(name):
    def fn(comm, inputs):
        d = _private_dir(comm, inputs, f"ckpt_{name}")
        res = TC.run_scenario_checkpointed(R, chaos_scenario(name), ckpt_dir=d, device=CPU, comm=comm,
                                           **CHAOS[name][1], **CKPT)
        return {**_result_out(res, "chaos"), **_digests_out(d, "ckpt")}

    return fn


def halt(comm, ckpt_dir, name="retain"):
    """The retain drive, checkpointed, halted at the boundary before
    ``HALT_AT``: its state on disk, nothing returned."""
    ctx = TD._make_ctx(R, device=CPU, comm=comm, max_rounds=CKPT["max_rounds"], **CHAOS[name][1])
    rfn, aux0 = TD._drive_parts(ctx, chaos_scenario(name))
    res = REC.run_checkpointed(ctx, rfn, TD._seed(ctx, chaos_scenario(name), ctx.cfg.capacity), aux0,
                               ckpt_dir=ckpt_dir, checkpoint_every=CKPT["checkpoint_every"],
                               max_rounds=CKPT["max_rounds"], keep=CKPT["keep"], halt_after_round=HALT_AT)
    assert res is None


def resume(comm, ckpt_dir, name="retain"):
    """Resume the halted drive from ``ckpt_dir`` to its end: the result
    dict and every boundary's digests."""
    sc = chaos_scenario(name)
    ctx = TD._make_ctx(R, device=CPU, comm=comm, max_rounds=CKPT["max_rounds"], **CHAOS[name][1])
    aux_like = tuple(np.zeros((R,), np.uint32) for _ in range(3))
    res = REC.resume_run(ctx, TD._drive_parts(ctx, sc)[0], ckpt_dir, aux_like=aux_like,
                         checkpoint_every=CKPT["checkpoint_every"], max_rounds=CKPT["max_rounds"], keep=CKPT["keep"])
    out = TD._result_dict(sc, res["q"], res["aux"], res["rounds"], res["done"], cfg=ctx.cfg, ring=res.get("ring"),
                          comm=ctx.comm)
    return {**_result_out(out, "chaos"), **_digests_out(ckpt_dir, "ckpt")}


def _halt_case(comm, inputs):
    d = _private_dir(comm, inputs, "halt")
    halt(comm, d)
    return _digests_out(d, "halt")


def _resume_case(source):
    """Resume a halted drive another run wrote (``inputs[source]``), from
    a copy process 0 makes."""
    def fn(comm, inputs):
        d = _private_dir(comm, inputs, f"resume_{source}")
        if comm.index == 0:
            shutil.copytree(inputs[source], d)
        comm.barrier()
        return resume(comm, d)

    return fn


def _elastic_case(comm, inputs):
    d = _private_dir(comm, inputs, "elastic")
    kw = dict(capacity=128, peer_capacity=2, overflow="retain")  # tests/test_torch_recovery.py's elastic drive
    res = TC.run_scenario_checkpointed(R, TC.capacity_drought(R), ckpt_dir=d, keep=99, device=CPU, comm=comm,
                                       **ELASTIC, **kw)
    return {**_result_out(res, "chaos"), **_digests_out(d, "ckpt")}


def bad_scenario(comm):
    """Process 1 hands the checkpointed drive a scenario laid out for 4
    ranks and raises in its check, while process 0 drives and waits in the
    first round's collective."""
    sc = TC.rotating_hotspot(4 if comm.index == 1 else R, rounds=4, emits_per_round=8)
    TC.run_scenario_checkpointed(R, sc, ckpt_dir=None, capacity=64, peer_capacity=8, device=CPU, comm=comm)


# ------------------------------------------------------------------ tuner
@work_item
@dataclasses.dataclass
class Unit:
    val: torch.Tensor  # () f32


TUNE = dict(capacity=128, n_emit=16, rounds=6)
TUNE_CFG = {
    "flat": dict(peer_capacity=8),
    "hier_2x4": dict(exchange="hierarchical", level_sizes=(2, 4), level_capacities=(8, 8)),
}


def _tune_case(name):
    """The drifting hot-spot of ``tests/test_torch_tune.py`` through
    ``autotune_forward`` on the process's ranks."""
    C, n_emit, rounds = TUNE["capacity"], TUNE["n_emit"], TUNE["rounds"]
    cfg0 = ForwardConfig(R, C, telemetry=True, telemetry_window=rounds + 2, telemetry_buckets=8, **TUNE_CFG[name])

    def fn(comm, inputs):
        me = comm.ranks(R)[:, None]
        L = me.shape[0]
        lane = torch.arange(n_emit)[None, :]
        ones = torch.ones(L, n_emit, dtype=torch.bool)

        def emitted(rnd):
            hot = (rnd // 2) % R
            dest = torch.where(lane % 2 == 0, hot, (me + lane) % R).to(torch.int32)
            dest = dest if rnd < rounds else torch.full_like(dest, DISCARD)
            return enqueue(make_queue(Unit(val=torch.zeros(())), C, num_ranks=L, device=CPU), Unit(val=torch.ones(L, n_emit)),
                           dest, ones)

        def run_burst(cfg):
            q, _acc, _r, _d, ring = run_until_done(lambda q_in, acc, rnd: (emitted(rnd + 1), acc), emitted(0),
                                                   torch.zeros(L), cfg, max_rounds=rounds + 2, comm=comm)
            return int(q.drops.sum()), ring

        final, report = autotune_forward(run_burst, cfg0, policy=TunePolicy(headroom=1.25, granularity=8),
                                         bounds=(n_emit * R,) * len(TUNE_CFG[name].get("level_sizes", (1,))),
                                         max_bursts=6, comm=comm)
        out = {f"world.tune.{f}": np.asarray([getattr(s, f) for s in report.steps])
               for f in ("capacities", "planned", "drops", "demand_max", "rounds", "retained")}
        out["world.tune.converged"] = np.asarray(report.converged)
        out["world.tune.final"] = np.asarray((final.peer_capacity,) + tuple(final.level_capacities))
        return out

    return fn


# ---------------------------------------------------------- phase profiler
PHASES = {
    "padded_sort": dict(peer_capacity=32),
    "padded_scatter_shards2": dict(peer_capacity=32, marshal="scatter", pipeline_shards=2),
    "hier_2x2x2": dict(exchange="hierarchical", level_sizes=(2, 2, 2), level_capacities=(32, 16, 8)),
    "ragged": dict(exchange="ragged"),
}


def _phases_case(name):
    cfg = ForwardConfig(R, 256, **PHASES[name])

    def fn(comm, inputs):
        calls = []

        def timeit(fn, x):  # one call a phase: the phase's collectives, counted
            calls.append(tuple(x[:, 0].tolist()))
            fn(x)
            return float(len(calls)), None

        keys = list(profile_phases(cfg, n_emit=64, cap=256, proto=TD.chaos_proto(), timeit=timeit, device=CPU,
                                   comm=comm))
        return {"world.phases.keys": np.asarray(keys), "rank.phases.ids": np.asarray(calls[0], np.int64),
                "world.phases.timed": np.asarray(len(calls))}

    return fn


# -------------------------------------------------------------------- apps
SIZE = 32


def _vopat_case(comm, inputs):
    img, st = VP.render(VP.VopatScene(width=SIZE, height=SIZE), num_ranks=R, marshal="scatter", telemetry=True,
                        device=CPU, comm=comm)
    tel = st.pop("telemetry")
    out = {"world.image": img, "world.rounds": np.asarray(st["rounds"]), "world.drops": np.asarray(st["drops"])}
    out.update({f"world.telemetry.{k}": np.asarray(v) for k, v in tel.items()
                if isinstance(v, (int, float, np.ndarray, list, tuple))})
    return out


def _lander_case(comm, inputs):
    img, st = LA.render_forwarding(LA.LanderScene(width=SIZE, height=SIZE), num_ranks=R, device=CPU, comm=comm)
    return {"world.image": img, "world.rounds": np.asarray(st["rounds"]), "world.drops": np.asarray(st["drops"])}


def _deep_case(max_fragments):
    def fn(comm, inputs):
        img, st = LA.render_deep_compositing(LA.LanderScene(width=SIZE, height=SIZE), num_ranks=R,
                                             max_fragments=max_fragments, device=CPU, comm=comm)
        return {"world.image": img, "world.dropped": np.asarray(st["dropped_fragments"])}

    return fn


def _schlieren_case(comm, inputs):
    u, v, st = SC.render(SC.SchlierenScene(width=SIZE, height=SIZE), num_ranks=R, device=CPU, comm=comm)
    return {"world.u": u, "world.v": v, "world.raw": st["raw"], "world.rounds": np.asarray(st["rounds"]),
            "world.drops": np.asarray(st["drops"])}


LANDER_REFERENCE = dict(width=16, height=16, num_slabs=32, samples_per_slab=4)  # tests/test_torch_lander_schlieren.py


def _lander_reference_case(comm, inputs):
    img, st = LA.render_forwarding(LA.LanderScene(**LANDER_REFERENCE), num_ranks=R, device=CPU, comm=comm)
    return {"world.image": img, "world.rounds": np.asarray(st["rounds"]), "world.drops": np.asarray(st["drops"])}


# ---------------------------------------------------------------------- LM
MOE_ARCH, DENSE_ARCH = "llama4-scout-17b-16e", "qwen2-7b"
MOE_X = (4, 8)  # (B, S) of the MoE layer's input


def moe_inputs(seed=31):
    """The MoE layer's float32 weights and input, from numpy: ``(params,
    x)`` as numpy arrays, the same in every process and in the reference."""
    cfg = get_smoke_config(MOE_ARCH)
    rng = np.random.default_rng(seed)
    p = {k: (rng.normal(size=d.shape) * (d.scale if d.scale is not None else 1.0 / np.sqrt(d.shape[-2])))
         .astype(np.float32) for k, d in M.moe_defs(cfg).items()}
    x = rng.normal(size=MOE_X + (cfg.d_model,)).astype(np.float32)
    return p, x


def _moe_case(comm, inputs):
    cfg = get_smoke_config(MOE_ARCH)
    p, x = moe_inputs()
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    layout = Layout(2, 4, comm=comm)
    lo, hi = layout.data_block(x.shape[0])
    xl = torch.from_numpy(x[lo:hi])
    y, drops = M.moe_rafi_ep(p, xl, cfg, layout=layout)
    q = M.rafi_ep_dispatch(M.rafi_ep_route(p, xl, cfg, layout=layout))
    return {"proc.y": y.numpy(), "proc.rows": np.asarray([lo, hi]), "world.drops": np.asarray(int(drops)),
            "rank.dispatched.count": q.count.numpy(), "rank.dispatched.drops": q.drops.numpy()}


SERVE = dict(slots=4, max_len=32, requests=6)


def serve_requests(vocab):
    rng = np.random.default_rng(5)
    return [Request(rid=i, prompt=rng.integers(0, vocab, rng.integers(2, 6)).astype(np.int32),
                    max_new_tokens=int(rng.integers(3, 7))) for i in range(SERVE["requests"])]


def _serve_case(comm, inputs):
    """llama4-scout's smoke engine on layout (1, 4): every step's logits,
    the tokens and the drops."""
    cfg = get_smoke_config(MOE_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    eng = BatchedEngine(model, params, slots=SERVE["slots"], max_len=SERVE["max_len"], layout=Layout(1, 4, comm=comm),
                        device=CPU)
    logits, step = [], eng.step_fn

    def recorded(params, token, caches):
        lg, caches = step(params, token, caches)
        logits.append(lg.detach().clone())
        return lg, caches

    eng.step_fn = recorded
    out = eng.run(serve_requests(cfg.vocab_size))
    tokens = [t for rid in sorted(out) for t in [-1] + out[rid]]
    return {"world.logits": torch.stack(logits).numpy(), "world.tokens": np.asarray(tokens),
            "world.drops": np.asarray([int(d) for d in eng.step_drops]), "world.steps": np.asarray(eng.steps)}


TRAIN = dict(steps=3, batch=4, seq=16, ckpt_every=2)


def train_run(comm, arch, ckpt_dir, **changes):
    """``launch.train.train`` of ``arch``'s smoke config (with ``changes``)
    on ``comm`` (None: stacked), layout (2, 4): the parameters, the AdamW
    state's first and second moments and step, the losses and each step's
    gradient norm (before the clip: it scales with the gradient) as
    numpy, and the last checkpoint restored."""
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    gnorms, build = [], TR.build_train_step

    def recorded(*a, **kw):
        inner = build(*a, **kw)

        def step(params, opt, batch):
            params, opt, met = inner(params, opt, batch)
            gnorms.append(float(met["gnorm"]))
            return params, opt, met

        return step

    TR.build_train_step = recorded
    try:
        params, opt, losses = train(arch=cfg, steps=TRAIN["steps"], batch=TRAIN["batch"], seq=TRAIN["seq"],
                                    ckpt_dir=ckpt_dir, ckpt_every=TRAIN["ckpt_every"],
                                    opt_cfg=AdamWConfig(warmup_steps=2), verbose=False, device=CPU, comm=comm)
    finally:
        TR.build_train_step = build
    out = {f"params.{i}": p.detach().numpy().copy() for i, p in enumerate(tree_leaves(params.tree()))}
    for moment in ("m", "v"):
        out.update({f"opt.{moment}.{i}": a.detach().numpy().copy() for i, a in enumerate(tree_leaves(opt[moment]))})
    out["opt.step"] = opt["step"].numpy().copy()
    out["losses"] = np.asarray([l for _s, l in losses], np.float32)
    out["gnorms"] = np.asarray(gnorms, np.float32)
    like = {"params": params.tree(), "opt": opt}
    saved = ckpt.restore_checkpoint(ckpt_dir, TRAIN["steps"], like, device=CPU)
    out["restored_equal"] = np.asarray(all(np.array_equal(ckpt.checkpoint.to_host(a), ckpt.checkpoint.to_host(b))
                                           for a, b in zip(ckpt.tree_flatten(saved)[0], ckpt.tree_flatten(like)[0])))
    return out


def _train_case(arch):
    def fn(comm, inputs):
        d = _private_dir(comm, inputs, f"train_{arch}")
        return {f"proc.{k}": v for k, v in train_run(comm, arch, d).items()}

    return fn


def _wrong_holders_case(comm, inputs):
    """The dense train run with a planted fault: the world's gradient sum
    divided by one holder fewer than hold rows (the stacked run has no
    world and is left as it is)."""
    average = ST._average_over_groups
    ST._average_over_groups = lambda comm, leaves, loss, holders, lead: average(comm, leaves, loss, holders - 1, lead)
    try:
        d = _private_dir(comm, inputs, "train_wrong_holders")
        return {f"proc.{k}": v for k, v in train_run(comm, DENSE_ARCH, d).items()}
    finally:
        ST._average_over_groups = average


# the reference comparison's optimizer and global batches: those of
# tests/test_torch_train.py's step against the reference
REF_OPT = dict(lr=1e-3, warmup_steps=2, eps=1e-6)
REF_STEPS, REF_BATCH = 3, (4, 16)


def reference_batches(vocab: int) -> list:
    """The global token batches of the reference comparison, from numpy."""
    return [np.random.default_rng(30 + i).integers(0, vocab, REF_BATCH).astype(np.int32) for i in range(REF_STEPS)]


def _train_reference_case(comm, inputs):
    """``build_train_step`` of the dense smoke config from the reference's
    weights (``inputs["reference_weights"]``, a pickle of numpy arrays the
    test wrote) over the world: each step's loss and gradient norm and
    the parameters after the last step."""
    cfg = get_smoke_config(DENSE_ARCH)
    with open(inputs["reference_weights"], "rb") as f:
        lm = params_from_jax(cfg, pickle.load(f), device=CPU)
    opt_cfg = AdamWConfig(**REF_OPT)
    opt, step = adamw_init(lm, opt_cfg), build_train_step(build_model(cfg), None, opt_cfg, comm=comm)
    losses, gnorms = [], []
    for tokens in reference_batches(cfg.vocab_size):
        lm, opt, met = step(lm, opt, {"tokens": tokens})
        losses.append(float(met["loss"]))
        gnorms.append(float(met["gnorm"]))
    out = {f"proc.params.{name}": p.detach().numpy().copy() for name, p in lm.named_parameters()}
    return {**out, "proc.losses": np.asarray(losses, np.float32), "proc.gnorms": np.asarray(gnorms, np.float32)}


# ------------------------------------------------------------------ cases
CASES = {}
CASES.update({f"chaos_{k}": _chaos_case(k) for k in CHAOS})
CASES.update({"ckpt_retain": _ckpt_case("retain"), "ckpt_credit": _ckpt_case("credit")})
CASES.update({"halt": _halt_case, "resume_from_stacked": _resume_case("halt_stacked"),
              "resume_from_world4": _resume_case("halt_world4"), "elastic": _elastic_case})
CASES.update({f"tune_{k}": _tune_case(k) for k in TUNE_CFG})
CASES.update({f"phases_{k}": _phases_case(k) for k in PHASES})
CASES.update({"vopat": _vopat_case, "lander": _lander_case, "deep_1": _deep_case(1), "deep_4": _deep_case(4),
              "schlieren": _schlieren_case, "lander_reference": _lander_reference_case})
CASES.update({"moe": _moe_case, "serve": _serve_case, "train_dense": _train_case(DENSE_ARCH),
              "train_moe": _train_case(MOE_ARCH), "train_reference": _train_reference_case,
              "train_dense_wrong_holders": _wrong_holders_case})

# what each world runs (the stacked backend runs every case): the drives
# and apps in every world, the rest where the issue's comparison lies
EVERY_WORLD = ["chaos_drop", "chaos_retain", "chaos_tiers_2x2x2", "chaos_credit", "ckpt_retain", "ckpt_credit",
               "vopat", "lander", "deep_1", "deep_4", "schlieren"]
WORLD_CASES = {
    4: EVERY_WORLD + ["halt", "resume_from_stacked", "tune_flat", "tune_hier_2x4", "phases_padded_sort",
                      "phases_padded_scatter_shards2", "phases_hier_2x2x2", "phases_ragged", "moe", "serve",
                      "train_dense", "train_dense_wrong_holders"],
    2: EVERY_WORLD + ["resume_from_world4", "elastic", "tune_flat", "tune_hier_2x4", "phases_padded_sort",
                      "phases_padded_scatter_shards2", "phases_hier_2x2x2", "phases_ragged", "moe", "serve",
                      "train_dense", "train_moe", "train_reference"],
    1: EVERY_WORLD,
    8: EVERY_WORLD + ["moe", "train_moe", "lander_reference"],
}
WORLD_ORDER = (4, 2, 1, 8)  # world 2 resumes what world 4 halted


def calls_of(comm) -> list:
    """The call record as sorted ``[kind, tier, shape, bytes, count]`` rows."""
    return sorted([c.kind, -1 if c.tier is None else c.tier, list(c.shape), c.nbytes, n]
                  for c, n in comm.calls.items())


def run_case(comm, name, inputs) -> dict:
    comm.reset()
    t0 = time.perf_counter()
    out = CASES[name](comm, inputs)
    out["seconds"] = np.asarray(time.perf_counter() - t0)
    out["calls"] = np.asarray(json.dumps(calls_of(comm)))
    out["host_reads"] = np.asarray(comm.host_reads)
    return out


def run_cases(comm, out_dir, names, inputs) -> None:
    """Every case in ``names``, written to ``<out_dir>/<case>.p<index>.npz``."""
    for name in names:
        np.savez(os.path.join(out_dir, f"{name}.p{comm.index}.npz"), **run_case(comm, name, inputs))
