"""The placed train step of the dense family over gloo worlds on the CPU,
against the stacked backend and the JAX reference.

qwen2-7b's smoke config on layout (2, 4), two steps of
``tests/_torch_shard_cases.py`` from seed-0 weights: with ``fsdp=True``,
with ``fsdp=True`` and ``microbatches=2``, and with ``fsdp`` off (the
parameters replicated over ``data``).  Worlds of 2 (a process holds one
data group) and 8 (a process holds one rank, so the ``psum`` over
``model`` and every gather cross processes), each started once (a module
fixture, ``spawn_world`` with a 300-s limit).

Bit for bit (tolerance: none): every process's losses, gradient norms,
parameters and AdamW moments, gathered whole, equal the stacked run's.
Every collective that sums does it in the stacked order (a ``psum``
gathers the group and sums in digit order, a ``reduce_scatter`` sums the
blocks its ``all_to_all_single`` delivers in digit order), and each
rank's arithmetic is the stacked rank's, so no order differs and no
measured bound is needed.  A planted fault, the gradient of a leaf
replicated over ``data`` left unsummed over it, parts from the stacked
run's right result in the world as in the stacked run.  Each process's
call record has the stacked record's kinds, tiers and counts at its
block's shape, the bytes summed over the world equal to the stacked bytes.

Within ``tests/test_torch_train.py``'s bounds of the reference: the
stacked (and so every world's) ``fsdp`` runs against the reference's step
jitted on ``mesh24`` with its shardings from the same weights and
batches: each step's loss within 1e-5, gradient norm within 5e-4
relative, every parameter within lr / 2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_shard_cases as SC
from repro.configs import get_smoke_config as jget_smoke
from repro.launch.mesh import make_test_mesh
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.models.api import build_model as jbuild
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch.core import StackedCollectives
from repro_torch.launch import dist as LD
from repro_torch.configs import get_smoke_config
from repro_torch.launch import specs as S
from repro_torch.models.api import build_model

WORLDS = (2, 8)
WORLD_TIMEOUT_S = 300
PAIRS = [(w, r) for w in WORLDS for r in list(SC.RUNS) + ["tp_only_wrong_data_psum"]]


@pytest.fixture(scope="module")
def stacked():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return SC.run_all(StackedCollectives())
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    return {w: LD.spawn_world(SC.run_all, w, timeout_s=WORLD_TIMEOUT_S) for w in WORLDS}


def _arrays(res):
    return {k: np.asarray(v) for k, v in res.items() if k != "calls"}


def _same(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), what


@pytest.mark.parametrize("world,run", PAIRS)
def test_world_equals_stacked(worlds, stacked, world, run):
    want = _arrays(stacked[run])
    for p, res in enumerate(worlds[world]):
        got = _arrays(res[run])
        assert set(got) == set(want)
        for k in sorted(want):
            _same(np.ascontiguousarray(got[k]), np.ascontiguousarray(want[k]), f"process {p} {k}")


@pytest.mark.parametrize("world,run", PAIRS)
def test_world_records_the_stacked_calls(worlds, stacked, world, run):
    want = stacked[run]["calls"]
    kinds = {k for k, *_ in want}
    assert {"psum", "all_gather", "reduce_scatter"} <= kinds or run == "tp_only"
    summed = {}
    for p, res in enumerate(worlds[world]):
        got = res[run]["calls"]
        shapes = sorted([k, t, [s[0] // world] + s[1:], n] for k, t, s, _b, n in want)
        assert sorted([k, t, s, n] for k, t, s, _b, n in got) == shapes, f"process {p}"
        for k, t, s, b, n in got:
            summed[(k, t, tuple(s[1:]), n)] = summed.get((k, t, tuple(s[1:]), n), 0) + b
    assert summed == {(k, t, tuple(s[1:]), n): b for k, t, s, b, n in want}


def test_a_planted_fault_is_caught(worlds, stacked):
    """The data ``psum`` of the replicated leaves' gradients left out: the
    gradient norms and the parameters part from the right run, in every
    world as in the stacked run."""
    right = _arrays(stacked["tp_only"])
    for res in [stacked] + [worlds[w][0] for w in WORLDS]:
        bad = _arrays(res["tp_only_wrong_data_psum"])
        assert not np.allclose(bad["gnorms"], right["gnorms"], rtol=5e-4, atol=0)
        assert any(not np.allclose(bad[k], right[k], atol=SC.OPT["lr"] / 2, rtol=0)
                   for k in right if k.startswith("params."))


def _reference_run(run):
    """The reference's step jitted with its shardings on ``mesh24`` from the
    port's seed-0 weights, on ``SC.batches``."""
    changes = SC.RUNS[run]
    jcfg = dataclasses.replace(jget_smoke(SC.ARCH), **changes)
    lm = build_model(dataclasses.replace(get_smoke_config(SC.ARCH), **changes)).init(
        torch.Generator().manual_seed(0), device="cpu")
    jp = {"tail": {}}  # the reference's tree keeps the empty group
    for path, t in S.named_leaves(lm.tree()):
        node = jp
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = jnp.asarray(t.detach().numpy())
    step, shardings = jbuild_train_step(jbuild(jcfg), make_test_mesh(2, 4), JAdamWConfig(**SC.OPT))
    jitted = jax.jit(step, in_shardings=(shardings["params"], shardings["opt"], None),
                     out_shardings=(shardings["params"], shardings["opt"], None))
    params = jax.device_put(jp, shardings["params"])
    opt = jax.device_put(jadamw_init(jp, JAdamWConfig(**SC.OPT)), shardings["opt"])
    losses, gnorms = [], []
    for tokens in SC.batches(jcfg.vocab_size):
        params, opt, met = jitted(params, opt, {"tokens": jnp.asarray(tokens)})
        losses.append(float(met["loss"]))
        gnorms.append(float(met["gnorm"]))
    flat = {"params." + ".".join(str(k.key) for k in p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(params)}
    return losses, gnorms, flat


@pytest.mark.parametrize("run", ["fsdp", "fsdp_micro2"])
def test_stacked_and_worlds_within_the_reference_bounds(stacked, run):
    losses, gnorms, params = _reference_run(run)
    got = _arrays(stacked[run])
    np.testing.assert_allclose(got["losses"], losses, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["gnorms"], gnorms, rtol=5e-4, atol=0)
    assert {k for k in got if k.startswith("params.")} == set(params)
    for k, v in params.items():
        np.testing.assert_allclose(got[k], v, atol=SC.OPT["lr"] / 2, rtol=0, err_msg=k)
    assert int(stacked[run]["step"]) == SC.STEPS
