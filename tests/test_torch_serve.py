"""The port's serving engine (``repro_torch.launch.serve``) against the JAX
engine on the CPU.

Both engines get the same requests (made from a seed with numpy) and the
same weights (the reference's, through ``params_from_jax``); the MoE configs
dispatch on the ``(2, 4)`` mesh / layout.  The token lists must be EQUAL:
greedy decoding takes the first index on ties in both, and the float32
logits agree within 1e-4 (``tests/test_torch_models.py``), far inside the
top-2 margins of these runs.

The slot-count finding: at the configs' capacity_factor=1.25 the llama4
smoke engine gives different tokens at 4 slots than at 2 — tokens drop
(at 4 slots a data group decodes 2 tokens, so every expert bucket and
every receive queue holds 1 row, and empty slots still route token 0) —
and the port reproduces exactly the reference's tokens at each slot count;
at capacity_factor=8 nothing drops and the slot count changes nothing.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import BatchedEngine as JEngine
from repro.launch.serve import Request as JRequest
from repro.models.api import build_model as jbuild
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_test_layout
from repro_torch.launch.serve import BatchedEngine, Request, reset_slot
from repro_torch.models.api import build_model, params_from_jax

MOE = ("llama4-scout-17b-16e", "dbrx-132b")


def _requests(cfg, cls, n=6, seed=0):
    rng = np.random.default_rng(seed)
    specs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(2, 12))).astype(np.int32), int(rng.integers(4, 12)))
             for _ in range(n)]
    return [cls(rid=i, prompt=p, max_new_tokens=m) for i, (p, m) in enumerate(specs)]


@functools.lru_cache(maxsize=None)
def _weights(arch, cf):
    jcfg = dataclasses.replace(jget_smoke(arch), capacity_factor=cf)
    cfg = dataclasses.replace(get_smoke_config(arch), capacity_factor=cf)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")


@functools.lru_cache(maxsize=None)
def _served(arch, slots, cf=1.25):
    """(JAX token lists, port token lists, port engine) of one run."""
    jcfg, cfg, jparams, lm = _weights(arch, cf)
    moe = cfg.kind == "moe"
    jout = JEngine(jbuild(jcfg), jparams, slots=slots, max_len=64,
                   mesh=make_test_mesh(2, 4) if moe else None).run(_requests(jcfg, JRequest))
    engine = BatchedEngine(build_model(cfg), lm, slots=slots, max_len=64,
                           layout=make_test_layout(2, 4) if moe else None, device="cpu")
    return jout, engine.run(_requests(cfg, Request)), engine


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("slots", [4, 2])
def test_engine_tokens_equal_the_reference_moe(arch, slots):
    jout, out, engine = _served(arch, slots)
    assert out == jout
    assert sorted(out) == list(range(6)) and all(len(v) > 0 for v in out.values())
    assert len(engine.step_drops) == engine.steps


def test_engine_tokens_equal_the_reference_dense():
    """qwen2-7b-smoke, no layout (no MoE), at 4 and at 2 slots."""
    for slots in (4, 2):
        jout, out, _ = _served("qwen2-7b", slots)
        assert out == jout


def test_slot_count_changes_moe_tokens_as_in_the_reference():
    """capacity_factor=1.25: 4 slots and 2 give different tokens, in the
    port exactly as in JAX, and the 4-slot run drops tokens."""
    j4, p4, e4 = _served("llama4-scout-17b-16e", 4)
    j2, p2, _ = _served("llama4-scout-17b-16e", 2)
    assert p4 == j4 and p2 == j2
    assert p4 != p2
    assert sum(int(d) for d in e4.step_drops) > 0


def test_slot_count_changes_nothing_without_drops():
    """capacity_factor=8: no step drops a token, and 4 slots give the 2
    slots' tokens (and the reference's)."""
    j4, p4, e4 = _served("llama4-scout-17b-16e", 4, 8.0)
    j2, p2, e2 = _served("llama4-scout-17b-16e", 2, 8.0)
    assert p4 == p2 == j4 == j2
    assert all(int(d) == 0 for d in e4.step_drops + e2.step_drops)


def test_reset_slot_zeroes_one_position_out_of_place():
    cfg = get_smoke_config("gemma3-1b")
    caches = build_model(cfg).init_caches(3, 8, device="cpu")
    for c in (caches["blocks"], caches["tail"]):
        for leaf in c.values():
            leaf["pos"].fill_(5)
    fresh = reset_slot(caches, 1)
    for c, old in ((fresh["blocks"], caches["blocks"]), (fresh["tail"], caches["tail"])):
        for key, leaf in c.items():
            assert leaf["pos"][..., 1].eq(0).all() and leaf["pos"][..., [0, 2]].eq(5).all()
            assert old[key]["pos"].eq(5).all()
            assert leaf["k"] is old[key]["k"]


def test_engine_runs_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("checks the rule where no card is present")
    cfg = get_smoke_config("qwen2-7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedEngine(build_model(cfg), None, slots=2)
