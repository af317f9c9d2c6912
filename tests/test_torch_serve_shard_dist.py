"""The placed serving engine of the dense family over a gloo world of 2
on the CPU, against the stacked backend.

``tests/_torch_serve_shard_cases.py``'s run: qwen2-7b's smoke config,
its parameters serve-placed on layout (2, 4) from seed-0 weights,
``BatchedEngine`` with 8 slots answering 10 requests.  In a world of 2
process p holds ranks ``[4p, 4p + 4)``, data group p: its four model
ranks and its four slots' cache rows.  Every process takes the global
token batch and ends each step with the whole logits, so both keep the
same slot tables.

Bit for bit (tolerance: none): every process's token lists and last
logits equal the stacked run's.  Every collective of the step gathers or
sums in the stacked order (a floating ``psum`` gathers the group and sums
in digit order), and each rank's arithmetic is the stacked rank's.  Each
process's call record has the stacked record's kinds, tiers and counts at
its block's shape.
"""
import numpy as np
import pytest
import torch

import _torch_serve_shard_cases as SC
from repro_torch.core import StackedCollectives
from repro_torch.launch import dist as LD

WORLD, WORLD_TIMEOUT_S = 2, 300


@pytest.fixture(scope="module")
def stacked():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return SC.serve(StackedCollectives())
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return LD.spawn_world(SC.serve, WORLD, timeout_s=WORLD_TIMEOUT_S)


def test_world_engine_equals_stacked(world, stacked):
    assert sum(map(len, stacked["tokens"].values())) == sum(r.max_new_tokens for r in SC.requests(256))
    for p, res in enumerate(world):
        assert res["tokens"] == stacked["tokens"], f"process {p}"
        assert res["steps"] == stacked["steps"]
        got, want = res["last_logits"], stacked["last_logits"]
        assert got.shape == want.shape == (SC.SLOTS, 256) and got.dtype == want.dtype
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), f"process {p}"


def test_world_records_the_stacked_calls(world, stacked):
    want = sorted([k, t, [s[0] // WORLD] + s[1:], n] for k, t, s, n in stacked["calls"])
    assert {k for k, *_ in want} == {"psum", "all_gather"}
    for p, res in enumerate(world):
        assert res["calls"] == want, f"process {p}"
