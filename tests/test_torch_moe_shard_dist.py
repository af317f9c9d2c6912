"""The MoE family on placed parameters over a gloo world of 2 on the CPU,
against the stacked backend.

``tests/_torch_moe_shard_cases.py``'s runs: dbrx's smoke config at
capacity factor 1.0 from seed-0 weights.  Decode under ``dense_tp`` on
layout (1, 8) (process p holds model ranks ``[4p, 4p + 4)`` of the one
data group, so the row-parallel ``psum`` and the attention's gathers
cross the processes) and under ``rafi_ep`` on (2, 4) (process p holds
data group p: the plane's two ``forward_work`` rounds and its combine
stay in the process, the drops' ``psum`` crosses it); training under both
planes on (2, 4) (the FSDP gathers and ``reduce_scatter``s cross the
processes, and so does ``dense_tp``'s gather of the top-k ids).

Bit for bit (tolerance: none): each placed decode step's logits and drops,
and the caches gathered whole at the end, equal the stacked run's.  Every
collective of the step gathers or sums in the stacked order.

The placed train steps (``fsdp``, two steps) within
``tests/test_torch_dist_paths.py``'s stated MoE tolerance of the stacked
run: the parameters and AdamW's two moments within 1e-5 of the largest
|value| of their kind, the losses and each step's gradient norm within
1e-5 relative.
"""
import numpy as np
import pytest
import torch

import _torch_moe_shard_cases as MC
from repro_torch.core import StackedCollectives
from repro_torch.launch import dist as LD

WORLD, WORLD_TIMEOUT_S = 2, 300
TOL = 1e-5  # tests/test_torch_dist_paths.py's MoE tolerance


@pytest.fixture(scope="module")
def stacked():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return MC.run_all(StackedCollectives())
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return LD.spawn_world(MC.run_all, WORLD, timeout_s=WORLD_TIMEOUT_S)


@pytest.mark.parametrize("plane", list(MC.DECODE))
def test_world_decode_equals_stacked(world, stacked, plane):
    want = stacked[f"decode_{plane}"]
    assert sum(int(want[f"drops{i}"]) for i in range(MC.DECODE_STEPS)) > 0
    for p, res in enumerate(world):
        got = res[f"decode_{plane}"]
        assert set(got) == set(want)
        for k in sorted(want):
            a, b = np.ascontiguousarray(got[k]), np.ascontiguousarray(want[k])
            assert a.shape == b.shape and a.dtype == b.dtype, f"process {p} {k}"
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f"process {p} {k}"


@pytest.mark.parametrize("plane", list(MC.TRAIN))
def test_world_train_within_tolerance_of_stacked(world, stacked, plane):
    want = stacked[f"train_{plane}"]
    for p, res in enumerate(world):
        got = res[f"train_{plane}"]
        assert set(got) == set(want)
        for kind in ("params.", "m.", "v."):
            keys = [k for k in want if k.startswith(kind)]
            scale = max(float(np.abs(want[k]).max()) for k in keys)
            gap = max(float(np.abs(got[k] - want[k]).max()) for k in keys)
            assert scale > 0 and gap <= TOL * scale, (p, kind, gap, scale)
        for k in ("losses", "gnorms"):
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=0, err_msg=f"process {p} {k}")
