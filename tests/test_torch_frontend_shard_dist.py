"""The stub-frontend families on placed parameters over a gloo world of 2
on the CPU, against the stacked backend.

``tests/_torch_frontend_shard_cases.py``'s runs, from seed-0 weights of the
smoke configs on layout (2, 4), process p holding data group p.  seamless-
m4t-medium's placed decode under ``dp_over_model`` (each decoder layer's
gather of q, k and v on the rows and its ``_combine`` stay in the
process) and split over ``model`` (every gather and ``psum`` over
``model`` stays in the process); the logits' rows cross it.  Bit for bit
(tolerance: none): each step's logits and the caches gathered whole at
the end equal the stacked run's.

The placed train steps, two of each arch (qwen2-vl with ``fsdp`` on
``embeds`` and ``labels``: the FSDP gathers and ``reduce_scatter``s cross
the processes; seamless under ``dp_over_model``: every leaf's flat
``psum`` over the eight ranks crosses them; seamless split over
``model``: each leaf's gradient ``psum`` over ``data`` crosses them), within
``tests/test_torch_dist_paths.py``'s stated tolerance of the stacked run
(its ``TOL``, 1e-5): the parameters and AdamW's two moments within 1e-5
of the largest |value| of their kind, the losses and each step's gradient
norm within 1e-5 relative.
"""
import numpy as np
import pytest
import torch

import _torch_frontend_shard_cases as FC
from repro_torch.core import StackedCollectives
from repro_torch.launch import dist as LD

WORLD, WORLD_TIMEOUT_S = 2, 300
TOL = 1e-5  # tests/test_torch_dist_paths.py's TOL


@pytest.fixture(scope="module")
def stacked():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return FC.run_all(StackedCollectives())
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return LD.spawn_world(FC.run_all, WORLD, timeout_s=WORLD_TIMEOUT_S)


def _decode_equal(world, stacked, key):
    want = stacked[key]
    assert any(k.startswith("caches.") for k in want)
    for p, res in enumerate(world):
        got = res[key]
        assert set(got) == set(want)
        for k in sorted(want):
            a, b = np.ascontiguousarray(got[k]), np.ascontiguousarray(want[k])
            assert a.shape == b.shape and a.dtype == b.dtype, f"process {p} {k}"
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f"process {p} {k}"


def test_world_decode_equals_stacked(world, stacked):
    _decode_equal(world, stacked, "decode")


def test_world_tp_decode_equals_stacked(world, stacked):
    _decode_equal(world, stacked, "decode_tp")


@pytest.mark.parametrize("arch", FC.TRAIN)
def test_world_train_within_tolerance_of_stacked(world, stacked, arch):
    want = stacked[f"train_{arch}"]
    for p, res in enumerate(world):
        got = res[f"train_{arch}"]
        assert set(got) == set(want)
        for kind in ("params.", "m.", "v."):
            keys = [k for k in want if k.startswith(kind)]
            scale = max(float(np.abs(want[k]).max()) for k in keys)
            gap = max(float(np.abs(got[k] - want[k]).max()) for k in keys)
            assert scale > 0 and gap <= TOL * scale, (p, kind, gap, scale)
        for k in ("losses", "gnorms"):
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=0, err_msg=f"process {p} {k}")
