"""The port's examples run on the CPU (``--cpu``) and print what the JAX
examples print: ``quickstart_torch.py`` the drained totals of sections 1–3
of ``examples/quickstart.py`` (deposits per rank, 4 rounds, 9.000), then
the same totals through retain and the hierarchical route;
``vopat_render_torch.py`` an 8-rank image bit-equal to the 1-rank one.
Neither imports JAX or the reference package."""
import os
import pathlib
import subprocess
import sys

import pytest

from test_torch_types_queue import _imports

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name), "--cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


@pytest.mark.parametrize("name", ["quickstart_torch.py", "vopat_render_torch.py"])
def test_example_imports_neither_jax_nor_the_reference(name):
    for mod in _imports(ROOT / "examples" / name):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod


def test_quickstart_torch_prints_the_reference_totals():
    out = _run("quickstart_torch.py")
    assert "deposited per rank: [1.5  1.75 2.   0.25 0.5  0.75 1.   1.25]" in out
    assert "rounds to distributed termination: 4" in out
    assert "total deposited: 9.000  (expected 9.000)" in out
    assert out.count("total deposited 9.000") == 3 and out.rstrip().endswith("OK")


def test_vopat_render_torch_is_bit_equal_across_rank_counts():
    out = _run("vopat_render_torch.py")
    assert "bitwise identical across rank counts: True" in out and "drops=0" in out
