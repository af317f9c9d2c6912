"""The port's examples run on the CPU (``--cpu``) and print what the JAX
examples print: ``quickstart_torch.py`` the drained totals of sections 1–5
of ``examples/quickstart.py`` (deposits per rank, 4 rounds, 9.000, the
telemetry summary of 5 recorded rounds with no drop, the pipelined drive
bit-exact with bulk), the same totals through retain and the hierarchical
route, section 6's overload drained losslessly by credit flow, and section
7's flight report flagging the open run alone; ``vopat_render_torch.py`` an
8-rank image bit-equal to the 1-rank one and its drop-free telemetry
summary; ``streamlines_demo_torch.py`` three fields, each equal to its
single-rank oracle; ``serve_lm_torch.py`` ten requests through the slot
engine for a dense and an MoE smoke config, each getting its
``max_new_tokens``; ``train_lm_torch.py`` the reference example's ~100M
model training a few steps with finite losses.  None imports JAX or the
reference package."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from test_torch_types_queue import _imports

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(name, *args):
    # one OpenMP thread: torch's default of a thread per core, in a child
    # started beside a parallel test run's other workers, oversubscribes
    # the host, and spinning threads then slow it by one or two orders of
    # magnitude (six concurrent VoPaT renders: 19 s at one thread each, not
    # done in 40 min at eight)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name), "--cpu", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


@pytest.mark.parametrize("name", ["quickstart_torch.py", "vopat_render_torch.py", "streamlines_demo_torch.py",
                                  "serve_lm_torch.py", "train_lm_torch.py"])
def test_example_imports_neither_jax_nor_the_reference(name):
    for mod in _imports(ROOT / "examples" / name):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod


def test_quickstart_torch_prints_the_reference_totals():
    out = _run("quickstart_torch.py")
    assert "deposited per rank: [1.5  1.75 2.   0.25 0.5  0.75 1.   1.25]" in out
    assert "rounds to distributed termination: 4" in out
    assert "total deposited: 9.000  (expected 9.000)" in out
    assert "telemetry: 5 rounds recorded, max segment demand 4 (peer slots sized 32), clamp drops 0" in out
    assert "pipelined (S=2) drive bit-exact with bulk: 9.000" in out
    assert out.count("total deposited 9.000") == 3 and out.rstrip().endswith("OK")
    # section 6: the chaos driver's overload, open against credit (the twin's 73 rounds)
    assert "overload [credit]: delivered 1152/1152 in 73 rounds, goodput 1.000, drops 0" in out
    # section 7: the flight report of those two runs
    assert "degraded_runs: ['sustained_overload_open']" in out
    assert "verdict: 1 degraded run(s) — sustained_overload_open" in out


def test_vopat_render_torch_is_bit_equal_across_rank_counts():
    out = _run("vopat_render_torch.py")
    assert "bitwise identical across rank counts: True" in out and "drops=0" in out
    assert "clamp drops 0" in out and "telemetry:" in out


def test_streamlines_demo_torch_matches_its_oracle():
    out = _run("streamlines_demo_torch.py")
    lines = [line for line in out.splitlines() if "oracle max err" in line]
    assert len(lines) == 3 and all(line.endswith("-> OK") for line in lines), out


def test_serve_lm_torch_answers_every_request():
    out = _run("serve_lm_torch.py")
    assert out.count("served 10 requests through 4 slots") == 2
    assert "qwen2-7b-smoke: 107072 parameters" in out and "llama4-scout-smoke: 254784 parameters" in out
    assert "MoE tokens dropped at capacity_factor 1.25" in out
    # the twin of examples/serve_lm.py's requests: rng(0), prompts of 2-11 tokens, 4-11 new tokens
    rng = np.random.default_rng(0)
    want = []
    for _ in range(10):
        prompt = rng.integers(0, 256, rng.integers(2, 12))
        want.append((len(prompt), int(rng.integers(4, 12))))
    lines = [line for line in out.splitlines() if line.startswith("  request ")]
    assert len(lines) == 20
    for i, line in enumerate(lines):
        plen, n_new = want[i % 10]
        assert f"prompt_len={plen:2d}" in line and len(ast.literal_eval(line.split("-> ")[1])) == n_new


def test_train_lm_torch_trains_the_100m_model(tmp_path):
    """Three steps of the ~100M model at batch 2 × 32 tokens, from an empty
    checkpoint directory and without checkpoints: the parameter count of
    the reference's example and a finite loss at each logged step."""
    out = _run("train_lm_torch.py", "--steps", "3", "--batch", "2", "--seq", "32", "--ckpt-every", "0",
               "--ckpt-dir", str(tmp_path / "ckpt"))
    assert "training repro-100m: 114.7M params" in out
    losses = [float(line.split("loss")[1].split()[0]) for line in out.splitlines() if line.startswith("[train] step")]
    assert len(losses) == 2 and all(np.isfinite(losses)), out
    assert "steps 0-2: loss" in out
