"""Shared test fixtures.

Tests that exercise collectives need a real multi-device mesh, so we ask the
CPU platform for 8 devices — enough for an interesting (2, 4) mesh.  The
production 512-device setting lives ONLY in ``repro.launch.dryrun`` (the
dry-run harness), never here: smoke tests and benchmarks are written to work
at whatever small device count this gives.

All version-sensitive JAX surface (``AxisType``, ``jax.shard_map``,
``ragged_all_to_all``) is reached through ``repro.compat`` — tests that need
a feature the installed JAX lacks must ``pytest.skip`` on the ``HAS_*``
flags, never fail at import.
"""
import os

# Must run before jax locks the backend on first init.
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import pytest

from repro import compat


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "pallas_interpret: force Pallas kernels into interpret mode for this "
        "test (sets RAFI_PALLAS_INTERPRET=1) so tier-1 exercises the kernel "
        "code paths — bucket_scatter, sort_keys, marshal — without a TPU.  "
        "On the CPU container interpret is already the default; on a TPU "
        "runner the marker keeps these tests backend-independent.",
    )
    config.addinivalue_line(
        "markers",
        "telemetry: exercises the ISSUE-5 traffic-telemetry / adaptive-"
        "capacity subsystem (repro.telemetry + repro.tune).  CI can select "
        "the subsystem with `-m telemetry`; the collective-budget guard "
        "(telemetry adds zero payload-sized collectives) carries the marker "
        "too so the selection is self-contained.",
    )
    config.addinivalue_line(
        "markers",
        "chaos: drives the ISSUE-6 deterministic fault-injection harness "
        "(repro.chaos) through the real on-device loop — multi-round, "
        "multi-scenario property tests of the lossless law (retain mode "
        "loses nothing) and the conservation identity (drop mode counts "
        "every loss).  Part of tier-1; CI can select with `-m chaos`.",
    )
    config.addinivalue_line(
        "markers",
        "recovery: exercises the ISSUE-7 recovery law — checkpoint/resume of "
        "the segmented drive loop (repro.core.recovery + repro.ckpt), "
        "elastic R→R′ restore, health-aware rank draining, and the "
        "conservation watchdog.  Part of tier-1; CI can select with "
        "`-m recovery`.",
    )
    config.addinivalue_line(
        "markers",
        "backpressure: exercises the ISSUE-9 backpressure law — credit-based "
        "flow control (``ForwardConfig.flow='credit'``): widened count "
        "collectives carrying receiver adverts, deterministic floor-share "
        "credit apportionment, the drive's emission gate, and graceful "
        "degradation under sustained overload (bounded occupancy, zero "
        "receiver drops where open flow wastes wire).  Part of tier-1; CI "
        "can select with `-m backpressure`.",
    )
    config.addinivalue_line(
        "markers",
        "obs: exercises the ISSUE-10 observation law (repro.obs) — host-side "
        "span tracing, metrics export, and the flight-data analyzer.  The "
        "marker also turns the ambient tracer ON via RAFI_TRACE=1 (the env "
        "toggle mirroring RAFI_PALLAS_INTERPRET), so marked tests run every "
        "drive entry point with its trace hooks live.  Part of tier-1; CI "
        "can select with `-m obs`.",
    )
    config.addinivalue_line(
        "markers",
        "slow: multi-minute end-to-end runs (the quickstart subprocess "
        "smoke test).  Part of tier-1; deselect locally with `-m 'not slow'` "
        "when iterating.",
    )
    config.addinivalue_line(
        "markers",
        "pipeline: exercises the ISSUE-8 overlap law — micro-shard pipelined "
        "forwarding (``ForwardConfig.pipeline_shards``) built on the stage-"
        "graph exchange layer (repro.core.stages).  Placement must stay "
        "bit-exact vs the bulk round and the per-axis collective budget "
        "scales to S payload + S count collectives.  Part of tier-1; CI can "
        "select with `-m pipeline`.",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc — runs the PyTorch port's "
        "hand-written CUDA kernels against their plain versions.  Skips with "
        "a reason where no card is present; select with `-m cuda`.",
    )


@pytest.fixture(autouse=True)
def _pallas_interpret_toggle(request, monkeypatch):
    """Honour the ``pallas_interpret`` marker via the env var that
    ``repro.kernels.default_interpret`` consults (the CI toggle)."""
    if request.node.get_closest_marker("pallas_interpret"):
        monkeypatch.setenv("RAFI_PALLAS_INTERPRET", "1")


@pytest.fixture(autouse=True)
def _rafi_trace_toggle(request, monkeypatch):
    """Honour the ``obs`` marker via the ``RAFI_TRACE`` env toggle that
    ``repro.obs.trace`` consults lazily (mirrors ``RAFI_PALLAS_INTERPRET``):
    marked tests run with the ambient tracer installed; teardown uninstalls
    it and restores the lazy env check so other tests stay untraced."""
    if not request.node.get_closest_marker("obs"):
        yield
        return
    from repro.obs import trace as OT

    monkeypatch.setenv(OT.ENV_VAR, "1")
    monkeypatch.setattr(OT, "_ENV_CHECKED", False)
    yield
    OT.uninstall()


@pytest.fixture(scope="session")
def mesh8():
    """A 1-D 8-way mesh over axis 'data'."""
    return compat.make_mesh((8,), ("data",))


@pytest.fixture(scope="session")
def mesh24():
    """A 2-D (2, 4) mesh over ('data', 'model') — miniature of the pod mesh."""
    return compat.make_mesh((2, 4), ("data", "model"))


@pytest.fixture(scope="session")
def mesh_nodes24():
    """A 2-D (node=2, device=4) forwarding mesh — the hierarchical exchange's
    (slow, fast) shape."""
    from repro.launch.mesh import make_node_mesh

    return make_node_mesh(2, 4)


@pytest.fixture(scope="session")
def mesh_nodes42():
    """The transposed (node=4, device=2) forwarding mesh."""
    from repro.launch.mesh import make_node_mesh

    return make_node_mesh(4, 2)


@pytest.fixture(scope="session")
def mesh_pods222():
    """A 3-D (pod=2, node=2, device=2) forwarding mesh — the N-level
    exchange's (slowest, …, fastest) shape."""
    from repro.launch.mesh import make_pod_mesh

    return make_pod_mesh(2, 2, 2)
