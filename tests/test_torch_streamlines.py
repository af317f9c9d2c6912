"""The port's streamlines app (§5.4) against the JAX reference app.

Both apps start from the same seeds, drawn in the test exactly as
``repro.apps.streamlines`` draws them and passed to the port's ``run``.
The reference runs its plain RK4 (``use_pallas_rk4=False``), the port its
plain RK4 on the CPU.  Tolerances: identical finite masks (which particle
is alive at which step), max abs difference <= 1e-4 between the two
packages (torch's and XLA's libm may differ by an ulp per sin/cos, over 16
steps), and <= 5e-4 between the port's run and its own oracle (the JAX
demo's bound; on the card the port demands exactly 0).
"""
import jax
import numpy as np
import pytest

from repro.apps import streamlines as jsl
from repro_torch.apps import streamlines as tsl
from repro_torch.core import RafiContext
from repro_torch.kernels.rk4_advect import ops as rk4

N, STEPS, DT = 32, 16, 0.1


def _seeds(seed):
    key = jax.random.PRNGKey(seed)
    return np.asarray(jax.random.uniform(key, (N, 3), minval=0.5, maxval=jsl.TWO_PI - 0.5))


@pytest.mark.parametrize("field_id", [rk4.ABC, rk4.TORNADO, rk4.TAYLOR_GREEN],
                         ids=["abc", "tornado", "taylor_green"])
def test_streamlines_match_reference_and_own_oracle(mesh8, field_id):
    jcfg = jsl.StreamlineConfig(num_particles=N, max_steps=STEPS, dt=DT, field_id=field_id)
    tcfg = tsl.StreamlineConfig(num_particles=N, max_steps=STEPS, dt=DT, field_id=field_id)
    seeds = _seeds(jcfg.seed)
    want, want_len, want_stats = jsl.run(mesh8, jcfg, use_pallas_rk4=False)
    got, got_len, got_stats = tsl.run(tcfg, num_ranks=8, seeds=seeds, device="cpu")
    assert got.shape == want.shape == (N, STEPS + 1, 3)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    m = np.isfinite(got)
    assert np.abs(got[m] - want[m]).max() <= 1e-4
    np.testing.assert_array_equal(got_len, want_len)
    assert got_stats == want_stats and got_stats["drops"] == 0
    orc = tsl.oracle(tcfg, seeds=seeds, device="cpu")
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(orc))
    assert np.abs(got[m] - orc[m]).max() <= 5e-4


def test_streamlines_default_seeds_are_deterministic():
    cfg = tsl.StreamlineConfig(num_particles=N, max_steps=8, dt=DT)
    a, la, sa = tsl.run(cfg, device="cpu")
    b, lb, sb = tsl.run(cfg, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert sa == sb and (la >= 1).all()
    lo, hi = 0.5, tsl.TWO_PI - 0.5
    assert ((a[:, 0] >= lo) & (a[:, 0] < hi)).all()


def test_streamlines_rounds_keep_the_collective_budget(monkeypatch):
    """Every forwarding round of the app's drive issues exactly one payload
    and one count all_to_all (read from the context's call recorder), and
    the trace merge after the drive is one pmin."""
    seen = []
    real_init = RafiContext.__init__

    def spy(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        seen.append(self)

    monkeypatch.setattr(RafiContext, "__init__", spy)
    cfg = tsl.StreamlineConfig(num_particles=N, max_steps=6, dt=DT)
    _, _, stats = tsl.run(cfg, device="cpu")
    (ctx,) = seen
    assert ctx.comm.count("all_to_all") == 2 * (stats["rounds"] + 1)
    assert ctx.comm.count("psum") == stats["rounds"] + 1
    assert ctx.comm.count("all_gather") == 0
    assert ctx.comm.count("pmin") == 1
    # the recorder counts calls: one entry per distinct call, not per round
    assert len(ctx.comm.calls) <= 4
