"""The port's N-body app (§5.5) against the JAX reference app and its own
oracle.

Both apps start from the same state, drawn in the test with ``jax.random``
exactly as ``repro.apps.nbody`` draws it and passed to the port as ``init``.
The reference runs as ``tests/test_apps.py`` runs it (``nbody.run(mesh,
cfg)``: forces through the Pallas kernel in interpret mode on the CPU), the
port on the CPU through K9's plain version.  Tolerances between the two
packages: totals and drops equal; positions within 1e-5 and velocities
within 1e-4.  XLA and torch sum the forces, the monopoles and the centres of
mass in different orders, so accelerations differ by ulps of their size
(up to ~1e3 here); over 3 steps of dt = 1e-3 that moves a velocity by about
1e-5 at most and a position by about 1e-8.  Against the port's own oracle
the reference's bounds hold: 1e-5 at R = 1 (the same direct sum, padded
with zero-mass sources, which can change the order of torch's reduction)
and 1e-2 at R = 8 (the octant approximation).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.apps import nbody as jnb
from repro_torch.apps import nbody as tnb
from repro_torch.core import StackedCollectives, pack_spec

CFG = dict(num_particles=64, steps=3, dt=1e-3, theta=0.3)


@pytest.fixture(scope="module")
def mesh1():
    return compat.make_mesh((1,), ("data",))


def _jax_init(n, seed=0):
    """The initial state of ``repro.apps.nbody.run``, drawn the same way."""
    key = jax.random.PRNGKey(seed)
    pos0 = jnp.clip(0.5 + 0.15 * jax.random.normal(key, (n, 3)), 0.05, 0.95)
    vel0 = 0.05 * jax.random.normal(jax.random.fold_in(key, 1), (n, 3))
    mass0 = jax.random.uniform(jax.random.fold_in(key, 2), (n,), minval=0.5, maxval=1.5)
    return tuple(np.asarray(a) for a in (pos0, vel0, mass0))


@pytest.mark.parametrize("R", [8, 1], ids=["r8", "r1"])
def test_nbody_matches_reference_app(R, mesh1, mesh8):
    jcfg, tcfg = jnb.NBodyConfig(**CFG), tnb.NBodyConfig(**CFG)
    want_p, want_v, want_s = jnb.run(mesh8 if R == 8 else mesh1, jcfg)
    got_p, got_v, got_s = tnb.run(tcfg, num_ranks=R, init=_jax_init(64), device="cpu")
    assert got_s["totals"] == want_s["totals"] == [64] * 3
    assert got_s["drops"] == want_s["drops"] == 0
    assert got_s["dims"] == tuple(want_s["dims"])
    assert np.abs(got_p - want_p).max() <= 1e-5
    assert np.abs(got_v - want_v).max() <= 1e-4


@pytest.mark.parametrize("R,tol", [(1, 1e-5), (8, 1e-2)], ids=["r1", "r8"])
def test_nbody_matches_own_oracle(R, tol):
    cfg = tnb.NBodyConfig(**CFG)
    init = _jax_init(64)
    p, v, stats = tnb.run(cfg, num_ranks=R, init=init, device="cpu")
    po, vo = tnb.oracle(cfg, init=init, device="cpu")
    assert stats["totals"] == [64] * 3 and stats["drops"] == 0
    assert np.abs(p - po).max() < tol
    assert np.isfinite(v).all()


def test_nbody_item_word_counts():
    """Particle 11 words, VirtualParticle 6, RefinementReq 1 (the byte counts
    of ``tests/test_apps.py``)."""
    for proto, words in ((tnb._p_proto(), 11), (tnb._vp_proto(), 6), (tnb._rq_proto(), 1)):
        assert pack_spec(proto).total_words == words


def test_nbody_call_recorder_per_step(monkeypatch):
    """Per step: 4 rounds (roots, requests, octants, migration), each one
    payload and one count all_to_all and one psum; 2 pmin in the final
    merge.  One recorder records all four contexts."""
    seen = []

    class Spy(StackedCollectives):
        def __init__(self):
            super().__init__()
            seen.append(self)

    monkeypatch.setattr(tnb, "StackedCollectives", Spy)
    steps, R = 2, 8
    tnb.run(tnb.NBodyConfig(num_particles=32, steps=steps, theta=0.3), num_ranks=R, device="cpu")
    (comm,) = seen
    kinds = lambda pred: sum(n for c, n in comm.calls.items() if pred(c))
    assert kinds(lambda c: c.kind == "all_to_all" and len(c.shape) == 4) == 4 * steps  # payload
    assert kinds(lambda c: c.kind == "all_to_all" and c.shape == (R, R, 1)) == 4 * steps  # counts
    assert comm.count("all_to_all") == 8 * steps
    assert comm.count("psum") == 4 * steps
    assert comm.count("pmin") == 2
    assert comm.count("all_gather") == 0
    # three capacities: 64 particles, 72 virtual particles, 8 requests per rank
    widths = {c.shape[2:] for c in comm.calls if c.kind == "all_to_all" and len(c.shape) == 4}
    assert widths == {(64, 11), (72, 6), (8, 1)}


def test_pmin_is_the_minimum_over_ranks():
    comm = StackedCollectives()
    x = torch.tensor([[3.0, -1.0], [2.0, 5.0], [torch.inf, 0.0]])
    assert torch.equal(comm.pmin(x), torch.tensor([2.0, -1.0]))
    assert comm.count("pmin") == 1


def test_nbody_default_init_is_deterministic_and_needs_a_device():
    cfg = tnb.NBodyConfig(num_particles=40, steps=2)
    a = tnb.run(cfg, num_ranks=2, device="cpu")
    b = tnb.run(cfg, num_ranks=2, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2] and a[2]["totals"] == [40, 40]
    pos0, _, mass0 = tnb._initial_state(cfg, None, torch.device("cpu"))
    assert float(pos0.min()) >= 0.05 and float(pos0.max()) <= 0.95
    assert float(mass0.min()) >= 0.5 and float(mass0.max()) < 1.5
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnb.run(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnb.oracle(cfg)


def test_nbody_init_shape_is_checked():
    cfg = tnb.NBodyConfig(num_particles=8, steps=1)
    bad = (np.zeros((8, 3)), np.zeros((8, 3)), np.ones(7))
    with pytest.raises(ValueError, match="mass0"):
        tnb.run(cfg, init=bad, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        tnb.run(cfg, num_ranks=3, device="cpu")
