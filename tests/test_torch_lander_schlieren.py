"""The port's §5.2 lander and §5.3 schlieren apps (``repro_torch.apps.lander``,
``repro_torch.apps.schlieren``) against the JAX package's, at the 16×16
scenes of ``tests/test_apps.py`` (32 slabs, 4 samples a slab).

* Forwarding lander and schlieren images within 1e-5 of JAX's (measured on
  this CPU: lander 3.3e-7, schlieren u 5.4e-7 and v 7.2e-7; the raw
  schlieren integrals, up to ~15 in size, within 1e-5, measured 4.8e-6),
  the same rounds and no drop: the blob sums run in another order (the
  port's are sequential, XLA's reduce), so bits may differ in the last
  place.
* Deep compositing at ``max_fragments`` 4 and 1: ``dropped_fragments``
  equal to JAX's exactly, images within 1e-5 of JAX's; at 4 it agrees with
  the forwarding image within 1e-5, at 1 it does not (above 1e-3).
* R-invariance bit for bit on the port (R = 1, 2, 4, 8), the onehot
  exchange equal to the padded one bit for bit, and the knife edges
  differing.

The JAX renders are module-scoped fixtures: each program compiles once.
"""
import numpy as np
import pytest

from repro.apps import lander as JL
from repro.apps import schlieren as JS
from repro_torch.apps import lander as L
from repro_torch.apps import schlieren as S
from repro_torch.core import pack_spec

TOL = 1e-5
_SCENE = dict(width=16, height=16, num_slabs=32, samples_per_slab=4)


@pytest.fixture(scope="module")
def jax_lander():
    from repro import compat

    mesh8 = compat.make_mesh((8,), ("data",))
    scene = JL.LanderScene(**_SCENE)
    fwd = JL.render_forwarding(mesh8, scene)
    dc = {f: JL.render_deep_compositing(mesh8, scene, max_fragments=f) for f in (1, 4)}
    return fwd, dc


@pytest.fixture(scope="module")
def jax_schlieren():
    from repro import compat

    return JS.render(compat.make_mesh((8,), ("data",)), JS.SchlierenScene(**_SCENE))


@pytest.fixture(scope="module")
def port_lander():
    return {r: L.render_forwarding(L.LanderScene(**_SCENE), num_ranks=r, device="cpu") for r in (1, 2, 4, 8)}


@pytest.fixture(scope="module")
def port_schlieren():
    return {r: S.render(S.SchlierenScene(**_SCENE), num_ranks=r, device="cpu") for r in (1, 2, 4, 8)}


def test_rays_are_twelve_words():
    assert pack_spec(L._proto()).total_words == 12
    assert pack_spec(S._proto()).total_words == 12


def test_lander_forwarding_within_tolerance_of_jax(jax_lander, port_lander):
    (jimg, jst), _dc = jax_lander
    img, st = port_lander[8]
    assert img.shape == jimg.shape == (16, 16) and img.dtype == np.float32
    assert st == jst == {"rounds": st["rounds"], "drops": 0}
    np.testing.assert_allclose(img, jimg, rtol=0, atol=TOL)


@pytest.mark.parametrize("num_ranks", [2, 4, 8])
def test_lander_forwarding_r_invariant_bitwise(port_lander, num_ranks):
    np.testing.assert_array_equal(port_lander[num_ranks][0], port_lander[1][0])
    assert port_lander[num_ranks][1]["drops"] == 0


@pytest.mark.parametrize("max_fragments", [1, 4])
def test_deep_compositing_equals_jax(jax_lander, port_lander, max_fragments):
    _fwd, dc = jax_lander
    jimg, jst = dc[max_fragments]
    img, st = L.render_deep_compositing(L.LanderScene(**_SCENE), num_ranks=8, max_fragments=max_fragments,
                                        device="cpu")
    assert st == jst  # a count: equal exactly
    np.testing.assert_allclose(img, jimg, rtol=0, atol=TOL)
    fwd = port_lander[8][0]
    if max_fragments == 4:  # num_slabs / R = 4 segments a rank: nothing dropped
        assert st["dropped_fragments"] == 0
        np.testing.assert_allclose(img, fwd, rtol=0, atol=TOL)
    else:  # the §5.2 artifacts
        assert st["dropped_fragments"] > 0 and np.abs(img - fwd).max() > 1e-3


def test_lander_onehot_equals_padded(port_lander):
    img, st = L.render_forwarding(L.LanderScene(**_SCENE), num_ranks=8, exchange="onehot", device="cpu")
    np.testing.assert_array_equal(img, port_lander[8][0])
    assert st == port_lander[8][1]


def test_schlieren_within_tolerance_of_jax(jax_schlieren, port_schlieren):
    ju, jv, jst = jax_schlieren
    u, v, st = port_schlieren[8]
    assert (st["rounds"], st["drops"]) == (jst["rounds"], jst["drops"]) == (st["rounds"], 0)
    np.testing.assert_allclose(u, ju, rtol=0, atol=TOL)
    np.testing.assert_allclose(v, jv, rtol=0, atol=TOL)
    np.testing.assert_allclose(st["raw"], jst["raw"], rtol=0, atol=TOL)


@pytest.mark.parametrize("num_ranks", [2, 4, 8])
def test_schlieren_r_invariant_bitwise(port_schlieren, num_ranks):
    u1, v1, _ = port_schlieren[1]
    u, v, st = port_schlieren[num_ranks]
    np.testing.assert_array_equal(u, u1)
    np.testing.assert_array_equal(v, v1)
    assert st["drops"] == 0


def test_schlieren_knife_edges_differ(port_schlieren):
    u, v, _ = port_schlieren[8]
    assert np.abs(u - v).max() > 0.01


def test_schlieren_camera_axes_equal_jax():
    ju, jv = JS._camera_axes()
    u, v = S._camera_axes("cpu")
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
