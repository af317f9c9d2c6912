"""The port's VoPaT (§5.1), its scene fields and its counter-based RNG
against the JAX reference.

* ``apps/rng.py`` must equal ``jax.random`` bit for bit (tolerance: none):
  every VoPaT walk is keyed by these bits.
* ``apps/fields.py`` is float arithmetic: within 1e-6 (rtol 1e-6 and atol
  1e-6; torch's and XLA's ``exp`` may differ by an ulp).
* A 16×16 render against the reference render: at least 99% of the pixels
  within 1e-5 and the image means within 1e-4 (a Woodcock walk branches on
  ``u2·mu < density`` and ``t_tgt <= t_exit``, and an ulp of ``exp`` or
  ``log1p`` may flip a rare ray).  The port's own renders at R=1, at R=8
  with the sort marshal and at R=8 with the scatter marshal are equal bit
  for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import fields as JF
from repro.apps import vopat as JV
from repro.core import types as JT
from repro_torch.apps import fields as TF
from repro_torch.apps import rng
from repro_torch.apps import vopat as TV
from repro_torch.core import pack_payload

U32 = lambda a: np.asarray(a).view(np.uint32)
SCENE = dict(width=16, height=16, spp=1, max_bounces=3)


# -------------------------------------------------------------------- rng
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_event_uniforms_equal_jax_random(seed, n):
    """``uniform(fold_in(fold_in(key, pixel), event), (n,))`` for pixels and
    events up to 2**31 - 1 (and negative int32, which wrap): bit-equal."""
    data = np.random.default_rng(seed % 97)
    pixel = np.concatenate([[0, 1, 2**31 - 1, -1], data.integers(-2**31, 2**31 - 1, 60)]).astype(np.int32)
    events = np.concatenate([[0, 2**31 - 1, 2**20, 5], data.integers(0, 2**31 - 1, 60)]).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    want = jax.jit(jax.vmap(lambda p, e: jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, p), e), (n,))))(jnp.asarray(pixel), jnp.asarray(events))
    got = rng.event_uniforms(rng.key_from_seed(seed), torch.from_numpy(pixel), torch.from_numpy(events), n)
    assert got.dtype == torch.float32 and got.shape == (len(pixel), n)
    np.testing.assert_array_equal(U32(got.numpy()), U32(want))


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_key_and_fold_in_words_equal_jax(seed):
    """The key words of ``PRNGKey`` and of ``fold_in``: bit-equal."""
    key = jax.random.PRNGKey(seed)
    tkey = rng.key_from_seed(seed)
    assert [int(tkey[0]), int(tkey[1])] == np.asarray(key).astype(np.int64).tolist()
    data = np.array([0, 9, 2**31 - 1, -7], np.int32)
    k1, k2 = rng.fold_in(tkey, torch.from_numpy(data))
    for i, d in enumerate(data):
        want = np.asarray(jax.random.fold_in(key, jnp.int32(d))).astype(np.int64)
        assert [int(k1[i]), int(k2[i])] == want.tolist()
    with pytest.raises(ValueError, match="seed"):
        rng.key_from_seed(2**31)


# ----------------------------------------------------------------- fields
def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_fields_equal_reference():
    blobs = TF.default_blobs(6, 0)
    assert isinstance(blobs, np.ndarray) and blobs.dtype == np.float32
    np.testing.assert_array_equal(blobs, np.asarray(JF.default_blobs(6, 0)))
    tb, jb = torch.from_numpy(blobs), jnp.asarray(blobs)
    assert TF.majorant(tb) == pytest.approx(JF.majorant(jb), rel=1e-6)
    p = np.random.default_rng(0).uniform(0, 1, (200, 3)).astype(np.float32)
    _close(TF.density(torch.from_numpy(p), tb), JF.density(jnp.asarray(p), jb))
    _close(TF.density_gradient(torch.from_numpy(p), tb), JF.density_gradient(jnp.asarray(p), jb))
    o, d = TF.camera_rays(16, 12)
    jo, jd = JF.camera_rays(16, 12)
    _close(o, jo)
    _close(d, jd)
    _close(TF.sky(d), JF.sky(jd))
    te, hit = TF.ray_domain_entry(o, d)
    jte, jhit = JF.ray_domain_entry(jo, jd)
    _close(te, jte)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))


def test_slab_partition_and_box_exit_equal_reference():
    """Slab arithmetic is exact; the exit axis follows argmin's first
    minimum (ties included)."""
    rs = np.random.default_rng(1)
    part, jpart = TF.SlabPartition(8, 4), JF.SlabPartition(8, 4)
    x = np.concatenate([rs.uniform(-0.1, 1.1, 100), [0.0, 0.125, 0.5, 1.0]]).astype(np.float32)
    np.testing.assert_array_equal(part.slab_of(torch.from_numpy(x)).numpy(), np.asarray(jpart.slab_of(jnp.asarray(x))))
    slab = np.arange(-1, 9, dtype=np.int32)
    np.testing.assert_array_equal(part.owner_of_slab(torch.from_numpy(slab)).numpy(),
                                  np.asarray(jpart.owner_of_slab(jnp.asarray(slab))))
    n = 300
    slab = rs.integers(0, 8, n).astype(np.int32)
    o = rs.uniform(0, 1, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[:20] = [1.0, 0.0, 0.0]  # axis-aligned: zero components, equal exits
    d[20:40] = [0.6, 0.0, -0.8]
    o[20:40] = [0.5, 0.5, 0.5]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rs.uniform(0, 0.2, n).astype(np.float32)
    lo, hi = part.bounds(torch.from_numpy(slab))
    jlo, jhi = jpart.bounds(jnp.asarray(slab))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    got = TF.ray_box_exit(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t), lo, hi)
    want = JF.ray_box_exit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), jlo, jhi)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_write_ppm_equals_reference(tmp_path):
    img = np.random.default_rng(2).uniform(-0.1, 1.1, (5, 7)).astype(np.float32)
    TF.write_ppm(str(tmp_path / "t.ppm"), img)
    JF.write_ppm(str(tmp_path / "j.ppm"), img)
    assert (tmp_path / "t.ppm").read_bytes() == (tmp_path / "j.ppm").read_bytes()


def test_path_ray_packs_like_the_reference():
    """The 11-leaf PathRay packs into the same 15 words (60 B) as the
    reference's, so the queue carries the same bits."""
    rs = np.random.default_rng(4)
    f = {k: rs.normal(size=(6, 3) if k in ("origin", "dir") else (6,)).astype(np.float32)
         for k in ("origin", "dir", "t", "t_tgt", "u2", "throughput")}
    f.update({k: rs.integers(0, 99, 6).astype(np.int32) for k in ("pixel", "events", "bounces", "slab", "in_flight")})
    words, spec = pack_payload(TV.PathRay(**{k: torch.from_numpy(v)[None] for k, v in f.items()}), batch_dims=2)
    jwords, _ = JT.pack_payload(JV.PathRay(**{k: jnp.asarray(v) for k, v in f.items()}))
    assert spec.total_words == 15
    np.testing.assert_array_equal(U32(words[0].numpy()), np.asarray(jwords))


# ------------------------------------------------------------------ render
@pytest.fixture(scope="module")
def jax_render(mesh8):
    return JV.render(mesh8, JV.VopatScene(**SCENE))


@pytest.fixture(scope="module")
def port_renders():
    scene = TV.VopatScene(**SCENE)
    return {
        (r, m): TV.render(scene, num_ranks=r, marshal=m, device="cpu")
        for r, m in ((8, "scatter"), (8, "sort"), (1, "sort"))
    }


def test_render_matches_reference(jax_render, port_renders):
    """≥ 99% of pixels within 1e-5, means within 1e-4 (module docstring);
    same drops; the round counts agree within 2."""
    jimg, jst = jax_render
    img, st = port_renders[(8, "scatter")]
    assert img.shape == jimg.shape == (16, 16) and img.dtype == np.float32
    assert (np.abs(img - jimg) <= 1e-5).mean() >= 0.99
    assert abs(float(img.mean()) - float(jimg.mean())) <= 1e-4
    assert st["drops"] == jst["drops"] == 0
    assert abs(st["rounds"] - jst["rounds"]) <= 2
    assert st["majorant"] == pytest.approx(jst["majorant"], rel=1e-6)


def test_render_is_rank_count_and_marshal_invariant(port_renders):
    """R=1, R=8 sort and R=8 scatter renders: bit-equal (spp=1)."""
    base, _ = port_renders[(8, "scatter")]
    for key in ((8, "sort"), (1, "sort")):
        img, st = port_renders[key]
        assert st["drops"] == 0
        np.testing.assert_array_equal(img, base)


def test_render_image_is_sane(port_renders):
    img, stats = port_renders[(8, "scatter")]
    assert np.isfinite(img).all()
    assert 0.0 <= img.min() and img.max() <= 1.0 + 1e-6
    assert img.std() > 0.01
    assert stats["rounds"] < 512 and stats["capacity"] == 256


def test_spp_accumulation_close():
    """spp=4: deposits of one pixel meet in another order at R=8 than at
    R=1, so the renders agree within 1e-6, as in the reference's test."""
    scene = TV.VopatScene(width=8, height=8, spp=4)
    i1, _ = TV.render(scene, num_ranks=1, device="cpu")
    i8, _ = TV.render(scene, num_ranks=8, marshal="scatter", device="cpu")
    np.testing.assert_allclose(i1, i8, atol=1e-6)


def test_render_onehot_exchange_equals_padded(port_renders):
    img, _ = TV.render(TV.VopatScene(**SCENE), num_ranks=8, exchange="onehot", device="cpu")
    np.testing.assert_array_equal(img, port_renders[(8, "scatter")][0])


def test_render_refuses_telemetry_and_a_missing_card(port_renders):
    # telemetry is ported (Queue 1 item 8): the render is the telemetry-off
    # one and its summary records every round, drop-free
    img, st = TV.render(TV.VopatScene(**SCENE), num_ranks=8, telemetry=True, device="cpu")
    np.testing.assert_array_equal(img, port_renders[(8, "sort")][0])
    assert st["telemetry"]["drops"] == 0 and st["telemetry"]["rounds"] == st["rounds"] + 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TV.render(TV.VopatScene(**SCENE), num_ranks=8)

