"""Serving on placed parameters for the dense family (``repro_torch.launch.
placement``'s ``serve_placement`` and ``cache_placement``, the placed
decode of ``repro_torch.models.attention``, ``api.placed_prefill`` /
``placed_decode`` and ``launch.serve.BatchedEngine`` on a placement)
against the JAX reference on the CPU, on the stacked backend.

Inputs are made from a seed with numpy; weights are the reference's
(``build_model(cfg).init(PRNGKey(0))``) carried into the port by
``params_from_jax``.

* Placement, bit for bit: the four text-only dense archs' smoke configs
  with ``fsdp=True`` (which serving must drop) on layouts (2, 4), (4, 2),
  (1, 8) and (8, 1): every rank's block of every parameter and of seeded
  decode caches equals the reference's addressable shard under
  ``build_decode_step``'s shardings (``jax.device_put`` on
  ``make_test_mesh``), compared as 32-bit words.  A planted misplacement
  (``model`` on the caches' kv-head dimension) fails; the refusals raise.
* Decode and prefill: qwen2-7b and gemma3-1b smoke (4 heads, 1 or 2 kv
  heads: the flat split cuts through a head on both layouts), float32, on
  (2, 4) and (1, 8), batch 4, ``max_len`` 16, 12 decode steps from seeded
  caches with the rows at depths 0, 3, 5 and 9 and slot 2 reset after the
  sixth, so that the positions cross every model rank's block, one row
  reaches the clamp at 15, and gemma3's window of 8 straddles block edges.
  The reference is its decode and prefill jitted with
  ``build_decode_step`` / ``build_prefill_step``'s shardings on the mesh
  of the same shape (it runs on JAX 0.9.0).  Logits within 1e-4
  (``tests/test_torch_models.py``'s decode bound); cache blocks within
  1e-4 of the reference's shards, or within ``CACHE_K`` times the
  reference's own gap where that is wider: its sharded decode's caches
  and its unsharded decode's, from the same inputs, lie up to 1.34e-4
  apart for gemma3-1b on (2, 4) (values up to ~20, five layers of float32
  reordering), the port's 1.61e-4 from the sharded ones; ``pos`` bit for
  bit.  gemma3-1b at 8 layers (a stacked period and two tail layers, as
  its 26) on (2, 4) the same way.  Two planted faults fail: the combine
  without the ``exp(m_r - M)`` rescale, and the clamp at T/M - 1.
* The engine: placed on (2, 4), 8 slots, 10 requests (a slot is reused):
  its tokens equal the port's unsharded engine's and the reference
  engine's, token for token.
* Train to serve: a train-placed (FSDP) state saved at (2, 4) restores
  onto the serve placement at (2, 4) and (1, 8), bit for bit against
  ``specs.cut``; a checkpoint the reference wrote from ``mesh24`` too.
* The call budget: one decode step's calls by kind and tier, pinned as a
  function of the layer count.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import save_checkpoint as jsave
from repro.configs import get_smoke_config as jget_smoke
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import BatchedEngine as JEngine
from repro.launch.serve import Request as JRequest
from repro.launch.serve import reset_slot as jreset_slot
from repro.launch.steps import build_decode_step as jbuild_decode_step
from repro.launch.steps import build_prefill_step as jbuild_prefill_step
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.models.api import build_model as jbuild
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import placement as PL
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_test_layout
from repro_torch.launch.serve import BatchedEngine, Request, reset_slot
from repro_torch.models import attention as A
from repro_torch.models.api import build_model, params_from_jax

DENSE = ("qwen2-7b", "glm4-9b", "qwen2.5-14b", "gemma3-1b")
LAYOUTS = ((2, 4), (4, 2), (1, 8), (8, 1))
TOL = 1e-4  # tests/test_torch_models.py's decode bound
B, T, STEPS, RESET = 4, 16, 12, (6, 2)  # batch, max_len, decode steps, (after step, slot) reset
DEPTHS = (0, 3, 5, 9)
CACHE_K = 2  # the caches' bound over the reference's own sharded-against-unsharded gap, where over 1e-4
NP = lambda a: a.detach().cpu().numpy()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(p):
    return tuple(str(k.key) for k in p)


@functools.lru_cache(maxsize=None)
def _pair(arch, fsdp=False, layers=None):
    """(JAX config, port config, JAX params, port LM) of a smoke arch (at
    ``layers`` layers where given)."""
    changes = dict(fsdp=fsdp) if layers is None else dict(fsdp=fsdp, num_layers=layers)
    jcfg = dataclasses.replace(jget_smoke(arch), **changes)
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _words(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a.view(np.uint16)


def _blocks(placed, path):
    for k in path:
        placed = placed[k]
    return placed


def _shards(jtree, placed, mesh):
    """``(path, rank, reference shard, port block)`` over every leaf and
    every device of the mesh (rank ``g·model + m`` at ``mesh.devices[g,
    m]``)."""
    pos = {d.id: (g, m) for (g, m), d in np.ndenumerate(mesh.devices)}
    M = mesh.devices.shape[1]
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        block = _blocks(placed, _path(path))
        assert len(leaf.addressable_shards) == block.shape[0]
        for shard in leaf.addressable_shards:
            g, m = pos[shard.device.id]
            yield _path(path), g * M + m, np.asarray(shard.data), NP(block[g * M + m])


def _shard_diffs(jtree, placed, mesh):
    """``{(path, rank): max |reference shard - port block|}``: inf where
    the shapes differ or integers are not equal."""
    out = {}
    for path, r, want, got in _shards(jtree, placed, mesh):
        if want.shape != got.shape or (want.dtype.kind in "iu" and not np.array_equal(want, got)):
            out[(path, r)] = np.inf
        else:
            out[(path, r)] = float(np.abs(want.astype(np.float64) - got).max(initial=0.0))
    return out


def _mismatches(jtree, placed, mesh):
    """``[(path, rank)]`` whose reference shard and port block differ as
    32-bit words."""
    return [(path, r) for path, r, want, got in _shards(jtree, placed, mesh)
            if want.shape != got.shape or not np.array_equal(_words(want), _words(got))]


def _seeded_caches(jmodel, batch, max_len, depths, seed):
    """Decode caches (numpy leaves) with seeded k, v and the given depths."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        if _path(path)[-1] == "pos":
            return np.broadcast_to(np.asarray(depths, np.int32), a.shape).copy()
        return rng.standard_normal(a.shape).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(lambda: jmodel.init_caches(batch, max_len)))


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------- placement
@pytest.mark.parametrize("d,m", LAYOUTS)
@pytest.mark.parametrize("arch", DENSE)
def test_serve_placement_equals_the_reference_shards(arch, d, m):
    jcfg, cfg, jp, lm = _pair(arch, fsdp=True)
    jmodel, model, mesh = jbuild(jcfg), build_model(cfg), make_test_mesh(d, m)
    _, shardings = jbuild_decode_step(jmodel, mesh, batch=8, max_len=T)
    jparams = jax.device_put(jp, shardings["params"])
    caches = _seeded_caches(jmodel, 8, T, (0, 1, 2, 3, 4, 5, 6, 7), seed=d * 10 + m)
    jcaches = jax.device_put(caches, shardings["caches"])
    layout = make_test_layout(d, m)
    sp, cp = PL.serve_placement(model, layout), PL.cache_placement(model, layout, 8, T)
    params, placed_caches = sp.place(lm), cp.place(_to_torch(caches))
    assert PL.is_placed(params) and PL.is_placed(placed_caches)
    assert _mismatches(jparams, params, mesh) == []
    assert _mismatches(jcaches, placed_caches, mesh) == []
    # serving drops FSDP: nothing is split over data, so unshard gathers nothing
    assert not any(S.DATA in S.spec_axes(part) for spec in sp.specs.values() for part in spec)
    ranks = sp.ranks("cpu")
    assert all(a is b for a, b in zip(jax.tree.leaves(sp.unshard(params, ranks)), jax.tree.leaves(dict(params))))
    for pl, placed in ((sp, params), (cp, placed_caches)):
        for path, spec in pl.specs.items():
            leaf = _blocks(placed, path)
            whole = torch.empty(pl.shapes[path], dtype=leaf.dtype, device="meta")
            assert leaf[0].numel() * leaf.element_size() == S.device_bytes(whole, spec, pl.axes), path
    # zero caches made placed have the placed caches' shapes and dtypes
    zeros = cp.zeros("cpu")
    for path in cp.paths:
        z, p = _blocks(zeros, path), _blocks(placed_caches, path)
        assert z.shape == p.shape and z.dtype == p.dtype and not z.any()
    # and back, bit for bit
    for path, leaf in S.named_leaves(cp.gather(placed_caches)):
        assert np.array_equal(NP(leaf), np.asarray(_blocks(caches, path))), path


def test_a_planted_cache_misplacement_fails():
    """``model`` on the caches' kv-head dimension instead of the sequence
    (layout (4, 2), where 2 kv heads split): the k and v blocks no longer
    equal the reference's shards."""
    jcfg, cfg, _, _ = _pair("qwen2-7b")
    jmodel, mesh = jbuild(jcfg), make_test_mesh(4, 2)
    _, shardings = jbuild_decode_step(jmodel, mesh, batch=8, max_len=T)
    caches = _seeded_caches(jmodel, 8, T, tuple(range(8)), seed=3)
    jcaches = jax.device_put(caches, shardings["caches"])
    cp = PL.cache_placement(build_model(cfg), make_test_layout(4, 2), 8, T)
    moved = {p: (None, S.DATA, None, S.MODEL, None) for p in cp.paths if p[-1] in ("k", "v")}
    bad = dataclasses.replace(cp, specs={**cp.specs, **moved})
    assert _mismatches(jcaches, cp.place(_to_torch(caches)), mesh) == []
    assert {p for p, _r in _mismatches(jcaches, bad.place(_to_torch(caches)), mesh)} == set(moved)


def test_refusals():
    """The caches where ``model`` leaves the sequence or ``data`` the slots,
    an engine whose slots do not split over the data groups, and the
    encoder-decoder split over ``model``: its smoke config places on (2,
    4); the full config without ``dp_over_model`` is refused there (its
    vocabulary of 256,206 takes a ``model`` of 1 or 2) and places on (4,
    2)."""
    _, cfg, _, lm = _pair("qwen2-7b")
    model = build_model(cfg)
    tp = build_model(get_smoke_config("seamless-m4t-medium"))
    assert PL.serve_placement(tp, make_test_layout(2, 4)).specs
    assert PL.cache_placement(tp, make_test_layout(2, 4), 4, 16).specs
    full = build_model(dataclasses.replace(get_config("seamless-m4t-medium"), dp_over_model=False))
    with pytest.raises(ValueError, match=r"embed \(256206, 1024\): the model axis \(4\) does not divide the "
                                         r"vocabulary \(256206\)"):
        PL.serve_placement(full, make_test_layout(2, 4))
    assert PL.serve_placement(full, make_test_layout(4, 2)).specs
    with pytest.raises(ValueError, match="model axis moves off the sequence"):
        PL.cache_placement(model, make_test_layout(2, 4), 4, 18)
    with pytest.raises(ValueError, match="data axis moves off the slots"):
        PL.cache_placement(model, make_test_layout(2, 4), 3, 16)
    params = PL.serve_placement(model, make_test_layout(2, 4)).place(lm)
    with pytest.raises(ValueError, match="do not split over 2 data groups"):
        BatchedEngine(model, params, slots=5, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="differs from the placed parameters"):
        BatchedEngine(model, params, slots=4, max_len=16, layout=make_test_layout(1, 8), device="cpu")
    caches = model.init_caches(4, 16, device="cpu")
    with pytest.raises(ValueError, match="placed caches"):
        model.decode_fn()(params, torch.zeros((4, 1), dtype=torch.int32), caches)


# ------------------------------------------------------- decode and prefill
def _tokens(vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (B, 1)).astype(np.int32) for _ in range(STEPS)]


def _reference_steps(step, params, caches, vocab, put=lambda c: c):
    logits = []
    for i, tok in enumerate(_tokens(vocab, 8)):
        out, caches = step(params, jnp.asarray(tok), caches)
        logits.append(np.asarray(out))
        if i + 1 == RESET[0]:
            caches = put(jreset_slot(caches, RESET[1]))
    return np.stack(logits), caches


@functools.lru_cache(maxsize=None)
def _reference_decode(arch, d, m, layers=None):
    """The reference's decode jitted with its shardings on a (d, m) mesh,
    from seeded caches: each step's logits, the caches at the end, the
    mesh, and the largest |difference| of those caches from the ones its
    unsharded jitted decode ends with."""
    jcfg, _, jp, _ = _pair(arch, layers=layers)
    jmodel, mesh = jbuild(jcfg), make_test_mesh(d, m)
    fn, shardings = jbuild_decode_step(jmodel, mesh, batch=B, max_len=T)
    step = jax.jit(fn, in_shardings=(shardings["params"], None, shardings["caches"]),
                   out_shardings=(None, shardings["caches"]))
    start = _seeded_caches(jmodel, B, T, DEPTHS, seed=7)
    put = lambda c: jax.device_put(c, shardings["caches"])
    logits, caches = _reference_steps(step, jax.device_put(jp, shardings["params"]), put(start), jcfg.vocab_size, put)
    _, whole = _reference_steps(jax.jit(fn), jp, jax.tree.map(jnp.asarray, start), jcfg.vocab_size)
    own = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(jax.tree.leaves(caches),
                                                                                  jax.tree.leaves(whole)))
    return logits, caches, mesh, own


def _port_decode(arch, d, m, layers=None):
    jcfg, cfg, _, lm = _pair(arch, layers=layers)
    model, layout = build_model(cfg), make_test_layout(d, m)
    params = PL.serve_placement(model, layout).place(lm)
    cp = PL.cache_placement(model, layout, B, T)
    caches = cp.place(_to_torch(_seeded_caches(jbuild(jcfg), B, T, DEPTHS, seed=7)))
    step = model.decode_fn()
    logits = []
    for i, tok in enumerate(_tokens(cfg.vocab_size, 8)):
        out, caches = step(params, torch.from_numpy(tok), caches)
        logits.append(NP(out))
        if i + 1 == RESET[0]:
            caches = reset_slot(caches, RESET[1])
    return np.stack(logits), caches


def _decode_gaps(arch, d, m, layers=None):
    """(max |logit difference|, max |cache difference| over k and v
    blocks, ``pos`` bit-equal) of the port's placed decode against the
    reference's sharded decode."""
    want, jcaches, mesh, _ = _reference_decode(arch, d, m, layers)
    got, caches = _port_decode(arch, d, m, layers)
    diffs = _shard_diffs(jcaches, caches, mesh)
    kv = max(v for (p, _r), v in diffs.items() if p[-1] in ("k", "v"))
    pos_equal = all(v == 0.0 for (p, _r), v in diffs.items() if p[-1] == "pos")
    return float(np.abs(got - want).max()), kv, pos_equal


@pytest.mark.parametrize("d,m", [(2, 4), (1, 8)])
@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma3-1b"])
def test_placed_decode_equals_the_reference_sharded_decode(arch, d, m):
    logit_gap, cache_gap, pos_equal = _decode_gaps(arch, d, m)
    own = _reference_decode(arch, d, m)[3]
    assert logit_gap <= TOL and cache_gap <= max(TOL, CACHE_K * own) and pos_equal, \
        (logit_gap, cache_gap, own, pos_equal)
    # the rows wrote positions 0 to 15, every model rank's block, and two
    # were held at the clamp; slot 2 restarted after its reset
    jcaches = _reference_decode(arch, d, m)[1]
    assert np.asarray(next(iter(jcaches["blocks"].values()))["pos"])[0].tolist() == [12, 15, 6, 15]


def test_placed_decode_through_tail_layers_equals_the_reference():
    """gemma3-1b smoke at 8 layers on (2, 4): one stacked period of six
    and two tail layers (as the config's 26 = 4 x 6 + 2), whose caches
    are unstacked leaves under ``tail``, held as above."""
    logit_gap, cache_gap, pos_equal = _decode_gaps("gemma3-1b", 2, 4, layers=8)
    _, jcaches, _, own = _reference_decode("gemma3-1b", 2, 4, 8)
    assert logit_gap <= TOL and cache_gap <= max(TOL, CACHE_K * own) and pos_equal, \
        (logit_gap, cache_gap, own, pos_equal)
    assert sorted(jcaches["tail"]) == ["k0_local", "k1_local"]
    assert all(np.asarray(c["pos"]).tolist() == [12, 15, 6, 15] for c in jcaches["tail"].values())


@pytest.mark.parametrize("d,m", [(2, 4), (1, 8)])
@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma3-1b"])
def test_placed_prefill_equals_the_reference_sharded_prefill(arch, d, m):
    jcfg, cfg, jp, lm = _pair(arch)
    fn, shardings = jbuild_prefill_step(jbuild(jcfg), make_test_mesh(d, m))
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, 12)).astype(np.int32)
    want = np.asarray(jax.jit(fn, in_shardings=(shardings["params"], None))(
        jax.device_put(jp, shardings["params"]), {"tokens": jnp.asarray(tokens)}))
    model = build_model(cfg)
    params = PL.serve_placement(model, make_test_layout(d, m)).place(lm)
    got = NP(model.prefill_fn()(params, {"tokens": torch.from_numpy(tokens)}))
    assert got.shape == want.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _without_rescale(m, l, acc, ranks):
    """The combine with each rank's partials summed as they are."""
    from repro_torch.models import parallel as P

    parts = P.psum_model(torch.cat([acc, l], dim=-1), ranks)
    return parts[..., :-1] / parts[..., -1:]


@pytest.mark.parametrize("fault", ["no_rescale", "clamp_at_the_block"])
def test_planted_decode_faults_fail(monkeypatch, fault):
    """Each planted fault moves the placed decode out of its bounds
    against the reference: the logits (the combine), or ``pos`` (the
    clamp at T/M - 1)."""
    d, m = 2, 4
    if fault == "no_rescale":
        monkeypatch.setattr(A, "_combine", _without_rescale)
    else:
        advance = A._advance
        monkeypatch.setattr(A, "_advance", lambda pos, length: advance(pos, length // m))
    logit_gap, cache_gap, pos_equal = _decode_gaps("qwen2-7b", d, m)
    own = _reference_decode("qwen2-7b", d, m)[3]
    assert not (logit_gap <= TOL and cache_gap <= max(TOL, CACHE_K * own) and pos_equal), \
        (logit_gap, cache_gap, pos_equal)
    if fault == "no_rescale":
        assert logit_gap > 100 * TOL
    else:
        assert not pos_equal


# --------------------------------------------------------------- the engine
def _requests(cfg, cls, n=10, seed=11):
    rng = np.random.default_rng(seed)
    specs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(2, 9))).astype(np.int32), int(rng.integers(2, 8)))
             for _ in range(n)]
    return [cls(rid=i, prompt=p, max_new_tokens=k) for i, (p, k) in enumerate(specs)]


def test_placed_engine_tokens_equal_the_unsharded_and_the_reference():
    jcfg, cfg, jp, lm = _pair("qwen2-7b")
    model = build_model(cfg)
    params = PL.serve_placement(model, make_test_layout(2, 4)).place(lm)
    engine = BatchedEngine(model, params, slots=8, max_len=32, device="cpu")
    placed = engine.run(_requests(cfg, Request))
    assert engine.cache_placement is not None and engine.steps > 0
    whole = BatchedEngine(model, lm, slots=8, max_len=32, device="cpu").run(_requests(cfg, Request))
    ref = JEngine(jbuild(jcfg), jp, slots=8, max_len=32).run(_requests(jcfg, JRequest))
    assert placed == whole == ref
    assert sum(map(len, placed.values())) == sum(r.max_new_tokens for r in _requests(cfg, Request))


def test_reset_slot_on_placed_caches():
    """Slot s of 8 on (2, 4) is row ``s % 4`` of data group ``s // 4``:
    reset on that group's four model ranks only, out of place."""
    _, cfg, _, _ = _pair("qwen2-7b")
    cp = PL.cache_placement(build_model(cfg), make_test_layout(2, 4), 8, T)
    caches = cp.zeros("cpu")
    for path in cp.paths:
        if path[-1] == "pos":
            _blocks(caches, path).fill_(5)
    fresh = reset_slot(caches, 6)
    assert PL.is_placed(fresh) and fresh.placement is cp
    pos = fresh["blocks"]["k0_global"]["pos"]  # (8 ranks, 2 layers, 4 rows)
    want = torch.full_like(pos, 5)
    want[4:, :, 2] = 0
    assert torch.equal(pos, want) and int(caches["blocks"]["k0_global"]["pos"].min()) == 5
    assert fresh["blocks"]["k0_global"]["k"] is caches["blocks"]["k0_global"]["k"]


# ------------------------------------------------------------ train to serve
def _same_blocks(got, lm, placement):
    ids = placement.layout.local_ranks().tolist()
    whole = lm.tree()
    for path, spec in placement.specs.items():
        want = S.cut(_blocks(whole, path), spec, placement.axes, ids)
        g = _blocks(got, path)
        assert g.shape == want.shape and torch.equal(g, want), path


def test_train_state_restores_onto_the_serve_placement(tmp_path, mesh24):
    """A train-placed (FSDP) state saved at (2, 4) restores onto the serve
    placement at (2, 4) and (1, 8), and so does the reference's checkpoint
    of its train-sharded parameters: bit for bit against ``specs.cut``."""
    jcfg, cfg, jp, lm = _pair("qwen2-7b", fsdp=True)
    model = build_model(cfg)
    train = PL.train_placement(model, make_test_layout(2, 4))
    save_checkpoint(tmp_path / "port", 2, {"params": train.place(lm)})
    _, shardings = jbuild_train_step(jbuild(jcfg), mesh24)
    jsave(tmp_path / "jax", 2, {"params": jax.device_put(jp, shardings["params"])})
    like = {"params": jax.tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), lm.tree())}
    for src in ("port", "jax"):
        for d, m in ((2, 4), (1, 8)):
            serve = PL.serve_placement(model, make_test_layout(d, m))
            got = restore_checkpoint(tmp_path / src, 2, like, device="cpu", shardings={"params": serve})
            assert PL.is_placed(got["params"]) and got["params"].placement is serve
            _same_blocks(got["params"], lm, serve)


# ------------------------------------------------------------ the call budget
def _one_decode_calls(layers):
    cfg = dataclasses.replace(get_smoke_config("qwen2-7b"), num_layers=layers)
    model, layout = build_model(cfg), make_test_layout(2, 4)
    sp = PL.serve_placement(model, layout)
    params = sp.place(model.init(torch.Generator().manual_seed(0), device="cpu"))
    caches = PL.cache_placement(model, layout, B, T).zeros("cpu")
    sp.comm.reset()
    model.decode_fn()(params, torch.zeros((B, 1), dtype=torch.int32), caches)
    counts = {}
    for call, n in sp.comm.calls.items():
        counts[(call.kind, call.tier)] = counts.get((call.kind, call.tier), 0) + n
    return counts


def test_one_decode_step_call_budget():
    """One decode step of qwen2-7b smoke on (2, 4), at 2 and 4 layers.
    Over ``model`` (tier 1), a layer: the q and the (k, v) ``all_gather``,
    the maxima's ``all_gather``, the partials' ``psum``, and the two
    row-parallel ``psum``s; besides, the embedding's ``psum`` and the
    logits' ``all_gather`` of the vocabulary.  Over ``data`` (tier 0): the
    logits' rows, one ``all_gather``.  Nothing else."""
    for layers in (2, 4):
        counts = _one_decode_calls(layers)
        assert counts == {("all_gather", 1): 3 * layers + 1, ("psum", 1): 3 * layers + 1, ("all_gather", 0): 1}, \
            (layers, counts)


def test_chip_smoke_phase_serve_shard_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.phase_serve_shard`` at a small width on the CPU (gloo at
    a world of one for its engine on the distributed backend): every check
    passes."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    monkeypatch.setattr(cs, "FAILURES", [])
    widths = dict(d_model=64, num_heads=8, num_kv_heads=4, head_dim=8, d_ff=128, vocab_size=512)
    out, paths = cs.phase_serve_shard(torch.device("cpu"), LAYERS=2, SLOTS=8, MAX_LEN=32, N_REQ=6, PROMPT=(2, 6),
                                      NEW=(2, 5), LONG=64, LONG_POS=60, PREFILL=(2, 32), CHECK_STEPS=8, widths=widths,
                                      profile=False)
    assert cs.FAILURES == [] and not any(paths["serve_shard"].values())
    assert out["placed_engine"]["calls_per_step"] == out["nccl_engine"]["calls_per_step"]
    assert len(set(out["param_bytes_per_rank"])) == 1 and out["float32_check"]["blocks_crossed"] == [0, 1, 2, 3]
