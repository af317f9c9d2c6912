"""The recurrent families on placed parameters (``repro_torch.launch.
placement`` for ``kind`` "hybrid" and "ssm", ``models.griffin.
griffin_block_placed`` and ``models.rwkv6.rwkv_block_placed``, the placed
train step, prefill, decode and ``BatchedEngine``) against the JAX
reference on the CPU, on the stacked backend.

Inputs are made from a seed with numpy; weights are the reference's
(``build_model(cfg).init(PRNGKey(0))``) carried into the port by
``params_from_jax``.  The smoke configs: recurrentgemma-2b (3 layers:
recurrent, recurrent, local; d_rnn 64; 4 q heads and 1 kv head, window 8)
and rwkv6-3b (2 layers, 4 heads of 16).

* Placement, bit for bit: the train placement with ``fsdp`` on and off
  (with seeded AdamW moments) and the serve placement with seeded decode
  caches (griffin's ``h`` and ``conv``, rwkv's state, the local layer's
  ``k``/``v``/``pos``) on layouts (2, 4), (4, 2) and (8, 1), and (1, 8)
  for recurrentgemma: every rank's block equals the reference's
  addressable shard under ``build_train_step`` / ``build_decode_step``'s
  shardings (``jax.device_put`` on ``make_test_mesh``), compared as 32-bit
  words; a rank's bytes are ``specs.device_bytes``.  A planted
  misplacement (griffin's ``wr`` and ``wi`` split on their rows) fails;
  the refusals raise.
* The train step: both archs, ``fsdp=True``, ``microbatches`` 1 and 2, on
  (2, 4), against the reference's step jitted on ``mesh24`` with its
  shardings and against the port's unsharded step: loss within 1e-5,
  gnorm within 5e-4 relative, every gathered parameter within lr / 2
  (``tests/test_torch_shard.py``'s bounds), over ``STEPS`` steps.
* Decode and prefill: both archs on (2, 4), batch 4, ``max_len`` 16, 12
  decode steps from seeded caches with the rows at depths 0, 3, 5 and 9
  and slot 2 reset after the sixth (its ``pos`` only: the recurrent state
  stays, as the reference's ``reset_slot`` leaves it), against the
  reference's decode and prefill jitted with ``build_decode_step`` /
  ``build_prefill_step``'s shardings: logits within 1e-4; every cache
  block within 1e-4 of the reference's shard, or within ``CACHE_K`` times
  the reference's own gap between its sharded and unsharded decodes where
  that is wider; ``pos`` bit for bit.
* The planted ξ fault: griffin's gates from the rank's own ξ columns
  alone (the other ranks' channels zero in the gathered ξ) fail the logits
  bound.
* The engine: placed on (2, 4), 8 slots, 10 requests (slots reused): its
  tokens equal the port's unsharded engine's and the reference engine's.
* The call budget: one placed decode step's calls by kind and tier,
  pinned as a function of the layer count.
* The checkpoint: rwkv6's ``train(place=True)`` on (2, 4) writes a
  checkpoint that restores onto (4, 2), bit for bit against its rule.
* The CPU rehearsal of ``chip_smoke.phase_recurrent_shard``, and the
  sweep that splits a profiled step by part on the card
  (``chip_smoke._ranged_kernels``) on stand-in events.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import BatchedEngine as JEngine
from repro.launch.serve import Request as JRequest
from repro.launch.serve import reset_slot as jreset_slot
from repro.launch.steps import build_decode_step as jbuild_decode_step
from repro.launch.steps import build_prefill_step as jbuild_prefill_step
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.models.api import build_model as jbuild
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch.ckpt import restore_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import placement as PL
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_test_layout
from repro_torch.launch.serve import BatchedEngine, Request, reset_slot
from repro_torch.launch.steps import build_train_step
from repro_torch.models import griffin as G
from repro_torch.models import parallel as P
from repro_torch.models.api import build_model, params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init

ARCHS = ("recurrentgemma-2b", "rwkv6-3b")
LAYOUTS = ((2, 4), (4, 2), (8, 1), (1, 8))
OPT = dict(lr=1e-3, warmup_steps=2, eps=1e-6)
STEPS = 2
TOL = 1e-4  # tests/test_torch_models.py's decode bound
CACHE_K = 2  # the caches' bound over the reference's own sharded-against-unsharded gap, where over 1e-4
B, T, DECODE_STEPS, RESET = 4, 16, 12, (6, 2)  # batch, max_len, decode steps, (after step, slot) reset
DEPTHS = (0, 3, 5, 9)
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
def _weights(arch):
    """The reference's seed-0 weights of a smoke arch: FSDP and the
    microbatches change no parameter's shape or draw."""
    return jbuild(jget_smoke(arch)).init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _pair(arch, fsdp=False, micro=1):
    """(JAX config, port config, JAX params, port LM) of a smoke arch."""
    changes = dict(fsdp=fsdp, microbatches=micro)
    jcfg = dataclasses.replace(jget_smoke(arch), **changes)
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    jp = _weights(arch)
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
    every device (rank ``g·model + m`` at ``mesh.devices[g, m]``)."""
    pos = {d.id: (g, m) for (g, m), d in np.ndenumerate(mesh.devices)}
    M_ = mesh.devices.shape[1]
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        block = _blocks(placed, _path(path))
        assert len(leaf.addressable_shards) == block.shape[0]
        for shard in leaf.addressable_shards:
            g, m = pos[shard.device.id]
            yield _path(path), g * M_ + m, np.asarray(shard.data), NP(block[g * M_ + m])


def _mismatches(jtree, placed, mesh):
    """``[(path, rank)]`` whose reference shard and port block differ as
    32-bit words."""
    return [(path, r) for path, r, want, got in _shards(jtree, placed, mesh)
            if want.shape != got.shape or not np.array_equal(_words(want), _words(got))]


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


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _seeded_caches(jmodel, batch, max_len, depths, seed):
    """Decode caches (numpy leaves): seeded states and k, v, the given
    depths."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        if _path(path)[-1] == "pos":
            return np.broadcast_to(np.asarray(depths, np.int32), a.shape).copy()
        return rng.standard_normal(a.shape).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(lambda: jmodel.init_caches(batch, max_len)))


def _moments(jp, seed):
    """An AdamW state with seeded moments (zeros would place trivially)."""
    rng = np.random.default_rng(seed)
    mom = lambda: jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)
    return {"m": mom(), "v": mom(), "step": np.asarray(3, np.int32)}


def _bytes_are_the_rule(placement, placed):
    for path, spec in placement.specs.items():
        leaf = _blocks(placed, path)
        whole = torch.empty(placement.shapes[path], dtype=leaf.dtype, device="meta")
        assert leaf[0].numel() * leaf.element_size() == S.device_bytes(whole, spec, placement.axes), path


# ---------------------------------------------------------------- placement
PLACE_CASES = [(a, d, m) for a in ARCHS for d, m in LAYOUTS if not (a == "rwkv6-3b" and m > 4)]


@pytest.mark.parametrize("state", ["train", "train_fsdp", "serve"])
@pytest.mark.parametrize("arch,d,m", PLACE_CASES)
def test_placement_equals_the_reference_shards(arch, d, m, state):
    jcfg, cfg, jp, lm = _pair(arch, fsdp=state == "train_fsdp")
    jmodel, model, mesh, layout = jbuild(jcfg), build_model(cfg), make_test_mesh(d, m), make_test_layout(d, m)
    if state == "serve":
        _, shardings = jbuild_decode_step(jmodel, mesh, batch=8, max_len=T)
        caches = _seeded_caches(jmodel, 8, T, tuple(range(8)), seed=d * 10 + m)
        placement, cp = PL.serve_placement(model, layout), PL.cache_placement(model, layout, 8, T)
        placed_caches = cp.place(_to_torch(caches))
        assert _mismatches(jax.device_put(caches, shardings["caches"]), placed_caches, mesh) == []
        _bytes_are_the_rule(cp, placed_caches)
        zeros = cp.zeros("cpu")
        for path in cp.paths:
            z, p = _blocks(zeros, path), _blocks(placed_caches, path)
            assert z.shape == p.shape and z.dtype == p.dtype and not z.any()
        for path, leaf in S.named_leaves(cp.gather(placed_caches)):
            assert np.array_equal(NP(leaf), np.asarray(_blocks(caches, path))), path
        state_kind = "rwkv" if arch == "rwkv6-3b" else "recurrent"
        for path, spec in cp.specs.items():  # the states: slots over data, channels or heads over model
            if path[1].endswith(state_kind):
                want = (None, S.DATA) + ((None,) if path[-1] == "conv" else ()) + (S.MODEL,)
                assert spec[:len(want)] == want, (path, spec)
    else:
        _, shardings = jbuild_train_step(jmodel, mesh)
        placement = PL.train_placement(model, layout)
        jopt = _moments(jp, seed=d * 10 + m)
        jstate = jax.device_put(jopt, shardings["opt"])
        state_ = placement.place(_to_torch(jopt))
        for k in ("m", "v"):
            assert PL.is_placed(state_[k]) and _mismatches(jstate[k], state_[k], mesh) == []
    params = placement.place(lm)
    assert _mismatches(jax.device_put(jp, shardings["params"]), params, mesh) == []
    _bytes_are_the_rule(placement, params)
    for path, leaf in S.named_leaves(placement.gather(params)):
        assert torch.equal(leaf, _blocks(lm.tree(), path)), path


def test_a_planted_misplacement_fails():
    """griffin's ``wr`` and ``wi`` split over ``model`` on their rows (the
    contraction) instead of their columns on (2, 4): exactly those blocks
    leave the reference's shards."""
    jcfg, cfg, jp, lm = _pair("recurrentgemma-2b")
    mesh = make_test_mesh(2, 4)
    _, shardings = jbuild_train_step(jbuild(jcfg), mesh)
    placement = PL.train_placement(build_model(cfg), make_test_layout(2, 4))
    moved = {p: (None, S.MODEL, None) for p in placement.paths if p[-2:-1] == ("rglru",) and p[-1] in ("wr", "wi")}
    assert len(moved) == 4
    bad = dataclasses.replace(placement, specs={**placement.specs, **moved})
    jparams = jax.device_put(jp, shardings["params"])
    assert _mismatches(jparams, placement.place(lm), mesh) == []
    assert {p for p, _r in _mismatches(jparams, bad.place(lm), mesh)} == set(moved)


def test_refusals():
    """rwkv6 where ``model`` does not divide its heads (4 heads on (1, 8)),
    griffin where it does not divide d_rnn, the caches where ``model``
    moves off the heads or the channels; the encoder-decoder split over
    ``model`` places (its smoke config on (2, 4), the full config without
    ``dp_over_model`` on (4, 2) but not on (2, 4), where ``model`` does not
    divide its vocabulary), as do qwen2-vl and the encoder-decoder under
    ``dp_over_model``."""
    _, cfg, _, _ = _pair("rwkv6-3b")
    for fn in (PL.train_placement, PL.serve_placement):
        with pytest.raises(ValueError, match=r"blocks.k0_rwkv.rwkv.u \(2, 4, 16\): the model axis \(8\) does not "
                                             r"divide the 4 heads"):
            fn(build_model(cfg), make_test_layout(1, 8))
    with pytest.raises(ValueError, match=r"blocks.k0_rwkv \(2, 4, 4, 16, 16\): the model axis moves off the heads"):
        PL.cache_placement(build_model(cfg), make_test_layout(1, 8), 4, 16)
    odd = dataclasses.replace(get_smoke_config("recurrentgemma-2b"), d_model=60)
    with pytest.raises(ValueError, match=r"rglru.wa \(1, 60, 60\): the model axis \(8\) does not divide d_rnn "
                                         r"\(60\)"):
        PL.serve_placement(build_model(odd), make_test_layout(1, 8))
    with pytest.raises(ValueError, match=r"k0_recurrent.h \(1, 4, 60\): the model axis moves off the channels"):
        PL.cache_placement(build_model(odd), make_test_layout(1, 8), 4, 16)
    assert PL.train_placement(build_model(get_smoke_config("seamless-m4t-medium")), make_test_layout(2, 4)).specs
    full = build_model(dataclasses.replace(get_config("seamless-m4t-medium"), dp_over_model=False))
    with pytest.raises(ValueError, match=r"embed \(256206, 1024\): the model axis \(4\) does not divide the "
                                         r"vocabulary \(256206\)"):
        PL.train_placement(full, make_test_layout(2, 4))
    assert PL.train_placement(full, make_test_layout(4, 2)).specs
    for cfg in (get_smoke_config("qwen2-vl-72b"),  # the stub-frontend families place
                dataclasses.replace(get_smoke_config("seamless-m4t-medium"), dp_over_model=True)):
        assert PL.train_placement(build_model(cfg), make_test_layout(2, 4)).specs


# ------------------------------------------------------------------ the step
def _batch(cfg, seed):
    return {"tokens": np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)}


def _reference_run(jcfg, jp, mesh):
    step, shardings = jbuild_train_step(jbuild(jcfg), mesh, JAdamWConfig(**OPT))
    jitted = jax.jit(step, in_shardings=(shardings["params"], shardings["opt"], None),
                     out_shardings=(shardings["params"], shardings["opt"], None))
    params = jax.device_put(jp, shardings["params"])
    opt = jax.device_put(jadamw_init(jp, JAdamWConfig(**OPT)), shardings["opt"])
    mets = []
    for i in range(STEPS):
        params, opt, met = jitted(params, opt, {k: jnp.asarray(v) for k, v in _batch(jcfg, 30 + i).items()})
        mets.append((float(met["loss"]), float(met["gnorm"])))
    return mets, {_path(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(params)}


def _port_run(cfg, lm, placement=None):
    step = build_train_step(build_model(cfg), None, AdamWConfig(**OPT))
    params = lm if placement is None else placement.place(lm)
    opt = adamw_init(params, AdamWConfig(**OPT))
    mets = []
    for i in range(STEPS):
        params, opt, met = step(params, opt, _batch(cfg, 30 + i))
        mets.append((float(met["loss"]), float(met["gnorm"])))
    gather = placement.gather if placement is not None else (lambda t: t.tree() if hasattr(t, "tree") else t)
    return mets, {p: NP(a) for p, a in S.named_leaves(gather(params))}, opt


def _within(got, want, what):
    (mets, params), (wmets, wparams) = got, want
    for (l, g), (wl, wg) in zip(mets, wmets):
        np.testing.assert_allclose(l, wl, atol=1e-5, rtol=0, err_msg=f"{what}: loss")
        np.testing.assert_allclose(g, wg, rtol=5e-4, atol=0, err_msg=f"{what}: gnorm")
    assert set(params) == set(wparams)
    for p in params:
        np.testing.assert_allclose(params[p], wparams[p], atol=OPT["lr"] / 2, rtol=0, err_msg=f"{what}: {p}")


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_step_equals_the_reference_sharded_step(arch, micro, mesh24):
    jcfg, cfg, jp, lm = _pair(arch, fsdp=True, micro=micro)
    want = _reference_run(jcfg, jp, mesh24)
    placement = PL.train_placement(build_model(cfg), make_test_layout(2, 4))
    mets, params, opt = _port_run(cfg, lm, placement)
    _within((mets, params), want, "placed vs reference")
    assert int(opt["step"]) == STEPS and PL.is_placed(opt["m"]) and PL.is_placed(opt["v"])
    whole_lm = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    _within((mets, params), _port_run(cfg, whole_lm)[:2], "placed vs unsharded")


def test_placed_train_checkpoint_restores_onto_another_layout(tmp_path):
    """rwkv6's ``train(place=True)`` on (2, 4) writes its placed state
    whole; it restores onto (4, 2), each block the chunk of the whole leaf
    that layout's rule names, bit for bit, and a resumed placed run
    continues."""
    from repro_torch.launch.train import train

    kw = dict(arch="rwkv6-3b", smoke=True, batch=4, seq=32, verbose=False, device="cpu", place=True)
    params, opt, losses = train(steps=2, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    assert PL.is_placed(params) and PL.is_placed(opt["m"]) and np.isfinite([l for _, l in losses]).all()
    model = build_model(get_smoke_config("rwkv6-3b"))
    pl24 = params.placement
    whole = {"params": pl24.gather(params), "opt": pl24.gather(opt)}
    like = jax.tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), whole)
    pl42 = PL.train_placement(model, make_test_layout(4, 2))
    got = restore_checkpoint(tmp_path, 2, like, device="cpu", shardings={"params": pl42, "opt": pl42})
    assert PL.is_placed(got["params"]) and got["params"].placement is pl42 and int(got["opt"]["step"]) == 2
    ids = pl42.layout.local_ranks().tolist()
    for name, tree, ref in (("params", got["params"], whole["params"]), ("m", got["opt"]["m"], whole["opt"]["m"]),
                            ("v", got["opt"]["v"], whole["opt"]["v"])):
        for path, spec in pl42.specs.items():
            want = S.cut(_blocks(ref, path), spec, pl42.axes, ids)
            assert torch.equal(_blocks(tree, path), want), (name, path)
    resumed = train(steps=3, ckpt_dir=str(tmp_path), ckpt_every=0, **kw)[2]
    assert [s for s, _ in resumed] == [2] and np.isfinite(resumed[0][1])


# ------------------------------------------------------- decode and prefill
def _tokens(vocab, seed=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (B, 1)).astype(np.int32) for _ in range(DECODE_STEPS)]


def _reference_steps(step, params, caches, vocab, put=lambda c: c):
    logits = []
    for i, tok in enumerate(_tokens(vocab)):
        out, caches = step(params, jnp.asarray(tok), caches)
        logits.append(np.asarray(out))
        if i + 1 == RESET[0]:
            caches = put(jreset_slot(caches, RESET[1]))
    return np.stack(logits), caches


@functools.lru_cache(maxsize=None)
def _reference_decode(arch):
    """The reference's decode jitted with its shardings on ``make_test_mesh(2,
    4)``, from seeded caches: each step's logits, the caches at the end,
    the mesh, and the largest |difference| of those caches from the ones
    its unsharded jitted decode ends with."""
    jcfg, _, jp, _ = _pair(arch)
    jmodel, mesh = jbuild(jcfg), make_test_mesh(2, 4)
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


def _port_decode(arch):
    jcfg, cfg, _, lm = _pair(arch)
    model, layout = build_model(cfg), make_test_layout(2, 4)
    params = PL.serve_placement(model, layout).place(lm)
    cp = PL.cache_placement(model, layout, B, T)
    caches = cp.place(_to_torch(_seeded_caches(jbuild(jcfg), B, T, DEPTHS, seed=7)))
    step = model.decode_fn()
    logits = []
    for i, tok in enumerate(_tokens(cfg.vocab_size)):
        out, caches = step(params, torch.from_numpy(tok), caches)
        logits.append(NP(out))
        if i + 1 == RESET[0]:
            caches = reset_slot(caches, RESET[1])
    return np.stack(logits), caches


def _decode_gaps(arch):
    """(max |logit difference|, max |cache difference| over the float
    leaves, ``pos`` bit-equal) of the port's placed decode against the
    reference's sharded decode."""
    want, jcaches, mesh, _ = _reference_decode(arch)
    got, caches = _port_decode(arch)
    diffs = _shard_diffs(jcaches, caches, mesh)
    floats = max(v for (p, _r), v in diffs.items() if p[-1] != "pos")
    pos_equal = all(v == 0.0 for (p, _r), v in diffs.items() if p[-1] == "pos")
    return float(np.abs(got - want).max()), floats, pos_equal


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_decode_equals_the_reference_sharded_decode(arch):
    logit_gap, cache_gap, pos_equal = _decode_gaps(arch)
    own = _reference_decode(arch)[3]
    assert logit_gap <= TOL and cache_gap <= max(TOL, CACHE_K * own) and pos_equal, \
        (logit_gap, cache_gap, own, pos_equal)
    jcaches = _reference_decode(arch)[1]
    if arch == "recurrentgemma-2b":  # the local layer's rows crossed the model ranks' blocks; slot 2 restarted
        assert np.asarray(jcaches["blocks"]["k2_local"]["pos"])[0].tolist() == [12, 15, 6, 15]
    else:
        assert sorted(jcaches["blocks"]) == ["k0_rwkv"]


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_prefill_equals_the_reference_sharded_prefill(arch):
    jcfg, cfg, jp, lm = _pair(arch)
    fn, shardings = jbuild_prefill_step(jbuild(jcfg), make_test_mesh(2, 4))
    model = build_model(cfg)
    params = PL.serve_placement(model, make_test_layout(2, 4)).place(lm)
    jitted = jax.jit(fn, in_shardings=(shardings["params"], None))
    for n, seed in ((12, 9), (64, 10)):  # one chunk, and two chunks of the rwkv scan
        tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
        want = np.asarray(jitted(jax.device_put(jp, shardings["params"]), {"tokens": jnp.asarray(tokens)}))
        got = NP(model.prefill_fn()(params, {"tokens": torch.from_numpy(tokens)}))
        assert got.shape == want.shape == (B, cfg.vocab_size)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=f"{n} tokens")


def _own_columns(xi, ranks):
    """The planted fault: the gathered ξ with every other rank's channels
    zero, so the gates contract over the rank's own columns alone."""
    whole = P.gather(xi, ranks, P.MODEL_TIER, 2)
    c = xi.shape[-1]
    cols = torch.arange(whole.shape[-1])
    mine = (cols[None, :] // c) == ranks.mrank[:, None]
    return torch.where(mine[:, None, None, :], whole, torch.zeros_like(whole))


def test_planted_xi_fault_fails(monkeypatch):
    """griffin's gates from the rank's own ξ columns: the logits leave
    their bound against the reference (finite all the same)."""
    monkeypatch.setattr(G, "_whole_xi", _own_columns)
    want = _reference_decode("recurrentgemma-2b")[0]
    got, _ = _port_decode("recurrentgemma-2b")
    gap = float(np.abs(got - want).max())
    assert np.isfinite(got).all() and gap > 10 * TOL, gap


# --------------------------------------------------------------- the engine
def _requests(cfg, cls, n=10, seed=11):
    rng = np.random.default_rng(seed)
    specs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(2, 9))).astype(np.int32), int(rng.integers(2, 8)))
             for _ in range(n)]
    return [cls(rid=i, prompt=p, max_new_tokens=k) for i, (p, k) in enumerate(specs)]


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_engine_tokens_equal_the_unsharded_and_the_reference(arch):
    jcfg, cfg, jp, lm = _pair(arch)
    model = build_model(cfg)
    params = PL.serve_placement(model, make_test_layout(2, 4)).place(lm)
    engine = BatchedEngine(model, params, slots=8, max_len=32, device="cpu")
    placed = engine.run(_requests(cfg, Request))
    assert engine.cache_placement is not None and engine.steps > 0
    whole = BatchedEngine(model, lm, slots=8, max_len=32, device="cpu").run(_requests(cfg, Request))
    ref = JEngine(jbuild(jcfg), jp, slots=8, max_len=32).run(_requests(jcfg, JRequest))
    assert placed == whole == ref
    assert sum(map(len, placed.values())) == sum(r.max_new_tokens for r in _requests(cfg, Request))


def test_reset_slot_keeps_the_recurrent_state():
    """On placed recurrentgemma caches, slot 6 of 8 on (2, 4) gets ``pos``
    zero on its group's ranks; ``h``, ``conv`` and the attention's k and v
    stay the same tensors, as the reference's ``reset_slot`` leaves them."""
    _, cfg, _, _ = _pair("recurrentgemma-2b")
    cp = PL.cache_placement(build_model(cfg), make_test_layout(2, 4), 8, T)
    caches = cp.zeros("cpu")
    _blocks(caches, ("blocks", "k2_local", "pos")).fill_(5)
    fresh = reset_slot(caches, 6)
    pos = fresh["blocks"]["k2_local"]["pos"]  # (8 ranks, 1 period, 4 rows)
    want = torch.full_like(pos, 5)
    want[4:, :, 2] = 0
    assert torch.equal(pos, want)
    for path in cp.paths:
        if path[-1] != "pos":
            assert _blocks(fresh, path) is _blocks(caches, path), path


# ------------------------------------------------------------ the call budget
def _one_decode_calls(arch, layers):
    cfg = dataclasses.replace(get_smoke_config(arch), num_layers=layers)
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


@pytest.mark.parametrize("arch,layer_counts", [("rwkv6-3b", (2, 4)), ("recurrentgemma-2b", (3, 6, 5))])
def test_one_decode_step_call_budget(arch, layer_counts):
    """One placed decode step on (2, 4).  Over ``model`` (tier 1): an rwkv
    layer two ``psum``s (``wo`` and the MLP); a recurrent layer ξ's
    ``all_gather`` and two ``psum``s; a local attention layer the dense
    family's q, (k, v) and maxima ``all_gather``s and its partials', ``wo``
    and MLP ``psum``s; besides, the embedding's ``psum`` and the logits'
    ``all_gather`` of the vocabulary.  Over ``data`` (tier 0): the logits'
    rows, one ``all_gather``.  recurrentgemma at 5 layers runs one period
    and two tail layers (recurrent, recurrent)."""
    for layers in layer_counts:
        counts = _one_decode_calls(arch, layers)
        if arch == "rwkv6-3b":
            gathers, psums = 0, 2 * layers
        else:
            local = layers // 3
            recurrent = layers - local
            gathers, psums = recurrent + 3 * local, 2 * recurrent + 3 * local
        want = {("all_gather", 1): gathers + 1, ("psum", 1): psums + 1, ("all_gather", 0): 1}
        assert counts == want, (arch, layers, counts)


def test_chip_smoke_phase_recurrent_shard_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.phase_recurrent_shard`` at a small width on the CPU:
    every check passes."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    monkeypatch.setattr(cs, "FAILURES", [])
    widths = {"rwkv6-3b": dict(d_model=64, num_heads=4, head_dim=16, d_ff=128, vocab_size=512),
              "recurrentgemma-2b": dict(d_model=64, num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
                                        vocab_size=512, window=8)}
    out, paths = cs.phase_recurrent_shard(torch.device("cpu"), widths=widths, SLOTS=8, MAX_LEN=32, N_REQ=6,
                                          PROMPT=(2, 6), NEW=(2, 5), BATCH=(8, 32), TRAIN_STEPS=2, CHECK_STEPS=6,
                                          SMOKE_BATCH=(4, 16), profile=False)
    assert cs.FAILURES == [] and not any(paths["recurrent_shard"].values())
    for arch in ARCHS:
        assert len(set(out[arch]["serve"]["param_bytes_per_rank"])) == 1


def _event(name, device, start=0, end=0, thread=0, corr=0, linked=0):
    """A stand-in for a raw profiler event (``_KinetoEvent``)."""
    return types.SimpleNamespace(name=lambda: name, device_type=lambda: device, start_ns=lambda: start,
                                 end_ns=lambda: end, duration_ns=lambda: end - start, start_thread_id=lambda: thread,
                                 correlation_id=lambda: corr, linked_correlation_id=lambda: linked,
                                 is_async=lambda: False)


def test_chip_smoke_ranged_kernels_finds_the_innermost_range():
    """``chip_smoke._ranged_kernels`` (the card's split of a step by part):
    each device event goes to the innermost range open on its host op's
    thread when the op began; a runtime event (linked, on the host) is not
    a host op; an op on another thread, after every range or unknown gets
    no range."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    host = [_event("rs.a", cpu, 0, 100, corr=90), _event("rs.b", cpu, 10, 50, corr=91),
            _event("op1", cpu, 5, 6, corr=1), _event("op2", cpu, 20, 21, corr=2), _event("op3", cpu, 60, 61, corr=3),
            _event("op4", cpu, 150, 151, corr=4), _event("op5", cpu, 20, 21, thread=2, corr=5),
            _event("cudaLaunchKernel", cpu, 30, 31, corr=7, linked=2)]
    kernels = [_event(f"k{i}", cuda, 200 + i, 210 + i, linked=i) for i in (1, 2, 3, 4, 5, 99)]
    got = [(part, e.name()) for part, e in cs._ranged_kernels(kernels[:3] + host + kernels[3:], "rs.")]
    assert got == [("a", "k1"), ("b", "k2"), ("a", "k3"), (None, "k4"), (None, "k5"), (None, "k99")]
