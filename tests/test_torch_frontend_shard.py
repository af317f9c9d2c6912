"""The stub-frontend families on placed parameters (``repro_torch.launch.
placement`` for qwen2-vl's vision stub and the encoder-decoder under
``dp_over_model``; ``models.encdec.encode_placed`` / ``decode_placed``,
``attention.decode_rows_placed``, ``transformer.forward_placed`` with
``frontend_embeds``; the placed train step, prefill, decode and, for
qwen2-vl, ``BatchedEngine``) against the JAX reference on the CPU, on the
stacked backend.

Inputs are made from a seed with numpy; weights are the reference's
(``build_model(cfg).init(PRNGKey(0))``) carried into the port by
``params_from_jax``.  The smoke configs: qwen2-vl-72b (2 layers, 4 q
heads and 2 kv heads of 16, qkv bias, M-RoPE) and seamless-m4t-medium (2 +
2 layers, 4 heads of 16) with ``dp_over_model=True``, the full config's
policy: every weight whole on every rank, the batch rows over ``(data,
model)``.

* Placement, bit for bit: the train placement with ``fsdp`` on and off
  (with seeded AdamW moments) and the serve placement with seeded decode
  caches on layouts (2, 4), (4, 2) and (8, 1), and (1, 8) for qwen2-vl
  (its 2 kv heads cut through): every rank's block equals the reference's
  addressable shard under ``build_train_step`` / ``build_decode_step``'s
  shardings (``jax.device_put`` on ``make_test_mesh``), compared as 32-bit
  words; a rank's bytes are ``specs.device_bytes``.  A planted
  misplacement (seamless's decoder ``wq`` split over ``model`` on its
  columns, as tensor parallelism would) fails; the full encoder-decoder
  config without ``dp_over_model`` where ``model`` does not divide its
  vocabulary, ``dp_over_model`` on a decoder family and a batch that does
  not split over ``data·model`` are refused (the smoke config split over
  ``model`` places: ``tests/test_torch_encdec_shard.py``).
* The train step: both archs, ``microbatches`` 1 and 2, on (2, 4) (qwen2-vl
  with ``fsdp``, seamless without and, at 2 microbatches, with), against
  the reference's step jitted on ``mesh24`` with its shardings and
  ``_batch_shardings``, and against the port's unsharded step: loss within
  1e-5, gnorm within 5e-4 relative, every gathered parameter within lr / 2
  (``tests/test_torch_shard.py``'s bounds), over ``STEPS`` steps; seamless
  over one step with Adam's eps at 1e-3 and each leaf's move within 1e-2
  of the reference's in L2 norm (``SM_OPT``: its training is chaotic in
  the reference itself, ``tests/test_torch_train.py``); every rank's
  block of every parameter and moment equal, bit for bit, across the
  ranks that hold its replicas.  qwen2-vl's ``embed`` gets no gradient (``embeds`` replace the
  lookup): it decays alone, as the reference's zero gradient decays it.
* Decode and prefill: both archs on (2, 4), batch 8, ``max_len`` 16, 12
  decode steps from seeded caches with the rows at depths 0 … 9 and slot 2
  reset after the sixth step; seamless's memory and token sharded over
  ``(data, model)`` as ``lower_cell`` shards them; against the reference's
  decode and prefill jitted with its shardings: logits within 1e-4; every
  cache block within 1e-4 of the reference's shard, or within ``CACHE_K``
  times the reference's own gap between its sharded and unsharded decodes
  where that is wider; ``pos`` bit for bit.
* M-RoPE: qwen2-vl's placed forward at three distinct position streams
  (t, h, w) against the reference's ``forward`` at the same; a planted
  plain RoPE (stream t for every frequency) fails there, while on text
  positions, whose three streams are equal, it is M-RoPE exactly.
* The planted rows fault: each seamless rank's own rows' q, k and v taken
  as its group's first slots (in place of the gather over ``model``) fail
  the logits bound (finite all the same).
* The engine: qwen2-vl placed on (2, 4), 8 slots, 10 requests (slots
  reused): its tokens equal the port's unsharded engine's and the
  reference engine's.
* The call budget: one placed decode step's and one train step's calls by
  kind and tier, both archs, pinned as a function of the layer count
  (qwen2-vl's step with ``embeds`` gathers no ``embed``).
* The CPU rehearsal of ``chip_smoke.phase_frontend_shard``.
"""
import dataclasses
import functools

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
from repro.launch.steps import _batch_shardings
from repro.launch.steps import build_decode_step as jbuild_decode_step
from repro.launch.steps import build_prefill_step as jbuild_prefill_step
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.models import encdec as JED
from repro.models import transformer as JTF
from repro.models.api import build_model as jbuild
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from jax.sharding import NamedSharding, PartitionSpec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import placement as PL
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_test_layout
from repro_torch.launch.serve import BatchedEngine, Request, reset_slot
from repro_torch.launch.steps import build_train_step
from repro_torch.models import api as API
from repro_torch.models import attention as A
from repro_torch.models import rope as R
from repro_torch.models import transformer as TF
from repro_torch.models.api import build_model, params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init

VL, SM = "qwen2-vl-72b", "seamless-m4t-medium"
ARCHS = (VL, SM)
LAYOUTS = ((2, 4), (4, 2), (8, 1), (1, 8))
OPT = dict(lr=1e-3, warmup_steps=2, eps=1e-6)
STEPS = 2
# seamless's smoke config trains chaotically in the reference itself: its
# step is held once, with Adam's eps above its float32 gradient noise, as
# tests/test_torch_train.py::test_encdec_train_step_equals_the_reference
# holds the unsharded step
SM_OPT, SM_STEPS = dict(lr=1e-3, warmup_steps=2, eps=1e-3), 1
TOL = 1e-4  # tests/test_torch_models.py's decode bound
CACHE_K = 2  # the caches' bound over the reference's own sharded-against-unsharded gap, where over 1e-4
B, T, DECODE_STEPS, RESET = 8, 16, 12, (6, 2)  # batch, max_len, decode steps, (after step, slot) reset
DEPTHS = (0, 3, 5, 9, 1, 7, 2, 4)
FRAMES, SEQ = 8, 12  # seamless's frames a row and tokens a row (train, prefill)
NP = lambda a: a.detach().cpu().numpy()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(p):
    return tuple(str(k.key) for k in p)


def _changes(arch, fsdp, micro, tp=False):
    """The config changes: seamless under ``dp_over_model`` unless ``tp``
    (the smoke config as it ships, split over ``model``)."""
    return dict(fsdp=fsdp, microbatches=micro, **({"dp_over_model": True} if arch == SM and not tp else {}))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's seed-0 weights of a smoke arch: the policy, FSDP and
    the microbatches change no parameter's shape or draw."""
    return jbuild(jget_smoke(arch)).init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _pair(arch, fsdp=False, micro=1, tp=False):
    """(JAX config, port config, JAX params, port LM) of a smoke arch
    (seamless under ``dp_over_model``, or split over ``model`` where
    ``tp``)."""
    jcfg = dataclasses.replace(jget_smoke(arch), **_changes(arch, fsdp, micro, tp))
    cfg = dataclasses.replace(get_smoke_config(arch), **_changes(arch, fsdp, micro, tp))
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
    """Decode caches (numpy leaves): seeded k and v, the given depths."""
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


def _replicas_disagree(placed, placement):
    """``[(path, rank)]`` whose block differs, bit for bit, from the first
    rank that holds the same chunk of the leaf."""
    bad = []
    for path, spec in placement.specs.items():
        blocks, first = _blocks(placed, path), {}
        for r in range(blocks.shape[0]):
            key = S._slices(placement.shapes[path], spec, placement.axes, S.rank_coords(r, placement.axes))
            key = tuple((s.start, s.stop) for s in key)
            if key in first and not torch.equal(blocks[r], blocks[first[key]]):
                bad.append((path, r))
            first.setdefault(key, r)
    return bad


# ---------------------------------------------------------------- placement
PLACE_CASES = [(a, d, m) for a in ARCHS for d, m in LAYOUTS if not (a == SM and m > 4)]


@pytest.mark.parametrize("state", ["train", "train_fsdp", "serve"])
@pytest.mark.parametrize("arch,d,m", PLACE_CASES)
def test_placement_equals_the_reference_shards(arch, d, m, state):
    jcfg, cfg, jp, lm = _pair(arch, fsdp=state == "train_fsdp")
    jmodel, model, mesh, layout = jbuild(jcfg), build_model(cfg), make_test_mesh(d, m), make_test_layout(d, m)
    if state == "serve":
        _, shardings = jbuild_decode_step(jmodel, mesh, batch=B, max_len=T)
        caches = _seeded_caches(jmodel, B, T, DEPTHS, seed=d * 10 + m)
        placement, cp = PL.serve_placement(model, layout), PL.cache_placement(model, layout, B, T)
        placed_caches = cp.place(_to_torch(caches))
        assert _mismatches(jax.device_put(caches, shardings["caches"]), placed_caches, mesh) == []
        _bytes_are_the_rule(cp, placed_caches)
        zeros = cp.zeros("cpu")
        for path in cp.paths:
            z, p = _blocks(zeros, path), _blocks(placed_caches, path)
            assert z.shape == p.shape and z.dtype == p.dtype and not z.any()
        for path, leaf in S.named_leaves(cp.gather(placed_caches)):
            assert np.array_equal(NP(leaf), np.asarray(_blocks(caches, path))), path
        if arch == SM:  # the encoder-decoder's stacked caches: slots over data, the sequence over model
            assert cp.rows_over_model and sorted(cp.paths) == [("k",), ("pos",), ("v",)]
            assert cp.specs[("k",)][:3] == (None, S.DATA, S.MODEL) and cp.specs[("pos",)] == (None, S.DATA)
    else:
        _, shardings = jbuild_train_step(jmodel, mesh)
        placement = PL.train_placement(model, layout)
        jopt = _moments(jp, seed=d * 10 + m)
        jstate = jax.device_put(jopt, shardings["opt"])
        state_ = placement.place(_to_torch(jopt))
        for k in ("m", "v"):
            assert PL.is_placed(state_[k]) and _mismatches(jstate[k], state_[k], mesh) == []
    assert placement.rows_over_model == (arch == SM)
    if arch == SM:  # dp_over_model: no leaf split over model
        assert not any(S.MODEL in S.spec_axes(part) for spec in placement.specs.values() for part in spec)
    params = placement.place(lm)
    assert _mismatches(jax.device_put(jp, shardings["params"]), params, mesh) == []
    _bytes_are_the_rule(placement, params)
    for path, leaf in S.named_leaves(placement.gather(params)):
        assert torch.equal(leaf, _blocks(lm.tree(), path)), path


def test_a_planted_misplacement_fails():
    """seamless's decoder ``wq`` and ``wk`` split over ``model`` on their
    columns (tensor parallelism's split, not ``dp_over_model``'s whole
    weights) on (2, 4): exactly those blocks leave the reference's shards."""
    jcfg, cfg, jp, lm = _pair(SM)
    mesh = make_test_mesh(2, 4)
    _, shardings = jbuild_train_step(jbuild(jcfg), mesh)
    placement = PL.train_placement(build_model(cfg), make_test_layout(2, 4))
    moved = {p: (None, None, S.MODEL) for p in placement.paths if p[0] == "dec_blocks" and p[-1] in ("wq", "wk")}
    assert len(moved) == 4
    bad = dataclasses.replace(placement, specs={**placement.specs, **moved})
    jparams = jax.device_put(jp, shardings["params"])
    assert _mismatches(jparams, placement.place(lm), mesh) == []
    assert {p for p, _r in _mismatches(jparams, bad.place(lm), mesh)} == set(moved)


def test_refusals():
    """The encoder-decoder split over ``model`` where ``model`` does not
    divide the full config's vocabulary (its smoke config places on (2, 4),
    the full config on (4, 2)), ``dp_over_model`` on a decoder family, and
    a batch whose rows do not split over ``data·model``."""
    tp = build_model(get_smoke_config(SM))
    for fn in (lambda: PL.train_placement(tp, make_test_layout(2, 4)),
               lambda: PL.serve_placement(tp, make_test_layout(2, 4)),
               lambda: PL.cache_placement(tp, make_test_layout(2, 4), B, T)):
        assert not fn().rows_over_model
    full = build_model(dataclasses.replace(get_config(SM), dp_over_model=False))
    for fn in (PL.train_placement, PL.serve_placement):
        with pytest.raises(ValueError, match=r"embed \(256206, 1024\): the model axis \(4\) does not divide the "
                                             r"vocabulary \(256206\)"):
            fn(full, make_test_layout(2, 4))
        assert fn(full, make_test_layout(4, 2)).specs
    with pytest.raises(NotImplementedError, match="dp_over_model is placed for the encoder-decoder only"):
        PL.serve_placement(build_model(dataclasses.replace(get_smoke_config("qwen2-7b"), dp_over_model=True)),
                           make_test_layout(2, 4))
    _, cfg, _, lm = _pair(SM)
    model = build_model(cfg)
    params = PL.serve_placement(model, make_test_layout(2, 4)).place(lm)
    rng = np.random.default_rng(1)
    batch = {"frames": torch.from_numpy(rng.standard_normal((4, FRAMES, cfg.d_model)).astype(np.float32)),
             "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, SEQ)).astype(np.int32))}
    with pytest.raises(ValueError, match=r"batch \(4\) does not split over the 2 data groups x 4 model ranks"):
        model.prefill_fn()(params, batch)
    tparams = PL.train_placement(model, make_test_layout(2, 4)).place(lm)
    step = build_train_step(model, None, AdamWConfig(**OPT))
    with pytest.raises(ValueError, match=r"batch \(4\) does not split into 1 microbatches over 2 data groups x 4 "
                                         r"model ranks"):
        step(tparams, adamw_init(tparams, AdamWConfig(**OPT)), {k: NP(v) for k, v in batch.items()})


# ------------------------------------------------------------------ the step
def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    if cfg.kind == "encdec":
        return {"frames": rng.standard_normal((16, FRAMES, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (16, SEQ)).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32),
            "embeds": rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (4, 15)).astype(np.int32)}


def _opt(cfg):
    """(AdamW keywords, steps) the train step is held over."""
    return (SM_OPT, SM_STEPS) if cfg.kind == "encdec" else (OPT, STEPS)


@functools.lru_cache(maxsize=None)
def _reference_run(arch, fsdp, micro, tp=False, layout=(2, 4)):
    jcfg, _, jp, _ = _pair(arch, fsdp, micro, tp)
    mesh = make_test_mesh(*layout)
    opt_kw, steps = _opt(jcfg)
    step, shardings = jbuild_train_step(jbuild(jcfg), mesh, JAdamWConfig(**opt_kw))
    first = _batch(jcfg, 30)
    jitted = jax.jit(step, in_shardings=(shardings["params"], shardings["opt"], _batch_shardings(mesh, first, jcfg)),
                     out_shardings=(shardings["params"], shardings["opt"], None))
    params = jax.device_put(jp, shardings["params"])
    opt = jax.device_put(jadamw_init(jp, JAdamWConfig(**opt_kw)), shardings["opt"])
    mets = []
    for i in range(steps):
        params, opt, met = jitted(params, opt, {k: jnp.asarray(v) for k, v in _batch(jcfg, 30 + i).items()})
        mets.append((float(met["loss"]), float(met["gnorm"])))
    return mets, {_path(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(params)}


def _port_run(cfg, lm, placement=None):
    opt_kw, steps = _opt(cfg)
    step = build_train_step(build_model(cfg), None, AdamWConfig(**opt_kw))
    params = lm if placement is None else placement.place(lm)
    opt = adamw_init(params, AdamWConfig(**opt_kw))
    mets = []
    for i in range(steps):
        params, opt, met = step(params, opt, _batch(cfg, 30 + i))
        mets.append((float(met["loss"]), float(met["gnorm"])))
    gather = placement.gather if placement is not None else (lambda t: t.tree() if hasattr(t, "tree") else t)
    return mets, {p: NP(a) for p, a in S.named_leaves(gather(params))}, params, opt


def _within(got, want, what, start=None):
    """``tests/test_torch_shard.py``'s bounds; with ``start`` (the whole
    parameters before the step, by path) also each leaf's move within 1e-2
    of the wanted move in L2 norm."""
    (mets, params), (wmets, wparams) = got, want
    assert len(mets) == len(wmets)
    for (l, g), (wl, wg) in zip(mets, wmets):
        np.testing.assert_allclose(l, wl, atol=1e-5, rtol=0, err_msg=f"{what}: loss")
        np.testing.assert_allclose(g, wg, rtol=5e-4, atol=0, err_msg=f"{what}: gnorm")
    assert set(params) == set(wparams)
    for p in params:
        np.testing.assert_allclose(params[p], wparams[p], atol=OPT["lr"] / 2, rtol=0, err_msg=f"{what}: {p}")
        if start is not None:
            move, wmove = params[p] - start[p], wparams[p] - start[p]
            assert np.linalg.norm(move - wmove) <= 1e-2 * np.linalg.norm(wmove), (what, p)


STEP_CASES = [(VL, True, 1), (VL, True, 2), (SM, False, 1), (SM, True, 2)]


@pytest.mark.parametrize("arch,fsdp,micro", STEP_CASES)
def test_placed_step_equals_the_reference_sharded_step(arch, fsdp, micro):
    jcfg, cfg, jp, lm = _pair(arch, fsdp=fsdp, micro=micro)
    want = _reference_run(arch, fsdp, micro)
    placement = PL.train_placement(build_model(cfg), make_test_layout(2, 4))
    start = {p: NP(a).copy() for p, a in S.named_leaves(lm.tree())} if arch == SM else None
    mets, params, placed, opt = _port_run(cfg, lm, placement)
    _within((mets, params), want, "placed vs reference", start)
    assert int(opt["step"]) == _opt(cfg)[1] and PL.is_placed(opt["m"]) and PL.is_placed(opt["v"])
    for name, tree in (("params", placed), ("m", opt["m"]), ("v", opt["v"])):
        assert _replicas_disagree(tree, placement) == [], name
    whole_lm = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    _within((mets, params), _port_run(cfg, whole_lm)[:2], "placed vs unsharded", start)
    if arch == VL:  # embed read by no forward: no gradient, decayed alone with its moments at zero
        assert not placement.gather(opt["m"])["embed"].any() and not placement.gather(opt["v"])["embed"].any()


# ------------------------------------------------------- decode and prefill
def _tokens(vocab, seed=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (B, 1)).astype(np.int32) for _ in range(DECODE_STEPS)]


@functools.lru_cache(maxsize=None)
def _memory():
    """seamless's encoder memory of seeded frames (the reference's
    unsharded encode), ``(B, FRAMES, D)``, numpy."""
    jcfg, _, jp, _ = _pair(SM)
    frames = np.random.default_rng(5).standard_normal((B, FRAMES, jcfg.d_model)).astype(np.float32)
    return np.asarray(jax.jit(lambda p, f: JED.encode(p, f, jcfg))(jp, frames))


def _reference_steps(step, params, caches, vocab, memory=None, put=lambda c: c, put_token=jnp.asarray):
    logits = []
    for i, tok in enumerate(_tokens(vocab)):
        args = (params, put_token(tok), caches) + (() if memory is None else (memory,))
        out, caches = step(*args)
        logits.append(np.asarray(out))
        if i + 1 == RESET[0]:
            caches = put(jreset_slot(caches, RESET[1]))
    return np.stack(logits), caches


@functools.lru_cache(maxsize=None)
def _reference_decode(arch, tp=False):
    """The reference's decode jitted with its shardings on ``make_test_mesh(2,
    4)`` (seamless's token and memory over ``(data, model)``, as
    ``lower_cell`` shards them), from seeded caches: each step's logits,
    the caches at the end, the mesh, and the largest |difference| of those
    caches from the ones its unsharded jitted decode ends with."""
    jcfg, _, jp, _ = _pair(arch, tp=tp)
    jmodel, mesh = jbuild(jcfg), make_test_mesh(2, 4)
    fn, shardings = jbuild_decode_step(jmodel, mesh, batch=B, max_len=T)
    baxes = ("data", "model") if jcfg.dp_over_model else "data"
    token_shard = NamedSharding(mesh, PartitionSpec(baxes, None))
    memory = None
    if arch == SM:
        mem_shard = NamedSharding(mesh, PartitionSpec(baxes, None, None))
        step = jax.jit(fn, in_shardings=(shardings["params"], token_shard, shardings["caches"], mem_shard),
                       out_shardings=(None, shardings["caches"]))
        memory = jax.device_put(_memory(), mem_shard)
    else:
        step = jax.jit(fn, in_shardings=(shardings["params"], token_shard, shardings["caches"]),
                       out_shardings=(None, shardings["caches"]))
    start = _seeded_caches(jmodel, B, T, DEPTHS, seed=7)
    put = lambda c: jax.device_put(c, shardings["caches"])
    logits, caches = _reference_steps(step, jax.device_put(jp, shardings["params"]), put(start), jcfg.vocab_size,
                                      memory, put, lambda t: jax.device_put(t, token_shard))
    _, whole = _reference_steps(jax.jit(fn), jp, jax.tree.map(jnp.asarray, start), jcfg.vocab_size,
                                None if memory is None else jnp.asarray(_memory()))
    own = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(jax.tree.leaves(caches),
                                                                                  jax.tree.leaves(whole)))
    return logits, caches, mesh, own


def _port_decode(arch, tp=False):
    jcfg, cfg, _, lm = _pair(arch, tp=tp)
    model, layout = build_model(cfg), make_test_layout(2, 4)
    params = PL.serve_placement(model, layout).place(lm)
    cp = PL.cache_placement(model, layout, B, T)
    caches = cp.place(_to_torch(_seeded_caches(jbuild(jcfg), B, T, DEPTHS, seed=7)))
    step = model.decode_fn()
    memory = () if arch == VL else (torch.from_numpy(np.array(_memory())),)
    logits = []
    for i, tok in enumerate(_tokens(cfg.vocab_size)):
        out, caches = step(params, torch.from_numpy(tok), caches, *memory)
        logits.append(NP(out))
        if i + 1 == RESET[0]:
            caches = reset_slot(caches, RESET[1])
    return np.stack(logits), caches


def _decode_gaps(arch, tp=False):
    """(max |logit difference|, max |cache difference| over the float
    leaves, ``pos`` bit-equal) of the port's placed decode against the
    reference's sharded decode."""
    want, jcaches, mesh, _ = _reference_decode(arch, tp)
    got, caches = _port_decode(arch, tp)
    diffs = _shard_diffs(jcaches, caches, mesh)
    floats = max(v for (p, _r), v in diffs.items() if p[-1] != "pos")
    pos_equal = all(v == 0.0 for (p, _r), v in diffs.items() if p[-1] == "pos")
    return float(np.abs(got - want).max()), floats, pos_equal, got


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_decode_equals_the_reference_sharded_decode(arch):
    logit_gap, cache_gap, pos_equal, got = _decode_gaps(arch)
    own = _reference_decode(arch)[3]
    assert logit_gap <= TOL and cache_gap <= max(TOL, CACHE_K * own) and pos_equal, \
        (logit_gap, cache_gap, own, pos_equal)
    assert got.shape == (DECODE_STEPS, B, get_smoke_config(arch).vocab_size)
    jcaches = _reference_decode(arch)[1]
    pos = jcaches["pos"] if arch == SM else jcaches["blocks"]["k0_global"]["pos"]
    assert np.asarray(pos)[0].tolist() == [12, 15, 6, 15, 13, 15, 14, 15]  # rows cross the blocks; slot 2 restarted


def _prefill_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    if cfg.kind == "encdec":
        return {"frames": rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(np.int32),
            "embeds": rng.standard_normal((B, SEQ, cfg.d_model)).astype(np.float32)}


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_prefill_equals_the_reference_sharded_prefill(arch):
    jcfg, cfg, jp, lm = _pair(arch)
    mesh = make_test_mesh(2, 4)
    fn, shardings = jbuild_prefill_step(jbuild(jcfg), mesh)
    model = build_model(cfg)
    params = PL.serve_placement(model, make_test_layout(2, 4)).place(lm)
    batch = _prefill_batch(cfg, 9)
    jitted = jax.jit(fn, in_shardings=(shardings["params"], _batch_shardings(mesh, batch, jcfg)))
    want = np.asarray(jitted(jax.device_put(jp, shardings["params"]), {k: jnp.asarray(v) for k, v in batch.items()}))
    params.placement.comm.reset()
    got = NP(model.prefill_fn()(params, {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert got.shape == want.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    calls = {(c.kind, c.tier) for c in params.placement.comm.calls}
    assert ("all_gather", 0) in calls and (arch == VL or calls == {("all_gather", 0), ("all_gather", 1)}), calls


# ----------------------------------------------------------------- M-RoPE
def _streams(b, s):
    """Three distinct position streams (t, h, w) ``(b, s, 3)``: a text
    prefix, then an image's patches on a 2 × 3 grid at one time step."""
    t = np.minimum(np.arange(s), 4)
    h = np.where(np.arange(s) < 4, np.arange(s), 4 + (np.arange(s) - 4) // 3)
    w = np.where(np.arange(s) < 4, np.arange(s), 4 + (np.arange(s) - 4) % 3)
    return np.broadcast_to(np.stack([t, h, w], axis=-1), (b, s, 3)).astype(np.int32).copy()


@functools.lru_cache(maxsize=None)
def _reference_forward(streams: bool):
    """The reference's ``forward`` of seeded ``embeds`` jitted with the
    serve shardings on (2, 4) (batch leaves over ``data``), at three
    distinct position streams or at text positions: the last position's
    logits ``(B, V)``."""
    jcfg, cfg, jp, _ = _pair(VL)
    mesh = make_test_mesh(2, 4)
    _, shardings = jbuild_prefill_step(jbuild(jcfg), mesh)
    embeds = _prefill_batch(cfg, 11)["embeds"][:, :10]
    pos = _streams(B, 10) if streams else np.broadcast_to(np.arange(10, dtype=np.int32), (B, 10)).copy()
    ins = {"embeds": embeds, "positions": pos}

    def fn(p, x):
        return JTF.forward(p, None, jcfg, mesh=mesh, positions=x["positions"], frontend_embeds=x["embeds"])[0][:, -1]

    jitted = jax.jit(fn, in_shardings=(shardings["params"], _batch_shardings(mesh, ins, jcfg)))
    return np.asarray(jitted(jax.device_put(jp, shardings["params"]), {k: jnp.asarray(v) for k, v in ins.items()})), ins


def _port_forward(ins):
    _, cfg, _, lm = _pair(VL)
    placement = PL.serve_placement(build_model(cfg), make_test_layout(2, 4))
    params = placement.place(lm)
    ranks = placement.ranks(torch.device("cpu"))
    rows = lambda a: API._group_rows(torch.from_numpy(a), ranks)
    with torch.no_grad():
        logits, _, _ = TF.forward_placed(params, None, cfg, ranks, positions=rows(ins["positions"]),
                                         frontend_embeds=rows(ins["embeds"]))
    return NP(API._whole_logits(logits[:, :, -1], ranks))


def _plain_rope(cfg, positions, theta=None):
    """The planted fault: plain RoPE at stream t, whatever the streams."""
    if positions.dim() == 3:
        positions = positions[..., 0]
    return R.rope_angles(positions, cfg.head_dim, theta or cfg.rope_theta)


def test_mrope_streams_equal_the_reference_and_plain_rope_fails(monkeypatch):
    """qwen2-vl's placed forward at three distinct streams equals the
    reference's; plain RoPE in M-RoPE's place leaves the bound there, and
    equals M-RoPE at text positions (three equal streams)."""
    for streams in (True, False):
        want, ins = _reference_forward(streams)
        assert np.abs(_port_forward(ins) - want).max() <= TOL, streams
    monkeypatch.setattr(A, "_angles", _plain_rope)
    want, ins = _reference_forward(True)
    got = _port_forward(ins)
    assert np.isfinite(got).all() and np.abs(got - want).max() > 10 * TOL
    want, ins = _reference_forward(False)
    assert np.abs(_port_forward(ins) - want).max() <= TOL


def _rows_as_first_slots(t, ranks):
    """The planted fault: a rank's own rows taken as its group's first
    slots (the other slots zero), in place of the gather over ``model``."""
    return torch.cat([t] + [torch.zeros_like(t)] * (ranks.model - 1), dim=1)


def test_planted_rows_as_slots_fault_fails(monkeypatch):
    """seamless's decode with each rank's rows written as its group's first
    slots: the logits leave their bound against the reference (finite all
    the same)."""
    monkeypatch.setattr(A, "_gather_rows", _rows_as_first_slots)
    want = _reference_decode(SM)[0]
    got, _ = _port_decode(SM)
    gap = float(np.abs(got - want).max())
    assert np.isfinite(got).all() and gap > 10 * TOL, gap


# --------------------------------------------------------------- the engine
def _requests(cfg, cls, n=10, seed=11):
    rng = np.random.default_rng(seed)
    specs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(2, 9))).astype(np.int32), int(rng.integers(2, 8)))
             for _ in range(n)]
    return [cls(rid=i, prompt=p, max_new_tokens=k) for i, (p, k) in enumerate(specs)]


def test_placed_engine_tokens_equal_the_unsharded_and_the_reference():
    jcfg, cfg, jp, lm = _pair(VL)
    model = build_model(cfg)
    params = PL.serve_placement(model, make_test_layout(2, 4)).place(lm)
    engine = BatchedEngine(model, params, slots=8, max_len=32, device="cpu")
    placed = engine.run(_requests(cfg, Request))
    assert engine.cache_placement is not None and engine.steps > 0
    whole = BatchedEngine(model, lm, slots=8, max_len=32, device="cpu").run(_requests(cfg, Request))
    ref = JEngine(jbuild(jcfg), jp, slots=8, max_len=32).run(_requests(jcfg, JRequest))
    assert placed == whole == ref
    assert sum(map(len, placed.values())) == sum(r.max_new_tokens for r in _requests(cfg, Request))
    with pytest.raises(ValueError, match="encdec step needs the encoder memory"):
        _, scfg, _, slm = _pair(SM)
        BatchedEngine(build_model(scfg), PL.serve_placement(build_model(scfg), make_test_layout(2, 4)).place(slm),
                      slots=8, device="cpu")


# ------------------------------------------------------------ the call budget
def _counts(comm):
    out = {}
    for call, n in comm.calls.items():
        out[(call.kind, call.tier)] = out.get((call.kind, call.tier), 0) + n
    return out


def _smoke(arch, layers, fsdp=False):
    cfg = dataclasses.replace(get_smoke_config(arch), **_changes(arch, fsdp, 1))
    if arch == SM:
        cfg = dataclasses.replace(cfg, encoder_layers=layers)
    return dataclasses.replace(cfg, num_layers=layers)


def _one_decode_calls(arch, layers):
    cfg = _smoke(arch, layers)
    model, layout = build_model(cfg), make_test_layout(2, 4)
    sp = PL.serve_placement(model, layout)
    params = sp.place(model.init(torch.Generator().manual_seed(0), device="cpu"))
    caches = PL.cache_placement(model, layout, B, T).zeros("cpu")
    memory = () if arch == VL else (torch.zeros((B, FRAMES, cfg.d_model)),)
    sp.comm.reset()
    model.decode_fn()(params, torch.zeros((B, 1), dtype=torch.int32), caches, *memory)
    return _counts(sp.comm)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_decode_step_call_budget(arch):
    """One placed decode step on (2, 4).  qwen2-vl, as the dense family:
    a layer's q, (k, v) and maxima ``all_gather``s and its partials', ``wo``
    and MLP ``psum``s over ``model``, the embedding's ``psum`` and the
    logits' vocabulary ``all_gather``; over ``data`` the logits' rows.
    seamless under ``dp_over_model``: a decoder layer's one ``all_gather``
    of q, k and v on the rows and the maxima's over ``model`` and one
    ``psum`` of the partials; the logits' rows gathered over ``model``,
    then over ``data``; nothing else (cross-attention, the MLP and the
    embedding are the rank's own)."""
    for layers in (1, 2, 3):
        counts = _one_decode_calls(arch, layers)
        if arch == VL:
            want = {("all_gather", 1): 3 * layers + 1, ("psum", 1): 3 * layers + 1, ("all_gather", 0): 1}
        else:
            want = {("all_gather", 1): 2 * layers + 1, ("psum", 1): layers, ("all_gather", 0): 1}
        assert counts == want, (arch, layers, counts)


def _one_train_calls(arch, layers, fsdp):
    cfg = _smoke(arch, layers, fsdp=fsdp)
    model = build_model(cfg)
    pl = PL.train_placement(model, make_test_layout(2, 4))
    params = pl.place(model.init(torch.Generator().manual_seed(0), device="cpu"))
    opt = adamw_init(params, AdamWConfig(**OPT))
    pl.comm.reset()
    build_train_step(model, None, AdamWConfig(**OPT))(params, opt, _batch(cfg, 3))
    return _counts(pl.comm), len(pl.paths)


@pytest.mark.parametrize("arch,fsdp", [(VL, True), (SM, False), (SM, True)])
def test_one_train_step_call_budget(arch, fsdp):
    """One placed train step on (2, 4) (one microbatch), as a function of
    the layer count n; a stacked leaf is gathered, summed and scattered
    once for all its layers, so the ``data`` tier's calls do not grow with
    n.  seamless under ``dp_over_model``: only the gradient sums, one flat
    ``psum`` a leaf over both batch axes (with ``fsdp``: each leaf's
    ``all_gather`` over ``data``, its ``reduce_scatter`` back, and a
    ``psum`` over ``model``), beside the loss's and the norm's flat
    ``psum``s.  qwen2-vl with ``fsdp`` and ``embeds``: every leaf but
    ``embed`` gathered over ``data`` and scattered back (``embed`` is read
    by no forward); the replicated biases ``psum``'d over ``data``; over
    ``model`` a layer's k and v gathers (its 2 kv heads cut through on 4
    model ranks) and their ``reduce_scatter``s, the ``psum``s of ``wo``
    and the MLP forward and of the attention's and the MLP's input
    gradients backward, the head's input gradient, the loss's maxima
    gather and its sums' ``psum``; the loss's ``psum`` over ``data`` and
    the norm's flat ``psum``.  (qwen2-vl's depths are even: at one layer
    ``data`` does not divide the stack of the biases, which are then
    replicated over ``data`` and ``psum``'d there.)"""
    for layers in ((2, 4) if arch == VL else (1, 2)):
        counts, leaves = _one_train_calls(arch, layers, fsdp)
        if arch == SM and not fsdp:
            want = {("psum", None): leaves + 2}
        elif arch == SM:
            want = {("all_gather", 0): leaves, ("reduce_scatter", 0): leaves, ("psum", 1): leaves,
                    ("psum", None): 2}
        else:
            want = {("all_gather", 0): leaves - 1, ("reduce_scatter", 0): leaves - 1, ("psum", 0): 1,
                    ("all_gather", 1): 2 * layers + 1, ("reduce_scatter", 1): 2 * layers,
                    ("psum", 1): 4 * layers + 2, ("psum", None): 1}
        assert counts == want, (arch, fsdp, layers, counts)


def test_chip_smoke_phase_frontend_shard_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.phase_frontend_shard`` at a small width on the CPU, part
    (g) (seamless split over ``model``) at 1 + 1 layers on (4, 2) and (2,
    2): every check passes."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    monkeypatch.setattr(cs, "FAILURES", [])
    widths = {VL: dict(d_model=64, num_heads=8, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512),
              SM: dict(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512)}
    out, paths = cs.phase_frontend_shard(torch.device("cpu"), widths=widths, VL_LAYERS=(2, 1, 1), SM_LAYERS=(1, 1),
                                         SLOTS=8, MAX_LEN=16, N_REQ=4, PROMPT=(2, 6), NEW=(2, 5), VL_PREFILL=(2, 8),
                                         FRAMES=(4, 8, 4), GREEDY=2, VL_TRAIN=(8, 16), SM_TRAIN=(8, 8),
                                         TRAIN_STEPS=2, CHECK_STEPS=4, profile=False)
    assert cs.FAILURES == [] and not any(paths["frontend_shard"].values())
    for arch in ARCHS + (cs.SM_TP,):
        assert len(set(out[arch]["serve"]["param_bytes_per_rank"])) == 1
    assert out[cs.SM_TP]["serve"]["layout"] == cs.SM_TP_LAYOUT and out[cs.SM_TP]["train"]["layout"] == (2, 2)
    same, held, rows = out[cs.SM_TP]["float32_check"]["argmax_held"]
    assert same == held >= cs.ARGMAX_HELD * rows
