"""The MoE family on placed parameters (``repro_torch.launch.placement``
for ``kind="moe"``, ``models.moe.moe_block_placed`` under both dispatch
planes, the placed train step, prefill, decode and ``BatchedEngine``)
against the JAX reference on the CPU, on the stacked backend.

Inputs are made from a seed with numpy; weights are the reference's
(``build_model(cfg).init(PRNGKey(0))``) carried into the port by
``params_from_jax``.  The smoke configs: llama4-scout (4 experts, top-1)
and dbrx (4 experts, top-2), each under ``rafi_ep`` (the experts split over
``model``) and under ``dense_tp`` (every expert on every rank, d_ff split
over ``model``).

* Placement, bit for bit: the train placement with ``fsdp`` on and off
  (with seeded AdamW moments) and the serve placement (with seeded decode
  caches) on layouts (2, 4), (4, 2) and (8, 1), and (1, 8) for
  ``dense_tp``: every rank's block equals the reference's addressable
  shard under ``build_train_step`` / ``build_decode_step``'s shardings
  (``jax.device_put`` on ``make_test_mesh``), compared as 32-bit words; a
  rank's bytes are ``specs.device_bytes``.  A planted misplacement (the
  experts' ``model`` on D) fails; the refusals raise.
* The train step: both archs under both planes, ``fsdp=True``,
  ``microbatches`` 1 and 2, on (2, 4), two steps, against the reference's
  step jitted on ``mesh24`` with its shardings and against the port's
  unsharded step: loss within 1e-5, gnorm within 5e-4 relative, every
  gathered parameter within lr / 2 (``tests/test_torch_shard.py``'s
  bounds).  Under ``rafi_ep`` the router, the experts and ``ln2`` get no
  gradient: each within one float32 ulp of weight decay alone, its ``m``
  and ``v`` zero.
* Decode and prefill: both archs under both planes on (2, 4), batch 4,
  ``max_len`` 16, 12 decode steps from seeded caches with the rows at
  depths 0, 3, 5 and 9 and slot 2 reset after the sixth.  The reference's
  ``decode_fn`` discards its drops, so its step is ``TF.forward`` as
  ``decode_fn`` calls it, jitted with ``build_decode_step``'s shardings:
  logits within 1e-4 and each step's drops equal exactly.  Decode,
  prefill and the engine run at ``capacity_factor`` 1.0 (``CF``), where
  the reference drops tokens in some of the 12 steps under every arch and
  plane (asserted).  At the smoke configs' 1.25 dbrx under ``rafi_ep``
  never drops at decode: a group's 2 tokens send 2 items to each expert
  at most (top-2 picks two experts), and its bucket holds ceil(1.25) = 2.
* The planted capacity fault: ``dense_tp`` ranked within each data group,
  at the group's capacity, fails the drops check.
* The engine: placed on (2, 4), 8 slots, 10 requests: its tokens and each
  step's drops equal the port's unsharded engine's and the reference
  engine's (its step jitted with its drops).
* The call budget: one placed decode step's calls by kind and tier for
  each plane, pinned as a function of the layer count.
* The CPU rehearsal of ``chip_smoke.phase_moe_shard``.
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
from repro.launch.steps import build_decode_step as jbuild_decode_step
from repro.launch.steps import build_prefill_step as jbuild_prefill_step
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.models import transformer as JTF
from repro.models.api import _first_cache_pos as jfirst_cache_pos
from repro.models.api import build_model as jbuild
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import placement as PL
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_test_layout
from repro_torch.launch.serve import BatchedEngine, Request, reset_slot
from repro_torch.launch.steps import build_train_step
from repro_torch.models import moe as M
from repro_torch.models.api import build_model, params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init

ARCHS = ("llama4-scout-17b-16e", "dbrx-132b")
PLANES = ("rafi_ep", "dense_tp")
CASES = [(a, p) for a in ARCHS for p in PLANES]
LAYOUTS = ((2, 4), (4, 2), (8, 1), (1, 8))
OPT = dict(lr=1e-3, warmup_steps=2, eps=1e-6)
STEPS = 2
TOL = 1e-4  # tests/test_torch_models.py's decode bound
B, T, DECODE_STEPS, RESET = 4, 16, 12, (6, 2)  # batch, max_len, decode steps, (after step, slot) reset
DEPTHS = (0, 3, 5, 9)
CF = 1.0  # decode, prefill and the engine's capacity factor (module docstring)
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
def _weights(arch, layers=None):
    """The reference's seed-0 weights of a smoke arch: the plane, FSDP, the
    microbatches and the capacity factor change no parameter's shape or
    draw, so every variant below shares them."""
    jcfg = jget_smoke(arch) if layers is None else dataclasses.replace(jget_smoke(arch), num_layers=layers)
    return jbuild(jcfg).init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _pair(arch, plane, fsdp=False, micro=1, layers=None, cf=None):
    """(JAX config, port config, JAX params, port LM) of a smoke arch under
    ``plane`` (at capacity factor ``cf`` where given)."""
    changes = dict(moe_dispatch=plane, fsdp=fsdp, microbatches=micro)
    if cf is not None:
        changes["capacity_factor"] = cf
    if layers is not None:
        changes["num_layers"] = layers
    jcfg = dataclasses.replace(jget_smoke(arch), **changes)
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    jp = _weights(arch, layers)
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


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _seeded_caches(jmodel, batch, max_len, depths, seed):
    """Decode caches (numpy leaves) with seeded k, v and the given depths."""
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
PLACE_CASES = [(a, p, d, m) for a, p in CASES for d, m in LAYOUTS if not (p == "rafi_ep" and m > 4)]


@pytest.mark.parametrize("state", ["train", "train_fsdp", "serve"])
@pytest.mark.parametrize("arch,plane,d,m", PLACE_CASES)
def test_placement_equals_the_reference_shards(arch, plane, d, m, state):
    jcfg, cfg, jp, lm = _pair(arch, plane, fsdp=state == "train_fsdp")
    jmodel, model, mesh, layout = jbuild(jcfg), build_model(cfg), make_test_mesh(d, m), make_test_layout(d, m)
    if state == "serve":
        _, shardings = jbuild_decode_step(jmodel, mesh, batch=8, max_len=T)
        caches = _seeded_caches(jmodel, 8, T, tuple(range(8)), seed=d * 10 + m)
        placement, cp = PL.serve_placement(model, layout), PL.cache_placement(model, layout, 8, T)
        placed_caches = cp.place(_to_torch(caches))
        assert _mismatches(jax.device_put(caches, shardings["caches"]), placed_caches, mesh) == []
        _bytes_are_the_rule(cp, placed_caches)
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
    wi = placement.specs[("blocks", "k0_moe", "moe", "wi")]
    if m > 1:  # the experts over model under rafi_ep, d_ff under dense_tp; the router whole over model
        assert wi.index(S.MODEL) == (1 if plane == "rafi_ep" else 3)
        assert S.MODEL not in S.spec_axes(placement.specs[("blocks", "k0_moe", "moe", "router")][1])
    for path, leaf in S.named_leaves(placement.gather(params)):
        assert torch.equal(leaf, _blocks(lm.tree(), path)), path


def test_fsdp_moves_data_off_a_layer_stack_it_does_not_divide():
    """llama4-scout smoke at 1 layer, ``fsdp``, on (2, 4): ``data`` on the
    experts' D (the stack of 1 does not divide), and the placed step's
    gather of them runs along that dimension."""
    cfg = dataclasses.replace(get_smoke_config("llama4-scout-17b-16e"), fsdp=True, num_layers=1)
    lm = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    placement = PL.train_placement(build_model(cfg), make_test_layout(2, 4))
    assert placement.specs[("blocks", "k0_moe", "moe", "wi")] == (None, S.MODEL, S.DATA, None)
    params = placement.place(lm)
    whole = placement.unshard(params, placement.ranks("cpu"))
    assert tuple(whole["blocks"]["k0_moe"]["moe"]["wi"].shape) == (8, 1, 1, 64, 128)


def test_a_planted_misplacement_fails():
    """The experts' ``model`` axis moved from E to D under ``rafi_ep`` on
    (2, 4): exactly those blocks leave the reference's shards."""
    jcfg, cfg, jp, lm = _pair("dbrx-132b", "rafi_ep")
    mesh = make_test_mesh(2, 4)
    _, shardings = jbuild_train_step(jbuild(jcfg), mesh)
    placement = PL.train_placement(build_model(cfg), make_test_layout(2, 4))
    moved = {p: (None, None, S.MODEL, None) for p in placement.paths if p[-2:-1] == ("moe",) and p[-1] != "router"}
    bad = dataclasses.replace(placement, specs={**placement.specs, **moved})
    jparams = jax.device_put(jp, shardings["params"])
    assert _mismatches(jparams, placement.place(lm), mesh) == []
    assert {p for p, _r in _mismatches(jparams, bad.place(lm), mesh)} == set(moved)


def test_refusals():
    """``rafi_ep`` where ``model`` does not divide the experts (4 experts on
    (1, 8)), ``dense_tp`` where it does not divide d_ff; every other family
    places, the encoder-decoder split over ``model`` too: its smoke config
    on (2, 4), and the full config without ``dp_over_model`` on (4, 2) but
    not on (2, 4), where ``model`` does not divide its vocabulary."""
    _, cfg, _, _ = _pair("llama4-scout-17b-16e", "rafi_ep")
    for fn in (PL.train_placement, PL.serve_placement):
        with pytest.raises(ValueError, match=r"blocks.k0_moe.moe.wi \(2, 4, 64, 128\): the model axis \(8\) does "
                                             r"not divide the 4 experts"):
            fn(build_model(cfg), make_test_layout(1, 8))
    odd = dataclasses.replace(cfg, moe_dispatch="dense_tp", d_ff=90)
    with pytest.raises(ValueError, match=r"moe.wi \(2, 4, 64, 90\): the model axis \(4\) does not divide d_ff"):
        PL.train_placement(build_model(odd), make_test_layout(2, 4))
    assert PL.serve_placement(build_model(get_smoke_config("seamless-m4t-medium")), make_test_layout(2, 4)).specs
    full = build_model(dataclasses.replace(get_config("seamless-m4t-medium"), dp_over_model=False))
    with pytest.raises(ValueError, match=r"embed \(256206, 1024\): the model axis \(4\) does not divide the "
                                         r"vocabulary \(256206\)"):
        PL.serve_placement(full, make_test_layout(2, 4))
    assert PL.serve_placement(full, make_test_layout(4, 2)).specs
    for arch in ("recurrentgemma-2b", "rwkv6-3b"):  # the recurrent families place now
        assert PL.serve_placement(build_model(get_smoke_config(arch)), make_test_layout(2, 4)).specs
    for cfg in (get_smoke_config("qwen2-vl-72b"),  # and the stub-frontend ones
                dataclasses.replace(get_smoke_config("seamless-m4t-medium"), dp_over_model=True)):
        assert PL.serve_placement(build_model(cfg), make_test_layout(2, 4)).specs


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
    step = build_train_step(build_model(cfg), None if placement is not None else make_test_layout(2, 4),
                            AdamWConfig(**OPT))
    params = lm if placement is None else placement.place(lm)
    opt = adamw_init(params, AdamWConfig(**OPT))
    mets = []
    for i in range(STEPS):
        params, opt, met = step(params, opt, _batch(cfg, 30 + i))
        mets.append((float(met["loss"]), float(met["gnorm"])))
    gather = placement.gather if placement is not None else (lambda t: t.tree() if hasattr(t, "tree") else t)
    flat = lambda tree: {p: NP(a) for p, a in S.named_leaves(gather(tree))}
    return mets, flat(params), opt, (flat(opt["m"]), flat(opt["v"]))


def _within(got, want, what):
    (mets, params), (wmets, wparams) = got, want
    for (l, g), (wl, wg) in zip(mets, wmets):
        np.testing.assert_allclose(l, wl, atol=1e-5, rtol=0, err_msg=f"{what}: loss")
        np.testing.assert_allclose(g, wg, rtol=5e-4, atol=0, err_msg=f"{what}: gnorm")
    assert set(params) == set(wparams)
    for p in params:
        np.testing.assert_allclose(params[p], wparams[p], atol=OPT["lr"] / 2, rtol=0, err_msg=f"{what}: {p}")


def _decayed_alone(p0, steps, wd):
    """A leaf after ``steps`` AdamW steps of zero gradient, in float32 as
    the update computes it: weight decay alone at each step's lr."""
    p = p0.astype(np.float32)
    for t in range(1, steps + 1):
        lr = np.float32(min(t / OPT["warmup_steps"], 1.0)) * np.float32(OPT["lr"])
        p = p - (p * np.float32(wd)) * lr
    return p


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch,plane", CASES)
def test_placed_step_equals_the_reference_sharded_step(arch, plane, micro, mesh24):
    jcfg, cfg, jp, lm = _pair(arch, plane, fsdp=True, micro=micro)
    want = _reference_run(jcfg, jp, mesh24)
    placement = PL.train_placement(build_model(cfg), make_test_layout(2, 4))
    mets, params, opt, (m, v) = _port_run(cfg, lm, placement)
    _within((mets, params), want, "placed vs reference")
    assert int(opt["step"]) == STEPS and PL.is_placed(opt["m"]) and PL.is_placed(opt["v"])
    whole_lm = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    whole = _port_run(cfg, whole_lm)
    _within((mets, params), whole[:2], "placed vs unsharded")
    moe_leaves = [p for p in params if p[-2:-1] == ("moe",) or p[-1] == "ln2"]
    assert len(moe_leaves) == 5
    for p in moe_leaves:
        if plane == "dense_tp":  # real gradients: the moments move (the router's only under top-2)
            assert (np.abs(m[p]).max() > 0) == (cfg.top_k > 1 or p[-1] != "router"), p
            continue
        p0 = np.asarray(_blocks(jp, p))
        ulp = np.spacing(np.abs(_decayed_alone(p0, STEPS, AdamWConfig().weight_decay)).astype(np.float32))
        assert np.all(np.abs(params[p] - _decayed_alone(p0, STEPS, AdamWConfig().weight_decay)) <= ulp), p
        assert not m[p].any() and not v[p].any(), p


def test_placed_train_runs_the_moe_configs(tmp_path):
    """``train(place=True)`` on llama4-scout smoke: the placed state comes
    back placed and its losses are the unsharded run's within 1e-5."""
    from repro_torch.launch.train import train

    kw = dict(arch="llama4-scout-17b-16e", smoke=True, steps=2, batch=4, seq=16, ckpt_every=0, verbose=False,
              device="cpu")
    params, opt, losses = train(ckpt_dir=str(tmp_path / "placed"), place=True, **kw)
    assert PL.is_placed(params) and PL.is_placed(opt["m"])
    whole = train(ckpt_dir=str(tmp_path / "whole"), **kw)[2]
    np.testing.assert_allclose([l for _, l in losses], [l for _, l in whole], atol=1e-5, rtol=0)


# ------------------------------------------------------- decode and prefill
def _tokens(vocab, seed=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (B, 1)).astype(np.int32) for _ in range(DECODE_STEPS)]


@functools.lru_cache(maxsize=None)
def _reference_decode(arch, plane):
    """The reference's decode step with its drops (``TF.forward`` as its
    ``decode_fn`` calls it) jitted with ``build_decode_step``'s shardings
    on ``make_test_mesh(2, 4)``, from seeded caches: each step's logits and
    drops."""
    jcfg, _, jp, _ = _pair(arch, plane, cf=CF)
    jmodel, mesh = jbuild(jcfg), make_test_mesh(2, 4)
    _, shardings = jbuild_decode_step(jmodel, mesh, batch=B, max_len=T)

    def step(params, token, caches):
        positions = jfirst_cache_pos(caches, token.shape[0])[:, None].astype(jnp.int32)
        logits, new, drops = JTF.forward(params, token, jcfg, mesh=mesh, caches=caches, positions=positions)
        return logits[:, -1], new, drops

    jitted = jax.jit(step, in_shardings=(shardings["params"], None, shardings["caches"]),
                     out_shardings=(None, shardings["caches"], None))
    put = lambda c: jax.device_put(c, shardings["caches"])
    params, caches = jax.device_put(jp, shardings["params"]), put(_seeded_caches(jmodel, B, T, DEPTHS, seed=7))
    logits, drops = [], []
    for i, tok in enumerate(_tokens(jcfg.vocab_size)):
        out, caches, d = jitted(params, jnp.asarray(tok), caches)
        logits.append(np.asarray(out))
        drops.append(int(d))
        if i + 1 == RESET[0]:
            caches = put(jreset_slot(caches, RESET[1]))
    return np.stack(logits), drops


def _port_decode(arch, plane):
    jcfg, cfg, _, lm = _pair(arch, plane, cf=CF)
    model, layout = build_model(cfg), make_test_layout(2, 4)
    params = PL.serve_placement(model, layout).place(lm)
    cp = PL.cache_placement(model, layout, B, T)
    caches = cp.place(_to_torch(_seeded_caches(jbuild(jcfg), B, T, DEPTHS, seed=7)))
    step = model.decode_fn(drops=True)
    logits, drops = [], []
    for i, tok in enumerate(_tokens(cfg.vocab_size)):
        out, caches, d = step(params, torch.from_numpy(tok), caches)
        logits.append(NP(out))
        drops.append(int(d))
        if i + 1 == RESET[0]:
            caches = reset_slot(caches, RESET[1])
    return np.stack(logits), drops


@pytest.mark.parametrize("arch,plane", CASES)
def test_placed_decode_equals_the_reference_sharded_decode(arch, plane):
    want, wdrops = _reference_decode(arch, plane)
    got, drops = _port_decode(arch, plane)
    assert float(np.abs(got - want).max()) <= TOL
    assert drops == wdrops and sum(wdrops) > 0, (drops, wdrops)


@pytest.mark.parametrize("arch,plane", CASES)
def test_placed_prefill_equals_the_reference_sharded_prefill(arch, plane):
    jcfg, cfg, jp, lm = _pair(arch, plane, cf=CF)
    fn, shardings = jbuild_prefill_step(jbuild(jcfg), make_test_mesh(2, 4))
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, 12)).astype(np.int32)
    want = np.asarray(jax.jit(fn, in_shardings=(shardings["params"], None))(
        jax.device_put(jp, shardings["params"]), {"tokens": jnp.asarray(tokens)}))
    model = build_model(cfg)
    params = PL.serve_placement(model, make_test_layout(2, 4)).place(lm)
    got = NP(model.prefill_fn()(params, {"tokens": torch.from_numpy(tokens)}))
    assert got.shape == want.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _per_group_buckets(idx, cfg, ranks):
    """The planted fault: each data group ranked alone at its own capacity."""
    L, n, k = idx.shape
    cap = int(np.ceil(n * k / cfg.num_experts * cfg.capacity_factor))
    flat = idx.reshape(L, n * k).to(torch.int64)
    pos = M._bucket_rows(flat, torch.ones_like(flat, dtype=torch.bool), cfg.num_experts)
    per_rank = torch.where(ranks.mrank == 0, (pos >= cap).sum(dim=1), 0)
    return pos, cap, ranks.comm.psum(per_rank).to(torch.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_planted_per_group_capacity_fails(monkeypatch, arch):
    want, wdrops = _reference_decode(arch, "dense_tp")
    monkeypatch.setattr(M, "_global_buckets", _per_group_buckets)
    got, drops = _port_decode(arch, "dense_tp")
    assert drops != wdrops, (drops, wdrops)


# --------------------------------------------------------------- the engine
def _requests(cfg, cls, n=10, seed=11):
    rng = np.random.default_rng(seed)
    specs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(2, 9))).astype(np.int32), int(rng.integers(2, 8)))
             for _ in range(n)]
    return [cls(rid=i, prompt=p, max_new_tokens=k) for i, (p, k) in enumerate(specs)]


def _reference_engine(jcfg, jp, mesh):
    """The reference engine, its step jitted with its drops kept."""
    engine = JEngine(jbuild(jcfg), jp, slots=8, max_len=32, mesh=mesh)

    def step(params, token, caches):
        positions = jfirst_cache_pos(caches, token.shape[0])[:, None].astype(jnp.int32)
        logits, new, d = JTF.forward(params, token, jcfg, mesh=mesh, caches=caches, positions=positions)
        return logits[:, -1], new, d

    jitted, drops = jax.jit(step), []

    def keep(params, token, caches):
        logits, caches, d = jitted(params, token, caches)
        drops.append(int(d))
        return logits, caches

    engine.step_fn = keep
    return engine.run(_requests(jcfg, JRequest)), drops


@pytest.mark.parametrize("arch,plane", CASES)
def test_placed_engine_equals_the_unsharded_and_the_reference(arch, plane, mesh24):
    jcfg, cfg, jp, lm = _pair(arch, plane, cf=CF)
    model, layout = build_model(cfg), make_test_layout(2, 4)
    engine = BatchedEngine(model, PL.serve_placement(model, layout).place(lm), slots=8, max_len=32, device="cpu")
    placed = engine.run(_requests(cfg, Request))
    whole_engine = BatchedEngine(model, lm, slots=8, max_len=32, layout=layout, device="cpu")
    whole = whole_engine.run(_requests(cfg, Request))
    ref, ref_drops = _reference_engine(jcfg, jp, mesh24)
    drops = [int(d) for d in engine.step_drops]
    assert placed == whole == ref
    assert drops == [int(d) for d in whole_engine.step_drops] == ref_drops and sum(drops) > 0
    assert sum(map(len, placed.values())) == sum(r.max_new_tokens for r in _requests(cfg, Request))


# ------------------------------------------------------------ the call budget
def _one_decode_calls(plane, layers):
    cfg = dataclasses.replace(get_smoke_config("dbrx-132b"), moe_dispatch=plane, num_layers=layers)
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


@pytest.mark.parametrize("plane", PLANES)
def test_one_decode_step_call_budget(plane):
    """One decode step of dbrx smoke on (2, 4), at 2 and 4 layers.  The
    attention of a layer is the dense family's: over ``model`` (tier 1)
    the q and the (k, v) ``all_gather``, the maxima's ``all_gather``, the
    partials' ``psum`` and the row-parallel ``psum``; besides, the
    embedding's ``psum`` and the logits' ``all_gather`` of the vocabulary
    over ``model`` and of the rows over ``data`` (tier 0).  ``rafi_ep``
    adds a layer's two ``forward_work`` rounds, the whole plane's (one
    payload and one count ``all_to_all`` and the delivered total's flat
    ``psum`` each, over all 8 ranks), the combine's ``all_gather`` over
    ``model`` and the drops' flat ``psum``.
    ``dense_tp`` adds the top-k ids' ``all_gather`` over ``data`` and the
    row-parallel ``psum`` over ``model``."""
    for layers in (2, 4):
        counts = _one_decode_calls(plane, layers)
        want = {("all_gather", 1): 3 * layers + 1, ("psum", 1): 2 * layers + 1, ("all_gather", 0): 1}
        if plane == "rafi_ep":
            want[("all_to_all", None)] = 4 * layers
            want[("all_gather", 1)] += layers
            want[("psum", None)] = 3 * layers
        else:
            want[("all_gather", 0)] += layers
            want[("psum", 1)] += layers
        assert counts == want, (layers, counts)


def test_chip_smoke_phase_moe_shard_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.phase_moe_shard`` at a small width on the CPU: every
    check passes."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    monkeypatch.setattr(cs, "FAILURES", [])
    widths = dict(d_model=64, num_heads=16, num_kv_heads=8, head_dim=8, d_ff=128, vocab_size=512)
    out, paths = cs.phase_moe_shard(torch.device("cpu"), widths=widths, SLOTS=8, MAX_LEN=32, N_REQ=6,
                                    PROMPT=(2, 6), NEW=(2, 5), BATCH=(8, 32), TRAIN_STEPS=2, CHECK_STEPS=8,
                                    SMOKE_BATCH=(4, 16), profile=False)
    assert cs.FAILURES == [] and not any(paths["moe_shard"].values())
    assert len(set(out["serve"]["param_bytes_per_rank"])) == 1 and out["serve"]["experts_per_rank"] == 2
    assert out["train"]["placed"]["decay_only_max_ulp"] == 0
