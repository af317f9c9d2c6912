"""The encoder-decoder split over ``model`` (seamless-m4t-medium's smoke
config as the reference ships it: 2 + 2 layers, 4 heads of 16, d_ff 128,
vocabulary 256, no ``dp_over_model``) on placed parameters, against the
JAX reference on the CPU, on the stacked backend.

The layout is the dense family's: the rows over ``data``; the encoder's
bidirectional attention, the decoder's causal and cross-attention
(``attention.self_attention_placed``) on the heads, the MLP on d_ff,
``embed`` and ``lm_head`` on the vocabulary.  Weights are the reference's
seed-0 draw carried into the port by ``params_from_jax``; the helpers
(shards, replicas, bounds, the reference's jitted runs) are
``tests/test_torch_frontend_shard.py``'s, given ``tp=True``.

* (a) Placement, bit for bit: the train placement with ``fsdp`` on and off
  (with seeded AdamW moments) and the serve placement with seeded decode
  caches on (2, 4), (4, 2), (8, 1) and (1, 8): every rank's block equals
  the reference's addressable shard under ``build_train_step`` /
  ``build_decode_step``'s shardings, compared as 32-bit words; a rank's
  bytes are ``specs.device_bytes``.
* (b) The train step: ``fsdp`` off in 1 microbatch and on in 2, on (2, 4),
  and ``fsdp`` off on (1, 8), where ``model`` cuts through the 4 heads
  (q, k and v gathered over it); against the reference's step jitted on
  the same mesh and against the port's unsharded step, over one step with
  ``SM_OPT``: loss within 1e-5, gnorm within 5e-4 relative, each leaf
  within lr / 2 and its move within 1e-2 of the wanted move in L2; every
  replica's block equal, bit for bit.
* (c) Planted faults: the memory passed to the decoder without its
  ``copy_model`` (each model rank then keeps only its heads' share of the
  memory's gradient): the encoder's leaves leave the move bound, the
  decoder's stay ten times closer; the encoder's mask made causal: the prefill logits
  leave their bound.  Both stay finite.
* (d) Decode and prefill on (2, 4): batch 8, ``max_len`` 16, 12 decode
  steps from seeded caches with slot 2 reset after the sixth, the token
  and memory over ``data``, against the reference's decode and prefill
  jitted with its shardings: logits within 1e-4; every cache block within
  1e-4 of the port's unsharded decode's, and within 1e-4 of the
  reference's shard or within (1 + ``CACHE_K``) times the float32
  rounding ``r`` where that is wider (``r``: the port's unsharded float32
  decode's distance from its float64 twin, rounding alone); the port's
  unsharded decode against the reference's on its own, within the same
  bound; ``pos`` bit for bit.
* (e) The call budgets of a decode step and a train step, pinned as
  functions of the layer counts.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_frontend_shard as FS
from repro.launch.mesh import make_test_mesh
from repro.launch.steps import _batch_shardings
from repro.launch.steps import build_decode_step as jbuild_decode_step
from repro.launch.steps import build_prefill_step as jbuild_prefill_step
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.models.api import build_model as jbuild
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import placement as PL
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_test_layout
from repro_torch.launch.serve import reset_slot
from repro_torch.launch.steps import build_train_step
from repro_torch.models import attention as A
from repro_torch.models import encdec as ED
from repro_torch.models import parallel as P
from repro_torch.models.api import build_model, params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init

SM = FS.SM
NP = FS.NP


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(fsdp=False, micro=1):
    return FS._pair(SM, fsdp, micro, True)


# ---------------------------------------------------------------- (a) blocks
@pytest.mark.parametrize("state", ["train", "train_fsdp", "serve"])
@pytest.mark.parametrize("d,m", FS.LAYOUTS)
def test_placement_equals_the_reference_shards(d, m, state):
    jcfg, cfg, jp, lm = _pair(fsdp=state == "train_fsdp")
    jmodel, model, mesh, layout = jbuild(jcfg), build_model(cfg), make_test_mesh(d, m), make_test_layout(d, m)
    if state == "serve":
        _, shardings = jbuild_decode_step(jmodel, mesh, batch=FS.B, max_len=FS.T)
        caches = FS._seeded_caches(jmodel, FS.B, FS.T, FS.DEPTHS, seed=d * 10 + m)
        placement, cp = PL.serve_placement(model, layout), PL.cache_placement(model, layout, FS.B, FS.T)
        placed_caches = cp.place(FS._to_torch(caches))
        assert FS._mismatches(jax.device_put(caches, shardings["caches"]), placed_caches, mesh) == []
        FS._bytes_are_the_rule(cp, placed_caches)
        assert not cp.rows_over_model and cp.specs[("k",)][:3] == (None, S.DATA, S.MODEL)
    else:
        _, shardings = jbuild_train_step(jmodel, mesh)
        placement = PL.train_placement(model, layout)
        jopt = FS._moments(jp, seed=d * 10 + m)
        jstate = jax.device_put(jopt, shardings["opt"])
        state_ = placement.place(FS._to_torch(jopt))
        for k in ("m", "v"):
            assert PL.is_placed(state_[k]) and FS._mismatches(jstate[k], state_[k], mesh) == []
    assert not placement.rows_over_model
    if m > 1:  # tensor parallelism: the vocabulary, the heads and d_ff over model
        assert S.MODEL in S.spec_axes(placement.specs[("embed",)][0])
        assert S.MODEL in S.spec_axes(placement.specs[("lm_head",)][1])
        for blocks in ("enc_blocks", "dec_blocks"):
            assert S.MODEL in S.spec_axes(placement.specs[(blocks, "attn", "wq")][2])
            assert S.MODEL in S.spec_axes(placement.specs[(blocks, "mlp", "wo")][1])
        assert S.MODEL in S.spec_axes(placement.specs[("dec_blocks", "xattn", "wk")][2])
    params = placement.place(lm)
    assert FS._mismatches(jax.device_put(jp, shardings["params"]), params, mesh) == []
    FS._bytes_are_the_rule(placement, params)
    for path, leaf in S.named_leaves(placement.gather(params)):
        assert torch.equal(leaf, FS._blocks(lm.tree(), path)), path


# -------------------------------------------------------------- (b) the step
STEP_CASES = [((2, 4), False, 1), ((2, 4), True, 2), ((1, 8), False, 1)]


def _start():
    return {p: NP(a).copy() for p, a in S.named_leaves(_pair()[3].tree())}


def _placed_run(layout, fsdp, micro):
    jcfg, cfg, jp, _ = _pair(fsdp, micro)
    lm = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    placement = PL.train_placement(build_model(cfg), make_test_layout(*layout))
    return FS._port_run(cfg, lm, placement), placement


@pytest.mark.parametrize("layout,fsdp,micro", STEP_CASES)
def test_placed_step_equals_the_reference_sharded_step(layout, fsdp, micro):
    jcfg, cfg, jp, _ = _pair(fsdp, micro)
    want = FS._reference_run(SM, fsdp, micro, True, layout)
    (mets, params, placed, opt), placement = _placed_run(layout, fsdp, micro)
    start = _start()
    FS._within((mets, params), want, f"placed on {layout} vs reference", start)
    assert int(opt["step"]) == FS.SM_STEPS and PL.is_placed(opt["m"]) and PL.is_placed(opt["v"])
    for name, tree in (("params", placed), ("m", opt["m"]), ("v", opt["v"])):
        assert FS._replicas_disagree(tree, placement) == [], name
    whole_lm = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    FS._within((mets, params), FS._port_run(cfg, whole_lm)[:2], f"placed on {layout} vs unsharded", start)


# ------------------------------------------------------- (c) planted faults
def _move_gaps(params, want, start):
    """``{path: ||move - wanted move|| / ||wanted move||}``."""
    return {p: float(np.linalg.norm((params[p] - start[p]) - (want[p] - start[p]))
                     / np.linalg.norm(want[p] - start[p])) for p in params}


def test_planted_memory_without_copy_fails(monkeypatch):
    """The decoder reads the memory without ``copy_model``: the backward
    pass no longer sums its gradient over ``model``, so each model rank's
    encoder gets only its own heads' share.  The encoder's leaves leave
    the 1e-2 move bound; the decoder's, whose gradients do not pass
    through the memory, move more than ten times closer to the reference's
    (they feel the fault only through the global norm's clipping);
    everything stays finite."""
    want = FS._reference_run(SM, False, 1, True, (2, 4))
    monkeypatch.setattr(ED, "P", types.SimpleNamespace(**{**vars(P), "copy_model": lambda x, ranks: x}))
    (mets, params, _, _), _ = _placed_run((2, 4), False, 1)
    gaps = _move_gaps(params, want[1], _start())
    enc = max(g for p, g in gaps.items() if p[0] in ("enc_blocks", "enc_ln"))
    dec = max(g for p, g in gaps.items() if p[0] not in ("enc_blocks", "enc_ln"))
    assert all(np.isfinite(a).all() for a in params.values()) and np.isfinite(mets).all()
    assert enc > 1e-2 and dec < enc / 10, (enc, dec)


def _prefill(tp_params, model, batch):
    return NP(model.prefill_fn()(tp_params, {k: torch.from_numpy(v) for k, v in batch.items()}))


def _reference_prefill(batch):
    jcfg, _, jp, _ = _pair()
    mesh = make_test_mesh(2, 4)
    fn, shardings = jbuild_prefill_step(jbuild(jcfg), mesh)
    jitted = jax.jit(fn, in_shardings=(shardings["params"], _batch_shardings(mesh, batch, jcfg)))
    return np.asarray(jitted(jax.device_put(jp, shardings["params"]), {k: jnp.asarray(v) for k, v in batch.items()}))


def test_planted_causal_encoder_fails(monkeypatch):
    """The encoder's bidirectional attention given a causal mask: the
    prefill logits leave their 1e-4 bound (finite all the same)."""
    _, cfg, _, lm = _pair()
    model = build_model(cfg)
    params = PL.serve_placement(model, make_test_layout(2, 4)).place(lm)
    batch = FS._prefill_batch(cfg, 9)
    want = _reference_prefill(batch)

    def causal(*args, causal=True, src=None, **kw):
        return A.self_attention_placed(*args, causal=src is None or causal, src=src, **kw)

    monkeypatch.setattr(ED, "A", types.SimpleNamespace(**{**vars(A), "self_attention_placed": causal}))
    got = _prefill(params, model, batch)
    assert np.isfinite(got).all() and np.abs(got - want).max() > 10 * FS.TOL


# -------------------------------------------------- (d) decode and prefill
def _unsharded_runs():
    """The unsharded decodes from the same seeded caches, tokens and memory:
    the reference's (jitted, float32), the port's in float32 and the port's
    float64 twin on the same weights (the float32 run's exact value):
    ``{name: (logits (steps, B, V), {"k", "v": caches})}``, numpy."""
    jcfg, cfg, jp, lm = _pair()
    jmodel = jbuild(jcfg)
    fn, _ = jbuild_decode_step(jmodel, make_test_mesh(2, 4), batch=FS.B, max_len=FS.T)
    start = FS._seeded_caches(jmodel, FS.B, FS.T, FS.DEPTHS, seed=7)
    logits, caches = FS._reference_steps(jax.jit(fn), jp, jax.tree.map(jnp.asarray, start), jcfg.vocab_size,
                                         jnp.asarray(FS._memory()))
    runs = {"reference": (logits, {k: np.asarray(caches[k], np.float64) for k in ("k", "v")})}
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    for name, c, params in (("f32", cfg, lm), ("f64", cfg64, params_from_jax(cfg64, jax.tree.map(np.asarray, jp), device="cpu"))):
        caches = {k: (v.to(c.torch_dtype) if v.is_floating_point() else v) for k, v in FS._to_torch(start).items()}
        step, memory = build_model(c).decode_fn(), torch.from_numpy(np.array(FS._memory())).to(c.torch_dtype)
        logits = []
        for i, tok in enumerate(FS._tokens(cfg.vocab_size)):
            out, caches = step(params, torch.from_numpy(tok), caches, memory)
            logits.append(NP(out))
            if i + 1 == FS.RESET[0]:
                caches = reset_slot(caches, FS.RESET[1])
        runs[name] = (np.stack(logits), {k: NP(caches[k]).astype(np.float64) for k in ("k", "v")})
    return runs


def _cache_gap(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in ("k", "v"))


def test_placed_decode_equals_the_reference_sharded_decode():
    """Logits within 1e-4 of the reference's sharded decode.  The caches
    against the float32 rounding ``r`` of one decode at these inputs: the
    largest |difference| of the port's unsharded float32 decode's caches
    from its float64 twin's.  ``r`` is rounding alone (a fault in the code
    both runs share sits in both and cancels): 1.5e-4 here, all in the
    second decoder layer's k and v (the first's are within 6e-6).  Inside
    the first layer's MLP the gated product reaches ~155 and its output
    (~60) carries 3.3e-4 of rounding, which the residual, ``ln1`` and
    ``wk`` / ``wv`` carry into the next layer's k and v.  The reference
    rounds there too, 2.7e-4 from the exact value (1.8 ``r``); its sharded
    and unsharded runs share XLA's summation order and so most of that
    rounding (8.8e-5 apart), which undercounts the noise against another
    implementation.  Two float32 decodes of different code then lie
    within ``r`` + ``CACHE_K`` · ``r`` of each other: the port's rounding
    and the reference's.  Held: (1) the port's unsharded decode against
    the reference's unsharded one, on their own: logits within 1e-4, the
    first layer's caches within 1e-4, all caches within (1 + ``CACHE_K``)
    · ``r`` (2.9e-4 here); (2) the placed decode's caches within 1e-4 of
    the port's unsharded decode's (2.9e-5), ``pos`` equal; (3) every
    placed cache block within 1e-4 of the reference's shard, or (1 +
    ``CACHE_K``) · ``r`` where that is wider (2.0e-4 here), ``pos`` bit
    for bit."""
    runs = _unsharded_runs()
    r = _cache_gap(runs["f32"][1], runs["f64"][1])
    bound = max(FS.TOL, (1 + FS.CACHE_K) * r)
    (logits, caches), (ref_logits, ref_caches) = runs["f32"], runs["reference"]
    first = max(float(np.abs(caches[k][0] - ref_caches[k][0]).max()) for k in ("k", "v"))
    whole_gap, whole_logit_gap = _cache_gap(caches, ref_caches), float(np.abs(logits - ref_logits).max())
    assert whole_logit_gap <= FS.TOL and first <= FS.TOL and whole_gap <= bound, (whole_logit_gap, first, whole_gap, r)
    placed = FS._port_decode(SM, True)[1]
    placed = placed.placement.gather(placed)
    placed_gap = _cache_gap({k: NP(placed[k]).astype(np.float64) for k in ("k", "v")}, caches)
    assert placed_gap <= FS.TOL, placed_gap
    logit_gap, cache_gap, pos_equal, got = FS._decode_gaps(SM, True)
    assert logit_gap <= FS.TOL and cache_gap <= bound and pos_equal, (logit_gap, cache_gap, r, pos_equal)
    assert got.shape == (FS.DECODE_STEPS, FS.B, get_smoke_config(SM).vocab_size)
    pos = np.asarray(FS._reference_decode(SM, True)[1]["pos"])
    assert pos[0].tolist() == [12, 15, 6, 15, 13, 15, 14, 15] and torch.equal(placed["pos"], torch.from_numpy(pos.copy()))


def test_placed_prefill_equals_the_reference_sharded_prefill():
    _, cfg, _, lm = _pair()
    model = build_model(cfg)
    params = PL.serve_placement(model, make_test_layout(2, 4)).place(lm)
    batch = FS._prefill_batch(cfg, 9)
    want = _reference_prefill(batch)
    params.placement.comm.reset()
    got = _prefill(params, model, batch)
    assert got.shape == want.shape == (FS.B, cfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=FS.TOL, rtol=0)
    counts = FS._counts(params.placement.comm)
    n, e = cfg.num_layers, cfg.encoder_layers  # as the decode budget, the vocabulary and rows gathered once
    assert counts == {("psum", 1): 2 * e + 3 * n + 1, ("all_gather", 1): 1, ("all_gather", 0): 1}, counts


# ------------------------------------------------------- (e) the call budget
def _cfg(enc, dec, fsdp=False, remat=False):
    return dataclasses.replace(get_smoke_config(SM), encoder_layers=enc, num_layers=dec, fsdp=fsdp, remat=remat)


def _one_decode_calls(layers):
    cfg = _cfg(1, layers)
    model, layout = build_model(cfg), make_test_layout(2, 4)
    sp = PL.serve_placement(model, layout)
    params = sp.place(model.init(torch.Generator().manual_seed(0), device="cpu"))
    caches = PL.cache_placement(model, layout, FS.B, FS.T).zeros("cpu")
    sp.comm.reset()
    model.decode_fn()(params, torch.zeros((FS.B, 1), dtype=torch.int32), caches,
                      torch.zeros((FS.B, FS.FRAMES, cfg.d_model)))
    return FS._counts(sp.comm)


def test_one_decode_step_call_budget():
    """One placed decode step on (2, 4) of n decoder layers.  Each layer:
    the cached self-attention as the dense family's (q, (k, v) and the
    maxima ``all_gather``ed over ``model``, the partials' and ``wo``'s
    ``psum``s), the cross-attention's ``wo`` ``psum`` (its 4 heads on 4
    model ranks: no gather) and the MLP's ``psum``: 3 gathers and 4 sums.
    Once a step: the embedding's ``psum`` and the logits' vocabulary
    ``all_gather`` over ``model``, their rows' ``all_gather`` over
    ``data``.  The memory's ``copy_model`` issues no call forward."""
    for n in (1, 2, 3):
        want = {("all_gather", 1): 3 * n + 1, ("psum", 1): 4 * n + 1, ("all_gather", 0): 1}
        assert _one_decode_calls(n) == want, (n, _one_decode_calls(n))


def _one_train_calls(enc, dec, fsdp, remat):
    cfg = _cfg(enc, dec, fsdp, remat)
    model = build_model(cfg)
    pl = PL.train_placement(model, make_test_layout(2, 4))
    params = pl.place(model.init(torch.Generator().manual_seed(0), device="cpu"))
    opt = adamw_init(params, AdamWConfig(**FS.SM_OPT))
    pl.comm.reset()
    build_train_step(model, None, AdamWConfig(**FS.SM_OPT))(params, opt, FS._batch(cfg, 3))
    return FS._counts(pl.comm), pl


@pytest.mark.parametrize("fsdp,remat", [(False, False), (True, False), (False, True)])
def test_one_train_step_call_budget(fsdp, remat):
    """One placed train step on (2, 4) (one microbatch) of e encoder and n
    decoder layers.  Over ``model``, forward: an encoder layer's attention
    ``wo`` and MLP ``psum``s, a decoder layer's self-attention ``wo``,
    cross-attention ``wo`` and MLP ``psum``s, the embedding's ``psum``,
    the loss's maxima ``all_gather`` and its sums' ``psum``; backward,
    each ``copy_model``'s sum of the partial input gradients: an encoder
    layer's attention and MLP inputs, a decoder layer's self-attention,
    cross-attention query and MLP inputs, the memory once for all the
    decoder's layers and the head's input.  So 4e + 6n + 4 ``psum``s and
    one ``all_gather`` over ``model``; with ``remat`` e + 2n more, the sums
    a layer's recompute issues before the checkpoint stops it (the
    attention ``wo``'s; the MLP's output is saved by no backward, as
    ``chip_smoke._encdec_tp_train_calls`` pins at full depth).  Over
    ``data``, every leaf not
    split over it ``psum``'d (without ``fsdp``) or ``all_gather``ed and
    ``reduce_scatter``ed (with it: a stacked leaf once for all its
    layers), beside the loss's ``psum``; the norm's flat ``psum``."""
    for enc, dec in ((1, 1), (2, 1), (1, 2)):
        counts, pl = _one_train_calls(enc, dec, fsdp, remat)
        split = sum(any(S.DATA in S.spec_axes(part) for part in spec) for spec in pl.specs.values())
        again = enc + 2 * dec if remat else 0
        want = {("psum", 1): 4 * enc + 6 * dec + 4 + again, ("all_gather", 1): 1, ("psum", None): 1}
        if fsdp:
            want.update({("all_gather", 0): split, ("reduce_scatter", 0): split})
        unsplit = len(pl.paths) - split
        want[("psum", 0)] = unsplit + 1
        assert counts == want, (fsdp, remat, enc, dec, counts, want)


# ------------------------------------------------------------ the refusal
def test_the_full_vocabulary_refuses_a_model_of_four():
    """The full config without ``dp_over_model``: its vocabulary of
    256,206 = 2 × 128,103 refuses a ``model`` of 4 and places on (4, 2)."""
    full = build_model(dataclasses.replace(get_config(SM), dp_over_model=False))
    for fn in (PL.train_placement, PL.serve_placement):
        with pytest.raises(ValueError, match=r"embed \(256206, 1024\): the model axis \(4\) does not divide the "
                                             r"vocabulary \(256206\)"):
            fn(full, make_test_layout(2, 4))
        placement = fn(full, make_test_layout(4, 2))
        assert placement.specs[("embed",)] == (S.MODEL, None) and placement.specs[("lm_head",)] == (None, S.MODEL)
