"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``)
against the JAX reference on the CPU.

Inputs are made from a seed with numpy; weights are the reference's
(``build_model(cfg).init(PRNGKey(0))``) carried into the port by
``params_from_jax``, so both packages compute the same function.  JAX runs
the MoE dispatch on the ``(2, 4)`` test mesh, the port on the ``(2, 4)``
layout.  Tolerances (float32 smoke configs):

* ``rmsnorm``, ``glu_mlp``, the RoPE angles and ``apply_rope``: 1e-6;
* ``self_attention`` (parallel, KV-blocked, decode): 1e-5;
* ``moe_dense_tp``, ``moe_rafi_ep``: 1e-5, and their drop counts exactly;
* ``forward`` logits and decode steps of every smoke config (the
  encoder-decoder's prefill and decode against its memory): 1e-4.

Everything that only moves or counts (router indices, drops, parameter
counts) is held exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import encdec as JED
from repro.models import moe as JM
from repro.models import rope as JR
from repro.models import transformer as JTF
from repro.models.api import build_model as jbuild
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch.mesh import Layout, make_test_layout
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import encdec as ED
from repro_torch.models import moe as M
from repro_torch.models import rope as R
from repro_torch.models import transformer as TF
from repro_torch.models.api import build_model, params_from_jax

T = lambda a: torch.from_numpy(np.array(a))  # a writable copy
NP = lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(a, b, tol):
    np.testing.assert_allclose(NP(a), NP(b), atol=tol, rtol=tol)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(arch, **changes):
    """(JAX config, port config, JAX params, port LM) for a smoke arch."""
    jcfg = dataclasses.replace(jget_smoke(arch), **changes)
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")


# ------------------------------------------------------------------ common
def test_config_copies_equal_the_reference():
    for arch in ARCHS:
        for ours, theirs in ((get_config(arch), jget_config(arch)), (get_smoke_config(arch), jget_smoke(arch))):
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_of_the_full_config_equals_the_reference(arch):
    """The published widths, counted from shapes on both sides."""
    assert build_model(get_config(arch)).param_count() == jbuild(jget_config(arch)).param_count()


def test_rmsnorm_and_glu_mlp():
    rng = np.random.default_rng(0)
    x, g = _normal(rng, 3, 5, 64), _normal(rng, 64, scale=0.1)
    close(C.rmsnorm(T(x), T(g)), JC.rmsnorm(jnp.asarray(x), jnp.asarray(g)), 1e-6)
    wi, wg, wo = _normal(rng, 64, 96, scale=0.1), _normal(rng, 64, 96, scale=0.1), _normal(rng, 96, 64, scale=0.1)
    for act in ("silu", "gelu"):
        close(C.glu_mlp(T(x), T(wi), T(wg), T(wo), act),
              JC.glu_mlp(*map(jnp.asarray, (x, wi, wg, wo)), act), 1e-6)


@pytest.mark.parametrize("theta", [1e4, 5e5, 1e6])
def test_rope_angles_and_apply_rope(theta):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 64, (2, 16)).astype(np.int32)
    cos, sin = R.rope_angles(T(pos), 16, theta)
    jcos, jsin = JR.rope_angles(jnp.asarray(pos), 16, theta)
    close(cos, jcos, 1e-6)
    close(sin, jsin, 1e-6)
    x = _normal(rng, 2, 16, 4, 16)
    close(R.apply_rope(T(x), cos, sin), JR.apply_rope(jnp.asarray(x), jcos, jsin), 1e-6)
    # bfloat16 activations against float32 angles: promoted, rotated, cast back
    xb = T(x).to(torch.bfloat16)
    got = R.apply_rope(xb, cos, sin)
    want = JR.apply_rope(jnp.asarray(x, jnp.bfloat16), jcos, jsin)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))


@pytest.mark.parametrize("head_dim", [16, 128])
def test_mrope_angles(head_dim):
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 64, (2, 8, 3)).astype(np.int32)
    cos, sin = R.mrope_angles(T(pos), head_dim, 1e6)
    jcos, jsin = JR.mrope_angles(jnp.asarray(pos), head_dim, 1e6)
    close(cos, jcos, 1e-6)
    close(sin, jsin, 1e-6)


# --------------------------------------------------------------- attention
def _attn_case(cfg, seed):
    rng = np.random.default_rng(seed)
    defs = JA.attn_defs(cfg)
    # the reference's init scales (1/sqrt(fan-in) unless declared), biases nonzero
    p = {k: _normal(rng, *d.shape, scale=d.scale or 1 / np.sqrt(d.shape[0])) for k, d in defs.items()}
    return rng, p


@pytest.mark.parametrize("arch,window", [("qwen2-7b", 0), ("gemma3-1b", 8), ("qwen2-vl-72b", 0)])
def test_self_attention_parallel(arch, window):
    cfg = get_smoke_config(arch)
    rng, p = _attn_case(cfg, 3)
    x = _normal(rng, 2, 16, cfg.d_model)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    got, _ = A.self_attention({k: T(v) for k, v in p.items()}, T(x), cfg, positions=T(pos), window=window)
    want, _ = JA.self_attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jget_smoke(arch),
                                positions=jnp.asarray(pos), window=window)
    close(got, want, 1e-5)


@pytest.mark.parametrize("window", [0, 300])
def test_self_attention_blocked_at_2048(window):
    """s > 1024 takes ``_sdpa_blocked`` (two 1,024-row KV blocks) with tiny heads."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-7b"), d_model=16, num_heads=2, num_kv_heads=1, head_dim=8)
    jcfg = dataclasses.replace(jget_smoke("qwen2-7b"), d_model=16, num_heads=2, num_kv_heads=1, head_dim=8)
    rng, p = _attn_case(cfg, 4)
    x = _normal(rng, 1, 2048, 16)
    pos = np.arange(2048, dtype=np.int32)[None]
    got, _ = A.self_attention({k: T(v) for k, v in p.items()}, T(x), cfg, positions=T(pos), window=window)
    want, _ = JA.self_attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
                                positions=jnp.asarray(pos), window=window)
    close(got, want, 1e-5)
    # the blocked pass against the materialising one, in the port alone
    plain, _ = A.self_attention({k: T(v) for k, v in p.items()}, T(x),
                                dataclasses.replace(cfg, blocked_attention=False), positions=T(pos), window=window)
    close(got, plain, 1e-5)


@pytest.mark.parametrize("arch,window", [("qwen2-7b", 0), ("gemma3-1b", 4)])
def test_self_attention_decode_at_row_positions(arch, window):
    """Two decode steps with the rows at different depths of the cache."""
    cfg = get_smoke_config(arch)
    rng, p = _attn_case(cfg, 5)
    b, t = 3, 16
    cache = {k: _normal(rng, b, t, cfg.num_kv_heads, cfg.head_dim) for k in ("k", "v")}
    cache["pos"] = np.array([0, 5, 11], np.int32)
    tc = {k: T(v.copy()) for k, v in cache.items()}
    jc = jax.tree.map(jnp.asarray, cache)
    tp_, jp_ = {k: T(v) for k, v in p.items()}, jax.tree.map(jnp.asarray, p)
    for _ in range(2):
        x = _normal(rng, b, 1, cfg.d_model)
        got, tc = A.self_attention(tp_, T(x), cfg, positions=tc["pos"][:, None], window=window, cache=tc)
        want, jc = JA.self_attention(jp_, jnp.asarray(x), jget_smoke(arch), positions=jc["pos"][:, None],
                                     window=window, cache=jc)
        close(got, want, 1e-5)
        for k in ("k", "v"):
            close(tc[k], jc[k], 1e-5)
        np.testing.assert_array_equal(NP(tc["pos"]), NP(jc["pos"]))


# --------------------------------------------------------------------- moe
def _moe_case(arch, seed, shape=(4, 16), **changes):
    jcfg = dataclasses.replace(jget_smoke(arch), **changes)
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    p = jax.tree.map(np.asarray, JC.init_params(JM.moe_defs(jcfg), jax.random.PRNGKey(seed), jnp.float32))
    x = _normal(np.random.default_rng(seed), *shape, cfg.d_model)
    return jcfg, cfg, p, x


@pytest.mark.parametrize("arch", ["llama4-scout-17b-16e", "dbrx-132b"])
def test_router_indices_equal(arch):
    jcfg, cfg, p, x = _moe_case(arch, 6)
    x2 = x.reshape(-1, cfg.d_model)
    idx, w = M._router({"router": T(p["router"])}, T(x2), cfg)
    jidx, jw = JM._router({"router": jnp.asarray(p["router"])}, jnp.asarray(x2), jcfg)
    np.testing.assert_array_equal(NP(idx), NP(jidx))
    close(w, jw, 1e-6)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-16e", "dbrx-132b"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_dense_tp(arch, cf):
    jcfg, cfg, p, x = _moe_case(arch, 7, moe_dispatch="dense_tp", capacity_factor=cf)
    y, d = M.moe_dense_tp({k: T(v) for k, v in p.items()}, T(x), cfg)
    jy, jd = JM.moe_dense_tp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    assert int(d) == int(jd)
    close(y, jy, 1e-5)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-16e", "dbrx-132b"])
@pytest.mark.parametrize("shape", [(4, 16), (4, 1), (2, 1)])
def test_moe_rafi_ep_drops_and_outputs_equal_the_reference(arch, shape, mesh24):
    """At the configs' capacity_factor=1.25 tokens drop: the port drops
    exactly as many as the reference, and the outputs agree within 1e-5.
    (4, 1) and (2, 1) are the decode shapes of 4 and 2 serving slots."""
    jcfg, cfg, p, x = _moe_case(arch, 8, shape)
    y, d = M.moe_rafi_ep({k: T(v) for k, v in p.items()}, T(x), cfg, layout=make_test_layout(2, 4))
    jy, jd = jax.jit(lambda p, x: JM.moe_rafi_ep(p, x, jcfg, mesh=mesh24))(jax.tree.map(jnp.asarray, p),
                                                                          jnp.asarray(x))
    assert int(d) == int(jd)
    if shape == (4, 16):
        assert int(d) > 0  # the drop contract is exercised
    close(y, jy, 1e-5)


@pytest.mark.parametrize("layout", [Layout(2, 4), Layout(1, 4), Layout(4, 2), Layout(1, 1)])
def test_moe_rafi_ep_matches_its_dense_tp(layout):
    """The twin of ``test_moe_rafi_matches_dense_tp``: at capacity_factor=8
    nothing drops and the forwarding dispatch computes the dense MoE, on
    every layout."""
    _, cfg, p, x = _moe_case("dbrx-132b", 0, capacity_factor=8.0)
    tp_ = {k: T(v) for k, v in p.items()}
    y_tp, d_tp = M.moe_dense_tp(tp_, T(x), cfg)
    y_ep, d_ep = M.moe_rafi_ep(tp_, T(x), cfg, layout=layout)
    assert int(d_tp) == 0 and int(d_ep) == 0
    close(y_ep, y_tp, 2e-5)


def test_moe_rafi_ep_split_steps_compose():
    """``moe_rafi_ep`` is its route, dispatch, experts, return and combine
    steps; the delivered queue holds every routed token once, in the
    destination's group."""
    _, cfg, p, x = _moe_case("llama4-scout-17b-16e", 9, capacity_factor=8.0)
    tp_ = {k: T(v) for k, v in p.items()}
    lay = make_test_layout(2, 4)
    route = M.rafi_ep_route(tp_, T(x), cfg, layout=lay)
    q = M.rafi_ep_dispatch(route)
    assert int(q.count.sum()) == int(route.mask.sum()) == x.shape[0] * x.shape[1]
    back, dest, valid, drops_cap = M.rafi_ep_experts(tp_, q, route, cfg)
    y = M.rafi_ep_combine(M.rafi_ep_return(route, back, dest, valid), route)
    assert int(drops_cap) == 0
    close(y, M.moe_rafi_ep(tp_, T(x), cfg, layout=lay)[0], 0.0)
    e_loc = cfg.num_experts // lay.model
    for r in range(lay.num_ranks):
        n = int(q.count[r])
        assert (NP(q.items.expert[r, :n]) // e_loc == r % lay.model).all()


# ----------------------------------------------------------------- forward
def _encdec_forward_and_decode(jcfg, cfg, jp, m):
    """The encoder-decoder: ``prefill_fn`` of 2×16 frames and tokens, then
    two decode steps against the encoder memory from fresh caches."""
    rng = np.random.default_rng(10)
    batch = {"frames": _normal(rng, 2, 16, cfg.d_model),
             "tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}
    model, jmodel = build_model(cfg), jbuild(jcfg)
    close(model.prefill_fn()(m, {k: T(v) for k, v in batch.items()}),
          jax.jit(jmodel.prefill_fn())(jp, {k: jnp.asarray(v) for k, v in batch.items()}), 1e-4)
    mem = ED.encode(m, T(batch["frames"]), cfg)
    jmem = JED.encode(jp, jnp.asarray(batch["frames"]), jcfg)
    caches, jcaches = model.init_caches(2, 32, device="cpu"), jmodel.init_caches(2, 32)
    step, jstep = model.decode_fn(), jax.jit(jmodel.decode_fn())
    for t in range(2):
        got, caches = step(m, T(batch["tokens"][:, t:t + 1]), caches, mem)
        want, jcaches = jstep(jp, jnp.asarray(batch["tokens"][:, t:t + 1]), jcaches, jmem)
        close(got, want, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_equal_the_reference(arch, mesh24):
    """``forward`` logits (and MoE drops) of a 2×16 batch, then two decode
    steps from fresh caches: within 1e-4 (the encoder-decoder: its prefill
    and two steps against the encoder memory)."""
    jcfg, cfg, jp, lm = _pair(arch)
    if cfg.kind == "encdec":
        return _encdec_forward_and_decode(jcfg, cfg, jp, lm)
    moe = cfg.kind == "moe"
    jmesh, lay = (mesh24, make_test_layout(2, 4)) if moe else (None, None)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    emb = _normal(rng, 2, 16, cfg.d_model) if cfg.frontend == "vision" else None
    logits, _, drops = TF.forward(lm, T(toks), cfg, layout=lay, frontend_embeds=None if emb is None else T(emb))
    jlogits, _, jdrops = jax.jit(lambda p, t, e: JTF.forward(p, t, jcfg, mesh=jmesh, frontend_embeds=e))(
        jp, jnp.asarray(toks), None if emb is None else jnp.asarray(emb))
    close(logits, jlogits, 1e-4)
    assert int(drops) == int(jdrops)

    model, jmodel = build_model(cfg), jbuild(jcfg)
    caches, jcaches = model.init_caches(2, 32, device="cpu"), jmodel.init_caches(2, 32)
    step, jstep = model.decode_fn(lay), jax.jit(jmodel.decode_fn(mesh=jmesh))
    for t in range(2):
        got, caches = step(lm, T(toks[:, t:t + 1]), caches)
        want, jcaches = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jcaches)
        close(got, want, 1e-4)


def test_modules_forward_equal_the_free_functions():
    """``LM``, ``Layer``, ``Attention`` and ``MoE`` are the parameters with
    the free functions as ``forward``: the same numbers bit for bit."""
    _, cfg, _, lm = _pair("llama4-scout-17b-16e")
    lay = make_test_layout(2, 4)
    toks = T(np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32))
    tree = lm.tree()
    for a, b in zip(lm(toks, layout=lay)[::2], TF.forward(tree, toks, cfg, layout=lay)[::2]):
        assert torch.equal(a, b)
    layer = lm.blocks.k0_moe
    x = T(_normal(np.random.default_rng(13), 2, 8, cfg.d_model))
    pos = torch.arange(8).expand(2, 8)
    got = layer(x, positions=pos, layout=lay, index=1)
    want = TF.apply_layer(TF._index(tree["blocks"]["k0_moe"], 1), x, cfg, "moe", positions=pos, layout=lay)
    assert torch.equal(got[0], want[0]) and int(got[2]) == int(want[2])
    assert torch.equal(layer.attn(x, positions=pos, index=1)[0],
                       A.self_attention(TF._index(tree["blocks"]["k0_moe"]["attn"], 1), x, cfg, positions=pos)[0])
    assert torch.equal(layer.moe(x, layout=lay, index=0)[0],
                       M.moe_block(TF._index(tree["blocks"]["k0_moe"]["moe"], 0), x, cfg, layout=lay)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_keeps_the_tree_and_its_bits(dtype):
    """Parameter names follow the reference's tree paths; every leaf is
    carried bit for bit (stacked blocks included), in either dtype."""
    jcfg = dataclasses.replace(jget_smoke("gemma3-1b"), dtype=dtype)
    jp = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    lm = params_from_jax(dataclasses.replace(get_smoke_config("gemma3-1b"), dtype=dtype), jp, device="cpu")
    flat = dict(lm.named_parameters())
    jflat = {".".join(str(k.key) for k in path): leaf for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    assert set(flat) == set(jflat)
    word = np.uint32 if dtype == "float32" else np.uint16
    for name, leaf in jflat.items():
        got = flat[name].detach()
        assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
        bits = got.view(torch.int32 if dtype == "float32" else torch.int16).numpy().view(word)
        np.testing.assert_array_equal(bits, leaf.view(word))
    with pytest.raises(ValueError):
        params_from_jax(get_smoke_config("qwen2-7b"), jp, device="cpu")


def test_init_draws_truncated_normals_at_the_reference_scales():
    """``Model.init``: seeded, in the config's dtype, every normal leaf
    within [-2, 2] × its scale (the reference's rule, stacked leaves'
    default scale read from their layer axis), zeros where declared."""
    cfg = get_smoke_config("dbrx-132b")
    model = build_model(cfg)
    a = model.init(torch.Generator().manual_seed(3), device="cpu")
    b = model.init(torch.Generator().manual_seed(3), device="cpu")
    tree = a.tree()
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert tree["embed"].dtype == torch.float32
    assert float(tree["embed"].abs().max()) <= 2 * 0.02
    wq = tree["blocks"]["k0_moe"]["attn"]["wq"]  # (2, 64, 64): default scale 1/sqrt(2)
    assert float(wq.abs().max()) <= 2 / np.sqrt(2) + 1e-6 and float(wq.std()) > 0.3
    assert not tree["final_ln"].any() and not tree["blocks"]["k0_moe"]["ln1"].any()


def test_every_reference_arch_builds_in_the_reference_order():
    """The registry names the reference's ten archs in its order; every
    layer kind of their patterns has defs, and each config builds into
    the module of its kind."""
    from repro.configs import ARCHS as JARCHS
    from repro_torch.models.encdec import EncDec

    assert ARCHS == JARCHS
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        for kind in set(cfg.pattern):
            assert set(TF.layer_defs(cfg, kind)) == set(JTF.layer_defs(jget_smoke(arch), kind)), (arch, kind)
        m = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
        assert isinstance(m, EncDec if cfg.kind == "encdec" else TF.LM), arch
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_entry_points_run_on_the_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the rule where no card is present")
    model = build_model(get_smoke_config("qwen2-7b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_caches(2, 8)
    # shapes only, by nature: ``abstract`` and the dry run run on meta,
    # neither on the card nor on the CPU, with or without a card
    from repro_torch.launch import dryrun

    assert {p.device.type for p in model.abstract().parameters()} == {"meta"}
    rec = dryrun.run_cell("qwen2-7b", "decode_32k", force=True, out_dir=tmp_path)
    assert rec["status"] == "ok" and rec["bytes"]["params"] == 2 * rec["n_params"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_moe_dispatch_equals_the_cpu(cuda_device):
    """The delivered queue of ``rafi_ep_dispatch`` on the card (K6, K3, K1,
    K2) equals the plain versions' on the CPU, on lanes < count, bit for
    bit; the whole MoE block within 1e-5."""
    from repro_torch import kernels as KN

    _, cfg, p, x = _moe_case("dbrx-132b", 11)
    lay = make_test_layout(2, 4)
    route = M.rafi_ep_route({k: T(v).to(cuda_device) for k, v in p.items()}, T(x).to(cuda_device), cfg,
                            layout=lay)
    KN.reset_launch_counts()
    q = M.rafi_ep_dispatch(route)
    launches = KN.launch_counts()
    qc = M.rafi_ep_dispatch(route.to("cpu"))
    assert torch.equal(q.count.cpu(), qc.count) and torch.equal(q.drops.cpu(), qc.drops)
    for f in dataclasses.fields(M.TokenItem):
        a, b = getattr(q.items, f.name).cpu(), getattr(qc.items, f.name)
        for r in range(lay.num_ranks):
            n = int(qc.count[r])
            assert torch.equal(a[r, :n], b[r, :n]), f.name
    assert all(launches[k] == 1 for k in ("compact_positions", "pack_and_histogram", "gather_rows", "unmarshal"))
    y, d = M.moe_rafi_ep({k: T(v).to(cuda_device) for k, v in p.items()}, T(x).to(cuda_device), cfg, layout=lay)
    yc, dc = M.moe_rafi_ep({k: T(v) for k, v in p.items()}, T(x), cfg, layout=lay)
    assert int(d) == int(dc)
    close(y, yc, 1e-5)
