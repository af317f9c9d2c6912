"""The port's bfloat16 model arithmetic against the JAX reference's, on
the CPU.

The full configs run bfloat16 (``ModelConfig.dtype``); the other LM tests
hold the float32 smoke configs.  Here both packages run each smoke config
in bfloat16 on the same weights: the reference's ``init`` in bfloat16,
carried into the port bit for bit by ``params_from_jax``.  The reference
is compiled with ``xla_allow_excess_precision`` off (``ROUNDED``), so it
rounds every bfloat16 result as torch does; XLA's default keeps excess
precision inside a fusion.  Distances are the largest |difference|
relative to the largest |value| of the reference's float32 run on the
same weights widened to float32:

* ``d_port``: the port's bfloat16 output against the reference's
  (rounded) bfloat16 output;
* ``d_ref``: the reference's own bfloat16-to-float32 gap.  For the whole
  model it is the larger of the gaps of its two compiled forms (rounded,
  and XLA's default), step by step.

Bounds:

* **Whole model**, all ten archs, seeds 0–2, batch 3 × 64 (4 × 64 for
  MoE): the forward logits, and the logits of each of 8 decode steps from
  fresh caches, each held alone, ``d_port <= K · d_ref`` with **K =
  2.5**.  The encoder-decoder: the encoder memory, the decoder's logits
  over the memory and 8 decode steps against it.  Measured at most 1.08
  (forward, dbrx seed 1) and 1.57 (dbrx seed 1, step 2).
* **One layer of each kind**, seeds 0–2, the reference's per-layer init
  (scale 1/sqrt(fan-in)), input (3, 64, 64) bfloat16 (MoE (4, 64, 64)),
  against the rounded reference: global, local and cross attention
  ``d_port <= 0.5 · d_ref`` (at most 0.35; 99.7–100% of the elements bit
  for bit, the rest one ulp apart from float32 ``exp`` and sum order);
  the GLU MLP (silu and gelu) ``<= 1.5 · d_ref`` (at most 1.35); ``rwkv``
  and ``recurrent`` (RG-LRU) ``<= 1.5 · d_ref`` (at most 1.07); ``moe``
  under ``dense_tp`` and under ``rafi_ep`` (the reference on the ``(2,
  4)`` mesh, the port on the ``(2, 4)`` layout) ``<= 2 · d_ref`` (at most
  1.54).  No kind is bit for bit whole; ``rmsnorm``, the RG-LRU's causal
  conv and the MoE router (experts and bfloat16 weights) are, and are
  held bit for bit.
* **MoE drops**: every MoE case runs at capacity_factor 16, where neither
  package drops a token; both must report 0.  At the configs' 1.25,
  near-tied router scores break differently in the two packages and move
  tokens between experts (the known cause of llama4-scout's distance of
  1.25 at that factor), which is a different result, not noise.

Why the two forms in a step's ``d_ref``: the smoke models are random and
saturated, and a step's gap is one draw of how a few ulps grow through
sharp attention and near-tied routers.  Against XLA's default form alone
the port read 7.94 · d_ref at one step (dbrx seed 1, step 7: a router
tie 0.0016 apart, where the fused run picked another expert than the
port and the rounded run), and the reference's two forms read 4.00 ·
d_ref against each other (gemma3 seed 2, step 2); against the rounded
form alone the port read 5.10 (dbrx seed 1, step 2), where the port's
decode attention on the reference's own input and cache equals it bit for
bit.  So no one form's gap is a floor for a single step; both are.

Two framework differences are not faults, and they set how close the two
packages can come: torch rounds ``silu``, ``gelu`` and ``logaddexp`` once
(the float32 result rounded to bfloat16), while JAX rounds after each
primitive; and XLA keeps excess precision inside its fusions unless told
not to (``ROUNDED``).  They do not justify a looser K.

Planted faults, each caught: softmax in bfloat16 (the attention layer
bounds, 0.84–1.41 · d_ref), ``rmsnorm``'s variance in bfloat16 (the whole
model, up to 91.6, and the bit-for-bit check), the GLU's down projection
summed in bfloat16 (the silu GLU bound, 1.62), the router's softmax in
bfloat16 (the router bit for bit).
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import encdec as JED
from repro.models import griffin as JG
from repro.models import moe as JM
from repro.models import rwkv6 as JW
from repro.models import transformer as JTF
from repro.models.api import build_model as jbuild
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.launch.mesh import make_test_layout
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import encdec as ED
from repro_torch.models import griffin as G
from repro_torch.models import moe as M
from repro_torch.models import rwkv6 as W
from repro_torch.models import transformer as TF
from repro_torch.models.api import build_model, params_from_jax

K = 2.5  # whole model: d_port <= K · d_ref
SEEDS = (0, 1, 2)
DECODE_STEPS = 8
NO_DROP_CF = 16.0  # a capacity factor at which neither package drops a token
# the reference compiled to round every bfloat16 result, as torch does (XLA's
# default keeps excess precision inside a fusion)
ROUNDED = {"xla_allow_excess_precision": False}
LAYER_K = {"global_attn": 0.5, "local_attn": 0.5, "cross_attn": 0.5, "glu_mlp_silu": 1.5, "glu_mlp_gelu": 1.5,
           "rwkv": 1.5, "recurrent": 1.5, "moe_dense_tp": 2.0, "moe_rafi_ep": 2.0}


def _t(a) -> torch.Tensor:
    """A JAX or numpy array as a tensor, bfloat16 carried as its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a).astype(np.float32)


def _widen(a) -> np.ndarray:
    """bfloat16 to float32 on the host (exact; no JAX op to compile)."""
    return np.asarray(a).astype(np.float32)


def _zeros_like(shapes):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _bf16(x: np.ndarray) -> np.ndarray:
    return x.astype(jnp.bfloat16)  # ml_dtypes' round to nearest even, on the host


def _dists(port, jb, jf, jbx=None):
    """(d_port, d_ref) of one output, relative to the largest |float32
    value|; with ``jbx`` (the reference's bfloat16 output as XLA compiles
    it by default) d_ref is the larger of its two bfloat16 gaps."""
    p, b, f = _f32(port), _f32(jb), _f32(jf)
    scale = float(np.abs(f).max())
    d_ref = float(np.abs(b - f).max())
    if jbx is not None:
        d_ref = max(d_ref, float(np.abs(_f32(jbx) - f).max()))
    return float(np.abs(p - b).max()) / scale, d_ref / scale


def _configs(arch, **changes):
    """(JAX bfloat16, JAX float32, port bfloat16) configs of a smoke arch."""
    jb = dataclasses.replace(jget_smoke(arch), dtype="bfloat16", **changes)
    return jb, dataclasses.replace(jb, dtype="float32"), dataclasses.replace(get_smoke_config(arch), dtype="bfloat16",
                                                                             **changes)


# --------------------------------------------------------------- whole model
def _compiled(jobs):
    """``(jitted function, example arguments, compiler options...)``
    tuples, each lowered once, in turn, and compiled once for each options
    dict it names (``ROUNDED`` if none) in threads: XLA's compile releases
    the GIL, and the compiles, not the runs, are most of this file's time.
    The executables in order, a job's options in turn."""
    lowered = [(fn.lower(*args), opts or (ROUNDED,)) for fn, args, *opts in jobs]
    tasks = [(lo, o) for lo, opts in lowered for o in opts]
    with ThreadPoolExecutor(len(tasks)) as pool:
        return list(pool.map(lambda t: t[0].compile(compiler_options=t[1]), tasks))


def _sds(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


def _shape(arch):
    return (4, 64) if jget_smoke(arch).kind == "moe" else (3, 64)


MODES = ("bf16", "bf16x", "f32")  # the reference's runs a whole-model output is held against


@functools.lru_cache(maxsize=None)
def _jax_fns(arch):
    """The reference's compiled functions (once an arch, reused across
    seeds): ``init``, and per mode the forward (encoder, decoder) and the
    decode step, with the caches' shapes.  The modes: ``bf16`` (every
    bfloat16 result rounded, ``ROUNDED``), ``bf16x`` (the same lowering
    compiled with XLA's default options) and ``f32``."""
    moe = jget_smoke(arch).kind == "moe"
    jb, jf, _ = _configs(arch, **({"capacity_factor": NO_DROP_CF} if moe else {}))
    mesh = None
    if moe:
        from repro import compat

        mesh = compat.make_mesh((2, 4), ("data", "model"))
    b, s = _shape(arch)
    key = jax.random.PRNGKey(0)
    init = jax.jit(jbuild(jb).init)  # the reference's init in bfloat16
    p_b = jax.eval_shape(init, key)
    params = {"bf16": p_b, "f32": jax.tree.map(lambda a: _sds(a.shape, jnp.float32), p_b)}
    toks, tok = _sds((b, s), jnp.int32), _sds((b, 1), jnp.int32)
    jobs, names, caches = [(init, (key,))], ["init"], {}
    for k, jc in (("bf16", jb), ("f32", jf)):
        opts, ks = ((ROUNDED, {}), ("bf16", "bf16x")) if k == "bf16" else ((ROUNDED,), ("f32",))
        caches[k] = jax.eval_shape(lambda jc=jc: jbuild(jc).init_caches(b, 32))
        if jc.kind == "encdec":
            mem = _sds((b, s, jc.d_model), jc.jdtype)
            step, extra = jax.jit(jbuild(jc).decode_fn()), (mem,)
            jobs += [(jax.jit(lambda p, f, jc=jc: JED.encode(p, f, jc)),
                      (params[k], _sds((b, s, jc.d_model), jnp.float32)), *opts),
                     (jax.jit(lambda p, t, m, jc=jc: JED.decode(p, t, m, jc)[0]), (params[k], toks, mem), *opts)]
            names += [("encode", x) for x in ks] + [("forward", x) for x in ks]
        else:
            emb = _sds((b, s, jc.d_model), jnp.float32) if jc.frontend == "vision" else None
            step, extra = jax.jit(jbuild(jc).decode_fn(mesh=mesh)), ()
            jobs += [(jax.jit(lambda p, t, e, jc=jc: JTF.forward(p, t, jc, mesh=mesh, frontend_embeds=e)),
                      (params[k], toks, emb), *opts)]
            names += [("forward", x) for x in ks]
        # the first step's caches, and the caches a step returns: the RG-LRU's
        # conv tail starts float32 and comes back in the model dtype
        after = jax.eval_shape(step, params[k], tok, caches[k], *extra)[1]
        jobs += [(step, (params[k], tok, caches[k], *extra), *opts)]
        names += [("step0", x) for x in ks]
        if jax.tree.structure(after) != jax.tree.structure(caches[k]) or jax.tree.leaves(after) != jax.tree.leaves(
                caches[k]):
            jobs += [(step, (params[k], tok, after, *extra), *opts)]
            names += [("step", x) for x in ks]
    caches["bf16x"] = caches["bf16"]
    out = dict(zip(names, _compiled(jobs)), caches=caches)
    for k in MODES:
        out.setdefault(("step", k), out[("step0", k)])  # a step returns the caches' own types
    return out


def _whole_model(arch, seed):
    """{"forward": [(d_port, d_ref)], "decode": [(d_port, d_ref)] a step[,
    "memory": ...]} and the drops of (port, JAX bf16, JAX f32)."""
    moe = jget_smoke(arch).kind == "moe"
    _, _, cfg = _configs(arch, **({"capacity_factor": NO_DROP_CF} if moe else {}))
    fns = _jax_fns(arch)
    jp = {"bf16": fns["init"](jax.random.PRNGKey(seed))}
    jp["f32"] = jax.tree.map(_widen, jp["bf16"])
    jp["bf16x"] = jp["bf16"]
    lm = params_from_jax(cfg, jax.tree.map(np.asarray, jp["bf16"]), device="cpu")
    rng = np.random.default_rng(100 + seed)
    b, s = _shape(arch)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out, drops = {}, None
    model = build_model(cfg)
    caches = model.init_caches(b, 32, device="cpu")
    run = lambda name, *args: {k: fns[(name, k)](jp[k], *args) for k in jp}
    dists = lambda port, want: _dists(port, want["bf16"], want["f32"], want["bf16x"])
    if cfg.kind == "encdec":
        frames = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        mem = ED.encode(lm, _t(frames), cfg)
        jmem = run("encode", frames)
        out["memory"] = [dists(mem, jmem)]
        logits = ED.decode(lm, _t(toks), mem, cfg)[0]
        jl = {k: fns[("forward", k)](jp[k], toks, jmem[k]) for k in jp}
        step = model.decode_fn()
        extra, jextra = (mem,), {k: (jmem[k],) for k in jmem}
    else:
        lay = make_test_layout(2, 4) if moe else None
        emb = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32) if cfg.frontend == "vision" else None
        logits, _, d = TF.forward(lm, _t(toks), cfg, layout=lay, frontend_embeds=None if emb is None else _t(emb))
        jres = run("forward", toks, emb)
        jl = {k: v[0] for k, v in jres.items()}
        drops = (int(d), int(jres["bf16"][2]), int(jres["f32"][2]))
        step = model.decode_fn(lay)
        extra, jextra = (), {k: () for k in jp}
    out["forward"] = [dists(logits, jl)]
    jc = {k: _zeros_like(fns["caches"][k]) for k in jp}
    out["decode"] = []
    for t in range(DECODE_STEPS):
        tk = toks[:, t:t + 1]
        got, caches = step(lm, _t(tk), caches, *extra)
        want = {}
        for k in jp:
            want[k], jc[k] = fns[("step0" if t == 0 else "step", k)](jp[k], tk, jc[k], *jextra[k])
        out["decode"].append(dists(got, want))
    return out, drops


@pytest.fixture(scope="module")
def jax_fns():
    """Every arch's compiled reference functions, all archs at once (XLA
    compiles outside the GIL)."""
    with ThreadPoolExecutor(len(ARCHS)) as pool:
        list(pool.map(_jax_fns, ARCHS))


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_model_bf16_within_k_of_the_reference_gap(arch, jax_fns):
    """Forward and 8 decode steps of every arch on three seeds: the port's
    bfloat16 logits lie within K times the reference's own
    bfloat16-to-float32 gap of the reference's bfloat16 logits; MoE drops
    0 on both sides at the no-drop capacity factor."""
    for seed in SEEDS:
        d, drops = _whole_model(arch, seed)
        for what, per in d.items():
            for i, (d_port, d_ref) in enumerate(per):
                assert d_ref > 0, (arch, seed, what, i)
                assert d_port <= K * d_ref, (
                    f"{arch} seed {seed} {what} {i}: d_port {d_port:.4g} > {K} x d_ref {d_ref:.4g}")
        if drops is not None:
            assert drops == (0, 0, 0), (arch, seed, drops)


# ------------------------------------------------------------------ one layer
def _pos(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()


def _layer_cases():
    """kind -> (arch, defs, port fn, JAX fn, input shape, config changes);
    each fn takes (params, x, cfg, memory) — the encoder memory for
    cross-attention, else None — and returns (out, drops or None)."""
    pos = _pos(3, 64)
    attn = lambda window: (
        lambda p, x, c, m: (A.self_attention(p, x, c, positions=torch.from_numpy(pos),
                                             window=c.window if window else 0)[0], None),
        lambda p, x, c, m: (JA.self_attention(p, x, c, positions=jnp.asarray(pos),
                                              window=c.window if window else 0)[0], None))
    mlp = (lambda p, x, c, m: (C.glu_mlp(x, p["wi"], p["wg"], p["wo"], c.act), None),
           lambda p, x, c, m: (JC.glu_mlp(x, p["wi"], p["wg"], p["wo"], c.act), None))

    def mesh24():
        from repro import compat

        return compat.make_mesh((2, 4), ("data", "model"))

    return {
        "global_attn": ("qwen2-7b", JA.attn_defs, *attn(False), (3, 64), {}),
        "local_attn": ("gemma3-1b", JA.attn_defs, *attn(True), (3, 64), {}),
        "cross_attn": ("seamless-m4t-medium", JA.attn_defs,
                       lambda p, x, c, m: (A.cross_attention(p, x, m, c), None),
                       lambda p, x, c, m: (JA.cross_attention(p, x, m, c), None), (3, 64), {}),
        "glu_mlp_silu": ("qwen2-7b", JC.mlp_defs, *mlp, (3, 64), {}),
        "glu_mlp_gelu": ("gemma3-1b", JC.mlp_defs, *mlp, (3, 64), {}),
        "rwkv": ("rwkv6-3b", JW.rwkv_defs,
                 lambda p, x, c, m: (W.rwkv_block(p, x, c)[0], None),
                 lambda p, x, c, m: (JW.rwkv_block(p, x, c)[0], None), (3, 64), {}),
        "recurrent": ("recurrentgemma-2b", JG.griffin_defs,
                      lambda p, x, c, m: (G.griffin_block(p, x, c)[0], None),
                      lambda p, x, c, m: (JG.griffin_block(p, x, c)[0], None), (3, 64), {}),
        "moe_dense_tp": ("dbrx-132b", JM.moe_defs,
                         lambda p, x, c, m: M.moe_dense_tp(p, x, c),
                         lambda p, x, c, m: JM.moe_dense_tp(p, x, c), (4, 64),
                         {"moe_dispatch": "dense_tp", "capacity_factor": NO_DROP_CF}),
        "moe_rafi_ep": ("llama4-scout-17b-16e", JM.moe_defs,
                        lambda p, x, c, m: M.moe_rafi_ep(p, x, c, layout=make_test_layout(2, 4)),
                        lambda p, x, c, m: JM.moe_rafi_ep(p, x, c, mesh=mesh24()), (4, 64),
                        {"capacity_factor": NO_DROP_CF}),
    }


def _shapes(kind, cfg):
    """(input shape, encoder-memory shape or None) of a layer case."""
    shape = _layer_cases()[kind][4] + (cfg.d_model,)
    return shape, ((3, 40, cfg.d_model) if kind == "cross_attn" else None)


@functools.lru_cache(maxsize=None)
def _layer_fns(kind):
    """The reference's compiled init and layer in both dtypes for a kind."""
    arch, defs_fn, _, jax_fn, _, changes = _layer_cases()[kind]
    jb, jf, cfg = _configs(arch, **changes)
    key = jax.random.PRNGKey(0)
    init = jax.jit(lambda key: JC.init_params(defs_fn(jb), key, jnp.bfloat16))
    p_b = jax.eval_shape(init, key)
    x_shape, mem_shape = _shapes(kind, cfg)
    args = {dt: (jax.tree.map(lambda a: _sds(a.shape, dt), p_b), _sds(x_shape, dt),
                 None if mem_shape is None else _sds(mem_shape, dt)) for dt in (jnp.bfloat16, jnp.float32)}
    return _compiled([(init, (key,)), (jax.jit(lambda p, x, m: jax_fn(p, x, jb, m)), args[jnp.bfloat16]),
                      (jax.jit(lambda p, x, m: jax_fn(p, x, jf, m)), args[jnp.float32])])


@pytest.fixture(scope="module")
def layer_fns():
    with ThreadPoolExecutor(len(LAYER_K)) as pool:
        list(pool.map(_layer_fns, LAYER_K))


@pytest.mark.parametrize("kind", list(LAYER_K))
def test_one_layer_bf16_within_its_bound(kind, layer_fns):
    """One layer of each kind in bfloat16 on the same weights and input,
    three seeds: d_port <= LAYER_K[kind] · d_ref; MoE drops 0 on both
    sides."""
    arch, _, port_fn, _, _, changes = _layer_cases()[kind]
    _, _, cfg = _configs(arch, **changes)
    x_shape, mem_shape = _shapes(kind, cfg)
    init, run_b, run_f = _layer_fns(kind)
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        jp = init(jax.random.PRNGKey(seed))
        xb = _bf16(rng.standard_normal(x_shape).astype(np.float32))
        mb = None if mem_shape is None else _bf16(rng.standard_normal(mem_shape).astype(np.float32))
        got, drops = port_fn({k: _t(v) for k, v in jp.items()}, _t(xb), cfg, None if mb is None else _t(mb))
        want_b, jdrops_b = run_b(jp, xb, mb)
        want_f, jdrops_f = run_f(jax.tree.map(_widen, jp), _widen(xb), None if mb is None else _widen(mb))
        assert got.dtype == torch.bfloat16
        d_port, d_ref = _dists(got, want_b, want_f)
        assert d_ref > 0
        assert d_port <= LAYER_K[kind] * d_ref, (
            f"{kind} seed {seed}: d_port {d_port:.4g} > {LAYER_K[kind]} x d_ref {d_ref:.4g}")
        if drops is not None:
            assert (int(drops), int(jdrops_b), int(jdrops_f)) == (0, 0, 0), (kind, seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_rmsnorm_causal_conv_and_router_bf16_bit_for_bit(seed):
    """The parts whose bfloat16 arithmetic equals JAX's bit for bit: the
    ``rmsnorm`` before every layer kind, the RG-LRU's depthwise causal
    conv (with and without a carried tail), and the MoE router's top-k
    experts and bfloat16 weights (dbrx top 2 of 16, llama4-scout top 1 of
    16)."""
    rng = np.random.default_rng(seed)
    bf = lambda *shape, scale=1.0: _bf16(rng.standard_normal(shape).astype(np.float32) * scale)
    x, g, w, tail = bf(3, 64, 64), bf(64, scale=0.1), bf(G.CONV_W, 64, scale=0.5), bf(3, G.CONV_W - 1, 64)
    bits = lambda a: _t(a).view(torch.int16).numpy() if not isinstance(a, torch.Tensor) else a.view(
        torch.int16).numpy()
    np.testing.assert_array_equal(bits(C.rmsnorm(_t(x), _t(g))), bits(jax.jit(JC.rmsnorm)(x, g)))
    for t in (None, tail):
        got = G._causal_conv(_t(x), _t(w), None if t is None else _t(t))
        want = jax.jit(JG._causal_conv)(x, w, t)
        np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
        np.testing.assert_array_equal(bits(got[1]), bits(want[1]))
    for arch in ("dbrx-132b", "llama4-scout-17b-16e"):
        jb, _, cfg = _configs(arch)
        xr, r = bf(256, cfg.d_model), bf(cfg.d_model, cfg.num_experts, scale=0.02)
        jidx, jw = jax.jit(lambda p, x, jb=jb: JM._router(p, x, jb))({"router": r}, xr)
        idx, wt = M._router({"router": _t(r)}, _t(xr), cfg)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(bits(wt), bits(jw))
