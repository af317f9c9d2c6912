"""The rwkv6, griffin and encdec families of the port
(``repro_torch.models.rwkv6``, ``griffin``, ``encdec``, ``attention.
cross_attention`` and their configs) against the JAX reference on the CPU.

Inputs are made from a seed with numpy; weights are the reference's
(``build_model(cfg).init(PRNGKey(0))``) carried into the port by
``params_from_jax``.  Tolerances (float32 smoke configs):

* ``_chunk_scan`` and ``naive_scan_oracle`` against the reference's: 1e-4;
  the chunk scan against the naive scan: the reference's own ``atol=2e-4,
  rtol=1e-4`` (``tests/test_models_smoke.py``);
* ``rwkv_block`` and ``griffin_block`` (train and decode, the state
  carried): 1e-4 of the largest |output| or state (``close_scaled``);
* ``cross_attention``: 1e-5; ``encode``, ``decode``, ``prefill_fn`` and
  ``decode_fn`` with the encoder memory: 1e-4; the loss: 1e-5;
* ``_causal_conv``: 1e-6.

Held exactly: the carried parameters (bit for bit), the engines' token
lists, the refusal of a length the chunk does not divide.
"""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.launch.serve import BatchedEngine as JEngine
from repro.launch.serve import Request as JRequest
from repro.launch.serve import reset_slot as jreset_slot
from repro.models import attention as JA
from repro.models import encdec as JED
from repro.models import griffin as JG
from repro.models import rwkv6 as JW
from repro.models.api import build_model as jbuild
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import BatchedEngine, Request, reset_slot
from repro_torch.models import attention as A
from repro_torch.models import encdec as ED
from repro_torch.models import griffin as G
from repro_torch.models import rwkv6 as W
from repro_torch.models.api import build_model, params_from_jax

T = lambda a: torch.from_numpy(np.array(a))  # a writable copy
NP = lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
FAMILIES = ("rwkv6-3b", "recurrentgemma-2b", "seamless-m4t-medium")


def close(a, b, tol):
    np.testing.assert_allclose(NP(a), NP(b), atol=tol, rtol=tol)


def close_scaled(a, b, tol):
    """Within ``tol`` of the reference's largest |value| (absolute) and of
    each value (relative): the smoke blocks' stacked weights draw at the
    default scale 1/sqrt(layer count), so their outputs reach ~1e3, where a
    float32 ulp is 6e-5."""
    b = NP(b)
    np.testing.assert_allclose(NP(a), b, atol=tol * float(np.abs(b).max()), rtol=tol)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return jbuild(jget_smoke(arch)).init(jax.random.PRNGKey(0))


def _pair(arch):
    """(JAX config, port config, JAX params, port module) for a smoke arch."""
    jp = _jparams(arch)
    cfg = get_smoke_config(arch)
    return jget_smoke(arch), cfg, jp, params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _layer(jp, key, sub, i=0):
    """Layer ``i``'s ``sub`` parameters of a stacked block: (JAX, port)."""
    jl = jax.tree.map(lambda a: a[i], jp["blocks"][key])[sub]
    return jl, {k: T(np.asarray(v)) for k, v in jl.items()}


# -------------------------------------------------------------------- rwkv6
def _scan_inputs(s, decays, seed=0, b=2, h=4, dh=16):
    rng = np.random.default_rng(seed)
    r, k, v = (_normal(rng, b, s, h, dh) for _ in range(3))
    if decays == "w_min":  # every step at the clamp: the midpoint factors reach e^40
        logw = np.full((b, s, h, dh), JW.W_MIN, np.float32)
    else:
        logw = np.clip(-np.abs(rng.standard_normal((b, s, h, dh))), JW.W_MIN, -1e-4).astype(np.float32)
        logw[:, ::3] = JW.W_MIN  # a third of the steps at the clamp
    u = _normal(rng, h, dh, scale=0.5)
    return r, k, v, logw, u


@pytest.mark.parametrize("s", [1, 16, 32, 96])
@pytest.mark.parametrize("decays", ["w_min", "mixed"])
def test_chunk_scan_equals_the_reference_and_the_naive_scan(s, decays):
    xs = _scan_inputs(s, decays)
    got = W._chunk_scan(*map(T, xs))
    naive = W.naive_scan_oracle(*map(T, xs))
    close(got, JW._chunk_scan(*map(jnp.asarray, xs)), 1e-4)
    close(naive, JW.naive_scan_oracle(*map(jnp.asarray, xs)), 1e-4)
    np.testing.assert_allclose(NP(got), NP(naive), atol=2e-4, rtol=1e-4)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()


def test_chunk_scan_refuses_a_length_the_chunk_does_not_divide():
    """S = 48 > CHUNK is not a multiple of 32: the reference asserts, the
    port raises, with the same message."""
    xs = _scan_inputs(48, "mixed")
    with pytest.raises(AssertionError, match="seq 48 must be a multiple of chunk 32") as jerr:
        JW._chunk_scan(*map(jnp.asarray, xs))
    with pytest.raises(ValueError, match="seq 48 must be a multiple of chunk 32") as err:
        W._chunk_scan(*map(T, xs))
    assert str(err.value) == str(jerr.value)
    _, cfg, _, lm = _pair("rwkv6-3b")
    with pytest.raises(ValueError, match="multiple of chunk"):
        build_model(cfg).prefill_fn()(lm, {"tokens": torch.zeros((1, 48), dtype=torch.int32)})


def _block_case(arch, key, sub, s, seed):
    jcfg, cfg, jp, _ = _pair(arch)
    jl, tl = _layer(jp, key, sub)
    x = _normal(np.random.default_rng(seed), 2, s, cfg.d_model)
    return jcfg, cfg, jl, tl, x


@pytest.mark.parametrize("s", [16, 64])
def test_rwkv_block_train_and_decode_equal_the_reference(s):
    """The chunk form over S tokens, then S decode steps carrying the
    (B, H, dk, dv) state: outputs and the state within 1e-4 of JAX's, and
    the decode outputs within 1e-4 of the chunk form's."""
    jcfg, cfg, jl, tl, x = _block_case("rwkv6-3b", "k0_rwkv", "rwkv", s, 1)
    got, st = W.rwkv_block(tl, T(x), cfg)
    want, _ = JW.rwkv_block(jl, jnp.asarray(x), jcfg)
    assert st is None
    close_scaled(got, want, 1e-4)
    state, jstate = W.rwkv_state(cfg, 2), JW.rwkv_state(jcfg, 2)
    outs = []
    for t in range(s):
        o, state = W.rwkv_block(tl, T(x[:, t:t + 1]), cfg, state=state)
        jo, jstate = JW.rwkv_block(jl, jnp.asarray(x[:, t:t + 1]), jcfg, state=jstate)
        close_scaled(o, jo, 1e-4)
        outs.append(o)
    close_scaled(state, jstate, 1e-4)
    assert state.dtype == torch.float32
    close_scaled(torch.cat(outs, dim=1), got, 1e-4)


@pytest.mark.parametrize("s", [1, 16])
def test_griffin_block_train_and_decode_equal_the_reference(s):
    """The RG-LRU scan over S tokens, then S decode steps carrying (h, the
    conv tail): outputs, h and the tail within 1e-4 of JAX's."""
    jcfg, cfg, jl, tl, x = _block_case("recurrentgemma-2b", "k0_recurrent", "rglru", s, 2)
    got, _ = G.griffin_block(tl, T(x), cfg)
    close_scaled(got, JG.griffin_block(jl, jnp.asarray(x), jcfg)[0], 1e-4)
    state, jstate = G.griffin_state(cfg, 2), JG.griffin_state(jcfg, 2)
    outs = []
    for t in range(s):
        o, state = G.griffin_block(tl, T(x[:, t:t + 1]), cfg, state=state)
        jo, jstate = JG.griffin_block(jl, jnp.asarray(x[:, t:t + 1]), jcfg, state=jstate)
        close_scaled(o, jo, 1e-4)
        outs.append(o)
    close_scaled(state["h"], jstate["h"], 1e-4)
    close_scaled(state["conv"], jstate["conv"], 1e-4)
    close_scaled(torch.cat(outs, dim=1), got, 1e-4)


def test_griffin_gates_follow_the_reference_dtypes():
    """bfloat16 activations: the conv tail stays in the activation dtype,
    the gates and h in float32; ``softplus`` (``lam``'s and the rwkv
    decay's) is ``jax.nn.softplus``, ``logaddexp(x, 0)``, within 1e-7 over
    [-30, 30]."""
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"), dtype="bfloat16")
    p = build_model(cfg).init(torch.Generator().manual_seed(1), device="cpu").tree()
    layer = {k: v[0] for k, v in p["blocks"]["k0_recurrent"]["rglru"].items()}
    x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    _, st = G.griffin_block(layer, x, cfg, state=G.griffin_state(cfg, 2))
    assert st["conv"].dtype == torch.bfloat16 and st["h"].dtype == torch.float32
    xs = np.linspace(-30, 30, 601, dtype=np.float32)
    np.testing.assert_allclose(NP(W.softplus(T(xs))), np.asarray(jax.nn.softplus(jnp.asarray(xs))), rtol=1e-7,
                               atol=1e-7)


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_equals_the_reference(with_tail):
    rng = np.random.default_rng(3)
    x, w = _normal(rng, 2, 7, 16), _normal(rng, G.CONV_W, 16, scale=0.5)
    tail = _normal(rng, 2, G.CONV_W - 1, 16) if with_tail else None
    got, gtail = G._causal_conv(T(x), T(w), None if tail is None else T(tail))
    want, wtail = JG._causal_conv(jnp.asarray(x), jnp.asarray(w), None if tail is None else jnp.asarray(tail))
    close(got, want, 1e-6)
    np.testing.assert_array_equal(NP(gtail), NP(wtail))


# ------------------------------------------------------------------- encdec
def test_cross_attention_equals_the_reference():
    cfg = get_smoke_config("seamless-m4t-medium")
    rng = np.random.default_rng(4)
    p = {k: _normal(rng, *d.shape, scale=d.scale or 1 / np.sqrt(d.shape[0])) for k, d in JA.attn_defs(cfg).items()}
    x, mem = _normal(rng, 2, 5, cfg.d_model), _normal(rng, 2, 9, cfg.d_model)
    got = A.cross_attention({k: T(v) for k, v in p.items()}, T(x), T(mem), cfg)
    want = JA.cross_attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(mem),
                              jget_smoke("seamless-m4t-medium"))
    close(got, want, 1e-5)


def _encdec_batch(cfg, b=2, t=12, s=10, seed=5):
    rng = np.random.default_rng(seed)
    return {"frames": _normal(rng, b, t, cfg.d_model),
            "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def test_encode_decode_and_loss_equal_the_reference():
    jcfg, cfg, jp, m = _pair("seamless-m4t-medium")
    batch = _encdec_batch(cfg)
    mem = ED.encode(m, T(batch["frames"]), cfg)
    jmem = JED.encode(jp, jnp.asarray(batch["frames"]), jcfg)
    close(mem, jmem, 1e-4)
    logits, caches = ED.decode(m, T(batch["tokens"]), mem, cfg)
    jlogits, _ = JED.decode(jp, jnp.asarray(batch["tokens"]), jmem, jcfg)
    assert caches is None
    close(logits, jlogits, 1e-4)
    loss = build_model(cfg).loss_fn()(m, {k: T(v) for k, v in batch.items()})
    jloss = jbuild(jcfg).loss_fn()(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5, rtol=0)
    got = build_model(cfg).prefill_fn()(m, {k: T(v) for k, v in batch.items()})
    close(got, jbuild(jcfg).prefill_fn()(jp, {k: jnp.asarray(v) for k, v in batch.items()}), 1e-4)


def test_decode_fn_with_memory_equals_the_reference_and_the_parallel_decode():
    """Greedy steps of ``decode_fn`` against the encoder memory from fresh
    caches (positions from ``caches["pos"][0]``): each step's logits within
    1e-4 of JAX's and of the parallel decode's row at that position."""
    jcfg, cfg, jp, m = _pair("seamless-m4t-medium")
    batch = _encdec_batch(cfg, s=6)
    mem = ED.encode(m, T(batch["frames"]), cfg)
    jmem = JED.encode(jp, jnp.asarray(batch["frames"]), jcfg)
    par, _ = ED.decode(m, T(batch["tokens"]), mem, cfg)
    model, jmodel = build_model(cfg), jbuild(jcfg)
    caches, jcaches = model.init_caches(2, 16, device="cpu"), jmodel.init_caches(2, 16)
    assert set(caches) == {"k", "v", "pos"} and caches["k"].shape[0] == cfg.num_layers
    step, jstep = model.decode_fn(), jax.jit(jmodel.decode_fn())
    for t in range(6):
        tok = batch["tokens"][:, t:t + 1]
        got, caches = step(m, T(tok), caches, mem)
        want, jcaches = jstep(jp, jnp.asarray(tok), jcaches, jmem)
        close(got, want, 1e-4)
        close(got, par[:, t], 1e-4)
    np.testing.assert_array_equal(NP(caches["pos"]), NP(jcaches["pos"]))


def test_encdec_remat_gives_the_same_gradients_bit_for_bit():
    cfg = get_smoke_config("seamless-m4t-medium")
    batch = {k: T(v) for k, v in _encdec_batch(cfg, seed=6).items()}
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        m = build_model(c).init(torch.Generator().manual_seed(4), device="cpu")
        for p in m.parameters():
            p.requires_grad_(True)
        loss = build_model(c).loss_fn()(m, batch)
        loss.backward()
        out[remat] = (loss.detach(), {k: p.grad for k, p in m.named_parameters()})
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(g, out[True][1][k]) for k, g in out[False][1].items())


# ----------------------------------------------------------- params_from_jax
@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_jax_carries_the_tree_bit_for_bit(arch):
    _, _, jp, m = _pair(arch)
    flat = dict(m.named_parameters())
    jflat = {".".join(str(k.key) for k in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    assert set(flat) == set(jflat)
    for name, leaf in jflat.items():
        np.testing.assert_array_equal(NP(flat[name]).view(np.uint32), leaf.view(np.uint32), err_msg=name)
    if arch == "seamless-m4t-medium":
        assert set(m.defs) == {"embed", "enc_blocks", "enc_ln", "dec_blocks", "final_ln", "lm_head"}
        assert isinstance(m, ED.EncDec)


# ------------------------------------------------------------------- engine
def _requests(cfg, cls, n=6, seed=0):
    rng = np.random.default_rng(seed)
    specs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(2, 12))).astype(np.int32), int(rng.integers(4, 12)))
             for _ in range(n)]
    return [cls(rid=i, prompt=p, max_new_tokens=m) for i, (p, m) in enumerate(specs)]


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b"])
@pytest.mark.parametrize("slots", [4, 2])
def test_engine_tokens_equal_the_reference(arch, slots):
    """Six requests through 4 or 2 slots: slots are reused, and a reused
    slot starts from the state its last request left (the reference's
    ``reset_slot`` zeroes positions only).  The token lists are equal."""
    jcfg, cfg, jp, m = _pair(arch)
    jout = JEngine(jbuild(jcfg), jp, slots=slots, max_len=64).run(_requests(jcfg, JRequest))
    out = BatchedEngine(build_model(cfg), m, slots=slots, max_len=64, device="cpu").run(_requests(cfg, Request))
    assert out == jout
    assert sorted(out) == list(range(6)) and all(len(v) > 0 for v in out.values())


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b"])
def test_reused_slot_keeps_the_recurrent_state_as_the_reference(arch):
    """``reset_slot`` zeroes ``pos`` and leaves every recurrent leaf (the
    same tensors), so a step from a reset slot differs from a step from
    fresh caches; the reference's ``reset_slot`` does the same."""
    jcfg, cfg, jp, m = _pair(arch)
    model, jmodel = build_model(cfg), jbuild(jcfg)
    step, jstep = model.decode_fn(), jax.jit(jmodel.decode_fn())
    caches, jcaches = model.init_caches(2, 16, device="cpu"), jmodel.init_caches(2, 16)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    for t in range(4):
        _, caches = step(m, T(toks[:, t:t + 1]), caches)
        _, jcaches = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jcaches)
    reset, jreset = reset_slot(caches, 1), jreset_slot(jcaches, 1)
    leaves = []

    def walk(a, b, path=""):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        else:
            leaves.append((path, a, b))

    walk(caches, reset)
    recurrent = [(p, a, b) for p, a, b in leaves if not p.endswith(("pos", ".k", ".v"))]
    assert recurrent and all(a is b and a.abs().sum() > 0 for _, a, b in recurrent)
    fresh = model.init_caches(2, 16, device="cpu")
    tok = T(toks[:, :1])
    got, _ = step(m, tok, reset)
    want, _ = jstep(jp, jnp.asarray(toks[:, :1]), jreset)
    close(got, want, 1e-4)
    assert not torch.allclose(got[1], step(m, tok, fresh)[0][1], atol=1e-3)


def test_engine_refuses_the_encdec_family():
    cfg = get_smoke_config("seamless-m4t-medium")
    with pytest.raises(ValueError, match="encoder memory"):
        BatchedEngine(build_model(cfg), None, slots=2, device="cpu")


# --------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_cuda_families_equal_the_cpu(arch, cuda_device):
    """The float32 smoke config from one CPU draw, on the card and on the
    CPU: the parallel logits within 1e-4, and for the decoder-only
    families 8 decode steps within 1e-4."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(8), device="cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(9)
    if cfg.kind == "encdec":
        batch = {k: T(v) for k, v in _encdec_batch(cfg, seed=9).items()}
        got = model.prefill_fn()(card, {k: v.to(cuda_device) for k, v in batch.items()})
        close(got.cpu(), model.prefill_fn()(cpu, batch), 1e-4)
        return
    toks = T(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))
    close(model.prefill_fn()(card, {"tokens": toks.to(cuda_device)}).cpu(),
          model.prefill_fn()(cpu, {"tokens": toks}), 1e-4)
    step = model.decode_fn()
    cc, gc = model.init_caches(2, 16, device="cpu"), model.init_caches(2, 16, device=cuda_device)
    for t in range(8):
        a, cc = step(cpu, toks[:, t:t + 1], cc)
        b, gc = step(card, toks[:, t:t + 1].to(cuda_device), gc)
        close(b.cpu(), a, 1e-4)
