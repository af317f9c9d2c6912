"""The port's training path (``repro_torch.models.api.Model.loss_fn``,
``repro_torch.optim``, ``repro_torch.data``, ``repro_torch.launch.steps``
and ``repro_torch.launch.train``) against the JAX reference on the CPU.

Inputs are made from a seed with numpy; weights are the reference's
(``build_model(cfg).init(PRNGKey(0))``) carried into the port by
``params_from_jax``.  JAX runs the MoE dispatch on the ``(2, 4)`` test mesh,
the port on the ``(2, 4)`` layout.  Tolerances (float32 smoke configs), each
with the largest difference measured on the CPU beside it:

* ``cross_entropy_loss``: 1e-6 relative (measured 2.0e-7);
* ``loss_fn``: 1e-5 (measured 1.4e-6); every gradient leaf within 1e-3 of
  that leaf's largest |g| (measured 3.4e-4 of it; 1.5e-3 absolute on
  gemma3's ``embed``);
* ``adamw_update`` over 5 steps: gnorm within 1e-6 relative (measured
  8.6e-8), the float32 state and parameters within 1e-6 (measured 4.8e-7),
  ``step`` exactly, bfloat16 parameters bit for bit;
* ``compress_gradients``: bit for bit;
* ``build_train_step`` over 3 steps: loss within 1e-5 (measured 1.4e-6),
  gnorm within 5e-4 relative (measured 1.4e-4), parameters within lr / 2 =
  5e-4 (measured 2.8e-4; why so wide: the test's docstring), and the first
  step's move p − p0 of each leaf within 1e-2 of the reference's in L2
  norm (measured 2.5e-3, on qwen2-vl-72b's ``wk``);
* the port resuming the reference's checkpoint: losses within 1e-4 of the
  uninterrupted reference run (measured 1.9e-6).

Held exactly: the synthetic batches, the ``rafi_ep`` plane's MoE leaves
(zero gradient in the reference, ``None`` in the port; the weight-decay-only
update within one ulp, measured: 1 element of 65,536 one ulp apart),
``remat`` against no remat, and the port's own checkpoint restart.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.launch.train import train as jtrain
from repro.models import common as JC
from repro.models.api import build_model as jbuild
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim.grad_compress import compress_gradients as jcompress
from repro.optim.grad_compress import init_residuals as jinit_residuals
from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.ckpt.checkpoint import npy_bytes, to_host
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.data import SyntheticLM, make_batch_iterator
from repro_torch.launch.mesh import make_test_layout
from repro_torch.launch.steps import build_train_step
from repro_torch.launch.train import train
from repro_torch.models import common as C
from repro_torch.models.api import build_model, params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, compress_gradients
from repro_torch.optim.grad_compress import init_residuals

T = lambda a: torch.from_numpy(np.array(a))  # a writable copy
NP = lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
MOE_LEAVES = ("blocks.k0_moe.moe.router", "blocks.k0_moe.moe.wi", "blocks.k0_moe.moe.wg", "blocks.k0_moe.moe.wo",
              "blocks.k0_moe.ln2")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The smoke shapes gain nothing from intra-op threads, and under a
    loaded parallel test run OpenMP's spinning threads slow a 70-step
    training loop from 2 s to minutes; one thread keeps the file quick
    and its neighbours unstarved."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(path):
    return ".".join(str(k.key) for k in path)


def _jflat(tree):
    return {_path(p): np.asarray(leaf) for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _pair(arch, **changes):
    """(JAX config, port config, JAX params, port LM) for a smoke arch."""
    jcfg = dataclasses.replace(jget_smoke(arch), **changes)
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _batch(cfg, b=2, s=16, seed=20):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.kind == "encdec":  # the reference's input_specs: frames and tokens of the same length
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        batch["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return batch


def _mesh_layout(cfg, mesh24):
    return (mesh24, make_test_layout(2, 4)) if cfg.kind == "moe" else (None, None)


# --------------------------------------------------------------------- loss
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_cross_entropy_loss_equals_the_reference(dtype):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    jl = jnp.asarray(logits, dtype)
    tl = T(np.asarray(jl.astype(jnp.float32)))
    if dtype is jnp.bfloat16:
        tl = tl.to(torch.bfloat16)  # exact: the values are bfloat16's
    got = C.cross_entropy_loss(tl, T(labels), vocab=50)
    want = JC.cross_entropy_loss(jl, jnp.asarray(labels), vocab=50)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


def _grads(arch, mesh24, **changes):
    jcfg, cfg, jp, lm = _pair(arch, **changes)
    jmesh, lay = _mesh_layout(cfg, mesh24)
    batch = _batch(cfg)
    jloss, jg = jax.jit(jax.value_and_grad(jbuild(jcfg).loss_fn(mesh=jmesh)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    for p in lm.parameters():
        p.requires_grad_(True)
    loss = build_model(cfg).loss_fn(lay)(lm, {k: T(v) for k, v in batch.items()})
    loss.backward()
    return cfg, float(loss.detach()), float(jloss), dict(lm.named_parameters()), _jflat(jg)


@pytest.mark.parametrize("arch,dispatch", [(a, None) for a in ARCHS]
                         + [("llama4-scout-17b-16e", "dense_tp"), ("dbrx-132b", "dense_tp")])
def test_loss_and_every_gradient_equal_the_reference(arch, dispatch, mesh24):
    """The loss within 1e-5 and every leaf's gradient within 1e-3 of its
    largest |g|; under ``rafi_ep`` the five MoE leaves get zeros in the
    reference and ``None`` in the port (``test_rafi_ep_plane_...``)."""
    cfg, loss, jloss, named, jg = _grads(arch, mesh24, **({} if dispatch is None else {"moe_dispatch": dispatch}))
    np.testing.assert_allclose(loss, jloss, atol=1e-5, rtol=0)
    assert set(named) == set(jg)
    for name, p in named.items():
        if p.grad is None:  # a leaf the loss does not reach: zeros in the reference
            assert not jg[name].any(), name
            continue
        scale = float(np.abs(jg[name]).max())
        np.testing.assert_allclose(NP(p.grad), jg[name], atol=1e-3 * max(scale, 1e-6), rtol=0, err_msg=name)
    unreached = {name for name, p in named.items() if p.grad is None}
    if cfg.frontend == "vision":
        assert unreached == {"embed"}  # the embeds stand in for the table
    elif cfg.kind == "moe" and cfg.moe_dispatch == "rafi_ep":
        assert unreached == set(MOE_LEAVES)
    else:
        assert not unreached
    if dispatch == "dense_tp":  # real MoE gradients; the router's under top-2 (a top-1 softmax is constant)
        for name in MOE_LEAVES:
            assert (np.abs(jg[name]).sum() > 0) == (cfg.top_k > 1 or not name.endswith("router")), name


@pytest.mark.parametrize("arch", ["llama4-scout-17b-16e", "dbrx-132b"])
def test_rafi_ep_plane_carries_no_gradient_as_in_the_reference(arch, mesh24):
    """The reference's dispatch packs each routed token into 32-bit words,
    which carry no gradient: router, experts and ``ln2`` (which feeds only
    the MoE) get exactly zero there.  The port's words carry none either
    (``grad`` stays ``None``), and one train step updates those leaves as
    the reference does, by weight decay alone, within one ulp; m and v stay 0."""
    _, _, _, named, jg = _grads(arch, mesh24)
    for name in MOE_LEAVES:
        assert not np.abs(jg[name]).any(), name
        assert named[name].grad is None, name

    jcfg, cfg, jp, lm = _pair(arch)
    before = {k: NP(v).copy() for k, v in lm.named_parameters()}
    batch = _batch(cfg, b=4)
    opt_cfg = AdamWConfig(warmup_steps=2)
    step, _ = jbuild_train_step(jbuild(jcfg), mesh24, JAdamWConfig(warmup_steps=2))
    jparams, jopt, _ = jax.jit(step)(jp, jadamw_init(jp, JAdamWConfig(warmup_steps=2)),
                                     {k: jnp.asarray(v) for k, v in batch.items()})
    opt = adamw_init(lm, opt_cfg)
    build_train_step(build_model(cfg), make_test_layout(2, 4), opt_cfg)(lm, opt, batch)
    jparams, jm, jv = _jflat(jparams), _jflat(jopt["m"]), _jflat(jopt["v"])
    named = dict(lm.named_parameters())
    m = _tflat(opt["m"])
    lr = np.float32(opt_cfg.lr / opt_cfg.warmup_steps)
    for name in MOE_LEAVES:
        # within one ulp of the reference (its compiler may fuse p - lr·d
        # into one rounding; measured: 1 element of 65,536 one ulp apart)
        np.testing.assert_array_max_ulp(NP(named[name]), jparams[name], maxulp=1)
        decayed = before[name] - lr * (np.float32(opt_cfg.weight_decay) * before[name])
        np.testing.assert_array_max_ulp(NP(named[name]), decayed, maxulp=1)
        assert not jm[name].any() and not jv[name].any() and not NP(m[name]).any(), name


def _tflat(tree, pre=""):
    """A nested dict of tensors as {dotted path: leaf}."""
    out = {}
    for k, v in tree.items():
        out.update(_tflat(v, pre + k + ".") if isinstance(v, dict) else {pre + k: v})
    return out


@pytest.mark.parametrize("arch", ["qwen2-7b", "llama4-scout-17b-16e", "gemma3-1b"])
def test_remat_gives_the_same_gradients_bit_for_bit(arch):
    """``cfg.remat`` checkpoints each period (the reference's
    ``jax.checkpoint``); the recomputed backward gives the same bits."""
    cfg = dataclasses.replace(get_smoke_config(arch), num_layers=4 if arch != "gemma3-1b" else 8)
    lay = make_test_layout(2, 4) if cfg.kind == "moe" else None
    batch = {k: T(v) for k, v in _batch(cfg, seed=21).items()}
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        lm = build_model(c).init(torch.Generator().manual_seed(4), device="cpu")
        for p in lm.parameters():
            p.requires_grad_(True)
        loss = build_model(c).loss_fn(lay)(lm, batch)
        loss.backward()
        out[remat] = (loss.detach(), {k: p.grad for k, p in lm.named_parameters()})
    assert torch.equal(out[False][0], out[True][0])
    for k, g in out[False][1].items():
        h = out[True][1][k]
        assert (g is None and h is None) or torch.equal(g, h), k


def test_remat_recompute_stops_before_the_rafi_ep_plane(monkeypatch):
    """The ``rafi_ep`` plane carries no gradient and runs without grad, so
    a checkpointed period saves nothing inside it and backward's recompute
    stops before it: one train step of ``microbatches`` × layers MoE calls
    dispatches each round once, in the forward."""
    from repro_torch.models import moe as M

    cfg = dataclasses.replace(get_smoke_config("llama4-scout-17b-16e"), remat=True, microbatches=2)
    in_backward, dispatch = [], M.rafi_ep_dispatch

    def counted(route, **kw):
        in_backward.append(torch._C._current_graph_task_id() != -1)
        return dispatch(route, **kw)

    monkeypatch.setattr(M, "rafi_ep_dispatch", counted)
    lm = build_model(cfg).init(torch.Generator().manual_seed(4), device="cpu")
    step = build_train_step(build_model(cfg), make_test_layout(2, 4), AdamWConfig())
    step(lm, adamw_init(lm, AdamWConfig()), SyntheticLM(cfg.vocab_size, 16, 4).batch_at(0))
    assert in_backward == [False] * (cfg.microbatches * cfg.num_layers)


def test_serving_keeps_its_parameters_without_grad():
    """``Model.init`` gives parameters without grad (serving); the train
    step turns it on for the module it trains and no other."""
    model = build_model(get_smoke_config("qwen2-7b"))
    a = model.init(torch.Generator().manual_seed(0), device="cpu")
    b = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert not any(p.requires_grad for p in a.parameters())
    build_train_step(model)(a, adamw_init(a, AdamWConfig()), SyntheticLM(256, 16, 2).batch_at(0))
    assert all(p.requires_grad and p.grad is None for p in a.parameters())
    assert not any(p.requires_grad for p in b.parameters())


# -------------------------------------------------------------------- adamw
def _tree_case(rng):
    shapes = {"a": ((4, 5), np.float32), "b": {"c": ((3,), jnp.bfloat16), "d": ((2, 3, 4), np.float32)},
              "e": ((6,), np.float32)}

    def draw(spec, scale):
        if isinstance(spec, dict):
            return {k: draw(v, scale) for k, v in spec.items()}
        shape, dtype = spec
        return jnp.asarray(rng.standard_normal(shape) * scale, dtype)

    return shapes, draw


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return T(a)


def _bits(a):
    a = NP(a.view(torch.int16) if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 else a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _assert_tree_close(got, want, tol):
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], tol)
            continue
        w = np.asarray(want[k])
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(_bits(got[k]), w.view(np.uint16), err_msg=k)
        else:
            np.testing.assert_allclose(NP(got[k]), w, atol=tol, rtol=0, err_msg=k)


@pytest.mark.parametrize("flags", [
    dict(), dict(grad_clip=1e6), dict(f32_master=True), dict(compress_grads=True),
    dict(f32_master=True, compress_grads=True, grad_clip=1e6), dict(warmup_steps=1, weight_decay=0.0),
])
def test_adamw_update_equals_the_reference(flags):
    """Five steps of random trees (float32 and bfloat16 leaves, one leaf
    without a gradient on the port's side and zeros on the reference's):
    the clip active (gradients of norm ~10 against 1.0) or not (1e6), the
    warmup ramping over the 5 steps (3) or done (1)."""
    rng = np.random.default_rng(7)
    shapes, draw = _tree_case(rng)
    flags = dict(dict(lr=1e-2, warmup_steps=3), **flags)
    jcfg, cfg = JAdamWConfig(**flags), AdamWConfig(**flags)
    jp = draw(shapes, 1.0)
    params = _to_torch(jp)
    jstate, state = jadamw_init(jp, jcfg), adamw_init(params, cfg)
    jupdate = jax.jit(jadamw_update, static_argnums=3)
    for _ in range(5):
        jg = draw(shapes, 3.0)
        jg["e"] = jnp.zeros_like(jg["e"])
        g = _to_torch(jg)
        g["e"] = None
        jp, jstate, jnorm = jupdate(jp, jg, jstate, jcfg)
        params, state, gnorm = adamw_update(params, g, state, cfg)
        np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=1e-6, atol=0)
        assert int(state["step"]) == int(jstate["step"])
        _assert_tree_close(params, jp, 1e-6)
        for key in ("m", "v") + (("master",) if cfg.f32_master else ()) + (("residual",) if cfg.compress_grads else ()):
            _assert_tree_close(state[key], jstate[key], 1e-6)
    assert set(state) == set(jstate)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_compress_gradients_is_bit_equal_to_the_reference(dtype):
    rng = np.random.default_rng(8)
    jg = {"w": jnp.asarray(rng.standard_normal((64, 33)) * 1e-3, dtype), "b": {"c": jnp.asarray(rng.standard_normal(5), dtype)}}
    jr = jinit_residuals(jg)
    r = init_residuals(_to_torch(jg))
    for _ in range(3):
        jq, jr = jcompress(jg, jr)
        q, r = compress_gradients(_to_torch(jg), r)
        assert q["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(q["w"]), np.asarray(jq["w"]).view(np.uint16))
        np.testing.assert_array_equal(_bits(q["b"]["c"]), np.asarray(jq["b"]["c"]).view(np.uint16))
        np.testing.assert_array_equal(NP(r["w"]).view(np.uint32), np.asarray(jr["w"]).view(np.uint32))
        np.testing.assert_array_equal(NP(r["b"]["c"]).view(np.uint32), np.asarray(jr["b"]["c"]).view(np.uint32))


def test_gradient_compression_error_feedback():
    g = {"w": torch.tensor([1.0000001, -2.5, 3.1415926], dtype=torch.float32)}
    res = init_residuals(g)
    total = torch.zeros(3)
    for _ in range(64):
        q, res = compress_gradients(g, res)
        total = total + q["w"].to(torch.float32)
    # with error feedback the long-run average equals the true gradient
    np.testing.assert_allclose(NP(total) / 64, NP(g["w"]), rtol=1e-4)


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,count", [(0, 1), (3, 2), (7, 4)])
def test_synthetic_lm_equals_the_reference_bit_for_bit(seed, count):
    for idx in range(count):
        ours = SyntheticLM(1000, 32, 8, seed=seed, process_index=idx, process_count=count)
        theirs = JSyntheticLM(1000, 32, 8, seed=seed, process_index=idx, process_count=count)
        for step in (0, 1, 13, 977):
            a, b = ours.batch_at(step), theirs.batch_at(step)
            assert set(a) == set(b) == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])


def test_data_pipeline_determinism_and_restart():
    ds = SyntheticLM(1000, 32, 8, seed=7)
    a = ds.batch_at(13)
    np.testing.assert_array_equal(a["tokens"], ds.batch_at(13)["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])  # next-token labels
    it = make_batch_iterator(ds, start_step=13)  # from mid-stream: direct indexing
    for step in (13, 14, 15):
        np.testing.assert_array_equal(next(it)["tokens"], ds.batch_at(step)["tokens"])
    it.close()


def test_host_sharded_loading_partitions_globally():
    p0 = SyntheticLM(1000, 16, 8, seed=3, process_index=0, process_count=2)
    p1 = SyntheticLM(1000, 16, 8, seed=3, process_index=1, process_count=2)
    assert p0.local_batch == 4 and p1.local_batch == 4
    assert not np.array_equal(p0.batch_at(0)["tokens"], p1.batch_at(0)["tokens"])
    with pytest.raises(ValueError):
        SyntheticLM(1000, 16, 8, process_count=3)


# --------------------------------------------------------------------- step
@pytest.mark.parametrize("arch,micro", [("qwen2-7b", 1), ("qwen2-7b", 2), ("llama4-scout-17b-16e", 2),
                                        ("qwen2-vl-72b", 1), ("rwkv6-3b", 1), ("rwkv6-3b", 2)])
def test_train_step_equals_the_reference(arch, micro, mesh24):
    """Three steps of ``build_train_step`` against the reference's jitted
    ``train_step`` from the same weights and batches: loss within 1e-5,
    gnorm within 5e-4 of itself, every parameter within lr / 2 after each
    step.  Adam's update ``m̂ / (√v̂ + eps)`` does not shrink with the
    gradient, so a component whose true gradient is 0 (``bk``: softmax is
    shift-invariant) or at a near-tie of the top-1 router moves by up to lr
    on float32 noise in either package; eps 1e-6 (not 1e-8) keeps that
    noise from deciding the first steps' moves.  That bound alone would
    pass a first update skipped (step 1's lr is lr / 2), so each leaf's
    first move p − p0 is held against the reference's in L2 norm."""
    jcfg, cfg, jp, lm = _pair(arch, microbatches=micro)
    jmesh, lay = _mesh_layout(cfg, mesh24)
    opt_cfg = dict(lr=1e-3, warmup_steps=2, eps=1e-6)
    jstep, _ = jbuild_train_step(jbuild(jcfg), jmesh if jmesh is not None else mesh24, JAdamWConfig(**opt_cfg))
    jstep = jax.jit(jstep)
    jopt = jadamw_init(jp, JAdamWConfig(**opt_cfg))
    opt = adamw_init(lm, AdamWConfig(**opt_cfg))
    step = build_train_step(build_model(cfg), lay, AdamWConfig(**opt_cfg))
    p0 = {name: NP(p).copy() for name, p in lm.named_parameters()}
    for i in range(3):
        batch = _batch(cfg, b=4, seed=30 + i)
        jp, jopt, jmet = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        lm, opt, met = step(lm, opt, batch)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(float(met["gnorm"]), float(jmet["gnorm"]), rtol=5e-4, atol=0)
        jflat = _jflat(jp)
        for name, p in lm.named_parameters():
            np.testing.assert_allclose(NP(p), jflat[name], atol=opt_cfg["lr"] / 2, rtol=0, err_msg=name)
            if i == 0:
                move, jmove = NP(p) - p0[name], np.asarray(jflat[name]) - p0[name]
                assert np.linalg.norm(move - jmove) <= 1e-2 * np.linalg.norm(jmove), name
        assert int(opt["step"]) == int(jopt["step"]) == i + 1


@pytest.mark.parametrize("micro", [1, 2])
def test_encdec_train_step_equals_the_reference(micro, mesh24):
    """One step of ``build_train_step`` on the encoder-decoder's batch
    (``frames`` and ``tokens``) against the reference's from the same
    weights: loss within 1e-5, gnorm within 5e-4 of itself, every
    parameter within lr / 2 and each leaf's move within 1e-2 of the
    reference's in L2 norm.  The seamless smoke config's gradients carry
    float32 noise up to 2e-3 of a leaf's largest |g| in either package
    (both against a float64 run of the port, measured on the CPU), and its
    training is chaotic in the reference itself (its weights times
    1 + 1e-7 take the third step's gnorm from 53.23 to 46.93).  So the
    step is held once, and with Adam's eps at 1e-3, above that noise, so
    that a noise-level gradient moves its parameter by a noise-level step
    instead of by ±lr / 2."""
    jcfg, cfg, jp, lm = _pair("seamless-m4t-medium", microbatches=micro)
    opt_cfg = dict(lr=1e-3, warmup_steps=2, eps=1e-3)
    jstep, _ = jbuild_train_step(jbuild(jcfg), mesh24, JAdamWConfig(**opt_cfg))
    batch = _batch(cfg, b=4, seed=30)
    assert set(batch) == {"tokens", "frames"}
    p0 = {name: NP(p).copy() for name, p in lm.named_parameters()}
    jp, jopt, jmet = jax.jit(jstep)(jp, jadamw_init(jp, JAdamWConfig(**opt_cfg)),
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    step = build_train_step(build_model(cfg), None, AdamWConfig(**opt_cfg))
    lm, opt, met = step(lm, adamw_init(lm, AdamWConfig(**opt_cfg)), batch)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(met["gnorm"]), float(jmet["gnorm"]), rtol=5e-4, atol=0)
    jflat = _jflat(jp)
    assert set(jflat) == set(p0)
    for name, p in lm.named_parameters():
        np.testing.assert_allclose(NP(p), jflat[name], atol=opt_cfg["lr"] / 2, rtol=0, err_msg=name)
        move, jmove = NP(p) - p0[name], np.asarray(jflat[name]) - p0[name]
        assert np.linalg.norm(move - jmove) <= 1e-2 * np.linalg.norm(jmove), name
    assert int(opt["step"]) == int(jopt["step"]) == 1


# -------------------------------------------------------------------- train
def test_loss_decreases(tmp_path):
    _, _, losses = train(
        arch="qwen2-7b", smoke=True, steps=70, batch=8, seq=64,
        ckpt_dir=str(tmp_path / "ck"), ckpt_every=0, verbose=False,
        opt_cfg=AdamWConfig(lr=1e-2, warmup_steps=10, weight_decay=0.0), device="cpu",
    )
    first = np.mean([l for _, l in losses[:5]])
    last = np.mean([l for _, l in losses[-5:]])
    assert last < first * 0.9, f"loss did not decrease: {first} -> {last}"


def test_checkpoint_restart_is_exact(tmp_path):
    """Kill-and-resume reproduces the uninterrupted run bit for bit."""
    kw = dict(arch="qwen2-7b", smoke=True, batch=4, seq=64, verbose=False, device="cpu")
    _, _, losses_full = train(steps=20, ckpt_dir=str(tmp_path / "uninterrupted"), ckpt_every=100, **kw)
    d2 = str(tmp_path / "interrupted")
    train(steps=10, ckpt_dir=d2, ckpt_every=10, **kw)  # "crash" at 10
    assert latest_step(d2) == 10
    params, opt, losses_resumed = train(steps=20, ckpt_dir=d2, ckpt_every=10, **kw)
    assert [s for s, _ in losses_resumed] == list(range(10, 20))
    assert dict(losses_full)[19] == dict(losses_resumed)[19]
    assert all(dict(losses_full)[s] == l for s, l in losses_resumed)


def test_a_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's ``train(steps=20, ckpt_every=10)`` writes step 10 and
    20; the port resumes step 10 (params and AdamW state in the
    reference's files) to 20, its losses within 1e-4 of the reference's."""
    kw = dict(arch="qwen2-7b", smoke=True, batch=4, seq=64, verbose=False)
    src = tmp_path / "jax"
    _, _, jlosses = jtrain(steps=20, ckpt_dir=str(src), ckpt_every=10, **kw)
    dst = tmp_path / "port"
    dst.mkdir()
    shutil.copytree(src / "step_00000010", dst / "step_00000010")
    _, opt, losses = train(steps=20, ckpt_dir=str(dst), ckpt_every=10, device="cpu", **kw)
    assert [s for s, _ in losses] == list(range(10, 20))
    jl = dict(jlosses)
    np.testing.assert_allclose([l for _, l in losses], [jl[s] for s, _ in losses], atol=1e-4, rtol=0)
    assert int(opt["step"]) == 20 and latest_step(str(dst)) == 20


def test_bfloat16_leaves_checkpoint_as_the_reference_writes_them(tmp_path):
    """A bfloat16 leaf is written as the reference writes one (the same
    ``.npy`` bytes: its 2-byte words) and restores bit for bit."""
    t = torch.randn(5, 7, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    j = jnp.asarray(NP(t.float()), jnp.bfloat16)
    assert npy_bytes(to_host(t)) == npy_bytes(np.asarray(j))
    save_checkpoint(tmp_path, 3, {"w": t, "s": torch.zeros((), dtype=torch.int32)})
    back = restore_checkpoint(tmp_path, 3, {"w": torch.empty(5, 7, dtype=torch.bfloat16), "s": torch.zeros(
        (), dtype=torch.int32)}, device="cpu")
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"].view(torch.int16), t.view(torch.int16))
    with pytest.raises(ValueError, match="dtype"):
        restore_checkpoint(tmp_path, 3, {"w": torch.empty(5, 7), "s": torch.zeros((), dtype=torch.int32)},
                           device="cpu")


def test_entry_points_run_on_the_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the rule where no card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(steps=1, ckpt_dir=str(tmp_path), ckpt_every=0, verbose=False)


# --------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b", "llama4-scout-17b-16e"])
def test_cuda_train_steps_equal_the_cpu(arch, cuda_device):
    """Three train steps of the smoke config on the card and on the CPU
    from the same weights, under the trainer's AdamW settings: losses
    within 1e-4, gnorm within 1e-4 of itself (measured on the H100: 5e-7
    and 2.5e-5); the card's MoE dispatch launches K6, K3, K1 and K2."""
    from repro_torch import kernels as KN

    cfg = get_smoke_config(arch)
    lay = make_test_layout(2, 4) if cfg.kind == "moe" else None
    model = build_model(cfg)
    lm_cpu = model.init(torch.Generator().manual_seed(6), device="cpu")
    lm_card = build_model(cfg).init(torch.Generator().manual_seed(6), device="cpu").to(cuda_device)
    ds = SyntheticLM(cfg.vocab_size, 32, 4)
    out = {}
    for where, lm in (("card", lm_card), ("cpu", lm_cpu)):
        step = build_train_step(model, lay, AdamWConfig(warmup_steps=20))
        opt = adamw_init(lm, AdamWConfig(warmup_steps=20))
        KN.reset_launch_counts()
        out[where] = [tuple(float(v) for v in step(lm, opt, ds.batch_at(i))[2].values()) for i in range(3)]
        out[where + "_launches"] = KN.launch_counts()
    card, cpu = np.array(out["card"]), np.array(out["cpu"])
    np.testing.assert_allclose(card[:, 0], cpu[:, 0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(card[:, 1], cpu[:, 1], rtol=1e-4, atol=0)
    if cfg.kind == "moe":
        for k in ("compact_positions", "pack_and_histogram", "gather_rows", "unmarshal"):
            assert out["card_launches"][k] > 0 and out["cpu_launches"][k] == 0, k
