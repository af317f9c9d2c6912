"""The placed train state of the dense family (``repro_torch.launch.
placement``, the placed step of ``repro_torch.launch.steps``, the elastic
restore of ``repro_torch.ckpt``) against the JAX reference on the CPU, on
the stacked backend.

Inputs are made from a seed with numpy; weights are the reference's
(``build_model(cfg).init(PRNGKey(0))``) carried into the port by
``params_from_jax``.

* Placement, bit for bit: the four text-only dense archs' smoke configs,
  as shipped and with ``fsdp=True``, on layouts (2, 4), (4, 2), (1, 8) and
  (8, 1): every rank's block of every parameter and AdamW leaf equals the
  reference's addressable shard on the device at that rank's position in
  ``mesh.devices`` (``jax.device_put`` onto ``build_train_step``'s
  shardings), compared as 32-bit words.  A planted misplacement (the
  ``data`` axis cut on another dimension than the one the rule resolves
  to) must fail.
* The train step: qwen2-7b and gemma3-1b smoke, ``fsdp`` off and on,
  ``microbatches`` 1 and 2, layout (2, 4), against the reference's step
  jitted on ``mesh24`` with its shardings (as the reference's ``train()``
  jits it): loss within 1e-5, gnorm within 5e-4 relative, every gathered
  parameter within lr / 2 (``tests/test_torch_train.py``'s bounds), over 3
  steps for qwen2-7b and one for gemma3-1b (its smoke training is chaotic
  at Adam's eps 1e-6: the reference's own step jitted on ``mesh24`` and
  jitted unsharded part by more than lr / 2 after the second step, held
  below, as the port's placed and whole steps part); and against the
  port's unsharded step at the same bounds.  A planted clip fault (every replica
  of a leaf counted) moves gnorm out of its bound.
* The call budget: one step's calls by kind and tier as a function of the
  layer count, pinned.
* Elastic restore, bit for bit: placed state saved at (2, 4) restores at
  (4, 2), (1, 1) and whole, each placed by its own rule; a reference
  checkpoint written from ``mesh24`` restores onto a port placement and a
  port checkpoint of placed state onto the reference's ``mesh24``; a
  placed ``train()`` resumes the reference's checkpoint.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as jrestore
from repro.ckpt import save_checkpoint as jsave
from repro.configs import get_smoke_config as jget_smoke
from repro.launch.mesh import make_test_mesh
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.launch.train import train as jtrain
from repro.models.api import build_model as jbuild
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.launch import placement as PL
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_test_layout
from repro_torch.launch.steps import build_train_step
from repro_torch.launch.train import train
from repro_torch.models.api import build_model, params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init

DENSE = ("qwen2-7b", "glm4-9b", "qwen2.5-14b", "gemma3-1b")
LAYOUTS = ((2, 4), (4, 2), (1, 8), (8, 1))
OPT = dict(lr=1e-3, warmup_steps=2, eps=1e-6)
NP = lambda a: a.detach().cpu().numpy()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(p):
    return tuple(str(k.key) for k in p)


def _pair(arch, **changes):
    """(JAX config, port config, JAX params, port LM) of a smoke arch."""
    jcfg = dataclasses.replace(jget_smoke(arch), **changes)
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _moments(jp, seed):
    """An AdamW state with seeded moments (zeros would place trivially)."""
    rng = np.random.default_rng(seed)
    mom = lambda: jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)
    return {"m": mom(), "v": mom(), "step": np.asarray(3, np.int32)}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _words(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a.view(np.uint16)


def _mismatches(jtree, placed, mesh):
    """Leaves whose reference shards differ from the port's rank blocks:
    ``[(path, rank)]`` (none when the placement is the reference's)."""
    pos = {d.id: (g, m) for (g, m), d in np.ndenumerate(mesh.devices)}
    M = mesh.devices.shape[1]
    bad = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        block = placed
        for k in _path(path):
            block = block[k]
        assert len(leaf.addressable_shards) == block.shape[0]
        for shard in leaf.addressable_shards:
            g, m = pos[shard.device.id]
            want, got = np.asarray(shard.data), NP(block[g * M + m])
            if want.shape != got.shape or not np.array_equal(_words(want), _words(got)):
                bad.append((_path(path), g * M + m))
    return bad


def _placed_state(arch, fsdp, d, m):
    jcfg, cfg, jp, lm = _pair(arch, fsdp=fsdp)
    mesh = make_test_mesh(d, m)
    _, shardings = jbuild_train_step(jbuild(jcfg), mesh)
    jopt = _moments(jp, seed=d * 10 + m)
    jparams = jax.device_put(jp, shardings["params"])
    jstate = jax.device_put(jopt, shardings["opt"])
    placement = PL.train_placement(build_model(cfg), make_test_layout(d, m))
    return mesh, jparams, jstate, placement, lm, _to_torch(jopt)


@pytest.mark.parametrize("d,m", LAYOUTS)
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_placement_equals_the_reference_shards(arch, fsdp, d, m):
    mesh, jparams, jstate, placement, lm, opt = _placed_state(arch, fsdp, d, m)
    params = placement.place(lm)
    state = placement.place(opt)
    assert _mismatches(jparams, params, mesh) == []
    for k in ("m", "v"):
        assert PL.is_placed(state[k]) and _mismatches(jstate[k], state[k], mesh) == []
    assert int(state["step"]) == 3 and state["step"].dim() == 0
    # each rank's bytes: the rule's bytes on one device
    for path, spec in placement.specs.items():
        leaf = params
        for k in path:
            leaf = leaf[k]
        whole = torch.empty(placement.shapes[path], dtype=leaf.dtype, device="meta")
        assert leaf[0].numel() * leaf.element_size() == S.device_bytes(whole, spec, placement.axes)
    # and back, bit for bit
    for path, leaf in S.named_leaves(placement.gather(params)):
        want = lm.tree()
        for k in path:
            want = want[k]
        assert torch.equal(leaf, want), path


def _misplaced(spec, shape, axes):
    """The resolved spec with ``data`` on another dimension it divides."""
    at = [i for i, part in enumerate(spec) if S.DATA in S.spec_axes(part)]
    free = [i for i, part in enumerate(spec) if part is None and shape[i] % axes[S.DATA] == 0]
    if not at or not free:
        return spec
    out = list(spec)
    out[at[0]], out[free[-1]] = None, S.DATA
    return tuple(out)


def test_a_planted_misplacement_fails():
    """The ``data`` axis cut on the last free dimension instead of the one
    the rule resolves to: the blocks no longer equal the reference's."""
    mesh, jparams, _, placement, lm, _ = _placed_state("qwen2-7b", True, 2, 4)
    specs = {p: _misplaced(s, placement.shapes[p], placement.axes) for p, s in placement.specs.items()}
    moved = {p for p in specs if specs[p] != placement.specs[p]}
    assert moved
    bad = dataclasses.replace(placement, specs=specs)
    assert {p for p, _r in _mismatches(jparams, bad.place(lm), mesh)} == moved


# ------------------------------------------------------------------ the step
def _batch(cfg, seed):
    return {"tokens": np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)}


STEPS = {"qwen2-7b": 3, "gemma3-1b": 1}


def _reference_run(jcfg, jp, mesh, steps):
    """The reference's step jitted with its shardings on ``mesh``, as its
    ``train()`` jits it: each step's (loss, gnorm) and the parameters."""
    step, shardings = jbuild_train_step(jbuild(jcfg), mesh, JAdamWConfig(**OPT))
    jitted = jax.jit(step, in_shardings=(shardings["params"], shardings["opt"], None),
                     out_shardings=(shardings["params"], shardings["opt"], None))
    params = jax.device_put(jp, shardings["params"])
    opt = jax.device_put(jadamw_init(jp, JAdamWConfig(**OPT)), shardings["opt"])
    mets = []
    for i in range(steps):
        params, opt, met = jitted(params, opt, {k: jnp.asarray(v) for k, v in _batch(jcfg, 30 + i).items()})
        mets.append((float(met["loss"]), float(met["gnorm"])))
    return mets, {_path(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(params)}


def _port_run(cfg, lm, steps, placement=None):
    step = build_train_step(build_model(cfg), None, AdamWConfig(**OPT))
    params = lm if placement is None else placement.place(lm)
    opt = adamw_init(params, AdamWConfig(**OPT))
    mets = []
    for i in range(steps):
        params, opt, met = step(params, opt, _batch(cfg, 30 + i))
        mets.append((float(met["loss"]), float(met["gnorm"])))
    whole = placement.gather(params) if placement is not None else params.tree()
    return mets, {p: NP(a) for p, a in S.named_leaves(whole)}, opt


def _within(got, want, what):
    (mets, params), (wmets, wparams) = got, want
    for (l, g), (wl, wg) in zip(mets, wmets):
        np.testing.assert_allclose(l, wl, atol=1e-5, rtol=0, err_msg=f"{what}: loss")
        np.testing.assert_allclose(g, wg, rtol=5e-4, atol=0, err_msg=f"{what}: gnorm")
    assert set(params) == set(wparams)
    for p in params:
        np.testing.assert_allclose(params[p], wparams[p], atol=OPT["lr"] / 2, rtol=0, err_msg=f"{what}: {p}")


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma3-1b"])
def test_placed_step_equals_the_reference_sharded_step(arch, fsdp, micro, mesh24):
    jcfg, cfg, jp, lm = _pair(arch, fsdp=fsdp, microbatches=micro)
    steps = STEPS[arch]
    want = _reference_run(jcfg, jp, mesh24, steps)
    placement = PL.train_placement(build_model(cfg), make_test_layout(2, 4))
    mets, params, opt = _port_run(cfg, lm, steps, placement)
    _within((mets, params), want, "placed vs reference")
    assert int(opt["step"]) == steps and PL.is_placed(opt["m"]) and PL.is_placed(opt["v"])
    whole_lm = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    whole_mets, whole_params, _ = _port_run(cfg, whole_lm, steps)
    _within((mets, params), (whole_mets, whole_params), "placed vs unsharded")


def test_gemma3_smoke_training_parts_from_itself_in_the_reference(mesh24):
    """Why gemma3-1b is held for one step above: the reference's own step
    jitted on ``mesh24`` and jitted unsharded part by more than lr / 2 on
    some parameter after two steps (``embed``, measured 1.08e-3), though
    both agree within the bounds after one."""
    jcfg, _, jp, _ = _pair("gemma3-1b")
    sharded = _reference_run(jcfg, jp, mesh24, 2)
    step = jax.jit(jbuild_train_step(jbuild(jcfg), mesh24, JAdamWConfig(**OPT))[0])
    params, opt = jp, jadamw_init(jp, JAdamWConfig(**OPT))
    mets = []
    for i in range(2):
        params, opt, met = step(params, opt, {k: jnp.asarray(v) for k, v in _batch(jcfg, 30 + i).items()})
        mets.append((float(met["loss"]), float(met["gnorm"])))
    unsharded = {_path(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(params)}
    np.testing.assert_allclose(mets[0][1], sharded[0][0][1], rtol=5e-4, atol=0)
    assert max(float(np.abs(unsharded[p] - sharded[1][p]).max()) for p in unsharded) > OPT["lr"] / 2


def test_a_replica_counted_twice_moves_gnorm(monkeypatch, mesh24):
    """The clip's norm with every replica of a leaf counted (a leaf
    replicated over ``data`` counted once per data group): gnorm leaves its
    bound against the reference."""
    jcfg, cfg, jp, lm = _pair("qwen2-7b")
    (want, _) = _reference_run(jcfg, jp, mesh24, 1)
    monkeypatch.setattr(PL, "counted", lambda spec, coords: torch.ones_like(coords[S.DATA], dtype=torch.bool))
    placement = PL.train_placement(build_model(cfg), make_test_layout(2, 4))
    (mets, _, _) = _port_run(cfg, lm, 1, placement)
    assert abs(mets[0][1] / want[0][1] - 1) > 100 * 5e-4


# ----------------------------------------------------------- the call budget
def _one_step_calls(layers, fsdp):
    cfg = dataclasses.replace(get_smoke_config("qwen2-7b"), num_layers=layers, fsdp=fsdp)
    model = build_model(cfg)
    placement = PL.train_placement(model, make_test_layout(2, 4))
    params = placement.place(model.init(torch.Generator().manual_seed(0), device="cpu"))
    step = build_train_step(model, None, AdamWConfig(**OPT))
    step(params, adamw_init(params, AdamWConfig(**OPT)), _batch(cfg, 30))
    counts = {}
    for call, n in placement.comm.calls.items():
        key = (call.kind, call.tier)
        counts[key] = counts.get(key, 0) + n
    return counts, placement


@pytest.mark.parametrize("fsdp", [False, True])
def test_one_step_call_budget(fsdp):
    """One step of qwen2-7b smoke (4 heads, 2 kv heads: the kv split cuts a
    head at model = 4) on (2, 4), at 2 and 4 layers.  Over ``model`` (tier
    1): a layer's two row-parallel ``psum``s and the two of its
    column-parallel inputs' backward, plus three (the embedding, the head's
    input, the loss's sums); one k and one v ``all_gather`` a layer with
    their ``reduce_scatter``s, and the loss's max.  Over ``data`` (tier 0):
    one ``all_gather`` and one ``reduce_scatter`` per FSDP leaf (the whole
    layer stack at once), one ``psum`` per leaf replicated over ``data`` and
    one for the loss.  One flat ``psum``: the norm."""
    for layers in (2, 4):
        counts, placement = _one_step_calls(layers, fsdp)
        n_fsdp = sum(S.DATA in {a for part in spec for a in S.spec_axes(part)} for spec in placement.specs.values())
        n_leaves = len(placement.specs)
        assert n_leaves == 15 and n_fsdp == (15 if fsdp else 0)
        want = {("psum", 1): 4 * layers + 3, ("all_gather", 1): 2 * layers + 1, ("reduce_scatter", 1): 2 * layers,
                ("psum", 0): 1 + n_leaves - n_fsdp, ("psum", None): 1}
        if n_fsdp:
            want.update({("all_gather", 0): n_fsdp, ("reduce_scatter", 0): n_fsdp})
        assert counts == want, (layers, counts)


# ----------------------------------------------------------- elastic restore
def _seeded_state(lm, seed=5):
    """An AdamW state of seeded moments for the port's ``lm``."""
    rng = np.random.default_rng(seed)
    mom = lambda: _nest({p: torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))
                         for p, t in S.named_leaves(lm.tree())})
    return {"m": mom(), "v": mom(), "step": torch.tensor(7, dtype=torch.int32)}


def _nest(flat):
    out = {}
    for path, t in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def _same_tree(a, b):
    fa, fb = dict(S.named_leaves(a)), dict(S.named_leaves(b))
    assert set(fa) == set(fb)
    for p, x in fa.items():
        y = fb[p]
        assert x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y), p


def _like(lm, opt):
    whole = {"params": lm.tree(), "opt": opt}
    return jax.tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), whole)


def test_elastic_restore_across_factorizations(tmp_path):
    """Placed state saved at (2, 4) restores at (4, 2), at (1, 1) and whole,
    bit for bit, each placed by its own rule; the files are those of the
    whole state, digest for digest."""
    _, cfg, _, lm = _pair("qwen2-7b", fsdp=True)
    model, opt = build_model(cfg), _seeded_state(lm)
    pl24 = PL.train_placement(model, make_test_layout(2, 4))
    save_checkpoint(tmp_path / "placed", 5, {"params": pl24.place(lm), "opt": pl24.place(opt)})
    save_checkpoint(tmp_path / "whole", 5, {"params": lm.tree(), "opt": opt})
    digests = lambda d: [e["sha256"] for e in __import__("json").loads(
        (d / "step_00000005" / "manifest.json").read_text())["leaves"]]
    assert digests(tmp_path / "placed") == digests(tmp_path / "whole")
    like = _like(lm, opt)
    for d, m in ((4, 2), (1, 1)):
        pl = PL.train_placement(model, make_test_layout(d, m))
        got = restore_checkpoint(tmp_path / "placed", 5, like, device="cpu", shardings={"params": pl, "opt": pl})
        assert PL.is_placed(got["params"]) and got["params"].placement is pl
        _same_tree(got["params"], pl.place(lm))
        want = pl.place(opt)
        for k in ("m", "v"):
            assert PL.is_placed(got["opt"][k])
            _same_tree(got["opt"][k], want[k])
        assert int(got["opt"]["step"]) == 7
    whole = restore_checkpoint(tmp_path / "placed", 5, like, device="cpu")
    _same_tree(whole["params"], lm.tree())
    _same_tree({"m": whole["opt"]["m"], "v": whole["opt"]["v"]}, {"m": opt["m"], "v": opt["v"]})


def test_reference_checkpoints_cross_placements(tmp_path, mesh24):
    """A checkpoint the reference writes from ``mesh24`` restores onto the
    port's (2, 4) placement, its blocks the reference's shards; one the port
    writes from placed state restores onto the reference's ``mesh24``."""
    mesh, jparams, jstate, pl, lm, opt = _placed_state("qwen2-7b", True, 2, 4)
    jsave(tmp_path / "jax", 3, {"params": jparams, "opt": jstate})
    got = restore_checkpoint(tmp_path / "jax", 3, _like(lm, opt), device="cpu", shardings={"params": pl, "opt": pl})
    assert _mismatches(jparams, got["params"], mesh) == []
    assert _mismatches(jstate["m"], got["opt"]["m"], mesh) == [] and int(got["opt"]["step"]) == 3
    save_checkpoint(tmp_path / "port", 4, {"params": pl.place(lm), "opt": pl.place(opt)})
    jcfg = dataclasses.replace(jget_smoke("qwen2-7b"), fsdp=True)
    _, shardings = jbuild_train_step(jbuild(jcfg), mesh)
    back = jrestore(tmp_path / "port", 4, {"params": jparams, "opt": jstate},
                    shardings={"params": shardings["params"], "opt": shardings["opt"]})
    for a, b in zip(jax.tree.leaves({"params": jparams, "opt": jstate}), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax.tree.leaves(back["params"])[0].sharding.mesh.shape["data"] == 2


def test_placed_train_resumes_a_reference_checkpoint(tmp_path):
    """The reference's ``train(steps=4, ckpt_every=2)`` writes step 2 and 4;
    the port's placed ``train()`` resumes step 2 to 4, its losses within
    1e-4 of the reference's (``tests/test_torch_train.py``'s bound), and
    its own placed run resumes itself bit for bit."""
    kw = dict(arch="qwen2-7b", smoke=True, batch=4, seq=32, verbose=False)
    _, _, jlosses = jtrain(steps=4, ckpt_dir=str(tmp_path / "jax"), ckpt_every=2, **kw)
    dst = tmp_path / "port"
    dst.mkdir()
    shutil.copytree(tmp_path / "jax" / "step_00000002", dst / "step_00000002")
    params, opt, losses = train(steps=4, ckpt_dir=str(dst), ckpt_every=2, device="cpu", place=True, **kw)
    assert [s for s, _ in losses] == [2, 3] and PL.is_placed(params) and PL.is_placed(opt["m"])
    np.testing.assert_allclose([l for _, l in losses], [dict(jlosses)[s] for s in (2, 3)], atol=1e-4, rtol=0)
    full = train(steps=4, ckpt_dir=str(tmp_path / "full"), ckpt_every=0, device="cpu", place=True, **kw)[2]
    train(steps=2, ckpt_dir=str(tmp_path / "cut"), ckpt_every=2, device="cpu", place=True, **kw)
    resumed = train(steps=4, ckpt_dir=str(tmp_path / "cut"), ckpt_every=2, device="cpu", place=True, **kw)[2]
    assert resumed == full[2:]


def test_chip_smoke_phase_shard_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.phase_shard`` at a small width on the CPU (gloo at a
    world of one for its distributed step): every check passes."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    monkeypatch.setattr(cs, "FAILURES", [])
    widths = dict(d_model=64, num_heads=8, num_kv_heads=4, head_dim=8, d_ff=128, vocab_size=512)
    out, paths = cs.phase_shard(torch.device("cpu"), widths=widths, BATCH=(8, 32), profile=False)
    assert cs.FAILURES == [] and paths == {}
    assert out["calls"] == out["nccl_calls"] and out["calls"]["reduce_scatter0"] == 15
    assert len(set(out["param_bytes_per_rank"])) == 1
