"""The shape suite and the meta-device dry run of the port
(``repro_torch.configs.shapes``, ``registry.shape_suite`` / ``input_specs``
/ ``Cell``, ``Model.abstract``, ``launch.steps.abstract_opt_state`` /
``abstract_caches``, ``roofline.analysis.model_flops``,
``launch.dryrun``) against the JAX reference on the CPU.

Everything here is a shape, a dtype, a count or a string, so everything is
held exactly: the suite and its skip reasons, every cell's input specs
(the reference's dtypes mapped to torch's), the leaves of the abstract
parameters, AdamW state and caches, ``model_flops`` in every runnable
cell, and the differenced FLOP count against the full-depth count.  The
bytes of every full-width cell are held here, and the sweep runs from its
records with one cell counted by its workers (a FLOP count of the
recurrent cells takes minutes of host time on meta); one full-width count
is held against its full-depth count.  The dry run must allocate nothing: no tensor off
the meta device larger than a scalar, and no CUDA call.
"""
import concurrent.futures
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs import registry as JR
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch.steps import abstract_caches as jabstract_caches
from repro.launch.steps import abstract_opt_state as jabstract_opt_state
from repro.models.api import build_model as jbuild
from repro.optim import AdamWConfig as JAdamWConfig
from repro.roofline import analysis as JA
from repro.roofline.analysis import model_flops as jmodel_flops
from repro_torch import kernels as KN
from repro_torch.configs import (
    ARCHS, SHAPES, SUB_QUADRATIC, Cell, ShapeSpec, get_config, get_smoke_config, input_specs, shape_suite,
)
from repro_torch.configs import registry as R
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_test_layout
from repro_torch.launch.steps import abstract_caches, abstract_opt_state
from repro_torch.models.api import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.roofline.analysis import model_flops

DTYPES = {np.dtype(jnp.bfloat16): torch.bfloat16, np.dtype(jnp.float32): torch.float32,
          np.dtype(jnp.int32): torch.int32}
FULL = ("qwen2-7b", "llama4-scout-17b-16e", "rwkv6-3b")


def _leaves(tree, pre=""):
    """{path: (shape, dtype)} of a nested dict of JAX shape structs or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{pre}{k}."))
        return out
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta", pre
        return {pre[:-1]: (tuple(tree.shape), tree.dtype)}
    return {pre[:-1]: (tuple(tree.shape), DTYPES[np.dtype(tree.dtype)])}


# ------------------------------------------------------------- shape suite
def test_shapes_and_sub_quadratic_equal_the_reference():
    assert list(SHAPES) == list(JSHAPES)
    for name in SHAPES:
        assert dataclasses.asdict(SHAPES[name]) == dataclasses.asdict(JSHAPES[name])
    assert SUB_QUADRATIC == JR.SUB_QUADRATIC


def test_shape_suite_equals_the_reference_cell_for_cell():
    """40 cells, 8 of them skipped with the reference's reason."""
    cells = skips = 0
    for arch in ARCHS:
        ours, theirs = shape_suite(arch), JR.shape_suite(arch)
        assert list(ours) == list(theirs), arch
        for name in ours:
            cells += 1
            if isinstance(theirs[name], str):
                skips += 1
                assert ours[name] == theirs[name], (arch, name)
            else:
                assert dataclasses.asdict(ours[name]) == dataclasses.asdict(theirs[name]), (arch, name)
    assert (cells, skips) == (40, 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    """Every cell's step, shape, skip reason and batch: keys, shapes and
    dtypes (the reference's mapped), the tensors on meta."""
    for name in SHAPES:
        cell, jcell = input_specs(arch, name), JR.input_specs(arch, name)
        assert isinstance(cell, Cell)
        assert (cell.arch, cell.step, cell.skip) == (jcell.arch, jcell.step, jcell.skip), (arch, name)
        assert dataclasses.asdict(cell.shape) == dataclasses.asdict(jcell.shape)
        assert _leaves(cell.batch) == _leaves(jcell.batch), (arch, name)


# ------------------------------------------------------ abstract structures
def _pairs():
    return [(a, "smoke") for a in ARCHS] + [(a, "full") for a in FULL]


@pytest.mark.parametrize("arch,which", _pairs())
def test_abstract_params_opt_state_and_caches_equal_the_reference(arch, which):
    """``Model.abstract``, ``abstract_opt_state`` (plain, and with float32
    masters and compression residuals) and ``abstract_caches``: the
    reference's leaves, path for path, shape and dtype, all on meta."""
    cfg, jcfg = (get_smoke_config(arch), jget_smoke(arch)) if which == "smoke" else (get_config(arch),
                                                                                        jget_config(arch))
    model, jmodel = build_model(cfg), jbuild(jcfg)
    assert _leaves(model.abstract().tree()) == _leaves(jmodel.abstract())
    for kw in ({}, {"f32_master": True, "compress_grads": True}):
        assert _leaves(abstract_opt_state(model, AdamWConfig(**kw))) == _leaves(
            jabstract_opt_state(jmodel, JAdamWConfig(**kw))), kw
    b, t = (2, 64) if which == "smoke" else (4, 1024)
    assert _leaves(abstract_caches(model, b, t)) == _leaves(jabstract_caches(jmodel, b, t))


# --------------------------------------------------------------- FLOPs
def test_model_flops_equals_the_reference_in_every_runnable_cell():
    n = 0
    for arch in ARCHS:
        for name, spec in shape_suite(arch).items():
            if isinstance(spec, str):
                continue
            n += 1
            assert model_flops(get_config(arch), spec) == jmodel_flops(jget_config(arch), JSHAPES[name]), (arch, name)
    assert n == 32


SMALL = {"train_4k": ShapeSpec("train_4k", 64, 2, "train"), "prefill_32k": ShapeSpec("prefill_32k", 64, 2, "prefill"),
         "decode_32k": ShapeSpec("decode_32k", 64, 2, "decode")}


_EXTENDED = ("flops", "bytes_accessed", "argument_bytes", "output_bytes")
_PEAKS = ("peak_bytes_one_device", "peak_bytes_per_device")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(SMALL))
def test_differenced_count_equals_the_full_depth_count(arch, shape, monkeypatch):
    """The smoke config at three pattern periods plus a leftover layer
    (the encoder-decoder at 3 + 3 layers; at the smoke configs' own depth
    of one or two periods the probes are the model), at 2 × 64 tokens:
    ``c1 + 2·(c2 - c1)`` from the probes at one and two periods equals the
    count of the whole model, FLOP for FLOP (as ``FlopCounterMode`` alone
    counts them), byte for byte accessed, in the arguments' and results'
    bytes a device and in each collective kind's bytes; and in both peaks
    of the bytes alive, except where the family's step is in
    ``FULL_DEPTH_PEAK`` (there the dry run counts at full depth).  The dry
    run's full-depth numbers (``cell_counts``) equal the whole model's."""
    monkeypatch.setitem(R.SHAPES, shape, SMALL[shape])
    base = get_smoke_config(arch)
    period = len(base.pattern)
    cfg = (dataclasses.replace(base, num_layers=3, encoder_layers=3) if base.kind == "encdec" else
           dataclasses.replace(base, num_layers=3 * period + (1 if period > 1 else 0)))
    layout = make_test_layout(2, 4)
    cell = input_specs(arch, shape, cfg)
    full = DR.count_cell(build_model(cfg), cell, layout)
    assert full["flops"] == DR.count_flops(build_model(cfg), cell, layout) > 0
    c = {m: DR.count_cell(build_model(DR._probe(cfg, m)), cell, layout) for m in (1, 2)}
    n = DR._n_blocks(cfg)
    ext = lambda k, d=lambda x: x: d(c[1])[k] + (n - 1) * (d(c[2])[k] - d(c[1])[k])
    for k in _EXTENDED:
        assert ext(k) == full[k], (k, cfg.num_layers)
    for k in full["coll"]:
        assert ext(k, lambda x: x["coll"]) == full["coll"][k], k
    linear = (DR.family(cfg), cell.step) not in DR.FULL_DEPTH_PEAK
    if linear:
        for k in _PEAKS:
            assert ext(k) == full[k], (k, cfg.num_layers)
    counted = DR.cell_counts(cfg, cell, layout, c if linear else None)
    assert counted["peak_from"] == ("difference" if linear else "full_depth")
    assert {k: counted[k] for k in _EXTENDED + _PEAKS} == {k: full[k] for k in _EXTENDED + _PEAKS}
    assert counted["coll"] == full["coll"]


def test_one_full_width_count_equals_its_full_depth_count():
    """qwen2-7b's decode_32k cell at the published widths, on the production
    layout: the differenced count equals all 28 layers counted."""
    cfg = get_config("qwen2-7b")
    cell = input_specs("qwen2-7b", "decode_32k")
    lay = DR.production_layout()
    assert DR.cell_flops(cfg, cell, lay) == DR.count_flops(build_model(cfg), cell, lay) > 0


def test_pooled_probe_counts_equal_the_serial_ones(tmp_path, monkeypatch):
    """The sweep reads back every standing record and counts the rest in
    its worker processes (spawned), which count the same probes as one
    process does; a probe that raises in a worker makes its cell an
    ``error`` record, written where the sweep collects it, and the other
    cells go on: 31 ok, 8 skip, 1 error, one record and one line a cell."""
    fresh = {("qwen2-7b", "decode_32k"), ("gemma3-1b", "decode_32k")}
    for arch in ARCHS:
        for shape, spec in shape_suite(arch).items():
            if not isinstance(spec, str) and (arch, shape) not in fresh:
                (tmp_path / f"{arch}__{shape}__pod1.json").write_text(json.dumps(
                    {"arch": arch, "shape": shape, "mesh": "pod1", "status": "ok", "marker": True,
                     "bytes": {"total": 0}, "counted_flops": 1, "model_flops": 1, "useful_flops_ratio": 1.0,
                     "seconds": 0.0, "roofline": {"dominant": "compute"},
                     "memory": {"peak_bytes_per_device": 0, "peak_bytes_one_device": 0}}))
    # the sweep hands each worker its config: gemma3-1b's cannot be built
    real = DR.get_config
    monkeypatch.setattr(DR, "get_config", lambda a: dataclasses.replace(real(a), pattern=("nope",))
                        if a == "gemma3-1b" else real(a))
    lines = []
    res = DR.sweep(out_dir=tmp_path, log=lines.append)
    status = [r["status"] for r in res]
    assert (status.count("ok"), status.count("skip"), status.count("error")) == (31, 8, 1)
    assert len(lines) == 40 and len(list(tmp_path.glob("*__pod1.json"))) == 40
    counted = [r for r in res if "marker" not in r and r["status"] == "ok"]
    assert [(r["arch"], r["shape"]) for r in counted] == [("qwen2-7b", "decode_32k")]
    assert counted[0]["counted_flops"] == DR.cell_flops(real("qwen2-7b"), input_specs("qwen2-7b", "decode_32k"),
                                                        DR.production_layout())
    serial = DR.run_cell("qwen2-7b", "decode_32k", out_dir=tmp_path / "serial")
    assert (counted[0]["memory"], counted[0]["roofline"]) == (serial["memory"], serial["roofline"])
    bad = [r for r in res if r["status"] == "error"]
    assert [(r["arch"], r["shape"], r["layout"]) for r in bad] == [("gemma3-1b", "decode_32k", [16, 16])]
    assert json.loads((tmp_path / "gemma3-1b__decode_32k__pod1.json").read_text())["status"] == "error"


# ----------------------------------------------------------------- sweep
def test_full_width_sweep_gives_32_ok_and_8_skip():
    """Every cell at the published widths on meta: 32 runnable, 8 skipped
    (``long_500k`` outside ``SUB_QUADRATIC``); the bytes are the abstract
    trees' and the state of a train cell holds the AdamW moments (8 bytes
    a parameter)."""
    runnable, skipped = [], []
    for arch in ARCHS:
        for shape, spec in shape_suite(arch).items():
            (skipped if isinstance(spec, str) else runnable).append((arch, shape))
    assert (len(runnable), len(skipped)) == (32, 8)
    assert all(a not in SUB_QUADRATIC and s == "long_500k" for a, s in skipped)
    for arch, shape in runnable:
        model = build_model(get_config(arch))
        cell = input_specs(arch, shape)
        b, n = DR.footprint(model, cell), model.param_count()
        assert b["params"] == n * 2  # bfloat16
        assert b["opt_state"] == (8 * n + 4 if cell.step == "train" else 0)
        assert (b["caches"] > 0) == (cell.step == "decode")
        assert b["total"] == b["params"] + b["opt_state"] + b["caches"] + b["batch"]


def _stub_probe(arch, shape_name, cfg, mult, multi_pod):
    """A probe's count without the step: a cell's numbers grow with the
    probe's depth, so the sweep's records can be read back exactly."""
    m = 1 if mult is None else mult
    count = {"flops": 1000 * m, "bytes_accessed": 10**9 * m, "peak_bytes_one_device": 3 * 10**9 * m,
             "peak_bytes_per_device": 2 * 10**9 * m + 0.25, "argument_bytes": 10**9 * m, "output_bytes": 5 * m,
             "coll": {k: 0 for k in JA._COLLECTIVES} | {"all-to-all": 11 * m}}
    return count, 0.0


def test_the_sweep_records_the_reference_keys(tmp_path, monkeypatch):
    """``sweep`` over the 40 cells with each probe's count stubbed (the
    counts themselves are held above and on the card): 32 ok, 8 skip, 0
    error; every ok record's ``roofline`` has the reference's
    ``RooflineTerms.as_dict`` keys over the layout's 256 chips, with the
    collective bytes a device's times the chips; its ``memory`` the
    reference's four keys, the peak the arguments plus the temporaries,
    and the whole card's peak; each number extended to full depth."""
    monkeypatch.setattr(DR, "_probe_count", _stub_probe)
    # the stub cannot reach spawned workers: the sweep's pool runs threads here
    monkeypatch.setattr(concurrent.futures, "ProcessPoolExecutor", lambda n, mp_context=None: ThreadPoolExecutor(n))
    res = DR.sweep(out_dir=tmp_path, log=None)
    status = [r["status"] for r in res]
    assert (status.count("ok"), status.count("skip"), status.count("error")) == (32, 8, 0)
    keys = set(JA.RooflineTerms(1.0, 1.0, 1.0, 1, {}).as_dict())
    for r in res:
        if r["status"] != "ok":
            continue
        cfg = get_config(r["arch"])
        probes = DR._probes(cfg, r["step"])
        n = 1 if probes == (None,) else DR._n_blocks(cfg)
        t, mem = r["roofline"], r["memory"]
        assert set(t) == keys and t["chips"] == 256, r["arch"]
        assert {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes_per_device"} <= set(mem)
        assert mem["argument_bytes"] == 10**9 * n and mem["peak_bytes_per_device"] == 2 * 10**9 * n
        assert mem["argument_bytes"] + mem["temp_bytes"] == mem["peak_bytes_per_device"]
        assert mem["peak_bytes_one_device"] == 3 * 10**9 * n
        assert mem["peak_from"] == ("full_depth" if probes == (None,) else "difference")
        assert t["coll_breakdown"]["all-to-all"] == 11 * n and t["coll_bytes"] == 11 * n * 256
        assert r["counted_flops"] == 1000 * n and t["flops"] == 1000 * n
        assert t["bytes_per_chip"] == mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
        assert json.loads((tmp_path / f"{r['arch']}__{r['shape']}__pod1.json").read_text()) == r


def test_records_are_cached_and_errors_retried(tmp_path, monkeypatch):
    """The reference's rule: an ``ok`` or ``skip`` record is read back, an
    ``error`` is rerun; ``--force`` reruns; the CLI exits 1 on an error."""
    monkeypatch.setattr(DR, "ARTIFACTS", tmp_path)
    path = tmp_path / "qwen2-7b__decode_32k__pod2.json"
    path.write_text(json.dumps({"status": "ok", "counted_flops": 1, "marker": True, "memory": {}, "roofline": {}}))
    assert DR.run_cell("qwen2-7b", "decode_32k", multi_pod=True)["marker"]
    r = DR.run_cell("qwen2-7b", "decode_32k", multi_pod=True, force=True)
    assert r["status"] == "ok" and r["layout"] == [32, 16] and "marker" not in r
    path.write_text(json.dumps({"status": "error"}))
    assert DR.run_cell("qwen2-7b", "decode_32k", multi_pod=True)["status"] == "ok"
    with pytest.raises(SystemExit) as e:
        DR.main(["--arch", "gemma3-1b", "--shape", "long_500k"])
    assert e.value.code == 0
    assert json.loads((tmp_path / "gemma3-1b__long_500k__pod1.json").read_text())["status"] == "skip"
    with pytest.raises(SystemExit) as e:
        DR.main(["--arch", "qwen2-7b", "--shape", "decode_32k", "--set", "pattern=('nope',)", "--tag", "_bad"])
    assert e.value.code == 1
    assert json.loads((tmp_path / "qwen2-7b__decode_32k__pod1_bad.json").read_text())["status"] == "error"


# ------------------------------------------------------ nothing allocated
class _OffMeta(TorchDispatchMode):
    """Records every op that takes or makes a tensor off meta with more
    than one element."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor) and t.device.type != "meta" and t.numel() > 1:
                self.seen.append((str(func), t.device.type, tuple(t.shape)))
        return out


@pytest.mark.parametrize("arch,shape", [("llama4-scout-17b-16e", "decode_32k"), ("qwen2-vl-72b", "prefill_32k"),
                                        ("seamless-m4t-medium", "train_4k"), ("rwkv6-3b", "long_500k"),
                                        ("dbrx-132b", "train_4k")])
def test_the_dry_run_allocates_nothing(arch, shape, tmp_path, monkeypatch):
    """A full-width cell with its FLOP count: no op takes or makes a tensor
    off the meta device larger than a scalar, nothing touches CUDA, and
    no kernel launches."""
    def no_cuda(*a, **k):
        raise AssertionError("the dry run called into CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    KN.reset_launch_counts()
    with _OffMeta() as mode:
        r = DR.run_cell(arch, shape, out_dir=tmp_path)
    assert r["status"] == "ok", r.get("trace")
    assert r["counted_flops"] > 0 and r["roofline"]["flops"] == r["counted_flops"]
    assert r["memory"]["peak_bytes_one_device"] >= r["memory"]["peak_bytes_per_device"] > 0
    assert mode.seen == []
    assert not any(KN.launch_counts().values())


def test_use_plain_takes_meta_and_refuses_mixed_devices():
    meta, cpu = torch.empty(4, device="meta"), torch.empty(4)
    assert KN.use_plain(meta, meta) and KN.use_plain(cpu, cpu)
    with pytest.raises(ValueError):
        KN.use_plain(meta, cpu)
