"""The port's roofline terms, report and inspector
(``repro_torch.roofline.analysis`` / ``report`` / ``inspect``) against the
JAX reference's on the CPU.

* The report: the port's ``report`` and ``repro.roofline.report`` on the
  same records print the same text, character for character: the
  synthetic records of ``tests/test_roofline_report.py`` and a record the
  port's dry run writes.
* The inspector: the all-to-all bytes the port's inspector reads from the
  call recorder of a padded round (R = 8, CAP = 64, the ray of
  ``tests/helpers.py``) equal the reference inspector's reading of the
  compiled HLO of the same round, ``[R·4, R·S·W·4]``; ``buffer_report``
  prints the reference's line; the CLI prints its three sections.
* ``RooflineTerms``: with the reference's ``HW`` set to the port's
  figures, ``as_dict`` equals the reference's on the same inputs.
* The bytes a device holds of a step's arguments: one smoke train cell a
  family (dense, MoE, vision, rwkv, griffin, encoder-decoder — every
  family the reference lowers on the CPU's 8 devices) lowered by the
  reference's ``lower_cell`` on ``make_test_mesh(2, 4)``, its
  ``memory_analysis().argument_size_in_bytes`` against the port's dry run
  on the (2, 4) layout, equal to the byte.  The port's partition rule
  (``launch.specs``) gives the reference's spec for every parameter and
  cache leaf of every architecture, smoke and full.

Tolerance: none — the numbers are counts, the text is compared whole.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from helpers import make_rays, ray_proto
from repro import compat
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs import registry as JR
from repro.core import ForwardConfig as JForwardConfig
from repro.core import enqueue as jenqueue
from repro.core import forward_work as jforward_work
from repro.core import make_queue as jmake_queue
from repro.core import types as JT
from repro.launch import steps as JS
from repro.launch.steps import lower_cell
from repro.models.api import build_model as jbuild
from repro.roofline import analysis as JA

# importing the reference's inspector sets XLA_FLAGS for its CLI; keep the
# suite's setting for the processes tests start
_saved_flags = os.environ.get("XLA_FLAGS")
from repro.roofline import inspect as RI  # noqa: E402
from repro.roofline import report as RR  # noqa: E402

if _saved_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved_flags

from repro_torch.configs import ARCHS, get_config, get_smoke_config, input_specs  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ForwardConfig, StackedCollectives, enqueue, forward_work, make_queue, work_item,
)
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import make_test_layout  # noqa: E402
from repro_torch.launch.steps import abstract_caches  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.roofline import analysis as A  # noqa: E402
from repro_torch.roofline import inspect as TI  # noqa: E402
from repro_torch.roofline import report as TR  # noqa: E402

R, CAP = 8, 64
WORDS = JT.pack_spec(ray_proto()).total_words


# ----------------------------------------------------------------- report
def _ok(arch, shape, step, t_comp, t_mem, t_coll, dominant, mem_bytes, uf, coll_breakdown=None, tag=""):
    return {"status": "ok", "arch": arch, "shape": shape, "step": step, "tag": tag,
            "roofline": {"t_compute": t_comp, "t_memory": t_mem, "t_collective": t_coll, "dominant": dominant,
                         "coll_breakdown": coll_breakdown or {}},
            "memory": {"peak_bytes_per_device": mem_bytes}, "useful_flops_ratio": uf}


# the records of tests/test_roofline_report.py's fixture
RECORDS = {
    "a__pod1.json": _ok("toy", "train_1k", 12, 1.5, 0.8, 0.2, "compute", 12.3e9, 0.55),
    "b__pod1.json": _ok("toy", "train_4k", 3, 0.4, 0.9, 0.1, "memory", 30.0e9, 0.40),
    "c__pod1.json": _ok("big", "train_8k", 7, 0.2, 0.3, 0.6, "collective", 64.0e9, 0.35,
                        coll_breakdown={"all-gather": 0.2, "all-to-all": 0.4}),
    "d__pod1.json": {"status": "skip", "arch": "huge", "shape": "train_32k", "tag": "", "reason": "needs 512 chips"},
    "e__pod1.json": {"status": "error", "arch": "bad", "shape": "train_1k", "tag": "",
                     "error": "OOM during layout assignment"},
    "f__pod2.json": _ok("other", "x", 1, 1.0, 0.1, 0.1, "compute", 1e9, 0.9),
    "g__pod1.json": _ok("other", "y", 1, 1.0, 0.1, 0.1, "compute", 1e9, 0.9, tag="probe"),
}


@pytest.fixture
def both_reports(tmp_path, monkeypatch):
    monkeypatch.setattr(RR, "ARTIFACTS", tmp_path)
    monkeypatch.setattr(TR, "ARTIFACTS", tmp_path)
    return tmp_path


def _reference_cli_text(tag):
    """What ``python -m repro.roofline.report <tag>`` prints."""
    return RR.roofline_table(tag) + "\n\n" + "".join(f"{row}\n" for row in RR.summary(tag))


def _same_reports(capsys):
    for tag in ("pod1", "pod2"):
        assert TR.roofline_table(tag) == RR.roofline_table(tag)
        assert TR.summary(tag) == RR.summary(tag)
        assert TR.load(tag) == RR.load(tag)
        assert TR.load(tag, tag="probe") == RR.load(tag, tag="probe")
        TR.main([tag])
        assert capsys.readouterr().out == _reference_cli_text(tag)


def test_report_prints_the_reference_text_on_the_synthetic_records(both_reports, capsys):
    for name, rec in RECORDS.items():
        (both_reports / name).write_text(json.dumps(rec))
    _same_reports(capsys)
    assert TR.roofline_table("pod1").splitlines()[2] == (
        "| toy | train_1k | 12 | 1.50s | 800.0ms | 200.0ms | **comp** | 12.3GB | 0.55 | "
        "cf=1.00; near compute roofline |")
    for x in (None, 1.0, 0.0125, 3.5, 0.0):
        assert TR._fmt_s(x) == RR._fmt_s(x)


def test_report_reads_the_dry_run_records_as_the_reference_does(both_reports, capsys):
    """Records the port's dry run writes (ok and skip) print in both
    reports alike: the port's records carry the keys the reference's
    report reads."""
    for arch, shape in (("qwen2-7b", "decode_32k"), ("gemma3-1b", "long_500k")):
        DR.run_cell(arch, shape, out_dir=both_reports)
    assert len(TR.load("pod1")) == 2
    _same_reports(capsys)


# -------------------------------------------------------------- inspector
@work_item
@dataclasses.dataclass
class Ray:
    origin: torch.Tensor
    direction: torch.Tensor
    tmin: torch.Tensor
    pixel: torch.Tensor
    integral: torch.Tensor


def _port_padded_round_calls():
    proto = Ray(torch.zeros(3), torch.zeros(3), torch.zeros(()), torch.zeros((), dtype=torch.int32), torch.zeros(()))
    rays = make_rays(10)
    items = Ray(*(torch.from_numpy(np.array(a)).expand((R,) + tuple(a.shape)).contiguous()
                  for a in (rays.origin, rays.direction, rays.tmin, rays.pixel, rays.integral)))
    dest = ((torch.arange(R)[:, None] + torch.arange(10)[None, :]) % R).to(torch.int32)
    q = enqueue(make_queue(proto, CAP, num_ranks=R, device="cpu"), items, dest, torch.ones(R, 10, dtype=torch.bool))
    comm = StackedCollectives()
    cfg = ForwardConfig(R, CAP, exchange="padded")
    forward_work(q, cfg, comm=comm)
    return cfg, comm.calls


def _reference_padded_round_hlo(mesh8):
    cfg = JForwardConfig("data", R, CAP, exchange="padded")

    def kernel(_x):
        q = jmake_queue(ray_proto(), CAP)
        me = jax.lax.axis_index("data")
        q = jenqueue(q, make_rays(10), ((me + jnp.arange(10)) % R).astype(jnp.int32), jnp.ones(10, bool))
        nq, total = jforward_work(q, cfg)
        return nq.count[None], total, nq.items.tmin

    return cfg, jax.jit(compat.shard_map(kernel, mesh=mesh8, in_specs=P("data"),
                                         out_specs=(P("data"), P(), P("data")))).lower(jnp.arange(8.0)).compile()


def test_inspector_reads_the_reference_all_to_all_bytes(mesh8):
    """The padded round's payload and count ``all_to_all``: the port's
    inspector on the recorder and the reference's on the compiled HLO
    give the same per-device bytes, ``[R·4, R·S·W·4]``."""
    cfg, calls = _port_padded_round_calls()
    jcfg, compiled = _reference_padded_round_hlo(mesh8)
    got = sorted(b for (kind, _s), b in TI.top_collectives(calls) if kind == "all-to-all")
    want = sorted(b for (kind, _s), b in RI.top_collectives(compiled.as_text()) if kind == "all-to-all")
    assert cfg.peer_capacity == jcfg.peer_capacity
    assert got == want == [R * 4, R * cfg.peer_capacity * WORDS * 4]
    shapes = {s for (kind, s), _b in TI.top_collectives(calls) if kind == "all-to-all"}
    assert shapes == {f"[{R},1]", f"[{R},{cfg.peer_capacity},{WORDS}]"}
    # the only other traffic: the scalar count reduction, as the reference's
    assert all(b <= R * R * 4 for (k, _s), b in TI.top_collectives(calls) if k != "all-to-all")


def test_buffer_report_prints_the_reference_line():
    class _Mem:
        argument_size_in_bytes = 2.0e9
        output_size_in_bytes = 5.0e8
        temp_size_in_bytes = 0.0

    class _Compiled:
        def memory_analysis(self):
            return _Mem()

    for args, out, temp in ((2.0e9, 5.0e8, 0.0), (123456789, 0, 9.87e10), (0, 0, 0)):
        _Mem.argument_size_in_bytes, _Mem.output_size_in_bytes, _Mem.temp_size_in_bytes = args, out, temp
        mine = TI.buffer_report({"argument_bytes": args, "output_bytes": out, "temp_bytes": temp})
        assert mine == RI.buffer_report(_Compiled())
    assert TI.buffer_report({"argument_bytes": 2.0e9, "output_bytes": 5.0e8, "temp_bytes": 0}) == \
        "args=2.00GB out=0.50GB temp=0.00GB"


def test_inspector_cli_prints_its_sections(capsys):
    """One period of llama4-scout's train cell on the production layout:
    the memory and cost lines, the MoE plane's collectives (its
    ``all-to-all`` rounds, the model tier's ``all-gather``, the gradient
    ``all-reduce``) and the duplicated signatures; no JAX flag set."""
    flags = os.environ.get("XLA_FLAGS")
    TI.main(["--arch", "llama4-scout-17b-16e", "--shape", "train_4k", "--probe"])
    out = capsys.readouterr().out.splitlines()
    assert os.environ.get("XLA_FLAGS") == flags
    assert out[0].startswith("== memory: args=") and out[1].startswith("== cost: flops=")
    heads = [i for i, line in enumerate(out) if line.startswith("==")]
    assert [out[i].split(":")[0] for i in heads] == ["== memory", "== cost", "== top collectives (bytes aggregated "
                                                     "over identical shapes)", "== most-duplicated op signatures "
                                                     "(recompute indicator)"]
    kinds = {line.split()[2] for line in out[heads[2] + 1:heads[3]]}
    assert {"all-to-all", "all-gather", "all-reduce"} <= kinds
    assert out[heads[3] + 1].lstrip().startswith("×")


# ---------------------------------------------------------- RooflineTerms
def test_hw_is_the_h100():
    assert A.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "link_bw": 450e9, "dcn_bw": 50e9}
    assert A.COLLECTIVES == JA._COLLECTIVES


@pytest.mark.parametrize("flops,bytes_,coll,chips", [
    (6.1e16, 9.2e14, 3.9e12, 256), (1e12, 1e15, 0.0, 1), (1e10, 1e9, 5e12, 512), (0.0, 0.0, 0.0, 8),
])
def test_roofline_terms_equal_the_reference_on_the_h100(monkeypatch, flops, bytes_, coll, chips):
    for k, v in A.HW.items():
        monkeypatch.setitem(JA.HW, k, v)
    breakdown = {k: int(coll / chips) if k == "all-reduce" else 0 for k in JA._COLLECTIVES}
    mine = A.RooflineTerms(flops, bytes_, coll, chips, breakdown, bytes_per_chip=1.5e9)
    theirs = JA.RooflineTerms(flops, bytes_, coll, chips, breakdown, bytes_per_chip=1.5e9)
    assert mine.as_dict() == theirs.as_dict()
    assert (mine.bound_time, mine.dominant) == (theirs.bound_time, theirs.dominant)


# ------------------------------------------------- arguments a device
def _jspecs(tree):
    return {tuple(str(k.key) for k in path): tuple(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, P))}


class _Mesh:
    def __init__(self, axes):
        self.shape = axes


@pytest.mark.parametrize("arch", ARCHS)
def test_partition_rule_is_the_reference_spec_for_every_leaf(arch):
    """``launch.specs``: every parameter (train and serve) and cache
    leaf's spec equals the reference's, smoke and full, and resolves on
    the one-pod, two-pod and (2, 4) meshes as the reference's
    ``resolve_spec`` does."""
    for cfg, jcfg in ((get_smoke_config(arch), jget_smoke(arch)), (get_config(arch), jget_config(arch))):
        model, jmodel = build_model(cfg), jbuild(jcfg)
        for serve in (False, True):
            want = _jspecs(jmodel.specs(serve=serve))
            for path, p in S.named_leaves(model.abstract().tree()):
                spec = S.param_spec(path, cfg, serve=serve)
                assert spec == want[path], (path, serve)
                for axes in (S.mesh_axes(), S.mesh_axes(multi_pod=True), S.mesh_axes(2, 4)):
                    theirs = tuple(JS.resolve_spec(tuple(p.shape), P(*spec), _Mesh(axes)))
                    assert S.resolve_spec(tuple(p.shape), spec, axes) == theirs + (None,) * (p.dim() - len(theirs))
        want = _jspecs(jmodel.cache_specs())
        for path, _t in S.named_leaves(abstract_caches(model, 4, 64)):
            assert S.cache_spec(path, cfg) == want[path], path


# one smoke train cell a family
FAMILY_CELLS = ["qwen2-7b", "llama4-scout-17b-16e", "qwen2-vl-72b", "rwkv6-3b", "recurrentgemma-2b",
                "seamless-m4t-medium"]


def test_family_cells_cover_every_family():
    assert sorted(DR.family(get_config(a)) for a in FAMILY_CELLS) == sorted(
        {DR.family(get_config(a)) for a in ARCHS})


@pytest.mark.parametrize("arch", FAMILY_CELLS)
def test_argument_bytes_a_device_equal_the_reference_memory_analysis(arch, mesh24):
    """The smoke config's train_4k cell: the reference's compiled step on
    ``make_test_mesh(2, 4)`` holds as many argument bytes a device as the
    port's dry run counts on the (2, 4) layout (the inputs the step reads,
    each under its spec; jit drops an input the step never reads, as the
    vision family's tokens)."""
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    with mesh24:
        compiled = lower_cell(jbuild(jcfg), mesh24, JR.input_specs(arch, "train_4k", jcfg)).compile()
    want = compiled.memory_analysis().argument_size_in_bytes
    got = DR.count_cell(build_model(cfg), input_specs(arch, "train_4k", cfg), make_test_layout(2, 4))
    assert got["argument_bytes"] == want
    assert 0 < got["argument_bytes"] <= got["peak_bytes_per_device"] <= got["peak_bytes_one_device"]
