"""Dry run of every (architecture × shape) cell on the meta device
(counterpart of ``repro.launch.dryrun``).

For every cell of the shape suite (``configs.registry.shape_suite``), at
the published widths, this module

  1. builds the model with ``Model.abstract()`` and the cell's inputs with
     ``input_specs`` — tensors on ``torch.device("meta")``, shapes and
     dtypes only, nothing allocated on the host or the card;
  2. runs the cell's step on them: ``build_train_step`` over
     ``abstract_opt_state`` (train), ``prefill_fn`` (prefill) or
     ``decode_fn`` over ``abstract_caches(global_batch, seq_len)`` (decode;
     the encoder-decoder also takes its ``memory``), on the production
     ``launch.mesh.Layout`` — (16, 16) for one pod, (32, 16) for two, the
     pod axis folded into data — which the MoE dispatch needs;
  3. counts the step in one pass (``count_cell``, through
     ``roofline.analysis.count_step``): its FLOPs as
     ``torch.utils.flop_counter.FlopCounterMode`` counts them, the bytes
     each aten op reads and writes, the peak of the bytes alive, and the
     collectives the layout's call recorder sees (a
     ``StackedCollectives`` that also records the gradient all-reduce a
     data-parallel world would make);
  4. counts it at two shallow depths, one and two pattern periods (plus
     the leftover layers; the encoder-decoder at 1 + 1 and 2 + 2 layers),
     and extends the difference to full depth: ``c1 + (n_blocks -
     1)·(c2 - c1)``, which equals the full-depth count (every period costs
     the same) at a fraction of the time.  The peak is such a sum only
     where the peak's moment does not move with the depth; the family
     steps where it moves on the smoke configs (``FULL_DEPTH_PEAK``: the
     MoE and rwkv decode steps, the vision prefill, the encoder-decoder's
     train step) are counted at full depth instead;
  5. records parameters, the bytes of the parameters, the AdamW state, the
     caches and the batch (from shapes and dtypes), the counted FLOPs,
     ``roofline.analysis.model_flops`` and their ratio, ``memory`` and
     ``roofline`` (``RooflineTerms.as_dict()`` over the layout's data ×
     model chips, on the H100's figures) into
     ``artifacts/dryrun_torch/<arch>__<shape>__<pod1|pod2><tag>.json``.
     A cell recorded ``ok`` (with ``memory`` and ``roofline``) or ``skip``
     is read back instead of rerun (``--force`` reruns it); an ``error``
     is retried.

``memory`` holds the reference's four keys, a device's share of the
reference's production mesh (``launch.specs`` has the partition rule the
port keeps for it): ``argument_bytes``, the inputs the step reads (jit
drops the others), each cut as its spec cuts it; ``output_bytes``, the
step's results (the updated parameters and AdamW state, the new caches,
the logits and metrics) cut likewise; ``peak_bytes_per_device``, the peak
of the bytes alive with every input and gradient at its spec's share and
everything else at the activations' (``specs.activation_pieces``); and
``temp_bytes``, that peak above the arguments.  Beside them,
``peak_bytes_one_device`` is the whole step as the port runs it on one
card (held against ``max_memory_allocated`` in ``chip_smoke.py`` phase
``dryrun``), and ``peak_from`` says whether the peak was differenced or
counted at full depth.  The collective term holds what the port issues:
the MoE plane's rounds and the gradient all-reduce; the port's stacked
layout makes no tensor-parallel collectives, so a dense cell's term has
no twin of the reference's.

The port's microbatch loop is a Python loop, so the count covers every
microbatch: the reference's ``× microbatches`` correction of a scanned
accumulation has no twin here.  Meta is the dry run's device by nature,
not a fallback: a meta tensor carries no data, so every kernel wrapper
traces its plain version (``kernels.use_plain``) and no kernel launches;
the bytes a cell that runs a kernel on the card accesses are its plain
version's.

No twin: the reference's ``lower_cell``, ``make_production_mesh``,
``memory_analysis`` and ``cost_analysis`` read a lowered and compiled XLA
program; the port lowers none and counts its eager step instead.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k [--multi-pod] [--set k=v] [--tag T]
  python -m repro_torch.launch.dryrun --sweep [--multi-pod] [--force]

A sweep counts its probes in ``WORKERS`` worker processes (spawned; the
recurrent cells' Python loops over 4,096 and 32,768 tokens take minutes
of host time on meta), then writes the records in the registry's order.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.registry import Cell, get_config, input_specs
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.collectives import Call, StackedCollectives, grad_buckets
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import Layout
from repro_torch.launch.steps import abstract_caches, abstract_opt_state, build_train_step
from repro_torch.models.api import Model, build_model
from repro_torch.models.common import ModelConfig, ParamTree, tree_leaves
from repro_torch.roofline.analysis import RooflineTerms, collective_bytes, count_step, model_flops, storage_key

__all__ = [
    "ARTIFACTS", "FULL_DEPTH_PEAK", "WORKERS", "cell_counts", "cell_flops", "count_cell", "count_flops", "device_axes",
    "family", "footprint", "main", "nbytes", "production_layout", "run_cell", "sweep",
]

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
# worker processes a sweep counts its probes in: the host's cores but two,
# which stay free for the caller (a device run beside the sweep)
WORKERS = max(1, (os.cpu_count() or 1) - 2)


def production_layout(*, multi_pod: bool = False) -> Layout:
    """The reference's production mesh as a layout: (data 16, model 16), or
    (pod 2, data 16, model 16) with the pod axis folded into data."""
    return Layout(32 if multi_pod else 16, 16)


def nbytes(tree) -> int:
    """Bytes of a tree's tensors (a module, or nested dicts), from their
    shapes and dtypes."""
    leaves = list(tree.parameters()) if isinstance(tree, ParamTree) else tree_leaves(tree)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


def footprint(model: Model, cell: Cell) -> dict:
    """Bytes of the state a step of ``cell`` holds: the parameters, the
    AdamW state (train), the caches (decode, ``global_batch`` ×
    ``seq_len``), the batch, and their total."""
    out = {"params": nbytes(model.abstract()),
           "opt_state": nbytes(abstract_opt_state(model)) if cell.step == "train" else 0,
           "caches": (nbytes(abstract_caches(model, cell.shape.global_batch, cell.shape.seq_len))
                      if cell.step == "decode" else 0),
           "batch": nbytes(cell.batch)}
    out["total"] = sum(out.values())
    return out


def _abstract_inputs(model: Model, cell: Cell):
    """The step's inputs on meta: parameters, AdamW state (train) and
    caches (decode; ``global_batch`` × ``seq_len``)."""
    opt = abstract_opt_state(model) if cell.step == "train" else None
    caches = abstract_caches(model, cell.shape.global_batch, cell.shape.seq_len) if cell.step == "decode" else None
    return model.abstract(), opt, caches


def _run_step(model: Model, cell: Cell, layout, inputs=None):
    params, opt, caches = inputs or _abstract_inputs(model, cell)
    if cell.step == "train":
        return build_train_step(model, layout)(params, opt, cell.batch)
    if cell.step == "prefill":
        return model.prefill_fn(layout)(params, cell.batch)
    if model.cfg.kind == "encdec":
        return model.decode_fn(layout)(params, cell.batch["token"], caches, cell.batch["memory"])
    return model.decode_fn(layout)(params, cell.batch["token"], caches)


class _Recorder(StackedCollectives):
    """The stacked backend, also recording the gradient all-reduce a
    data-parallel world of the port makes (``DistributedCollectives.
    grad_all_reduce``: one call a bucket; the stacked backend makes none)."""

    def grad_all_reduce(self, tensors) -> None:
        for b in grad_buckets(tensors):
            self.calls[Call("grad_all_reduce", sum(t.numel() * t.element_size() for t in b),
                            (sum(t.numel() for t in b),))] += 1


def device_axes(layout, *, multi_pod: bool = False) -> dict:
    """The reference's mesh a layout stands for (``specs.mesh_axes``): the
    pod axis unfolded from data across two pods; one device without a
    layout."""
    if layout is None:
        return S.mesh_axes(1, 1)
    if multi_pod:
        return S.mesh_axes(layout.data // 2, layout.model, multi_pod=True)
    return S.mesh_axes(layout.data, layout.model)


def _held(model: Model, cell: Cell, inputs, axes: dict):
    """The step's inputs as ``[(tensor, weight, bytes a device)]``: each at
    one over the pieces its spec cuts it into (``launch.specs``); and the
    parameters as ``[(parameter, weight)]``, their gradients' weights."""
    cfg = model.cfg
    params, opt, caches = inputs
    held, grads = [], []

    def add(t, spec, allow_move=True):
        k = S.share(t.shape, spec, axes, allow_move=allow_move)
        held.append((t, 1.0 / k, t.numel() * t.element_size() // k))
        return k

    for path, p in S.named_leaves(params.tree()):
        k = add(p, S.param_spec(path, cfg, serve=cell.step != "train"))
        if cell.step == "train":
            grads.append((p, 1.0 / k))
    for key, tree in (opt or {}).items():
        for path, t in S.named_leaves(tree, (key,)):
            add(t, () if key == "step" else S.param_spec(path[1:], cfg))
    for path, t in S.named_leaves(caches or {}):
        add(t, S.cache_spec(path, cfg))
    for t in cell.batch.values():
        add(t, S.batch_spec(t.dim(), cfg, axes), allow_move=False)
    return held, grads


def _output_bytes(model: Model, cell: Cell, out, axes: dict) -> int:
    """Bytes a device holds of the step's results: the parameters and
    AdamW state (train) and the caches (decode) under their specs, the
    logits over the batch axes, the metrics whole."""
    cfg = model.cfg
    if cell.step == "train":
        params, opt, metrics = out
        held, _ = _held(model, dataclasses.replace(cell, batch={}), (params, opt, None), axes)
        return sum(n for _t, _w, n in held) + sum(t.numel() * t.element_size() for t in metrics.values())
    logits, caches, rest = (out, None, ()) if cell.step == "prefill" else (out[0], out[1], out[2:])
    n = S.device_bytes(logits, S.batch_spec(logits.dim(), cfg, axes), axes, allow_move=False)
    n += sum(S.device_bytes(t, S.cache_spec(path, cfg), axes) for path, t in S.named_leaves(caches or {}))
    return n + sum(t.numel() * t.element_size() for t in rest)


def count_cell(model: Model, cell: Cell, layout=None, *, multi_pod: bool = False, signatures: bool = False) -> dict:
    """One step of ``cell`` at the model's depth, counted on meta in one
    pass (``roofline.analysis.count_step``): its FLOPs, bytes accessed,
    the peak bytes alive on one card running the whole step (its inputs,
    ``held_bytes``, alive from the start) and on one device of the
    layout's mesh (:func:`device_axes`; every input and gradient at its
    spec's share, the rest at the activations', ``specs.
    activation_pieces``), the arguments' and results' bytes a device, and
    the collectives of the layout's recorder (a device's result bytes by
    HLO kind, and the calls).  ``signatures``: also the ops'
    signatures."""
    axes = device_axes(layout, multi_pod=multi_pod)
    rec = None
    if layout is not None:
        rec = _Recorder()
        layout = dataclasses.replace(layout, comm=rec)
    inputs = _abstract_inputs(model, cell)
    held, grads = _held(model, cell, inputs, axes)
    c = count_step(lambda: _run_step(model, cell, layout, inputs), held=[([t], w) for t, w, _n in held], grads=grads,
                   default_weight=1.0 / S.activation_pieces(model.cfg, cell.batch, axes), signatures=signatures)
    # the inputs the step reads: a jitted step's arguments (jit drops those it never reads)
    arg = sum(n for t, _w, n in held if storage_key(t) in c.read)
    calls, tiers = (rec.calls, (layout.data, layout.model)) if rec is not None else ({}, None)
    out = {"flops": c.flops, "bytes_accessed": c.bytes_accessed, "peak_bytes_one_device": c.peak_bytes,
           "peak_bytes_per_device": c.peak_weighted, "argument_bytes": arg,
           "held_bytes": sum(t.numel() * t.element_size() for t, _w, _n in held),
           "output_bytes": _output_bytes(model, cell, c.out, axes), "coll": collective_bytes(calls, tiers),
           "calls": dict(calls)}
    if signatures:
        out["signatures"] = c.signatures
    return out


def count_flops(model: Model, cell: Cell, layout=None) -> int:
    """FLOPs of one step of ``cell`` at the model's depth, as
    ``FlopCounterMode`` counts them (matmuls, forward, backward and the
    checkpoint's recompute), on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        _run_step(model, cell, layout)
    return int(fc.get_total_flops())


def _probe(cfg: ModelConfig, mult: int) -> ModelConfig:
    if cfg.kind == "encdec":
        return dataclasses.replace(cfg, encoder_layers=mult, num_layers=mult)
    period = len(cfg.pattern)
    return dataclasses.replace(cfg, num_layers=period * mult + cfg.num_layers % period)


def _n_blocks(cfg: ModelConfig) -> int:
    return cfg.num_layers if cfg.kind == "encdec" else cfg.num_layers // len(cfg.pattern)


def family(cfg: ModelConfig) -> str:
    """The family whose step shapes the peak: ``encdec``, ``moe``,
    ``rwkv``, ``griffin``, ``vision`` (M-RoPE) or ``dense``."""
    if cfg.kind in ("encdec", "moe"):
        return cfg.kind
    if "rwkv" in cfg.pattern:
        return "rwkv"
    if "recurrent" in cfg.pattern:
        return "griffin"
    return "vision" if cfg.frontend == "vision" else "dense"


# (family, step) pairs whose peak the two probes' difference does not
# give: the peak moves between moments (a decode step's last layer, its
# stacked new caches, its logits) as the depth grows.  Found on each
# family's smoke config at three periods (tests/test_torch_dryrun.py);
# these cells are counted at full depth instead.
FULL_DEPTH_PEAK = {("moe", "decode"), ("rwkv", "decode"), ("vision", "prefill"), ("encdec", "train")}


def _probes(cfg: ModelConfig, step: str):
    """The depths a count runs at: one and two pattern periods, or the
    config itself (None) when it has at most one or its peak needs the
    full depth (:data:`FULL_DEPTH_PEAK`)."""
    if _n_blocks(cfg) > 1 and (family(cfg), step) not in FULL_DEPTH_PEAK:
        return (1, 2)
    return (None,)


_SUMMED = ("flops", "bytes_accessed", "peak_bytes_one_device", "peak_bytes_per_device", "argument_bytes",
           "output_bytes")


def cell_counts(cfg: ModelConfig, cell: Cell, layout=None, counts=None, *, multi_pod: bool = False) -> dict:
    """:func:`count_cell`'s numbers at full depth, from the counts at one
    and two pattern periods: ``c1 + (n_blocks - 1)·(c2 - c1)`` for each
    (the FLOPs, bytes, peaks and each collective kind's bytes), which
    equals the full-depth count where every period costs the same; or the
    full-depth count itself (:func:`_probes`).  ``counts``
    maps each of ``_probes`` to a count made elsewhere (``sweep``'s
    workers)."""
    if counts is None:
        counts = {m: count_cell(build_model(cfg if m is None else _probe(cfg, m)), cell, layout, multi_pod=multi_pod)
                  for m in _probes(cfg, cell.step)}
    if None in counts:
        return dict(counts[None], peak_from="full_depth")
    c1, c2, n = counts[1], counts[2], _n_blocks(cfg)
    ext = lambda a, b: a + (n - 1) * (b - a)
    out = {k: ext(c1[k], c2[k]) for k in _SUMMED}
    out["coll"] = {k: ext(c1["coll"][k], c2["coll"][k]) for k in c1["coll"]}
    return dict(out, peak_from="difference")


def cell_flops(cfg: ModelConfig, cell: Cell, layout=None, counts=None) -> int:
    """The full-depth FLOP count (:func:`cell_counts`)."""
    return int(cell_counts(cfg, cell, layout, counts)["flops"])


def _probe_count(arch: str, shape_name: str, cfg: ModelConfig, mult, multi_pod: bool):
    """One probe's count and its seconds (a worker's unit in ``sweep``)."""
    t0 = time.perf_counter()
    pcfg = cfg if mult is None else _probe(cfg, mult)
    c = count_cell(build_model(pcfg), input_specs(arch, shape_name, pcfg), production_layout(multi_pod=multi_pod),
                   multi_pod=multi_pod)
    return c, time.perf_counter() - t0


def _cached(out_path: Path, *, force: bool):
    """The cell's record if it stands: not forced, not an error (errors
    are retried after fixes), and an ``ok`` record with its ``memory`` and
    ``roofline`` (a record written before they were counted is rerun)."""
    if force or not out_path.exists():
        return None
    cached = json.loads(out_path.read_text())
    if cached.get("status") == "skip" or (cached.get("status") == "ok" and {"memory", "roofline"} <= set(cached)):
        return cached
    return None


def _name(arch: str, shape_name: str, multi_pod: bool, tag: str = "") -> str:
    return f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}{tag}"


def _header(arch: str, shape_name: str, cell: Cell, *, multi_pod: bool, tag: str) -> dict:
    layout = production_layout(multi_pod=multi_pod)
    return {"arch": arch, "shape": shape_name, "mesh": "pod2" if multi_pod else "pod1", "step": cell.step,
            "tag": tag, "layout": [layout.data, layout.model]}


def _failed(rec: dict, e: Exception, seconds: float) -> dict:
    rec.update(status="error", error=f"{type(e).__name__}: {e}",
               trace="".join(traceback.format_exception(e))[-2000:], seconds=seconds)
    print(f"[{rec['arch']} × {rec['shape']}] FAILED: {rec['error']}")
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, force: bool = False,
             overrides: dict | None = None, tag: str = "", out_dir: Path | None = None, counts=None) -> dict:
    """Dry-run one cell and write its record.  ``counts`` are the probes'
    ``{mult: (count, seconds)}`` when ``sweep``'s workers made them."""
    out_dir = Path(out_dir or ARTIFACTS)
    out_path = out_dir / f"{_name(arch, shape_name, multi_pod, tag)}.json"
    cached = _cached(out_path, force=force)
    if cached is not None:
        return cached

    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = input_specs(arch, shape_name, cfg)
    layout = production_layout(multi_pod=multi_pod)
    rec = _header(arch, shape_name, cell, multi_pod=multi_pod, tag=tag)
    if cell.skip:
        rec.update(status="skip", reason=cell.skip)
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    t0 = time.perf_counter()
    seconds = 0.0
    try:
        model = build_model(cfg)
        rec.update(n_params=model.param_count(), bytes=footprint(model, cell))
        if counts is not None:
            seconds = sum(t for _, t in counts.values())
            counts = {m: c for m, (c, _) in counts.items()}
        c = cell_counts(cfg, cell, layout, counts, multi_pod=multi_pod)
        mf = model_flops(cfg, cell.shape)
        rec.update(status="ok", counted_flops=int(c["flops"]), model_flops=mf, useful_flops_ratio=mf / c["flops"],
                   **_terms(c, layout), seconds=time.perf_counter() - t0 + seconds)
    except Exception as e:  # noqa: BLE001 — a failed cell is a recorded result
        _failed(rec, e, time.perf_counter() - t0 + seconds)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def _terms(c: dict, layout) -> dict:
    """A cell's ``memory`` and ``roofline`` entries from
    its full-depth counts: the reference's memory keys (``temp_bytes``
    the device's peak above its arguments, so that ``argument_bytes +
    temp_bytes`` is ``peak_bytes_per_device``, as the reference adds
    them) and the whole card's step beside them; the terms over the
    layout's chips with the collective bytes a device's times the chips,
    as ``analyze_lowered`` gives them."""
    chips = layout.data * layout.model
    peak, arg, out = int(round(c["peak_bytes_per_device"])), int(c["argument_bytes"]), int(c["output_bytes"])
    temp = peak - arg
    memory = {"argument_bytes": arg, "output_bytes": out, "temp_bytes": temp, "peak_bytes_per_device": peak,
              "peak_bytes_one_device": int(c["peak_bytes_one_device"]), "peak_from": c["peak_from"]}
    coll = {k: int(v) for k, v in c["coll"].items()}
    terms = RooflineTerms(flops=float(c["flops"]), bytes_accessed=float(c["bytes_accessed"]),
                          coll_bytes=float(sum(coll.values())) * chips, chips=chips, coll_breakdown=coll,
                          bytes_per_chip=float(arg + out + temp))
    return {"memory": memory, "roofline": terms.as_dict()}


def _line(r: dict) -> str:
    if r["status"] == "ok":
        extra = (f" dominant={r['roofline']['dominant']} peak {r['memory']['peak_bytes_per_device'] / 1e9:.1f} GB a "
                 f"device, {r['memory']['peak_bytes_one_device'] / 1e9:.1f} GB on one card; counted "
                 f"{r['counted_flops']:.4e} model {r['model_flops']:.4e} ratio {r['useful_flops_ratio']:.4f} "
                 f"({r['seconds']:.1f} s)")
    else:
        extra = f" ({r.get('reason', r.get('error', ''))[:60]})"
    return f"{r['arch']:>22} × {r['shape']:<12} [{r['mesh']}] → {r['status']}{extra}"


def sweep(*, multi_pod: bool = False, force: bool = False, out_dir: Path | None = None, log=print,
          archs=None) -> list:
    """Every cell of every arch (of ``archs``, None: all), in the
    registry's order; one line each.
    The probes of the cells not read back are counted first, in
    ``WORKERS`` processes, the longest first: the scans' (a recurrent or
    rwkv step is a Python loop a token, and on meta each elementwise op
    costs ~0.2 ms of the host), then the full-depth counts; a cell whose
    probe raised is recorded as an error there."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.configs.registry import ARCHS, shape_suite

    out_dir = Path(out_dir or ARTIFACTS)
    cells = [(arch, shape_name) for arch in ARCHS if archs is None or arch in archs
             for shape_name in shape_suite(arch)]
    todo = [(arch, shape_name, get_config(arch)) for arch, shape_name in cells
            if not isinstance(shape_suite(arch)[shape_name], str)
            and _cached(out_dir / f"{_name(arch, shape_name, multi_pod)}.json", force=force) is None]
    units = [(arch, shape_name, cfg, m) for arch, shape_name, cfg in todo
             for m in _probes(cfg, SHAPES[shape_name].step)]
    units.sort(key=lambda u: (-("recurrent" in u[2].pattern), -("rwkv" in u[2].pattern), u[3] is not None,
                              SHAPES[u[1]].step == "decode", -(u[3] or 0)))
    futures: dict = {}
    pool = None
    if units:
        pool = ProcessPoolExecutor(min(WORKERS, len(units)), mp_context=multiprocessing.get_context("spawn"))
        for arch, shape_name, cfg, m in units:
            futures.setdefault((arch, shape_name), {})[m] = pool.submit(_probe_count, arch, shape_name, cfg, m,
                                                                        multi_pod)
    results = []
    try:
        for arch, shape_name in cells:
            counts = None
            if (arch, shape_name) in futures:
                t0 = time.perf_counter()
                try:
                    counts = {m: f.result() for m, f in futures[(arch, shape_name)].items()}
                except Exception as e:  # noqa: BLE001 — a failed probe is the cell's recorded error
                    out_dir.mkdir(parents=True, exist_ok=True)
                    rec = _failed(_header(arch, shape_name, input_specs(arch, shape_name), multi_pod=multi_pod,
                                          tag=""), e, time.perf_counter() - t0)
                    (out_dir / f"{_name(arch, shape_name, multi_pod)}.json").write_text(json.dumps(rec, indent=1))
                    results.append(rec)
                    if log:
                        log(_line(rec))
                    continue
            r = run_cell(arch, shape_name, multi_pod=multi_pod, force=force, out_dir=out_dir, counts=counts)
            if log:
                log(_line(r))
            results.append(r)
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="artifact suffix for variants")
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig overrides key=value, the value a Python literal (repeatable)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = ast.literal_eval(v)

    if args.sweep:
        t0 = time.perf_counter()
        results = sweep(multi_pod=args.multi_pod, force=args.force, log=lambda s: print(s, flush=True))
        count = {s: sum(1 for r in results if r["status"] == s) for s in ("ok", "skip", "error")}
        print(f"\nsweep done: {count['ok']} ok, {count['skip']} skip, {count['error']} error "
              f"in {time.perf_counter() - t0:.1f} s")
        raise SystemExit(1 if count["error"] else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --sweep")
    r = run_cell(args.arch, args.shape, multi_pod=args.multi_pod, force=args.force, overrides=overrides,
                 tag=args.tag)
    print(json.dumps(r, indent=1))
    raise SystemExit(1 if r["status"] == "error" else 0)


if __name__ == "__main__":
    main()
