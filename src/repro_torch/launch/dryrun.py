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
  3. counts the step's FLOPs under ``torch.utils.flop_counter.
     FlopCounterMode`` at two shallow depths, one and two pattern periods
     (plus the leftover layers; the encoder-decoder at 1 + 1 and 2 + 2
     layers), and extends the difference to full depth:
     ``c1 + (n_blocks - 1)·(c2 - c1)``, which equals the full-depth count
     (every period costs the same) at a fraction of the time;
  4. records parameters, the bytes of the parameters, the AdamW state, the
     caches and the batch (from shapes and dtypes), the counted FLOPs,
     ``roofline.analysis.model_flops`` and their ratio into
     ``artifacts/dryrun_torch/<arch>__<shape>__<pod1|pod2><tag>.json``.
     A cell recorded ``ok`` or ``skip`` is read back instead of rerun
     (``--force`` reruns it); an ``error`` is retried.

The port's microbatch loop is a Python loop, so the count covers every
microbatch: the reference's ``× microbatches`` correction of a scanned
accumulation has no twin here.  Meta is the dry run's device by nature,
not a fallback: a meta tensor carries no data, so every kernel wrapper
traces its plain version (``kernels.use_plain``) and no kernel launches.

No twin: the reference's ``lower_cell``, ``make_production_mesh``,
``memory_analysis``, ``cost_analysis``, the collective bytes and
``peak_bytes_per_device`` read a lowered and compiled XLA program; the
port lowers none.  The bytes here are the state a step holds, not a
compiler's peak.

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
from repro_torch.launch.mesh import Layout
from repro_torch.launch.steps import abstract_caches, abstract_opt_state, build_train_step
from repro_torch.models.api import Model, build_model
from repro_torch.models.common import ModelConfig, ParamTree, tree_leaves
from repro_torch.roofline.analysis import model_flops

__all__ = [
    "ARTIFACTS", "WORKERS", "cell_flops", "count_flops", "footprint", "main", "nbytes", "production_layout", "run_cell",
    "sweep",
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


def _run_step(model: Model, cell: Cell, layout):
    params = model.abstract()
    if cell.step == "train":
        return build_train_step(model, layout)(params, abstract_opt_state(model), cell.batch)
    if cell.step == "prefill":
        return model.prefill_fn(layout)(params, cell.batch)
    caches = abstract_caches(model, cell.shape.global_batch, cell.shape.seq_len)
    if model.cfg.kind == "encdec":
        return model.decode_fn(layout)(params, cell.batch["token"], caches, cell.batch["memory"])
    return model.decode_fn(layout)(params, cell.batch["token"], caches)


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


def _probes(cfg: ModelConfig):
    """The depths a count runs at: one and two pattern periods, or the
    config itself (None) when it has at most one."""
    return (1, 2) if _n_blocks(cfg) > 1 else (None,)


def cell_flops(cfg: ModelConfig, cell: Cell, layout=None, counts=None) -> int:
    """The full-depth FLOP count, from the counts at one and two pattern
    periods: ``c1 + (n_blocks - 1)·(c2 - c1)``.  ``counts`` maps each of
    ``_probes(cfg)`` to a count made elsewhere (``sweep``'s workers)."""
    if counts is None:
        counts = {m: count_flops(build_model(cfg if m is None else _probe(cfg, m)), cell, layout)
                  for m in _probes(cfg)}
    if None in counts:
        return counts[None]
    return counts[1] + (_n_blocks(cfg) - 1) * (counts[2] - counts[1])


def _probe_count(arch: str, shape_name: str, cfg: ModelConfig, mult, multi_pod: bool):
    """One probe's count and its seconds (a worker's unit in ``sweep``)."""
    t0 = time.perf_counter()
    pcfg = cfg if mult is None else _probe(cfg, mult)
    n = count_flops(build_model(pcfg), input_specs(arch, shape_name, pcfg), production_layout(multi_pod=multi_pod))
    return n, time.perf_counter() - t0


def _cached(out_path: Path, *, force: bool):
    """The cell's record if it stands: not forced and not an error (errors
    are retried after fixes)."""
    if force or not out_path.exists():
        return None
    cached = json.loads(out_path.read_text())
    return cached if cached.get("status") in ("ok", "skip") else None


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
            counts = {m: n for m, (n, _) in counts.items()}
        counted = cell_flops(cfg, cell, layout, counts)
        mf = model_flops(cfg, cell.shape)
        rec.update(status="ok", counted_flops=counted, model_flops=mf, useful_flops_ratio=mf / counted,
                   seconds=time.perf_counter() - t0 + seconds)
    except Exception as e:  # noqa: BLE001 — a failed cell is a recorded result
        _failed(rec, e, time.perf_counter() - t0 + seconds)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def _line(r: dict) -> str:
    if r["status"] == "ok":
        extra = (f" state {r['bytes']['total'] / 1e9:.1f} GB counted {r['counted_flops']:.4e} model "
                 f"{r['model_flops']:.4e} ratio {r['useful_flops_ratio']:.4f} ({r['seconds']:.1f} s)")
    else:
        extra = f" ({r.get('reason', r.get('error', ''))[:60]})"
    return f"{r['arch']:>22} × {r['shape']:<12} [{r['mesh']}] → {r['status']}{extra}"


def sweep(*, multi_pod: bool = False, force: bool = False, out_dir: Path | None = None, log=print) -> list:
    """Every cell of every arch, in the registry's order; one line each.
    The probes of the cells not read back are counted first, in
    ``WORKERS`` processes, the scans' first (a recurrent or rwkv step is a
    Python loop a token, and on meta each elementwise op costs ~0.2 ms of
    the host); a cell whose probe raised is recorded as an error there."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.configs.registry import ARCHS, shape_suite

    out_dir = Path(out_dir or ARTIFACTS)
    cells = [(arch, shape_name) for arch in ARCHS for shape_name in shape_suite(arch)]
    todo = [(arch, shape_name, get_config(arch)) for arch, shape_name in cells
            if not isinstance(shape_suite(arch)[shape_name], str)
            and _cached(out_dir / f"{_name(arch, shape_name, multi_pod)}.json", force=force) is None]
    units = [(arch, shape_name, cfg, m) for arch, shape_name, cfg in todo for m in _probes(cfg)]
    units.sort(key=lambda u: (-("recurrent" in u[2].pattern), -("rwkv" in u[2].pattern),
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
