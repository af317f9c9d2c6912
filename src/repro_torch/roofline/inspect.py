"""The dry run's inspector (counterpart of ``repro.roofline.inspect``):
what a cell's roofline terms are made of, from one counted pass of its
step on the meta device (``launch.dryrun.count_cell``), where the
reference reads a compiled XLA program.

  * the memory line — a device's argument, result and temporary bytes, in
    the reference's ``buffer_report`` format;
  * the cost line — a device's FLOPs and bytes accessed (the whole step's
    over the layout's chips, as the reference's per-partition
    ``cost_analysis``);
  * the top collectives by bytes aggregated over identical shapes, read
    from the collective layer's call recorder — what to reshard;
  * the most duplicated op signatures (aten op, operand shapes and
    dtypes) — the recompute that remat adds, where the reference counts
    duplicated fusions.

It sets no ``XLA_FLAGS`` and imports no JAX.

Usage:
  PYTHONPATH=src python -m repro_torch.roofline.inspect --arch qwen2-7b --shape train_4k [--multi-pod] [--probe]
      [--set k=v]
"""
from __future__ import annotations

import argparse
import ast
import collections
import dataclasses

from repro_torch.roofline.analysis import collective_inventory

__all__ = ["buffer_report", "duplicated_signatures", "main", "top_collectives"]


def top_collectives(calls, k: int = 12, level_sizes=None):
    """``[((kind, shape), bytes)]``: a call recorder's calls (``{Call:
    n}``) by HLO kind and one device's result shape, bytes summed over
    identical shapes, the ``k`` largest first (the reference's reading
    of the HLO text, on the recorder)."""
    agg = collections.Counter()
    for kind, shape, nbytes, _n in collective_inventory(calls, level_sizes):
        agg[(kind, "[" + ",".join(str(d) for d in shape) + "]")] += nbytes
    return agg.most_common(k)


def buffer_report(memory) -> str:
    """The reference's memory line from a record's ``memory`` (or any
    mapping with ``argument_bytes``, ``output_bytes``, ``temp_bytes``)."""
    try:
        return (
            f"args={memory['argument_bytes']/1e9:.2f}GB "
            f"out={memory['output_bytes']/1e9:.2f}GB "
            f"temp={memory['temp_bytes']/1e9:.2f}GB"
        )
    except Exception as e:  # noqa: BLE001
        return str(e)


def duplicated_signatures(signatures, k: int = 6):
    """``[(count, signature)]`` of the op signatures that ran more than
    twice, most first."""
    rows = [(c, f"{op}(" + ", ".join(f"{dt}[{','.join(map(str, shape))}]" for shape, dt in operands) + ")")
            for (op, operands), c in signatures.items() if c > 2]
    rows.sort(reverse=True)
    return rows[:k]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--probe", action="store_true", help="inspect the one-period probe (per-layer view)")
    ap.add_argument("--set", action="append", default=[],
                    help="config overrides key=value, the value a Python literal (e.g. fsdp=True)")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_config, input_specs
    from repro_torch.launch import dryrun as DR
    from repro_torch.models.api import build_model

    cfg = get_config(args.arch)
    overrides = {}
    for kv in args.set:
        key, v = kv.split("=", 1)
        overrides[key] = ast.literal_eval(v)
    if args.probe:
        overrides.update(num_layers=len(cfg.pattern))
        if cfg.kind == "encdec":
            overrides.update(encoder_layers=1, num_layers=1)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    cell = input_specs(args.arch, args.shape, cfg)
    if cell.skip:
        print(f"== skip: {cell.skip}")
        return
    layout = DR.production_layout(multi_pod=args.multi_pod)
    chips = layout.data * layout.model
    c = DR.count_cell(build_model(cfg), cell, layout, multi_pod=args.multi_pod, signatures=True)
    temp = int(round(c["peak_bytes_per_device"])) - c["argument_bytes"]
    print("== memory:", buffer_report({"argument_bytes": c["argument_bytes"], "output_bytes": c["output_bytes"],
                                       "temp_bytes": temp}))
    print(f"== cost: flops={c['flops'] / chips:.3e} bytes={c['bytes_accessed'] / chips:.3e}")
    print("== top collectives (bytes aggregated over identical shapes):")
    for (kind, shape), b in top_collectives(c["calls"], level_sizes=(layout.data, layout.model)):
        print(f"  {b/1e9:9.3f} GB  {kind:<18} {shape}")
    print("== most-duplicated op signatures (recompute indicator):")
    for n, s in duplicated_signatures(c["signatures"]):
        print(f"  ×{n}  {s[:120]}")


if __name__ == "__main__":
    main()
