"""Render the dry run's records into roofline tables (counterpart of
``repro.roofline.report``, reading ``artifacts/dryrun_torch``, which
``launch.dryrun`` writes).

Given the same records it prints the reference's text, character for
character: one row a cell with its three terms, the dominant one, the
peak bytes a device, the useful-FLOP ratio and a note on what would move
the dominant term down.

Usage:
  python -m repro_torch.roofline.report [pod1|pod2]
"""
from __future__ import annotations

import json
from pathlib import Path

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

__all__ = ["ARTIFACTS", "load", "roofline_fraction", "roofline_table", "summary"]


def load(mesh_tag: str = "pod1", tag: str = "", root=None):
    """The records of ``root`` (default :data:`ARTIFACTS`) for a mesh and tag."""
    recs = []
    for p in sorted(Path(root or ARTIFACTS).glob(f"*__{mesh_tag}{tag}.json")):
        r = json.loads(p.read_text())
        if r.get("tag", "") == tag:
            recs.append(r)
    return recs


def _fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    return f"{x*1e3:.1f}ms"


def roofline_table(mesh_tag: str = "pod1", tag: str = "", root=None) -> str:
    rows = [
        "| arch | shape | step | t_comp | t_mem | t_coll | bound | HBM/chip | useful_F | note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in load(mesh_tag, tag, root):
        if r["status"] == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | skip | - | - | - | - | - | - | {r['reason'][:60]} |")
            continue
        if r["status"] == "error":
            rows.append(f"| {r['arch']} | {r['shape']} | ERR | - | - | - | - | - | - | {r['error'][:60]} |")
            continue
        t = r["roofline"]
        mem_gb = r["memory"]["peak_bytes_per_device"] / 1e9
        uf = r.get("useful_flops_ratio")
        note = _note(r)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['step']} | {_fmt_s(t['t_compute'])} | "
            f"{_fmt_s(t['t_memory'])} | {_fmt_s(t['t_collective'])} | **{t['dominant'][:4]}** | "
            f"{mem_gb:.1f}GB | {uf:.2f} | {note} |"
        )
    return "\n".join(rows)


def _note(r) -> str:
    """One sentence: what would move the dominant term down."""
    t = r["roofline"]
    dom = t["dominant"]
    frac = roofline_fraction(r)
    if dom == "memory":
        return f"cf={frac:.2f}; cut bytes: fused/banded attention, bf16 CE, less remat"
    if dom == "collective":
        cb = t["coll_breakdown"]
        worst = max(cb, key=cb.get)
        return f"cf={frac:.2f}; dominant coll={worst}: reshard/overlap or shrink TP"
    return f"cf={frac:.2f}; near compute roofline"


def roofline_fraction(r) -> float:
    """compute-term / bound-time: 1.0 == compute-roofline-limited."""
    t = r["roofline"]
    bound = max(t["t_compute"], t["t_memory"], t["t_collective"])
    return t["t_compute"] / bound if bound else 0.0


def summary(mesh_tag: str = "pod1", root=None):
    recs = [r for r in load(mesh_tag, root=root) if r["status"] == "ok"]
    recs.sort(key=roofline_fraction)
    out = []
    for r in recs:
        t = r["roofline"]
        out.append(
            (r["arch"], r["shape"], r["step"], t["dominant"],
             round(roofline_fraction(r), 3),
             round(r["memory"]["peak_bytes_per_device"] / 1e9, 1))
        )
    return out


def main(argv=None) -> None:
    import sys

    argv = sys.argv[1:] if argv is None else argv
    tag = argv[0] if argv else "pod1"
    print(roofline_table(tag))
    print()
    for row in summary(tag):
        print(row)


if __name__ == "__main__":
    main()
