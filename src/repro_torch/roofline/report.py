"""Roofline report — render JSON records into the §Roofline table (a copy
of :mod:`repro.roofline.report`)."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

__all__ = ["load_results", "format_table", "one_liner"]


def load_results(artifact_dir: str) -> List[Dict]:
    out = []
    if not os.path.isdir(artifact_dir):
        return out
    for f in sorted(os.listdir(artifact_dir)):
        if f.endswith(".json"):
            with open(os.path.join(artifact_dir, f)) as fh:
                out.append(json.load(fh))
    return out


def _fmt_s(x: Optional[float]) -> str:
    return "-" if x is None else f"{x:.3e}"


def _fmt_pct(x: Optional[float]) -> str:
    return "-" if x is None else f"{100 * x:.1f}%"


def format_table(results: List[Dict]) -> str:
    hdr = (f"| {'arch':24s} | {'shape':11s} | {'compute_s':9s} | "
           f"{'memory_s':9s} | {'collect_s':9s} | {'bound':10s} | "
           f"{'useful':7s} | {'MFU@roof':8s} |")
    sep = "|" + "-" * (len(hdr) - 2) + "|"
    rows = [hdr, sep]
    for r in results:
        t = r.get("roofline", {})
        rows.append(
            f"| {r['arch']:24s} | {r['shape']:11s} | "
            f"{_fmt_s(t.get('compute_s')):9s} | "
            f"{_fmt_s(t.get('memory_s')):9s} | "
            f"{_fmt_s(t.get('collective_s')):9s} | "
            f"{t.get('dominant', '-'):10s} | "
            f"{_fmt_pct(t.get('useful_fraction')):7s} | "
            f"{_fmt_pct(t.get('mfu_at_roofline')):8s} |")
    return "\n".join(rows)


def one_liner(r: Dict) -> str:
    t = r.get("roofline", {})
    dom = t.get("dominant", "?")
    hints = {
        "compute": "reduce recompute/padding or shift flops to bf16",
        "memory": "fuse more, cut activation width, or raise arithmetic "
                  "intensity (bigger microbatch per sweep)",
        "collective": "reshard to shrink the gathered dim, overlap with "
                      "compute, or move the reduction off the critical path",
    }
    return (f"{r['arch']} × {r['shape']}: {dom}-bound "
            f"(bound {_fmt_s(max(t.get('compute_s', 0), t.get('memory_s', 0), t.get('collective_s', 0)))}s) — "
            f"{hints.get(dom, '')}")
