"""Render the dry-run artifacts (``launch.dryrun``) into markdown tables."""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List


def load_records(dryrun_dir: str = "experiments/dryrun_torch") -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.1f}us"
    if x < 1.0:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(recs: List[Dict], mesh: str = "pod16x16") -> str:
    """Markdown §Roofline table for one mesh."""
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "model TFLOPs | useful ratio | HBM/chip |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in recs:
        if rec.get("status") != "ok" or rec.get("mesh") != mesh:
            continue
        r = rec["roofline"]
        mem = rec.get("memory", {})
        bpc = mem.get("bytes_per_chip")
        bpc_s = f"{bpc / 2**30:.2f}GiB" if bpc else "n/a"
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | {_fmt_s(r['compute_s'])} | "
            f"{_fmt_s(r['memory_s'])} | {_fmt_s(r['collective_s'])} | "
            f"**{r['dominant']}** | {r['model_flops'] / 1e12:.1f} | "
            f"{r['useful_ratio']:.2f} | {bpc_s} |"
        )
    return "\n".join(lines)


def dryrun_table(recs: List[Dict]) -> str:
    """Markdown §Dry-run table: every combo x mesh with compile status."""
    lines = [
        "| arch | shape | mesh | status | chips | compile (s) | "
        "collective bytes/dev | dominant collective |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for rec in recs:
        status = rec.get("status")
        if status == "ok":
            r = rec["roofline"]
            kinds = r.get("coll_by_kind", {})
            dom_kind = max(kinds, key=kinds.get) if kinds else "-"
            lines.append(
                f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | ok | "
                f"{rec['chips']} | {rec.get('compile_s', 0):.1f} | "
                f"{r['coll_bytes']:.2e} | {dom_kind} |"
            )
        else:
            reason = rec.get("reason", rec.get("error", ""))[:60]
            lines.append(
                f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
                f"{status} | - | - | - | {reason} |"
            )
    return "\n".join(lines)


def summary(recs: List[Dict]) -> Dict[str, int]:
    out = {"ok": 0, "skipped": 0, "error": 0}
    for rec in recs:
        out[rec.get("status", "error")] = out.get(rec.get("status"), 0) + 1
    return out


if __name__ == "__main__":
    recs = load_records()
    print(summary(recs))
    print()
    print(roofline_table(recs))
