"""Render the dry run's tables from experiments/dryrun/*.json.

Counterpart of ``src/repro/roofline/report.py``: the same columns, the
same formats.  The default layout of ``roofline_table`` is the port's
production one, "32x8" (the reference's is "16x16"); ``compile`` is the
seconds the costing took (the reference's, XLA's compile)."""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List


def load_results(directory: str) -> List[Dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def dryrun_table(results: List[Dict], mesh: str = None) -> str:
    lines = ["| arch | shape | mesh | status | compile | mem/dev | "
             "GFLOP/chip | GB/chip | collectives |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in results:
        if mesh and r["mesh"] != mesh:
            continue
        if r["skipped"]:
            reason = r["reason"][:60]
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"SKIP | — | — | — | — | {reason} |")
            continue
        if not r["ok"]:
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"FAIL | — | — | — | — | — |")
            continue
        c = r["collectives"]["counts"]
        cstr = " ".join(f"{k.replace('all-', 'a').replace('reduce-', 'r')}"
                        f"×{v}" for k, v in sorted(c.items()))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | OK | "
            f"{r['compile_s']:.0f}s | "
            f"{r['memory'].get('total_per_device_gb', 0):.2f}GB | "
            f"{r['cost'].get('flops', 0) / 1e9:.1f} | "
            f"{r['cost'].get('bytes accessed', 0) / 2**30:.1f} | {cstr} |")
    return "\n".join(lines)


def roofline_table(results: List[Dict], mesh: str = "32x8") -> str:
    lines = ["| arch | shape | compute | memory | collective | bottleneck "
             "| MODEL/HLO flops | roofline-bound MFU |",
             "|---|---|---|---|---|---|---|---|"]
    for r in results:
        if r["mesh"] != mesh or not r.get("ok") or r.get("skipped"):
            continue
        rl = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(rl['compute_s'])} | "
            f"{_fmt_s(rl['memory_s'])} | {_fmt_s(rl['collective_s'])} | "
            f"**{rl['bottleneck']}** | {rl['useful_flops_frac']:.2f} | "
            f"{min(rl['mfu_bound'], 1.0):.3f} |")
    return "\n".join(lines)


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--table", default="dryrun",
                    choices=["dryrun", "roofline"])
    args = ap.parse_args()
    rs = load_results(args.dir)
    if args.table == "dryrun":
        print(dryrun_table(rs, args.mesh))
    else:
        print(roofline_table(rs, args.mesh or "32x8"))


if __name__ == "__main__":
    main()
