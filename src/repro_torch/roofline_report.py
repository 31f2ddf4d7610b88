"""Render the dry run's tables from ``results/dryrun_torch.jsonl``.

The port of ``benchmarks/roofline_report.py``: the dry-run table (per
device: traced seconds, HBM used, whether it fits the H100's 80 GB, GFLOPs,
collective GB) and the single-pod roofline table, from the records that
``python -m repro_torch.launch.dryrun`` appends.

    PYTHONPATH=src python -m repro_torch.roofline_report [--results DIR]
"""
from __future__ import annotations

import json
import os

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "results")
FILE = "dryrun_torch.jsonl"


def load(path) -> dict:
    """The records of a dry-run file by (arch, shape, mesh, tag), the last
    of each."""
    rows = {}
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            rows[(r["arch"], r["shape"], r["mesh"], r.get("tag", ""))] = r
    return rows


def fmt_bytes(b) -> str:
    return f"{b / 2**30:.2f}"


def dryrun_table(rows) -> str:
    out = ["| arch | shape | mesh | traced s | HBM used GiB | fits 80GB | "
           "per-dev GFLOPs | collective GB |",
           "|---|---|---|---|---|---|---|---|"]
    for (arch, shape, mesh, tag), r in sorted(rows.items()):
        if tag:
            continue
        pd = r["per_device"]
        out.append(
            f"| {arch} | {shape} | {mesh} | {r['lower_s']:.1f} | "
            f"{fmt_bytes(pd['hbm_used_bytes'])} | "
            f"{'yes' if pd['fits_80GB'] else 'NO*'} | "
            f"{pd['flops'] / 1e9:.1f} | {pd['ici_bytes'] / 1e9:.2f} |")
    return "\n".join(out)


def roofline_tbl(rows) -> str:
    out = ["| arch | shape | t_compute s | t_memory s | t_collective s | "
           "bound | useful (6ND/counted) | roofline frac |",
           "|---|---|---|---|---|---|---|---|"]
    for (arch, shape, mesh, tag), r in sorted(rows.items()):
        if mesh != "16x16" or tag:
            continue
        rl = r["roofline"]
        out.append(
            f"| {arch} | {shape} | {rl['t_compute_s']:.4g} | "
            f"{rl['t_memory_s']:.4g} | {rl['t_collective_s']:.4g} | "
            f"{rl['bound']} | {rl['useful_ratio']:.2f} | "
            f"{rl['roofline_fraction']:.4f} |")
    return "\n".join(out)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", default=RESULTS,
                    help=f"results directory holding {FILE}")
    args = ap.parse_args(argv)
    rows = load(os.path.join(args.results, FILE))
    print("## Dry-run table\n")
    print(dryrun_table(rows))
    print("\n## Roofline (single pod 16x16)\n")
    print(roofline_tbl(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
