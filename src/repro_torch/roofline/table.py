"""The dry run's table from its records (counterpart of
``repro/roofline/table.py``): one row per counted record, then the
skipped and the failed pairs.

  PYTHONPATH=src python -m repro_torch.roofline.table \\
      [--dir results/dryrun_torch]

Every time in it is a prediction, counted FLOPs and bytes over the card's
datasheet peaks (``repro_torch/hardware.py``), not a measurement.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(dirname: str) -> list:
    rows = []
    for p in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(p) as f:
            rows.append(json.load(f))
    return rows


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    return f"{b / 2**30:.2f}"


def fmt_s(x) -> str:
    if x is None:
        return "-"
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.1f}µs"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def fmt_fits(r) -> str:
    """'yes' or 'no', with the peak in GiB."""
    return f"{'yes' if r['fits'] else 'no'} ({fmt_bytes(r['peak_bytes'])})"


def cause(err: str) -> str:
    """An error record's cause: the last line of its traceback."""
    lines = err.strip().splitlines()
    return lines[-1][:200] if lines else ""


def build_tables(rows):
    """-> (markdown table of the counted records, skipped lines, failed
    lines, the counted records)."""
    ok = [r for r in rows if "error" not in r and "skipped" not in r]
    skipped = [r for r in rows if "skipped" in r]
    failed = [r for r in rows if "error" in r]
    lines = ["| arch | shape | mesh | compute | memory | collective | "
             "bottleneck | model/counted flops | args GiB | trace s | "
             "fits 1 GPU (peak GiB) |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(ok, key=lambda x: (x["arch"], x["shape"], x["mesh"])):
        ur = r.get("useful_ratio")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} | "
            f"{fmt_s(r['collective_s'])} | **{r['bottleneck']}** | "
            f"{'-' if ur is None else f'{ur:.2f}'} | "
            f"{fmt_bytes(r['argument_bytes'])} | {r['t_trace_s']} | "
            f"{fmt_fits(r)} |")
    table = "\n".join(lines)
    sk = "\n".join(f"* {r['arch']} × {r['shape']} ({r.get('mesh', 'both')})"
                   f": {r['skipped']}" for r in skipped)
    fl = "\n".join(f"* {r['arch']} × {r['shape']} × {r.get('mesh')}: "
                   f"`{cause(r['error'])}`" for r in failed)
    return table, sk, fl, ok


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.roofline.table")
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    table, sk, fl, ok = build_tables(load(args.dir))
    print(table)
    if sk:
        print("\nSkipped (documented):\n" + sk)
    if fl:
        print("\nFAILED:\n" + fl)
    print(f"\n{len(ok)} combinations traced OK.")


if __name__ == "__main__":
    main()
