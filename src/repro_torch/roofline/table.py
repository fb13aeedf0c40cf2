"""The dry run's table from its records (counterpart of
``repro/roofline/table.py``): one row per counted record, then the
skipped and the failed pairs.

  PYTHONPATH=src python -m repro_torch.roofline.table \\
      [--dir results/dryrun_torch]

Every time in it is a prediction, counted FLOPs and bytes over the card's
datasheet peaks (``repro_torch/hardware.py``), not a measurement. The
terms are priced anew from each record's counts (``analysis.py``
``roofline_terms``), so a record written before a change of pricing
reads as a new one would.

A table a shape of ``launch/sweep.py`` ``MODEL_AXIS_SHAPES`` reads its
records on the model axis (``dryrun --model-parallel K``): per arch and
mesh, the peak a GPU at one GPU a node, at the reference's K (or its
refusal, where the port splits heads whole and K does not divide them)
and at the smallest K that fits; an arch that waits for its ROADMAP.md
item says which.
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
            rows.append(priced(json.load(f)))
    return rows


def priced(r: dict) -> dict:
    """A counted record with its roofline terms priced from its counts
    by ``analysis.py`` ``roofline_terms``; any other record as it is."""
    if "flops_per_dev" not in r:
        return r
    from repro_torch.configs import get_config
    from repro_torch.roofline.analysis import model_group_bytes, \
        roofline_terms
    return {**r, **roofline_terms(
        r["flops_per_dev"], r["bytes_analytic_per_dev"],
        r["coll_bytes_per_dev"], get_config(r["arch"]).dtype,
        r["n_devices"], model_group_bytes(r), r.get("model_parallel", 1))}


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


TERM = {"compute": "cmp", "memory": "mem", "collective": "coll"}


def term(r) -> str:
    """' cmp', ' mem' or ' coll': the record's largest term ('' if none)."""
    return f" {TERM[r['bottleneck']]}" if r and "bottleneck" in r else ""


def run_flags(r) -> str:
    """The training record's flags beyond the sweep's blocking exact
    gather run ('' for it): its mode, transport and codec."""
    return " ".join(f for f, on in (
        ("--nonblocking", r.get("nonblocking") and not r.get("overlap")),
        ("--overlap", r.get("overlap")),
        (f"--gossip-impl {r.get('gossip')}",
         r.get("gossip", "gather") != "gather"),
        ("--quantize", r.get("quantize"))) if on)


def model_axis_table(rows, shape: str = "train_4k") -> str:
    """The `shape` rows on the model axis, a line per (arch, mesh, run
    flags): each peak in GiB a GPU beside the record's largest term."""
    from repro_torch.configs import get_config
    from repro_torch.launch.sweep import model_axis_ks
    from repro_torch.models.split import NOT_ON_THE_MODEL_AXIS
    ok = [r for r in rows if "error" not in r and "skipped" not in r
          and r.get("shape") == shape]
    by = {}
    for r in ok:
        base = r["mesh"].split("_tp")[0]
        if run_flags(r):
            base += f" ({run_flags(r)})"
        by.setdefault((r["arch"], base), {})[r.get("model_parallel", 1)] = r
    lines = ["| arch | mesh | 1 GPU a node: peak GiB | reference's K: "
             "fits (peak GiB) | smallest K that fits: peak GiB | kv heads "
             "whole at that K |", "|---|---|---|---|---|---|"]
    for (arch, mesh), recs in sorted(by.items()):
        one = recs.get(1)
        ks = model_axis_ks(arch)
        if ks is None:
            cfg = get_config(arch)
            why = "big_model" if cfg.big_model else "ssm"
            item = NOT_ON_THE_MODEL_AXIS[why].split("ROADMAP.md ")[-1]
            lines.append(f"| {arch} | {mesh} | "
                         f"{fmt_bytes(one and one['peak_bytes'])}{term(one)}"
                         f" | waits ({item}) | - | - |")
            continue
        k_ref = ks[0]
        ref = recs.get(k_ref)
        fit = next((recs[k] for k in sorted(recs) if k > 1 and
                    recs[k]["fits"]), None)
        at_ref = f"{fmt_fits(ref)}{term(ref)}" if ref else \
            "-" if k_ref in ks[1] else "refused (whole heads, Queue A 16)"
        lines.append(
            f"| {arch} | {mesh} | {fmt_bytes(one and one['peak_bytes'])}"
            f"{term(one)} | K {k_ref}: {at_ref} | " +
            (f"K {fit['model_parallel']}: {fmt_bytes(fit['peak_bytes'])}"
             f"{term(fit)}"
             if fit else "none of " + ", ".join(map(str, ks[1]))) + " | " +
            ("yes" if (fit or {}).get("kv_heads_whole") else "no") + " |")
    return "\n".join(lines)


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
    from repro_torch.launch.sweep import MODEL_AXIS_SHAPES
    rows = load(args.dir)
    for shape in MODEL_AXIS_SHAPES:
        print(f"\nOn the model axis ({shape}):\n" +
              model_axis_table(rows, shape))


if __name__ == "__main__":
    main()
