"""Roofline analysis — the port of ``repro.launch.roofline``.

Reads ``results/dryrun_torch/*.json`` (the port's dry run: collective
bytes a rank from its record of the traced step, the rank's memory) and
the analytic FLOP/byte model (``launch/costs.py``), and emits the
three-term roofline per (arch x shape x mesh), on the H100 SXM's
data-sheet peaks of ``launch/costs.py``:

  compute    = FLOPs / (cards * PEAK_FLOPS)
  memory     = HBM bytes / (cards * HBM_BW)
  collective = collective bytes a card / ICI_BW (NVLink, one direction)

Dominant term = the bottleneck; roofline fraction = the model FLOPs' time
at peak over the dominant term's time (the fraction of step time doing
useful math under ideal overlap).

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline
       [--dir results/dryrun_torch] [--markdown results/roofline_torch.md]
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import List, Optional

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch.costs import (HBM_BW, ICI_BW, PEAK_FLOPS, cache_bytes,
                                      step_costs)


def load_records(dirname: str, tag: str = "") -> List[dict]:
    recs = []
    for fn in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(fn) as f:
            r = json.load(f)
        if (r.get("tag") or "") != tag:
            continue
        recs.append(r)
    return recs


def analyze(rec: dict) -> Optional[dict]:
    if rec.get("status") != "ok":
        return None
    cfg = get_config(rec["arch"])
    if rec.get("cache_dtype"):
        cfg = dataclasses.replace(cfg, cache_dtype=rec["cache_dtype"])
    if rec.get("expert_dtype"):
        cfg = dataclasses.replace(cfg, expert_dtype=rec["expert_dtype"])
    shape = SHAPES[rec["shape"]]
    n = rec["devices"]
    costs = step_costs(cfg, shape, remat=rec.get("remat", "full"),
                       multi_pod=rec["multi_pod"])
    t_comp = costs.flops_total / (n * PEAK_FLOPS)
    t_mem = costs.hbm_bytes / (n * HBM_BW)
    coll_dev = rec["collectives"]["total"]          # per-device bytes
    t_coll = coll_dev / ICI_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    # the score: time the MODEL_FLOPS would take at peak, over the step's
    # dominant-term time (MFU under ideal compute/comm overlap)
    t_model = costs.model_flops / (n * PEAK_FLOPS)
    frac = t_model / max(terms.values()) if max(terms.values()) > 0 else 0.0
    util = costs.model_flops / costs.flops_total if costs.flops_total else 0
    return {
        **rec,
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "dominant": dominant, "roofline_frac": frac,
        "model_flops": costs.model_flops, "hlo_flops": costs.flops_total,
        "useful_ratio": util,
        "tokens": costs.tokens,
        "hbm_bytes": costs.hbm_bytes,
        "collective_bytes_dev": coll_dev,
    }


_FIX = {"compute": "more useful FLOPs/chip (less remat, fuse recompute)",
        "memory": "cut HBM traffic (fp8 streams, fewer passes, larger "
                  "arithmetic intensity per pass)",
        "collective": "cut wire bytes (dedup routing, compressed "
                      "collectives, overlap with compute)"}


def _mesh(r: dict) -> str:
    """The record's mesh label (the dry run writes it)."""
    return r.get("mesh") or ("2x16x16" if r["multi_pod"] else "16x16")


def to_markdown(rows: List[dict]) -> str:
    out = ["| arch | shape | mesh | t_comp (s) | t_mem (s) | t_coll (s) | "
           "dominant | roofline frac | MODEL/HLO FLOPs | next lever |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r is None:
            continue
        if r.get("status") == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | "
                       f"{_mesh(r)} | — | — "
                       f"| — | skipped | — | — | {r['reason']} |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {_mesh(r)} "
            f"| {r['t_compute_s']:.3f} | {r['t_memory_s']:.3f} "
            f"| {r['t_collective_s']:.3f} | **{r['dominant']}** "
            f"| {r['roofline_frac']:.2f} | {r['useful_ratio']:.2f} "
            f"| {_FIX[r['dominant']]} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--markdown", default="results/roofline_torch.md")
    args = ap.parse_args(argv)
    rows = []
    for rec in load_records(args.dir, args.tag):
        if rec.get("status") == "skipped":
            rows.append(rec)
            continue
        rows.append(analyze(rec))
    md = to_markdown(rows)
    print(md)
    if args.markdown:
        os.makedirs(os.path.dirname(args.markdown), exist_ok=True)
        with open(args.markdown, "w") as f:
            f.write(md + "\n")
    # summary: worst fraction, most collective-bound
    ok = [r for r in rows if r and r.get("status") == "ok"]
    if ok:
        worst = min(ok, key=lambda r: r["roofline_frac"])
        coll = max(ok, key=lambda r: r["t_collective_s"])
        print(f"\nworst roofline frac: {worst['arch']} x {worst['shape']} "
              f"({worst['roofline_frac']:.2f}, {worst['dominant']}-bound)")
        print(f"most collective-bound: {coll['arch']} x {coll['shape']} "
              f"(t_coll {coll['t_collective_s']:.3f}s)")


if __name__ == "__main__":
    main()
