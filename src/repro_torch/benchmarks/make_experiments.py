"""The dry run's two markdown tables from its records: the compile
matrix (here the count matrix) with memory per chip, and the roofline
terms.  The port of the JAX package's ``benchmarks/make_experiments.py``;
it prints markdown to stdout.

  PYTHONPATH=src python -m repro_torch.benchmarks.make_experiments \\
      [all|dryrun|roofline]

Records under ``$DRYRUN_DIR`` (default ``results/dryrun``); knob and
topology variants are left out, as in the reference.
"""
from __future__ import annotations

import glob
import json
import os
import sys

from ..launch.steps import SHAPES
from .bench_roofline import model_flops_per_chip

__all__ = ["ARCHS", "load", "dryrun_section", "roofline_section", "main"]

ARCHS = ["mamba2-1.3b", "granite-34b", "musicgen-large", "gemma2-27b",
         "llama-3.2-vision-90b", "zamba2-1.2b", "qwen3-0.6b",
         "granite-moe-3b-a800m", "deepseek-67b", "dbrx-132b"]


def load(pattern: str = "dryrun_*.json") -> dict:
    results = os.environ.get("DRYRUN_DIR", "results/dryrun")
    recs = {}
    for path in sorted(glob.glob(os.path.join(results, pattern))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("knobs") or rec.get("topology") != "one_peer_exp":
            continue
        recs[(rec["arch"], rec["shape"], rec["multi_pod"])] = rec
    return recs


def _rows(recs):
    for arch in ARCHS:
        for shape in SHAPES:
            for mp in (False, True):
                r = recs.get((arch, shape, mp))
                if r:
                    yield arch, shape, mp, r


def dryrun_section(recs) -> str:
    out = ["### Count matrix (baseline: one-peer exp, DmSGD, per-arch "
           "layouts; per chip, rank 0)", "",
           "| arch | shape | mesh | nodesxfsdpxmodel | count s | "
           "temp GB/chip | args GB/chip | collectives (counts) |",
           "|---|---|---|---|---|---|---|---|"]
    for arch, shape, mp, r in _rows(recs):
        mem = r["memory_analysis"]
        cc = r["cost"]["collective_counts"]
        cstr = " ".join(f"{k.replace('collective-', '')}:{int(v)}"
                        for k, v in sorted(cc.items()))
        out.append(
            f"| {arch} | {shape} | {'2pod' if mp else '1pod'} "
            f"| {r['nodes']}x{r['fsdp']}x{r['model_axis']} "
            f"| {r['count_s']} "
            f"| {mem['temp_bytes'] / 1e9:.2f} "
            f"| {mem['argument_bytes'] / 1e9:.2f} "
            f"| {cstr} |")
    return "\n".join(out)


def roofline_section(recs) -> str:
    out = ["| arch | shape | mesh | compute ms | memory ms | collective ms |"
           " dominant | MODEL_FLOPS/counted FLOPs |",
           "|---|---|---|---|---|---|---|---|"]
    for arch, shape, mp, r in _rows(recs):
        rf = r["roofline"]
        ratio = model_flops_per_chip(r) / max(r["cost"]["flops"], 1.0)
        out.append(
            f"| {arch} | {shape} | {'2pod' if mp else '1pod'} "
            f"| {1e3 * rf['compute_s']:.2f} "
            f"| {1e3 * rf['memory_s']:.2f} "
            f"| {1e3 * rf['collective_s']:.2f} "
            f"| **{rf['dominant']}** | {ratio:.3f} |")
    return "\n".join(out)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    recs = load()
    which = argv[0] if argv else "all"
    if which in ("all", "dryrun"):
        print(dryrun_section(recs))
        print()
    if which in ("all", "roofline"):
        print(roofline_section(recs))


if __name__ == "__main__":
    main()
