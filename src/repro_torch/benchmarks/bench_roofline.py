"""Roofline table from the dry run's records (one row per arch x shape x
mesh): the port of the JAX package's ``benchmarks/bench_roofline.py``.

Reads ``$DRYRUN_DIR/*.json`` (default ``results/dryrun``) written by
``repro_torch.launch.dryrun``, adds MODEL_FLOPS = 6 N D per chip for
training and 2 N D for serving (N the active parameters for moe,
``models.model.active_param_count``) and the ratio MODEL_FLOPS / counted
flops (remat and attention show as a ratio below 1), and reports the
dominant roofline term.  ``us_per_call`` is the projected step time, the
largest of the three terms, on the H100's constants.  Every record
counts rank 0's step, the collectives inside its replica among them.
"""
from __future__ import annotations

import functools
import glob
import json
import os

from ..launch.steps import SHAPES
from .common import emit

__all__ = ["RESULTS", "active_params", "model_flops_per_chip", "run"]

RESULTS = os.environ.get("DRYRUN_DIR", "results/dryrun")


@functools.lru_cache(maxsize=None)
def active_params(arch: str) -> int:
    """Parameters a token meets: ``active_param_count`` of the arch's
    model on the meta device (top_k / n_experts of the expert weights)."""
    from .. import configs
    from ..models import model as M

    cfg = configs.get_config(arch)
    return M.active_param_count(M.init(cfg, device="meta"), cfg)


def model_flops_per_chip(rec: dict) -> float:
    info = SHAPES[rec["shape"]]
    tokens = info["global_batch"] * (1 if info["kind"] == "decode"
                                     else info["seq"])
    n_chips = 512 if rec["multi_pod"] else 256
    factor = 6.0 if rec["kind"] == "train" else 2.0
    return factor * active_params(rec["arch"]) * tokens / n_chips


def run(pattern: str = "*.json") -> None:
    results = os.environ.get("DRYRUN_DIR", RESULTS)
    files = sorted(glob.glob(os.path.join(results, pattern)))
    if not files:
        emit("roofline_missing", 0.0, f"no dryrun artifacts under {results}")
        return
    for path in files:
        with open(path) as f:
            rec = json.load(f)
        if not rec.get("ok"):
            continue
        r = rec["roofline"]
        mf = model_flops_per_chip(rec)
        ratio = mf / max(rec["cost"]["flops"], 1.0)
        bound_us = 1e6 * max(r["compute_s"], r["memory_s"], r["collective_s"])
        tag = "2pod" if rec["multi_pod"] else "1pod"
        emit(f"roofline_{rec['arch']}_{rec['shape']}_{tag}", bound_us,
             f"compute_ms={1e3 * r['compute_s']:.2f};"
             f"memory_ms={1e3 * r['memory_s']:.2f};"
             f"collective_ms={1e3 * r['collective_s']:.2f};"
             f"dominant={r['dominant']};"
             f"useful_flops_ratio={ratio:.3f};"
             f"temp_GB={rec['memory_analysis']['temp_bytes'] / 1e9:.2f}")
