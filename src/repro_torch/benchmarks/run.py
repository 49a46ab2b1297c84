"""Benchmark harness: one module per table or figure of the paper, and
the kernels.

Prints ``name,us_per_call,derived`` CSV, as the JAX package's
``benchmarks/run.py``:

  spectral_gap  Fig. 3 / Table 5  (Proposition 1)         host math
  consensus     Fig. 4 / 10 / 11  (Lemma 1, Remarks 4-5)  host math
  transient     Fig. 1 / Fig. 13  (transient iterations)  DmSGD on --device
  hetero        eq. 3 / 4         (b^2 vs topology; stragglers)  --device
  comm          Table 1 / 7 / 8   (per-iteration communication; the flat
                                   engine against per-leaf)  --device
  kernels       each hand-written kernel against its plain version
                                                          --device
  roofline      the dry run's records (``$DRYRUN_DIR``, written by
                ``python -m repro_torch.launch.dryrun``): per-chip
                roofline terms on the H100's constants    host

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--only a,b] \\
      [--device cuda|cpu]

Every suite of the reference is ported: ``LATER`` (suites that raise,
naming their ROADMAP item) is empty.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from ..device import resolve_device
from . import bench_comm, bench_consensus, bench_hetero, bench_kernels
from . import bench_roofline, bench_spectral_gap, bench_transient

__all__ = ["SUITES", "LATER", "run_suites", "main"]

SUITES = {
    "spectral_gap": lambda device: bench_spectral_gap.run(),
    "consensus": lambda device: bench_consensus.run(),
    "transient": lambda device: bench_transient.run(device=device),
    "hetero": lambda device: bench_hetero.run(device=device),
    "comm": lambda device: bench_comm.run(device=device),
    "kernels": lambda device: bench_kernels.run(device),
    "roofline": lambda device: bench_roofline.run(),
}
LATER: dict[str, str] = {}


def run_suites(names, device="cuda") -> tuple[dict, list]:
    """Run the named suites on ``device``; returns the seconds each took
    and the names of those that raised (their tracebacks printed)."""
    for name in names:
        if name in LATER:
            raise NotImplementedError(
                f"benchmark suite {name!r} waits for ROADMAP {LATER[name]} "
                "of the PyTorch port")
        if name not in SUITES:
            raise KeyError(f"unknown suite {name!r}; options: "
                           f"{sorted(SUITES)}")
    dev = resolve_device(device)
    seconds, failed = {}, []
    for name in names:
        t0 = time.perf_counter()
        try:
            SUITES[name](dev)
        except Exception:  # noqa: BLE001
            failed.append(name)
            traceback.print_exc()
        seconds[name] = time.perf_counter() - t0
    return seconds, failed


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated suite names")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    names = args.only.split(",") if args.only else list(SUITES)
    print("name,us_per_call,derived")
    _, failed = run_suites(names, args.device)
    if failed:
        sys.exit(f"benchmark suites failed: {failed}")


if __name__ == "__main__":
    main()
