"""Perf gate: diff a fresh ``bench_comm --quick`` record against a
committed baseline and fail on a wire-bytes regression.

The port of the JAX package's ``benchmarks/check_comm_regression.py``:
the same failures, the same messages, the same exit codes and the same
JSON schema, so either package's checker reads either package's records.
It reads JSON only, so it runs anywhere.

The structural table is deterministic -- bytes per iteration per
topology read straight off the realization IR and the packed layout -- so
ANY growth is a real change to what the engine puts on the wire.  The
gate fails when any topology's ``bytes_per_iter`` (or 2-axis
``bytes_per_iter_per_shard``, or a runtime row's ``bytes_per_iter``)
exceeds the baseline by more than ``--threshold`` (default 20%), or when
a runtime row gains a collective; improvements and new topologies pass
with a note.

TIMING fields (``us_per_mix`` per topology, the ``overlap`` section's
sync/pipelined ms-per-step pair) are reported, never gated -- except a
NaN or missing timing field, a missing overlap section where the
baseline has one, and the overlap SPEEDUP below
``--min-overlap-speedup`` (default 1.0).

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_comm --quick \\
      --out BENCH_comm.new.json
  PYTHONPATH=src python -m repro_torch.benchmarks.check_comm_regression \\
      --baseline BENCH_comm_h100.json --new BENCH_comm.new.json
"""
from __future__ import annotations

import argparse
import json
import sys

__all__ = ["compare", "report_timings", "main"]


def _index(rows: list[dict], key: str = "topology") -> dict:
    return {r[key]: r for r in rows}


def compare(baseline: dict, new: dict, threshold: float = 0.2) -> list[str]:
    """Returns a list of human-readable regression messages (empty = pass)."""
    fails: list[str] = []

    def check(tag: str, old_rows: list, new_rows: list, field: str):
        old = _index(old_rows)
        for name, row in _index(new_rows).items():
            base = old.get(name)
            if base is None or field not in base:
                print(f"  {tag}/{name}: new row (no baseline), skipping")
                continue
            b, n = base[field], row[field]
            if b > 0 and n > b * (1.0 + threshold):
                fails.append(
                    f"{tag}/{name}: {field} {b} -> {n} "
                    f"(+{100.0 * (n - b) / b:.1f}% > {100 * threshold:.0f}%)")
            elif n < b:
                print(f"  {tag}/{name}: {field} improved {b} -> {n}")

    check("comm", baseline.get("rows", []), new.get("rows", []),
          "bytes_per_iter")
    check("two_axis",
          baseline.get("two_axis", {}).get("rows", []),
          new.get("two_axis", {}).get("rows", []),
          "bytes_per_iter_per_shard")
    # runtime-valued rounds: the piggybacked metadata bytes are structural
    # (4 bytes/col/payload-copy off the IR) -- gated like the payload, and
    # extra collectives for the metadata are a hard zero-tolerance failure
    # (the piggyback's whole point is riding the existing permute)
    check("runtime",
          baseline.get("runtime", {}).get("rows", []),
          new.get("runtime", {}).get("rows", []),
          "bytes_per_iter")
    old_rt = _index(baseline.get("runtime", {}).get("rows", []))
    for name, row in _index(new.get("runtime", {}).get("rows", [])).items():
        base = old_rt.get(name)
        if base and row.get("collectives_per_step", 0) \
                > base.get("collectives_per_step", 0):
            fails.append(
                f"runtime/{name}: collectives_per_step "
                f"{base['collectives_per_step']} -> "
                f"{row['collectives_per_step']} -- metadata must ride the "
                "existing permute, never add collectives")
    return fails


def _num(x) -> bool:
    return isinstance(x, (int, float)) and x == x   # rejects NaN


def report_timings(baseline: dict, new: dict,
                   min_overlap_speedup: float = 1.0) -> list[str]:
    """Print timing deltas (informational) and return the hard failures:
    only a NaN/missing timing field or an overlap speedup below
    ``min_overlap_speedup`` fails -- absolute times never do."""
    fails: list[str] = []
    old = _index(baseline.get("rows", []))
    for name, row in _index(new.get("rows", [])).items():
        t = row.get("us_per_mix")
        if not _num(t):
            fails.append(f"comm/{name}: us_per_mix is {t!r} (want a real "
                         "wall time; the NaN placeholder regressed)")
            continue
        b = (old.get(name) or {}).get("us_per_mix")
        ref = f" (baseline {b:.0f})" if _num(b) else ""
        print(f"  timing comm/{name}: us_per_mix {t:.0f}{ref}")
    het = new.get("hetero", {})
    if het:
        # straggler-simulation section (bench_hetero --quick --merge):
        # stochastic quadratics, REPORT-ONLY -- prints the trade, never gates
        for r in het.get("rows", []):
            print(f"  hetero/{r['mode']}: tail_mse={r['tail_mse']:.4f} "
                  f"sim_time={r['sim_time']:.0f} "
                  f"mse_x_time={r['mse_x_time']:.2f}")
        print(f"  hetero: skip_beats_wait_wallclock="
              f"{het.get('skip_beats_wait_wallclock')}")
    ov, ov0 = new.get("overlap", {}), baseline.get("overlap", {})
    if ov0 and not ov:
        # the baseline records the pipelined-vs-sync pair; a fresh run
        # silently dropping the section would retire the gate unnoticed
        fails.append("overlap: section missing from the new benchmark "
                     "(baseline has one) -- run bench_comm --quick")
    if ov:
        sp = ov.get("speedup")
        for f in ("ms_per_step_sync", "ms_per_step_overlap", "speedup"):
            if not _num(ov.get(f)):
                fails.append(f"overlap/{f}: {ov.get(f)!r} (want a real "
                             "timing)")
        if _num(sp):
            ref = (f" (baseline {ov0['speedup']:.2f}x)"
                   if _num(ov0.get("speedup")) else "")
            print(f"  timing overlap: sync {ov.get('ms_per_step_sync'):.1f}"
                  f" -> pipelined {ov.get('ms_per_step_overlap'):.1f}"
                  f" ms/step, {sp:.2f}x{ref}")
            if sp < min_overlap_speedup:
                fails.append(
                    f"overlap/speedup: {sp:.2f}x < {min_overlap_speedup}x "
                    "-- the pipelined step no longer beats sync gossip")
    return fails


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--baseline", default="BENCH_comm.json")
    ap.add_argument("--new", default="BENCH_comm.new.json")
    ap.add_argument("--threshold", type=float, default=0.2,
                    help="max allowed fractional wire-bytes growth")
    ap.add_argument("--min-overlap-speedup", type=float, default=1.0,
                    help="fail when the pipelined step's speedup over sync "
                         "gossip falls below this (1.0 = never slower)")
    args = ap.parse_args(argv)

    with open(args.baseline) as f:
        baseline = json.load(f)
    with open(args.new) as f:
        new = json.load(f)

    fails = compare(baseline, new, args.threshold)
    fails += report_timings(baseline, new, args.min_overlap_speedup)
    if fails:
        print("COMM BENCH REGRESSION:")
        for msg in fails:
            print(f"  {msg}")
        sys.exit(1)
    print("comm wire bytes OK (no regression above "
          f"{100 * args.threshold:.0f}%; timings reported above)")


if __name__ == "__main__":
    main()
