"""Perf gate: diff a fresh serving benchmark record against a committed
baseline and fail on a serving regression.

The port of the JAX package's ``benchmarks/check_serve_regression.py``:
the same three failures, the same messages, and the same JSON schema, so
either package's checker reads either package's records.

Three hard failures:

  * **tokens/sec drop** -- the engine's throughput falling more than
    ``--threshold`` (default 20%) below the committed baseline's.  This IS
    a timing, but it is the serving plane's headline number; the generous
    threshold absorbs host drift while catching a lost batched-prefill
    path or a per-step rebuild.
  * **NaN/missing latency or throughput** -- a placeholder field
    regressed, or the latency summary ran over zero finished requests.
  * **paged peak-KV-bytes >= dense** -- the page pool's high-water mark
    reaching the dense ``max_batch x cache_len`` allocation means paging
    stopped saving memory (e.g. pages leak on finish/preempt).

Everything else (speedup vs the in-run baseline, latency percentiles,
compile-cache counters) is printed, never gated.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_serve --quick \\
      --out BENCH_serve.new.json
  PYTHONPATH=src python -m repro_torch.benchmarks.check_serve_regression \\
      --baseline BENCH_serve_h100.json --new BENCH_serve.new.json
"""
from __future__ import annotations

import argparse
import json
import sys

LATENCY_FIELDS = ("first_token_p50_s", "first_token_p99_s",
                  "total_p50_s", "total_p99_s")


def _num(x) -> bool:
    return isinstance(x, (int, float)) and x == x   # rejects NaN


def compare(baseline: dict, new: dict, threshold: float = 0.2) -> list[str]:
    fails: list[str] = []
    eng, base_eng = new.get("engine", {}), baseline.get("engine", {})

    tps, tps0 = eng.get("tokens_per_s"), base_eng.get("tokens_per_s")
    if not _num(tps):
        fails.append(f"engine/tokens_per_s is {tps!r} (want a real rate)")
    elif _num(tps0):
        print(f"  engine tokens/s: {tps:.1f} (baseline {tps0:.1f})")
        if tps < tps0 * (1.0 - threshold):
            fails.append(
                f"engine/tokens_per_s: {tps0:.1f} -> {tps:.1f} "
                f"(-{100.0 * (tps0 - tps) / tps0:.1f}% > "
                f"{100 * threshold:.0f}%)")

    for side, d in (("engine", eng), ("baseline", new.get("baseline", {}))):
        for f in LATENCY_FIELDS:
            if not _num(d.get(f)):
                fails.append(f"{side}/{f}: {d.get(f)!r} (NaN latency -- "
                             "zero finished requests or a placeholder)")

    pk = eng.get("peak_kv_bytes")
    dense = new.get("baseline", {}).get("dense_kv_bytes")
    if _num(pk) and _num(dense):
        print(f"  KV bytes: paged peak {pk} vs dense {dense} "
              f"(ratio {pk / max(dense, 1):.2f})")
        if pk >= dense:
            fails.append(
                f"engine/peak_kv_bytes {pk} >= dense baseline {dense} -- "
                "paging no longer saves memory (page leak on "
                "finish/preempt?)")
    else:
        fails.append("peak_kv_bytes / dense_kv_bytes missing from the "
                     "benchmark -- memory accounting regressed")

    sp = new.get("speedup")
    if _num(sp):
        ref = baseline.get("speedup")
        print(f"  continuous-batching speedup: {sp:.2f}x"
              + (f" (baseline {ref:.2f}x)" if _num(ref) else ""))
    cc = eng.get("compile_cache", {})
    if cc:
        print(f"  compile cache: {cc.get('entries')} executables, "
              f"{cc.get('hits')} hits / {cc.get('misses')} misses / "
              f"{cc.get('evictions')} evictions")
    return fails


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--baseline", default="BENCH_serve.json")
    ap.add_argument("--new", default="BENCH_serve.new.json")
    ap.add_argument("--threshold", type=float, default=0.2,
                    help="max allowed fractional tokens/sec drop")
    args = ap.parse_args(argv)

    with open(args.baseline) as f:
        baseline = json.load(f)
    with open(args.new) as f:
        new = json.load(f)

    fails = compare(baseline, new, args.threshold)
    if fails:
        print("SERVE BENCH REGRESSION:")
        for msg in fails:
            print(f"  {msg}")
        sys.exit(1)
    print(f"serving OK (tokens/sec within {100 * args.threshold:.0f}% of "
          "baseline; paged KV below dense; latencies real)")


if __name__ == "__main__":
    main()
