"""Serving benchmark: continuous-batching paged engine vs the legacy
one-batch-at-a-time ``generate`` on the same Poisson arrival trace.

The port of the JAX package's ``benchmarks/bench_serve.py``, on
``--device`` (the card by default).  Both sides serve an identical trace
(exponential inter-arrivals, Poisson prompt lengths, fixed ``max_new``;
numpy only, so the same trace as the reference's for the same seed):

  * **engine** -- :class:`repro_torch.serve.ServeEngine`: requests admitted
    the step they arrive, mixed prefill/decode batches over the paged KV
    pool (the flash-attention kernel in every prefill and the
    paged-attention kernel in every decode step, on the card).
  * **baseline** -- the pre-paging serving path: requests grouped into
    fixed batches of ``max_batch`` in arrival order; each batch blocks
    until ITS whole ``generate`` call (token-by-token loop prefill +
    ``max_new`` decode steps over a dense ``B x cache_len`` ring cache)
    finishes before the next batch starts.

Reported per side: tokens/sec, first-token and total latency p50/p99
(virtual clock: arrival waits count, so the baseline pays its
head-of-line blocking), and peak KV footprint -- the engine's page
high-water mark vs the dense cache's fixed ``max_batch x cache_len``
allocation at the same dtype width.

Both sides are warmed on a replay of the same trace before timing (the
engine's ``CompileCache`` is shared into the timed engine; here its
entries are eager callables, so the warm-up loads the kernels and the
libraries' handles, not a compilation), and every timed call ends in
``torch.cuda.synchronize`` on the card.

``--quick`` runs a smaller trace on the reduced config and writes the JSON
record with ``--out``, the schema of the reference's ``BENCH_serve.json``;
``repro_torch.benchmarks.check_serve_regression`` (or the reference's
checker) diffs it against a committed baseline:

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_serve --quick \\
      --out BENCH_serve.new.json
  PYTHONPATH=src python -m repro_torch.benchmarks.check_serve_regression \\
      --baseline BENCH_serve_h100.json --new BENCH_serve.new.json
  PYTHONPATH=src python -m repro_torch.benchmarks.bench_serve --quick \\
      --device cpu --out /tmp/bs.json
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import configs
from ..device import resolve_device
from ..launch import serve as serve_mod
from ..models import model as M
from ..serve import ServeEngine, page_bytes


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_engine(cfg, params, trace, *, args, compile_cache=None):
    device = resolve_device(args.device)
    eng = ServeEngine(cfg, params, n_pages=args.pages,
                      page_size=args.page_size, max_seq=args.max_seq,
                      max_batch=args.max_batch,
                      temperature=args.temperature, seed=args.seed,
                      compile_cache=compile_cache, device=device)
    _sync(device)
    wall = serve_mod.serve_trace(eng, trace)
    _sync(device)
    lat = serve_mod.latency_summary(eng.finished)
    new_tokens = sum(len(r.generated) for r in eng.finished)
    st = eng.stats()
    return eng, dict(
        tokens_per_s=new_tokens / max(wall, 1e-9),
        new_tokens=new_tokens, wall_s=wall,
        peak_kv_pages=st["peak_pages"],
        peak_kv_bytes=st["peak_kv_bytes"],
        preemptions=st["preemptions"],
        compile_cache=st["compile_cache"], **lat)


def run_baseline(cfg, params, trace, *, args):
    """Fixed batches of max_batch in arrival order, each generate() call
    (legacy loop prefill, dense ring cache) run to completion before the
    next batch starts.  Virtual clock: a batch starts at max(previous
    batch end, last member arrival); wall time of the call advances it."""
    device = resolve_device(args.device)
    extra = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    now, toks = 0.0, 0
    first, total = [], []
    batches = [trace[i:i + args.max_batch]
               for i in range(0, len(trace), args.max_batch)]
    for batch in batches:
        now = max(now, max(a for a, _, _ in batch))
        lmax = max(p.shape[0] for _, p, _ in batch)
        prompts = np.zeros((len(batch), lmax) + extra, np.int32)
        for i, (_, p, _) in enumerate(batch):
            prompts[i, :p.shape[0]] = p
        _sync(device)
        t0 = time.perf_counter()
        serve_mod.generate(cfg, params, torch.from_numpy(prompts),
                           max_new=args.max_new, cache_len=args.max_seq,
                           temperature=args.temperature, seed=args.seed,
                           prefill="loop", device=device)
        _sync(device)
        now += time.perf_counter() - t0
        toks += len(batch) * args.max_new
        for a, _, _ in batch:
            # the whole batch's tokens land when the call returns
            first.append(now - a)
            total.append(now - a)

    def pct(x, q):
        return float(np.percentile(x, q))

    dense_bytes = (args.max_batch * args.max_seq
                   * page_bytes(cfg, 1, torch.bfloat16))
    return dict(
        tokens_per_s=toks / max(now, 1e-9), new_tokens=toks, wall_s=now,
        dense_kv_bytes=dense_bytes,
        first_token_p50_s=pct(first, 50), first_token_p99_s=pct(first, 99),
        total_p50_s=pct(total, 50), total_p99_s=pct(total, 99))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--n-requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=8.0)
    ap.add_argument("--mean-prompt", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--pages", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="CI fast tier: smaller trace")
    ap.add_argument("--out", default=None, help="write JSON here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.quick:
        args.n_requests = min(args.n_requests, 12)
        args.max_new = min(args.max_new, 8)

    device = resolve_device(args.device)
    cfg = configs.reduced_config(configs.get_config(args.arch))
    params = M.init(cfg, args.seed, device=device)
    trace = serve_mod.poisson_trace(args.n_requests, args.rate,
                                    args.mean_prompt, args.max_new,
                                    cfg.vocab_size, args.seed,
                                    n_codebooks=cfg.n_codebooks)

    # warm both sides, then time steady-state
    warm_eng, _ = run_engine(cfg, params, trace, args=args)
    _, engine = run_engine(cfg, params, trace, args=args,
                           compile_cache=warm_eng.compile_cache)
    run_baseline(cfg, params, trace[:args.max_batch], args=args)
    baseline = run_baseline(cfg, params, trace, args=args)

    speedup = engine["tokens_per_s"] / max(baseline["tokens_per_s"], 1e-9)
    kv_ratio = engine["peak_kv_bytes"] / max(baseline["dense_kv_bytes"], 1)
    rec = dict(
        config=dict(arch=cfg.name, n_requests=args.n_requests,
                    rate=args.rate, mean_prompt=args.mean_prompt,
                    max_new=args.max_new, pages=args.pages,
                    page_size=args.page_size, max_seq=args.max_seq,
                    max_batch=args.max_batch, quick=args.quick),
        engine=engine, baseline=baseline,
        speedup=speedup, kv_bytes_ratio=kv_ratio)

    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"bench_serve {cfg.name} (reduced) on {where}")
    print(f"engine:   {engine['tokens_per_s']:.1f} tok/s | first-token "
          f"p50 {engine['first_token_p50_s']:.3f}s p99 "
          f"{engine['first_token_p99_s']:.3f}s | peak KV "
          f"{engine['peak_kv_bytes'] / 1e6:.2f} MB "
          f"({engine['peak_kv_pages']} pages)")
    print(f"baseline: {baseline['tokens_per_s']:.1f} tok/s | first-token "
          f"p50 {baseline['first_token_p50_s']:.3f}s p99 "
          f"{baseline['first_token_p99_s']:.3f}s | dense KV "
          f"{baseline['dense_kv_bytes'] / 1e6:.2f} MB")
    print(f"continuous batching speedup: {speedup:.2f}x | "
          f"paged/dense KV bytes: {kv_ratio:.2f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
