"""Where the serving path's time goes on the card.

Serves a full-width model of a paged family (``--arch``: qwen3-0.6b by
default, granite-moe-3b-a800m, whose decode step runs the dropless
experts, or musicgen-large, whose tokens are frames of 4 codes; random
weights from ``--seed``) through
:class:`repro_torch.serve.ServeEngine` and traces, with ``torch.profiler``,
one bucketed prefill and a steady window of batched decode steps.  For
each it prints the host time per call (each ends in the engine's copy of
the logits to the host, which waits for the card), the device time per
call summed over kernels, the device's idle share, and the kernels that
take the most device time.  For a model with experts it also traces one
layer's dropless mixture (``moe_apply``) at the decode step's shape: its
launches and device time, and the share of the weights' casts to the
activation dtype.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve [--steps 8]
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch granite-moe-3b-a800m
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch musicgen-large
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .. import configs
from ..device import resolve_device
from ..models import model as M
from ..models.moe import moe_apply
from ..serve import ServeEngine, pages_needed


def report(name: str, prof, wall_s: float, calls: int, top: int) -> None:
    """Print host and device ms per call, the device's idle share and the
    ``top`` kernels by device time from a ``torch.profiler`` trace.  The
    device rows of ``record_function`` ranges span kernels counted in
    their own rows, so they are left out of the sum."""
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and not e.is_user_annotation]
    device_us = sum(e.self_device_time_total for e in rows)
    wall_ms = wall_s * 1e3 / calls
    dev_ms = device_us / 1e3 / calls
    print(f"{name}: host {wall_ms:.3f} ms/call, device {dev_ms:.3f} ms/call, "
          f"device idle {100 * (1 - dev_ms / wall_ms):.1f}% "
          f"({len(rows)} kernel names, {sum(e.count for e in rows) / calls:.0f}"
          f" launches/call)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3 / calls:9.4f} ms/call "
              f"{e.count / calls:6.1f}x  {e.key[:90]}")


def moe_layer(cfg, params, batch: int, calls: int, dev) -> None:
    """One layer's dropless mixture at the decode step's shape (``batch``
    tokens of one position): launches and device ms per call over
    ``calls`` traced calls, and the share of the weights' casts."""
    h = torch.randn(batch, 1, cfg.d_model, device=dev).to(
        cfg.activation_dtype)
    layer = params.layers[0].moe

    def call():
        return moe_apply(layer, h, n_experts=cfg.n_experts,
                         top_k=cfg.top_k, dropless=True)

    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    report(f"moe_apply, one layer's dropless experts ({batch} tokens)",
           prof, wall, calls, 8)
    casts = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "bfloat16_copy" in e.key)
    print(f"  of it the casts to {cfg.activation_dtype} (the three expert "
          f"stacks and the output): "
          f"{casts / 1e3 / calls:.4f} ms/call")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("profile_serve measures the card: run it on one")

    cfg = configs.get_config(args.arch)
    params = M.init(cfg, args.seed, device=dev)
    max_seq = 2 * args.prompt + 4 * args.steps
    engine = ServeEngine(cfg, params, max_batch=args.batch, page_size=16,
                         max_seq=max_seq, prefill_token_budget=args.prompt,
                         n_pages=1 + (args.batch + 1)
                         * pages_needed(max_seq, 16), device=dev)
    rng = np.random.default_rng(args.seed)
    frame = (cfg.n_codebooks,) if cfg.family == "audio" else ()

    def submit():
        engine.submit(rng.integers(0, cfg.vocab_size, (args.prompt,) + frame),
                      max_new=max_seq - args.prompt)

    for _ in range(args.batch):           # warm up every bucket once
        submit()
    while engine.sched.waiting:
        engine.step()
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()

    t0 = time.perf_counter()              # the same window, untraced
    for _ in range(args.steps):
        engine.step()
    torch.cuda.synchronize()
    print(f"decode step (batch {len(engine.sched.running)}), untraced: host "
          f"{(time.perf_counter() - t0) * 1e3 / args.steps:.3f} ms/call")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(f"decode step (batch {len(engine.sched.running)})", prof, wall,
            args.steps, args.top)
    if cfg.n_experts:
        moe_layer(cfg, params, len(engine.sched.running), args.steps, dev)

    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, args.prompt) + frame),
        device=dev)
    with torch.no_grad():
        M.forward_prefill(params, cfg, tokens)            # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.forward_prefill(params, cfg, tokens)
        torch.cuda.synchronize()
        print(f"forward_prefill (1 x {args.prompt} tokens), untraced: host "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms/call")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            M.forward_prefill(params, cfg, tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    report(f"forward_prefill (1 x {args.prompt} tokens)", prof, wall, 1,
            args.top)


if __name__ == "__main__":
    main()
