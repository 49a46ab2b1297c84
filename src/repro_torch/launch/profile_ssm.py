"""Where the ssm and hybrid families' time goes on the card.

Runs full-width mamba2-1.3b, or zamba2-1.2b with ``--arch zamba2-1.2b``
(random weights from ``--seed``), and traces, with ``torch.profiler``, one
full-sequence ``forward`` through the SSD-scan kernel (and, for hybrid,
the flash-attention kernel in the shared block; ``attention_impl=
"pallas"``) and a window of ``decode_step`` calls (the loop
``launch.serve.generate`` runs; hybrid at position ``CACHE_LEN`` - 1,
over full rings).  For each it prints the host time per call (ending in a
device synchronisation), the device time per call summed over kernels,
the device's idle share, and the kernels that take the most device time
(``profile_serve.report``).

  PYTHONPATH=src python -m repro_torch.launch.profile_ssm [--steps 8]
  PYTHONPATH=src python -m repro_torch.launch.profile_ssm --arch zamba2-1.2b
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .. import configs
from ..device import resolve_device
from ..models import model as M
from .profile_serve import report

CACHE_LEN = 128              # the hybrid decode's rings: generate's default


def _timed(fn, calls: int, traced: bool):
    """Host seconds for ``calls`` calls of ``fn`` ending in a sync, and the
    profiler (None when untraced)."""
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if traced else contextlib.nullcontext())
    with ctx as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, prof


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b",
                    choices=["mamba2-1.3b", "zamba2-1.2b"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--decode-batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("profile_ssm measures the card: run it on one")

    cfg = dataclasses.replace(configs.get_config(args.arch),
                              attention_impl="pallas")
    params = M.init(cfg, args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.seq)), device=dev)
    cache = M.init_cache(cfg, batch=args.decode_batch,
                         cache_len=CACHE_LEN, dtype=torch.float32,
                         device=dev)
    token = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.decode_batch, 1)), device=dev)

    def fwd():
        M.forward(params, cfg, tokens)

    def step():
        M.decode_step(params, cfg, token, cache, CACHE_LEN - 1)

    with torch.no_grad():
        for name, fn, calls in (
                (f"{cfg.name} forward ({args.batch} x {args.seq} tokens)",
                 fwd, 1),
                (f"{cfg.name} decode step (batch {args.decode_batch})", step,
                 args.steps)):
            _timed(fn, 2, traced=False)                      # warm up
            wall, _ = _timed(fn, calls, traced=False)
            print(f"{name}, untraced: host {wall * 1e3 / calls:.3f} ms/call")
            wall, prof = _timed(fn, calls, traced=True)
            report(name, prof, wall, calls, args.top)


if __name__ == "__main__":
    main()
