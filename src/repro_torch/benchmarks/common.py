"""Benchmark utilities: a timer that waits for the card, and the
``name,us_per_call,derived`` CSV row every suite prints."""
from __future__ import annotations

import time

import torch

__all__ = ["time_fn", "emit"]


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median wall time per call in microseconds, the card synchronised
    after every call."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return 1e6 * times[len(times) // 2]


def emit(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)
