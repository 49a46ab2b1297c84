"""Benchmark utilities: a timer that waits for the card, a timer that
replays a CUDA graph, timings taken in turns, the roofline bound on one
H100, and the ``name,us_per_call,derived`` CSV row every suite prints."""
from __future__ import annotations

import time

import torch

__all__ = ["time_fn", "time_graph_us", "time_turns", "bound_us", "emit",
           "PEAK_BF16_FLOPS", "PEAK_F32_FLOPS", "PEAK_TF32_FLOPS",
           "PEAK_BYTES"]

# published peaks of one H100 SXM (dense, no sparsity) at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12       # outside the tensor cores
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12


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


def time_graph_us(fn, *, calls: int = 20, reps: int = 5,
                  warmup: int = 3) -> float:
    """Device microseconds per call of ``fn`` on the card: ``warmup``
    calls on a side stream, then ONE CUDA graph of ``calls`` calls
    replayed ``reps`` times, each replay timed by CUDA events; the median
    replay over ``calls``.  No host launch cost lies between the calls,
    so a kernel shorter than its Python wrapper is timed by the device.
    ``fn`` runs ``warmup + calls`` times in Python: a replay runs the
    kernels, not ``fn``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()                      # the first replay uploads the graph
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / calls)
    del graph
    times.sort()
    return times[len(times) // 2]


def time_turns(fns: dict, timer, rounds: int = 4) -> dict:
    """Median of ``rounds`` timings ``timer(fn)`` of each function, taken
    in turns (a b, b a, ...) so that a drift of the card's clock falls on
    both."""
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(timer(fns[name]))
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}


def bound_us(flops: float, nbytes: float,
             peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """The least time one H100 could take for work of ``flops``
    operations at ``peak_flops`` and ``nbytes`` of traffic at its memory
    rate: the larger of the two, in microseconds, and which one it is."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e6,
            "operations" if t_ops >= t_bytes else "bytes")


def emit(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)
