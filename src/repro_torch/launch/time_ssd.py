"""Times K4 (``kernels/ssd_scan``) on the card at mamba2-1.3b's widths
(H 64, P 64, G 1, N 128, the model's A range), f32, at the two chunk
lengths its forward runs with the model's chunk of 128:

  chunk128  s = 2048: ``chip_smoke.py``'s main shape, L = 128
  chunk64   s = 1984, an odd multiple of 64: ``ops.chunk_len`` halves the
            chunk to L = 64

Each is timed from CUDA-graph replays (no host launch cost between calls);
the eager time through the Python wrapper is printed beside it.

  PYTHONPATH=src python3 src/repro_torch/launch/time_ssd.py

It uses only ``ssd_scan`` (the same signature in every version of the
port), so with another checkout's ``src`` first on ``PYTHONPATH`` it times
that checkout's kernel at the same shapes.
"""
from __future__ import annotations

import json
import subprocess

import torch

from repro_torch.kernels.ssd_scan import ops

SHAPES = {"chunk128": (1, 2048, 64, 64, 1, 128),
          "chunk64": (1, 1984, 64, 64, 1, 128)}    # (b, s, h, p, g, n)


def _events_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_shape(dev, name: str, calls: int = 10) -> dict:
    """Graph-replay and eager ms per call at shape ``name``."""
    b, s, h, p, g, n = SHAPES[name]
    gen = torch.Generator(device=dev).manual_seed(6)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x, dt = rn(b, s, h, p), torch.nn.functional.softplus(rn(b, s, h))
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    B, C = rn(b, s, g, n), rn(b, s, g, n)

    def run_all():
        for _ in range(calls):
            ops.ssd_scan(x, dt, A, B, C)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run_all()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run_all()
    graph_ms = _events_ms(graph.replay, 5) / calls
    del graph
    return {"shape": name, "bshpgn": SHAPES[name],
            "chunk": ops.chunk_len(s, 128), "ms": graph_ms,
            "eager_ms": _events_ms(run_all, 3) / calls}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_ssd measures the card: run it on one")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; ssd_scan from {ops.__file__}", flush=True)
    rows = []
    for name in SHAPES:
        r = time_shape(dev, name)
        rows.append(r)
        print(f"  {name}: (b,s,h,p,g,n)={r['bshpgn']} chunk {r['chunk']} "
              f"f32: graph {r['ms']:.4f} ms, eager {r['eager_ms']:.4f} ms",
              flush=True)
    print(json.dumps({"ssd_times": rows}), flush=True)


if __name__ == "__main__":
    main()
