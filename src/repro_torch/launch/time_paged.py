"""Times K3 (``kernels/paged_attention``) on the card at ten shapes, with
the page pool cold as the serving path finds it.

Shapes (bf16, page 16; qwen3-0.6b's heads H 16, Kv 8, D 128 but where
named):

  ragged  8 sequences of random lengths up to 1,024 (one at 1,024, one a
          trash-padded row of length 1), Pmax 64: ``chip_smoke.py``'s
  serve   8 sequences of 257-288 tokens, Pmax 32: a decode step of the
          serve phase (256-token prompts, 32 new tokens)
  long    one sequence of 8,192 tokens, Pmax 512
  moe     serve's lengths at granite-moe-3b-a800m's heads, H 24, Kv 8,
          D 64: G 3, so each block's group of GT 4 query rows has one
          idle row (phase 12's decode step)
  audio   serve's lengths at musicgen-large's heads, H 32, Kv 32, D 64:
          G 1, so each group is one query row (phase 13's decode step)
  gemma2, granite34b, deepseek, dbrx
          serve's lengths at the heads of gemma2-27b (H 32, Kv 16: G 2;
          window 4096 and soft-cap 50, as its local layers call it),
          granite-34b (H 48, Kv 1: G 48, six groups of GT 8 rows over one
          kv head), deepseek-67b (H 64, Kv 8: G 8) and dbrx-132b (H 48,
          Kv 8: G 6, two of each group's 8 rows idle), all D 128
          (``chip_smoke.py`` phase 15's decode steps)
  gemma2_long
          one 6,148-token sequence at gemma2-27b's heads, window 4096 and
          soft-cap 50: the window starts 2,052 tokens into the sequence
          (phase 15 (c))

Each is timed from CUDA-graph replays (no host launch cost between calls)
cycling over at least four copies of the pool, more than 50 MB together,
so that no call finds its pages in the 50 MB L2; the eager time through
the Python wrapper is printed beside it.  The bound is the larger of the
bytes -- the K and V of the visible tokens once (those inside the window,
where there is one), q, out, the page table and lengths -- and the
operations on them at the card's peak rate for their type, bf16 on the
tensor cores (bytes set it at every shape).

  PYTHONPATH=src python3 src/repro_torch/launch/time_paged.py

It uses only ``paged_attention`` (the same signature in every version of
the port), so with another checkout's ``src`` first on ``PYTHONPATH`` it
times that checkout's kernel at the same shapes.
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from repro_torch.benchmarks.common import PEAK_BF16_FLOPS, bound_us
from repro_torch.kernels.paged_attention import ops

COLD_BYTES = 60e6        # the pool copies together: beyond the 50 MB L2
H, KV, D, PAGE = 16, 8, 128, 16
SHAPES = ("ragged", "serve", "long", "moe", "audio", "gemma2", "granite34b",
          "deepseek", "dbrx", "gemma2_long")
_HEADS = {"moe": (24, 8, 64), "audio": (32, 32, 64),
          "gemma2": (32, 16, 128), "gemma2_long": (32, 16, 128),
          "granite34b": (48, 1, 128), "deepseek": (64, 8, 128),
          "dbrx": (48, 8, 128)}
# (window, soft-cap) a shape is called with, where not (None, None)
_MASKS = {"gemma2": (4096, 50.0), "gemma2_long": (4096, 50.0)}
_SERVE_LIKE = ("serve", "moe", "audio", "gemma2", "granite34b", "deepseek",
               "dbrx")


def heads(name: str) -> tuple[int, int, int]:
    """(H, Kv, D) of shape ``name``."""
    return _HEADS.get(name, (H, KV, D))


def mask(name: str) -> tuple[int | None, float | None]:
    """(window, soft-cap) of shape ``name``."""
    return _MASKS.get(name, (None, None))


def lengths(name: str) -> tuple[np.ndarray, int]:
    """(lengths, Pmax) of shape ``name``."""
    if name == "ragged":
        pmax = 64
        ln = np.random.default_rng(2).integers(1, pmax * PAGE + 1, 8)
        ln[0], ln[-1] = pmax * PAGE, 1
        return ln, pmax
    if name in _SERVE_LIKE:
        return np.random.default_rng(3).integers(257, 289, 8), 32
    if name == "long":
        return np.array([8192]), 512
    if name == "gemma2_long":
        return np.array([6148]), -(-6148 // PAGE)
    raise ValueError(name)


def inputs(dev, name: str, copies: int = 1, dtype=torch.bfloat16):
    """q, [(k_pages, v_pages)] x copies, page_table, lengths (on ``dev``)
    and the lengths as numpy.  Each sequence's pages are distinct pages of
    the pool in a random order; a row of length 1 at the end of a ragged
    batch reads the trash page 0, as a padded bucket row does."""
    ln, pmax = lengths(name)
    h, kv, d = heads(name)
    B = len(ln)
    per_seq = -(-ln // PAGE)
    trash_row = name == "ragged"
    n_pages = 1 + int(per_seq[:B - trash_row].sum())
    rng = np.random.default_rng(B + pmax)
    order = 1 + rng.permutation(n_pages - 1)
    table = np.zeros((B, pmax), np.int32)
    at = 0
    for b in range(B - trash_row):
        table[b, :per_seq[b]] = order[at:at + per_seq[b]]
        at += per_seq[b]
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(B, h, d, generator=g, device=dev).to(dtype)
    kp, vp = (torch.randn(kv, n_pages, PAGE, d, generator=g, device=dev)
              .to(dtype) for _ in range(2))
    pools = [(kp, vp)] + [(kp.clone(), vp.clone()) for _ in range(copies - 1)]
    return (q, pools, torch.from_numpy(table).to(dev),
            torch.from_numpy(ln.astype(np.int32)).to(dev), ln)


def visible_tokens(ln: np.ndarray, window: int | None = None) -> int:
    """Tokens the decode queries see: each sequence's last ``window``."""
    return int((ln if window is None else np.minimum(ln, window)).sum())


def cost(ln: np.ndarray, pmax: int, elem: int = 2,
         hkd: tuple = (H, KV, D), window: int | None = None
         ) -> tuple[int, int]:
    """Operations and bytes one call needs: 4 H D flops per visible token
    (q.k and p.v for the G rows of each kv head); K and V of the visible
    tokens once, q and out, the page table and the lengths."""
    h, kv, d = hkd
    visible, B = visible_tokens(ln, window), len(ln)
    return (4 * h * d * visible,
            2 * visible * kv * d * elem + 2 * B * h * d * elem
            + 4 * (B * pmax + B))


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


def time_shape(dev, name: str) -> dict:
    """Graph-replay and eager ms per call at shape ``name``, cold pool."""
    ln, pmax = lengths(name)
    _, kv, d = hkd = heads(name)
    copy_bytes = 2 * kv * (1 + int((-(-ln // PAGE)).sum())) * PAGE * d * 2
    copies = max(4, -(-int(COLD_BYTES) // copy_bytes))
    q, pools, table, lens, _ = inputs(dev, name, copies)
    calls = copies * max(1, 32 // copies)
    window, cap = mask(name)

    def run_all():
        for kp, vp in pools * (calls // copies):
            ops.paged_attention(q, kp, vp, table, lens, window=window,
                                attn_cap=cap)

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
    eager_ms = _events_ms(run_all, 3) / calls
    flops, nbytes = cost(ln, pmax, hkd=hkd, window=window)
    b_us, by = bound_us(flops, nbytes, PEAK_BF16_FLOPS)
    b_ms = b_us / 1e3
    return {"shape": name, "B": len(ln), "pmax": pmax, "heads": hkd,
            "window": window, "cap": cap,
            "visible": visible_tokens(ln, window), "copies": copies,
            "pool_mb": copies * copy_bytes / 1e6, "ms": graph_ms,
            "eager_ms": eager_ms, "bound_ms": b_ms, "bound_by": by,
            "gbps": nbytes / graph_ms / 1e6, "bound_share": b_ms / graph_ms}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_paged measures the card: run it on one")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; paged_attention from {ops.__file__}", flush=True)
    rows = []
    for name in SHAPES:
        r = time_shape(dev, name)
        rows.append(r)
        print(f"  {name}: B={r['B']} (H, Kv, D)={r['heads']} "
              f"window={r['window']} cap={r['cap']} "
              f"Pmax={r['pmax']} {r['visible']} "
              f"visible tokens, {r['copies']} pool copies "
              f"({r['pool_mb']:.1f} MB): graph {r['ms']:.4f} ms "
              f"({r['gbps']:.1f} GB/s, {100 * r['bound_share']:.1f} % of "
              f"the {r['bound_ms']:.4f} ms {r['bound_by']} bound), eager "
              f"{r['eager_ms']:.4f} ms", flush=True)
    print(json.dumps({"paged_times": rows}), flush=True)


if __name__ == "__main__":
    main()
