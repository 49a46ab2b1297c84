"""Kernel microbenchmarks: each hand-written kernel against its plain
version, at the JAX package's ``benchmarks/bench_kernels.py`` shapes.

Three rows, the reference's names, shapes and dtypes (f32 throughout):

  kernel_flash_attention  K2 at (B, S, H, Kv, D) = (1, 512, 4, 2, 64),
                          causal (its f32 FMA branch on the card), against
                          ``flash_attention/ref.py``; allclose 2e-4
  kernel_ssd_scan         K4 at (b, s, h, p, g, n) = (1, 512, 4, 64, 1, 64),
                          chunk 128 (its 3xTF32 tensor-core branch),
                          against ``ssd_ref``; allclose 2e-3
  kernel_gossip_mix       K1 on 2^20 f32 elements, one receive, weights
                          0.5 / 0.5; allclose 1e-5

The inputs are numpy draws from seed 0 (:func:`make_inputs`), so a test
can feed the same arrays to the JAX package's refs.  On the card
``us_per_call`` is the hand-written kernel's time (CUDA-graph replays,
median: the reference times its oracle, since interpret mode cannot time
a kernel), and ``derived`` keeps the reference's keys (``allclose``,
``ref_gflops``, ``shape``, ``ref_GBps``), computed from the plain
version's time as the reference computes them, and adds ``bound_us`` (the
least time one H100 could take: operations at the inputs' peak rate --
f32 FMA for K2's f32 branch, 3xTF32 for K4, bytes for K1 -- or bytes at
3.35 TB/s, whichever is larger), ``bound_share`` (bound / kernel) and
``library_us``: one PyTorch call for the same function, replayed in turns
with the kernel (``scaled_dot_product_attention`` with ``enable_gqa`` for
K2, ``torch.lerp(x, r, 0.5)`` for K1; K4 has none).  On ``--device cpu``
``us_per_call`` is the plain version's time, ``derived`` says
``impl=plain`` and the share and the library time are not measured.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_kernels \\
      [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.flash_attention import ops as fa_ops, ref as fa_ref
from ..kernels.gossip_mix import ops as gm_ops, ref as gm_ref
from ..kernels.ssd_scan import ops as ssd_ops, ref as ssd_ref
from .common import (PEAK_F32_FLOPS, PEAK_TF32_FLOPS, bound_us, emit,
                     time_fn, time_graph_us, time_turns)

__all__ = ["FLASH", "SSD", "SSD_CHUNK", "GOSSIP_N", "TOL", "make_inputs",
           "flash_cost", "ssd_cost", "run", "main"]

FLASH = (1, 512, 4, 2, 64)           # (B, S, H, Kv, D)
SSD = (1, 512, 4, 64, 1, 64)         # (b, s, h, p, g, n)
SSD_CHUNK = 128
GOSSIP_N = 1 << 20
# the reference's allclose tolerances (rtol = atol)
TOL = {"kernel_flash_attention": 2e-4, "kernel_ssd_scan": 2e-3,
       "kernel_gossip_mix": 1e-5}


def make_inputs() -> dict:
    """The three rows' inputs as f32 numpy arrays, drawn as the reference
    draws its own (standard normals; ``dt = softplus(N)``, ``A =
    -exp(0.3 N)``) from one numpy generator."""
    rng = np.random.default_rng(0)

    def rn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    B, S, H, Kv, D = FLASH
    b, s, h, p, g, n = SSD
    flash = (rn(B, S, H, D), rn(B, S, Kv, D), rn(B, S, Kv, D))
    x, dt = rn(b, s, h, p), np.logaddexp(0.0, rn(b, s, h)).astype(np.float32)
    A = (-np.exp(rn(h) * 0.3)).astype(np.float32)
    ssd = (x, dt, A, rn(b, s, g, n), rn(b, s, g, n))
    gossip = (rn(GOSSIP_N), rn(GOSSIP_N))
    return {"kernel_flash_attention": flash, "kernel_ssd_scan": ssd,
            "kernel_gossip_mix": gossip}


def flash_cost(shape=FLASH, elem_bytes: int = 4,
               window: int | None = None) -> tuple[int, int]:
    """Operations and bytes of one causal call: the visible (row, col)
    pairs (row i sees min(i + 1, window) columns), two products of D
    each; q, k, v read once and out written once."""
    B, S, H, Kv, D = shape
    w = S if window is None else min(window, S)
    pairs = w * (w + 1) // 2 + (S - w) * w
    return 4 * B * H * D * pairs, elem_bytes * (2 * B * S * H * D
                                                + 2 * B * S * Kv * D)


def ssd_cost(shape=SSD, chunk: int = SSD_CHUNK) -> tuple[int, int]:
    """Operations and bytes of one call: per (b, h, chunk) the causal half
    of M (dt x), C H_in and the chunk state B^T (w x); the causal half of
    C B^T once per (b, g, chunk), as the kernel shares it across a group's
    heads; then the state pass.  The inputs read once, y and the final
    state written once."""
    b, s, h, p, g, n = shape
    L = ssd_ops.chunk_len(s, chunk)
    nc, pairs = s // L, L * (L + 1) // 2
    flops = (b * h * nc * (2 * pairs * p + 4 * L * n * p + 2 * p * n)
             + b * g * nc * 2 * pairs * n)
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * g * n
                  + b * h * p * n)
    return flops, nbytes


def _allclose(got, want, tol: float) -> bool:
    return bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))


def _row(name: str, device, kernel, plain, check, bound, iters: int,
         library=None) -> dict:
    """One row: the kernel checked against its plain version, timed (on
    the card from CUDA-graph replays, in turns with ``library`` where
    there is one), and the plain version timed as the reference times its
    oracle.  ``kernel_calls`` counts the wrapper's calls."""
    calls = [0]

    def counted():
        calls[0] += 1
        return kernel()

    ok = check(counted(), plain())
    us_plain = time_fn(plain, iters=iters)
    row = {"name": name, "allclose": ok, "plain_us": us_plain,
           "bound_us": bound[0], "bound_by": bound[1], "library_us": None}
    if device.type == "cuda":
        fns = {"kernel": counted}
        if library is not None:
            fns["library"] = library
        t = time_turns(fns, time_graph_us, rounds=2)
        row["us"], row["library_us"] = t["kernel"], t.get("library")
        row["impl"] = "kernel"
        row["bound_share"] = bound[0] / row["us"]
    else:
        row["us"], row["impl"] = us_plain, "plain"
    row["kernel_calls"] = calls[0]
    return row


def _share(row) -> str:
    share = row.get("bound_share")
    return ("not measured" if share is None else f"{share:.3f}")


def _library(row) -> str:
    """The library call's time; ``none`` on the card where no one PyTorch
    call computes the function (K4)."""
    us = row["library_us"]
    if us is not None:
        return f"{us:.3f}"
    return "none" if row["impl"] == "kernel" else "not measured"


def run(device="cuda") -> list[dict]:
    """The three rows on ``device``, each emitted as a CSV line; returns
    them (with ``kernel_calls``: the kernel wrapper's calls, so a caller
    can hold its launch counter to them)."""
    dev = resolve_device(device)
    inputs = {k: [torch.from_numpy(a).to(dev) for a in v]
              for k, v in make_inputs().items()}
    rows = []

    q, k, v = inputs["kernel_flash_attention"]
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    tol = TOL["kernel_flash_attention"]
    flops, nbytes = flash_cost()
    r = _row("kernel_flash_attention", dev,
             lambda: fa_ops.flash_attention(q, k, v),
             lambda: fa_ref.attention_ref(q, k, v),
             lambda a, b: _allclose(a, b, tol),
             bound_us(flops, nbytes, PEAK_F32_FLOPS), iters=5,
             library=lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True))
    B, S, H, Kv, D = FLASH
    # the reference's count: half of the S^2 pairs
    ref_flops = 4 * B * H * S * S * D / 2
    r["derived"] = (f"allclose={r['allclose']};"
                    f"ref_gflops={ref_flops / r['plain_us'] / 1e3:.1f};"
                    f"shape=B{B}S{S}H{H}D{D};"
                    f"bound_us={r['bound_us']:.3f};"
                    f"bound_share={_share(r)};"
                    f"library_us={_library(r)};impl={r['impl']}")
    rows.append(r)

    x, dt, A, Bm, Cm = inputs["kernel_ssd_scan"]
    tol = TOL["kernel_ssd_scan"]
    flops, nbytes = ssd_cost()

    def ssd_check(got, want):
        return (_allclose(got[0], want[0], tol)
                and _allclose(got[1], want[1], tol))

    # 3xTF32: three TF32 products for every f32 one
    r = _row("kernel_ssd_scan", dev,
             lambda: ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=SSD_CHUNK),
             lambda: ssd_ref.ssd_ref(x, dt, A, Bm, Cm), ssd_check,
             bound_us(3 * flops, nbytes, PEAK_TF32_FLOPS), iters=3)
    b, s, h, p, g, n = SSD
    r["derived"] = (f"allclose={r['allclose']};"
                    f"shape=b{b}s{s}h{h}p{p}n{n};"
                    f"bound_us={r['bound_us']:.3f};"
                    f"bound_share={_share(r)};"
                    f"library_us={_library(r)};impl={r['impl']}")
    rows.append(r)

    xg, rg = inputs["kernel_gossip_mix"]
    tol = TOL["kernel_gossip_mix"]
    r = _row("kernel_gossip_mix", dev,
             lambda: gm_ops.gossip_mix(xg, [rg], w_self=0.5, ws=(0.5,)),
             lambda: gm_ref.gossip_mix_ref(xg, [rg], 0.5, (0.5,)),
             lambda a, b: _allclose(a, b, tol),
             bound_us(3 * GOSSIP_N, 3 * 4 * GOSSIP_N, PEAK_F32_FLOPS),
             iters=5, library=lambda: torch.lerp(xg, rg, 0.5))
    gbps = 3 * 4 * GOSSIP_N / r["plain_us"] / 1e3
    r["derived"] = (f"allclose={r['allclose']};ref_GBps={gbps:.1f};"
                    f"bound_us={r['bound_us']:.3f};"
                    f"bound_share={_share(r)};"
                    f"library_us={_library(r)};impl={r['impl']}")
    rows.append(r)

    for r in rows:
        emit(r["name"], r["us"], r["derived"])
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    return run(args.device)


if __name__ == "__main__":
    main()
