"""Eq. (4) heterogeneity ablation and the straggler trade, on the device.

The port of the JAX package's ``benchmarks/bench_hetero.py``.  Per-node
quadratics ``f_i(x) = 0.5 ||A x - y||^2 + c_i . x`` with ``sum_i c_i = 0``
isolate b^2 (Assumption A.3): grad f_i - grad f = c_i exactly and the
global optimum does not depend on the heterogeneity level.  Metric: the
steady-state MSE above parallel SGD's at the same constant step (the
eq.-3 b^2/(1-rho)^2 term), per topology and heterogeneity level.  The
paper predicts a badly connected ring degrades much faster with b than
the exponential graph.

STRAGGLER half (``straggler_rows`` / ``--quick``): two slow nodes miss
each round's deadline with probability ``p_miss``.  ``wait`` (the
synchronous baseline) waits for them, ``slow_factor`` time units a late
step; ``skip`` closes the round at the deadline (1 unit) and drops the
late nodes per node (``deadline_skip``); ``skip+loss`` adds AL-DSGD
weights, the losses riding the same gather.  Reported per mode: tail
MSE, simulated wall-clock and their product.

Problem data and the ``late`` flags are the reference's numpy draws, bit
for bit; the gradient noise, which the reference draws from
``jax.random``, comes from a ``torch.Generator`` on the device seeded
with the reference's seed (``noise`` injects any other stream).

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_hetero \\
      [--quick [--merge PATH]] [--device cuda|cpu]

``--merge PATH`` records the quick run as a ``hetero`` section of the
JSON file at PATH, and writes nothing else.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..core import optim, topology
from ..device import resolve_device
from .common import emit

STRAGGLER_MODES = ("wait", "skip", "skip+loss")


def _quadratic(rng, d):
    """A (d, d) and y (d,) float32 numpy draws, and the least-squares
    optimum (float64 solve, cast to float32)."""
    A = (rng.standard_normal((d, d)) * 0.3 + np.eye(d)).astype(np.float32)
    yv = rng.standard_normal(d).astype(np.float32)
    A64 = A.astype(np.float64)
    x_star = np.linalg.solve(A64.T @ A64, A64.T @ yv.astype(np.float64))
    return A, yv, x_star.astype(np.float32)


def _problem(n, d, b_scale, seed=0):
    """``_run``'s data: A, y, the zero-mean heterogeneity C scaled by
    ``b_scale``, and x_star (numpy)."""
    rng = np.random.default_rng(seed)
    A, yv, x_star = _quadratic(rng, d)
    C = rng.standard_normal((n, d)).astype(np.float32)
    C -= C.mean(axis=0, keepdims=True)          # sum_i c_i = 0
    return A, yv, C * b_scale, x_star


def _noise_stream(shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return lambda k: torch.randn(shape, generator=gen, device=device)


def _tail_mse(tail) -> float:
    return float(torch.stack(tail).double().cpu().mean())


def _run(n, d, topname, b_scale, T=1500, lr=0.015, sigma=0.3, seed=0,
         device="cuda", noise=None):
    dev = resolve_device(device)
    A, yv, C, x_star = (torch.from_numpy(a).to(dev)
                        for a in _problem(n, d, b_scale, seed))
    noise = noise or _noise_stream((n, d), dev, seed + 1)
    opt = (optim.parallel_msgd(n, beta=0.8) if topname == "parallel" else
           optim.make_optimizer("dmsgd", topology.get_topology(topname, n),
                                beta=0.8))
    params = {"x": torch.zeros((n, d), device=dev)}
    state = opt.init(params)
    tail = []
    for k in range(T):
        r = torch.einsum("ij,nj->ni", A, params["x"]) - yv[None]
        g = torch.einsum("ij,ni->nj", A, r) + C
        g = g + sigma * noise(k)
        params, state = opt.update(params, state, {"x": g}, k, lr)
        if k >= T - 200:
            tail.append(torch.mean(torch.sum((params["x"] - x_star[None])
                                             ** 2, -1)))
    return _tail_mse(tail)


def _run_straggler(n, d, topname, mode, T=900, lr=0.02, sigma=0.3, seed=0,
                   n_stragglers=2, p_miss=0.5, slow_factor=4.0,
                   device="cuda", noise=None):
    """One straggler-simulation run; returns its summary row.  Homogeneous
    quadratics (b = 0) isolate the straggler effect."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    A, yv, x_star = (torch.from_numpy(a).to(dev)
                     for a in _quadratic(rng, d))
    noise = noise or _noise_stream((n, d), dev, seed + 1)
    straggler = np.zeros(n, bool)
    straggler[:n_stragglers] = True

    deadline = mode in ("skip", "skip+loss")
    opt = optim.make_optimizer("dmsgd", topology.get_topology(topname, n),
                               beta=0.8, deadline=deadline,
                               loss_aware=(mode == "skip+loss"))
    params = {"x": torch.zeros((n, d), device=dev)}
    state = opt.init(params)
    sim_time = 0.0
    tail = []
    for k in range(T):
        r = torch.einsum("ij,nj->ni", A, params["x"]) - yv[None]
        g = torch.einsum("ij,ni->nj", A, r)
        g = g + sigma * noise(k)
        late = straggler & (rng.random(n) < p_miss)
        aux = None
        if deadline:
            # the round closes at the deadline: one time unit, late out
            sim_time += 1.0
            aux = {"loss": 0.5 * torch.sum(r * r, 1),
                   "alive": torch.from_numpy(~late)}
        else:
            # synchronous gossip waits for the slowest node
            sim_time += slow_factor if late.any() else 1.0
        params, state = opt.update(params, state, {"x": g}, k, lr, aux=aux)
        if k >= T - 200:
            tail.append(torch.mean(torch.sum((params["x"] - x_star[None])
                                             ** 2, -1)))
    mse = _tail_mse(tail)
    return dict(mode=mode, topology=topname, n=n, n_stragglers=n_stragglers,
                p_miss=p_miss, slow_factor=slow_factor, steps=T,
                tail_mse=mse, sim_time=sim_time,
                mse_x_time=mse * sim_time)


def straggler_rows(n: int = 16, d: int = 10, topname: str = "one_peer_exp",
                   T: int = 900, device="cuda") -> list[dict]:
    """wait vs skip vs skip+loss on the same straggler stream (same seed)."""
    return [_run_straggler(n, d, topname, mode, T=T, device=device)
            for mode in STRAGGLER_MODES]


def _emit_straggler(rows, us) -> None:
    for r in rows:
        emit(f"hetero_straggler_{r['mode'].replace('+', '_')}", us,
             f"tail_mse={r['tail_mse']:.4f};sim_time={r['sim_time']:.0f};"
             f"mse_x_time={r['mse_x_time']:.2f}")


def run_quick(merge_path: str | None = None, n: int = 8, T: int = 600,
              device="cuda") -> None:
    """Smoke size: 2 simulated stragglers on one_peer_exp.  Emits one row
    per mode and the trade; with ``merge_path`` records the summary as a
    ``hetero`` section of that JSON file (report-only, stochastic)."""
    t0 = time.perf_counter()
    rows = straggler_rows(n=n, T=T, device=device)
    us = 1e6 * (time.perf_counter() - t0) / len(rows)
    by_mode = {r["mode"]: r for r in rows}
    ok = (by_mode["skip"]["sim_time"] < by_mode["wait"]["sim_time"]
          and by_mode["skip"]["tail_mse"]
          < 5.0 * max(by_mode["wait"]["tail_mse"], 1e-9))
    _emit_straggler(rows, us)
    emit("hetero_straggler_trade", us, f"skip_beats_wait_wallclock={ok}")
    if merge_path:
        rec = {}
        if os.path.exists(merge_path):
            with open(merge_path) as f:
                rec = json.load(f)
        rec["hetero"] = {"n": n, "steps": T, "rows": rows,
                         "skip_beats_wait_wallclock": bool(ok)}
        with open(merge_path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"merged hetero section into {merge_path}")


def run(n: int = 32, d: int = 10, device="cuda") -> None:
    t0 = time.perf_counter()
    rows = {}
    for b in (0.0, 1.0, 3.0):
        rows[b] = {t: _run(n, d, t, b, device=device)
                   for t in ("parallel", "one_peer_exp", "ring")}
    us = 1e6 * (time.perf_counter() - t0) / (3 * 3)
    # excess steady-state MSE over parallel = the eq.-3 topology terms
    exc = {b: {t: max(v[t] - v["parallel"], 1e-9) for t in
               ("one_peer_exp", "ring")} for b, v in rows.items()}
    ring_growth = exc[3.0]["ring"] / max(exc[0.0]["ring"], 1e-9)
    op_growth = exc[3.0]["one_peer_exp"] / max(exc[0.0]["one_peer_exp"], 1e-9)
    ok = (exc[3.0]["ring"] > exc[3.0]["one_peer_exp"]
          and ring_growth > op_growth)
    emit("hetero_eq4", us,
         ";".join(f"b{b}_onepeer={exc[b]['one_peer_exp']:.4f};"
                  f"b{b}_ring={exc[b]['ring']:.4f}" for b in rows)
         + f";ring_degrades_faster={ok}")
    t0 = time.perf_counter()
    srows = straggler_rows(n=16, device=device)
    _emit_straggler(srows, 1e6 * (time.perf_counter() - t0) / len(srows))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--merge", default=None,
                    help="with --quick: the JSON file to record into")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    if args.quick:
        run_quick(merge_path=args.merge, device=args.device)
    else:
        run(device=args.device)


if __name__ == "__main__":
    main()
