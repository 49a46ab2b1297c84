"""The paper's transient-iteration experiment (Fig. 1 / Fig. 13, Appendix
D.5) on distributed logistic regression.

The port of the JAX package's ``examples/topology_compare.py``: DmSGD
over ring / grid / static-exp / one-peer-exp (or any listed topology)
against parallel mSGD, heterogeneous data, every update through a
:class:`repro_torch.core.plan.GossipPlan` (one executable per gossip
realization).  Writes ``results/topology_compare.csv`` (or ``--out``)
and prints the final MSEs and the ordering the paper predicts (Table 1):
exponential graphs track parallel SGD closest.  The problem data are the
reference's numpy draws; the minibatch indices come from a
``torch.Generator`` on the device seeded with the reference's seed.
``--overlap`` runs the one-step-delayed pipeline (not for the
``parallel`` baseline); its curves read the flushed (mixed) iterates.

  PYTHONPATH=src python -m repro_torch.launch.topology_compare \\
      [--nodes 64] [--steps 3000] [--tops parallel,one_peer_exp,ring] \\
      [--optimizer dmsgd] [--overlap] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import csv
import os

import torch

from ..benchmarks.bench_transient import _grads, _problem, index_stream
from ..core import optim, topology
from ..core.plan import GossipPlan
from ..device import resolve_device

__all__ = ["run", "main"]

M_SAMPLES = 2000


def run(topname, n, h, y, x_star, T, lr0, beta=0.8, seed=1,
        optimizer="dmsgd", overlap=False) -> list:
    """``[(step, MSE)]`` every 25 steps of ``optimizer`` over ``topname``
    (``"parallel"``: parallel momentum SGD); ``overlap`` pipelines the
    gossip and measures the flushed iterates."""
    d = h.shape[-1]
    if topname == "parallel":
        opt = optim.parallel_msgd(n, beta=beta)
    else:
        opt = optim.make_optimizer(optimizer,
                                   topology.get_topology(topname, n),
                                   beta=beta, overlap=overlap)
    if opt.overlap:
        def step_fn(io, p, s, g, lr):
            return opt.update_pipelined(p, s, g, lr, io)
    else:
        def step_fn(mix, p, s, g, lr):
            return opt.update_with_mix(p, s, g, lr, mix)
    plan = GossipPlan.for_optimizer(opt, fn=step_fn)
    draw_idx = index_stream(n, h.shape[1], h.device, seed)
    params = {"x": torch.zeros((n, d), device=h.device)}
    state = opt.init(params)
    curve = []
    for k in range(T):
        g = {"x": _grads(h, y, params["x"], draw_idx(k))}
        lr = lr0 * (0.5 ** (k // 1000))
        params, state = plan.step_fn(k)(params, state, g, lr)
        if k % 25 == 0:
            # flush is pure: the mixed view, the in-flight buffer kept
            ev, _ = plan.flush_step_fn(k + 1)(params, state)
            curve.append((k, torch.mean(torch.sum((ev["x"] - x_star)
                                                  ** 2, -1))))
    return [(k, float(m)) for k, m in curve]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--optimizer", default="dmsgd",
                    choices=sorted(optim.OPTIMIZERS),
                    help="decentralized optimizer for the non-parallel runs")
    ap.add_argument(
        "--tops", default="parallel,one_peer_exp,static_exp,grid,ring",
        help="comma-separated topologies to compare; 'parallel' is the "
             "all-reduce baseline; base_k and ceca are the finite-time "
             "families")
    ap.add_argument("--overlap", action="store_true",
                    help="one-step-delayed (overlapped) gossip: the mix "
                         "of step k's payload lands at step k+1; curves "
                         "measure the flushed (mixed) iterates")
    ap.add_argument("--out", default="results/topology_compare.csv")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # AdamW takes normalized steps: a much smaller peak rate than momentum
    # SGD's 0.2 (the "parallel" baseline keeps the mSGD rate)
    lr0 = 0.02 if args.optimizer == "d_adamw" else 0.2
    h, y, x_star = (torch.from_numpy(a).to(dev)
                    for a in _problem(args.nodes, d=10, M=M_SAMPLES))
    tops = [t.strip() for t in args.tops.split(",") if t.strip()]
    curves = {t: run(t, args.nodes, h, y, x_star, args.steps,
                     lr0=0.2 if t == "parallel" else lr0,
                     optimizer=args.optimizer,
                     overlap=args.overlap and t != "parallel")
              for t in tops}

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["step"] + tops)
        for row in zip(*(curves[t] for t in tops)):
            w.writerow([row[0][0]] + [f"{m:.6e}" for _, m in row])

    print(f"wrote {args.out}")
    print(f"{'topology':>14s}  final MSE")
    finals = {t: curves[t][-1][1] for t in tops}
    for t in tops:
        print(f"{t:>14s}  {finals[t]:.4e}")
    if {"one_peer_exp", "static_exp", "ring"} <= finals.keys():
        ok = (finals["one_peer_exp"] <= finals["ring"] + 1e-6
              and finals["static_exp"] <= finals["ring"] + 1e-6)
        print("exp graphs beat ring:", ok)
    return curves


if __name__ == "__main__":
    main()
