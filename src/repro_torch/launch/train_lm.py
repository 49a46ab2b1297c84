"""End-to-end example: train a ~100M-param decoder LM with decentralized
momentum SGD over the one-peer exponential graph for a few hundred steps.

The port of the JAX package's ``examples/train_lm.py``: the same presets,
config, loop and CLI, plus ``--device`` (the card by default; ``--device
cpu`` runs the plain PyTorch path).  It runs BOTH one-peer and static
exponential graphs (+ optionally parallel SGD) with identical data and
seed and reports the loss curves side by side -- the Remark 7 claim
(one-peer converges like static) at LM scale.

Each topology trains through :func:`repro_torch.launch.train.build_trainer`
(DmSGD, or parallel mSGD for ``parallel``): the n nodes stacked on the
leading axis of every tensor on one device, the per-node gradients a loop
over the nodes with the plain attention (as the JAX train path), and one
gossip a step whose combine is the ``gossip_mix`` kernel on the card (the
degree-1 fast path for one-peer, the degree-3 table kernel for static
exponential at n 8).  Every step's batch is sampled before the loop (the
bigram sampler is host work that grows with the vocabulary: ~0.8 s a step
at the 100m preset's 32,768 tokens and 8 nodes), once for all topologies,
and each step is timed on the host clock up to a device synchronisation.

  PYTHONPATH=src python -m repro_torch.launch.train_lm --preset 100m \\
      --nodes 8 --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu \\
      --preset small --steps 20
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time

import numpy as np
import torch

from ..core import schedule, topology
from ..data import SyntheticLM
from ..device import resolve_device
from ..models import model as M
from ..models.model import ModelConfig
from .train import build_trainer, stack_nodes

__all__ = ["PRESETS", "make_cfg", "param_count", "train_one", "main"]

PRESETS = {
    # ~10M params: CPU-friendly
    "small": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                  head_dim=64, d_ff=1024, vocab_size=8192),
    # ~35M
    "medium": dict(n_layers=8, d_model=384, n_heads=6, n_kv_heads=2,
                   head_dim=64, d_ff=1536, vocab_size=16384),
    # ~110M params (GPT-2-small class): a few hundred steps on real HW
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 head_dim=64, d_ff=3072, vocab_size=32768),
}


def make_cfg(preset: str) -> ModelConfig:
    return ModelConfig(name=f"lm-{preset}", family="dense",
                       qk_norm=True, tie_embeddings=True, remat=False,
                       **PRESETS[preset])


def param_count(cfg: ModelConfig) -> int:
    """Parameters of one node's model (built on the CPU, uninitialised:
    nothing is drawn)."""
    return M.param_count(M.Model(cfg, device="cpu"))


@functools.lru_cache(maxsize=2)
def _batches(vocab: int, nodes: int, hetero: float, seed: int, steps: int,
             batch: int, seq: int) -> tuple:
    """Every step's tokens, (nodes, batch, seq) int32 numpy each."""
    data = SyntheticLM(vocab, nodes, hetero=hetero, seed=seed)
    return tuple(data.sample(k, batch, seq) for k in range(steps))


def train_one(cfg, topname, *, nodes, steps, batch, seq, lr0, hetero, seed,
              device="cuda") -> dict:
    """Train ``cfg`` over ``topname`` (``"parallel"``: parallel momentum
    SGD) as the reference's ``train_one`` does.  Returns ``curve`` (the
    reference's ``[(step, loss)]`` every 10 steps and at the last),
    ``losses`` (every step), ``step_s`` (every step's seconds), the plan's
    ``num_compiled``, the ``distinct`` realizations it met and, on the
    card, ``peak_bytes`` allocated during the run (None on the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    top = (topology.full_averaging(nodes) if topname == "parallel"
           else topology.get_topology(topname, nodes))
    # build_trainer wires optimizer + train step into a GossipPlan, whose
    # realization-keyed cache works for aperiodic schedules too
    opt, step_for = build_trainer(
        cfg, top, "parallel_msgd" if topname == "parallel" else "dmsgd", 0.9)
    stacked = stack_nodes(M.init(cfg, seed, device=dev), nodes)
    state = opt.init(stacked)
    tokens = _batches(cfg.vocab_size, nodes, hetero, seed, steps, batch, seq)
    lr_fn = schedule.warmup_step_decay(lr0, max(steps // 20, 1),
                                       [int(steps * 0.7)])
    curve, losses, step_s = [], [], []
    t0 = time.time()
    for k in range(steps):
        bt = {"tokens": torch.from_numpy(tokens[k])}
        t = time.perf_counter()
        stacked, state, loss = step_for(k)(stacked, state, bt, lr_fn(k))
        losses.append(float(loss))          # waits for the step
        step_s.append(time.perf_counter() - t)
        if k % 10 == 0 or k == steps - 1:
            curve.append((k, losses[-1]))
            print(f"  [{topname}] step {k:4d} loss {losses[-1]:.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    plan = step_for.plan
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    return {"curve": curve, "losses": losses, "step_s": step_s,
            "num_compiled": plan.num_compiled,
            "distinct": len({plan.realization_key(k) for k in range(steps)}),
            "peak_bytes": peak}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=list(PRESETS))
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--hetero", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--with-parallel", action="store_true")
    ap.add_argument("--tops", default="one_peer_exp,static_exp",
                    help="comma-separated topologies (any repro_torch.core."
                         "topology family, incl. the finite-time base_k / "
                         "ceca graphs and matching families like "
                         "one_peer_hypercube / random_match)")
    ap.add_argument("--out", default="results/train_lm.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    resolve_device(args.device)
    cfg = make_cfg(args.preset)
    n_params = param_count(cfg)
    print(f"model: {cfg.name}  params={n_params/1e6:.1f}M  nodes={args.nodes}")

    tops = [t.strip() for t in args.tops.split(",") if t.strip()] + (
        ["parallel"] if args.with_parallel else [])
    runs = {}
    for t in tops:
        print(f"== training with {t} ==")
        runs[t] = train_one(cfg, t, nodes=args.nodes, steps=args.steps,
                            batch=args.batch, seq=args.seq, lr0=args.lr,
                            hetero=args.hetero, seed=args.seed,
                            device=args.device)
    results = {t: r["curve"] for t, r in runs.items()}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"params_M": n_params / 1e6, "curves": results,
                   "args": vars(args)}, f, indent=1)
    print(f"\nwrote {args.out}")
    for t, r in runs.items():
        ms = 1e3 * float(np.median(r["step_s"][1:] or r["step_s"]))
        peak = ("" if r["peak_bytes"] is None
                else f"; peak allocated {r['peak_bytes'] / 1e9:.3f} GB")
        print(f"  [{t}] median step {ms:.1f} ms; {r['num_compiled']} "
              f"executables for {r['distinct']} distinct realizations{peak}")
    print("final losses:", {t: c[-1][1] for t, c in results.items()})
    if {"one_peer_exp", "static_exp"} <= results.keys():
        op, se = results["one_peer_exp"][-1][1], results["static_exp"][-1][1]
        print(f"one-peer vs static final-loss gap: {abs(op - se):.4f} "
              "(Remark 7: should be small)")
    return runs


if __name__ == "__main__":
    main()
