"""Quickstart: decentralized momentum SGD over a one-peer exponential graph.

The port of the JAX package's ``examples/quickstart.py``.  Trains the
reduced qwen3 decoder on 8 decentralized nodes, each with its own data
shard, exchanging (params, momentum) with ONE peer per step (Algorithm 1
of the paper).  Prints loss and consensus distance, then checks the
Lemma-1 exact-averaging property on the live parameter tree.  Runs on the
card by default; ``--device cpu`` runs the plain path.

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--steps N] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import math

import torch

from .. import configs
from ..core import optim, topology
from ..core.plan import GossipPlan
from ..data import SyntheticLM
from ..device import resolve_device
from ..models import model as M
from . import steps as steps_mod
from .train import consensus_distance, stack_nodes

N_NODES = 8
STEPS = 60


def main(steps: int = STEPS, device="cuda") -> dict:
    """Returns the per-step losses, the Lemma-1 deviation and the number of
    executables the plan built."""
    device = resolve_device(device)
    # 1) A reduced qwen3-family config (2 layers, d_model 256) -- same code
    #    path as the full 0.6B model.
    cfg = configs.reduced_config(configs.get_config("qwen3-0.6b"))
    params = M.init(cfg, 0, device=device)
    stacked = stack_nodes(params, N_NODES)

    # 2) One-peer exponential graph + DmSGD (Algorithm 1) through a
    #    GossipPlan: one executable per distinct gossip realization.
    top = topology.one_peer_exponential(N_NODES)
    opt = optim.dmsgd(top, beta=0.9)
    state = opt.init(stacked)
    plan = GossipPlan.for_optimizer(opt, fn=steps_mod.make_train_step(cfg, opt))

    # 3) Heterogeneous per-node data (Assumption A.3 with b > 0).
    data = SyntheticLM(cfg.vocab_size, N_NODES, hetero=0.5, seed=0)

    losses = []
    for step in range(steps):
        batch = {"tokens": torch.from_numpy(data.sample(step, 2, 32))}
        stacked, state, loss = plan.step_fn(step)(stacked, state, batch, 0.02)
        losses.append(float(loss))
        if step % 10 == 0:
            cd = consensus_distance(stacked)
            print(f"step {step:3d}  loss {losses[-1]:.4f}  consensus {cd:.3e}")
    print(f"(built {plan.num_compiled} executables for "
          f"{top.period} gossip realizations)")

    # 4) Lemma 1 live: tau consecutive one-peer gossips == exact averaging.
    tau = int(math.log2(N_NODES))
    mixed = stacked
    for k in range(tau):
        mixed = plan.mix(k)(mixed)
    err = max(float((v.float() - v.float().mean(0)).abs().max())
              for v in mixed.values())
    print(f"\nLemma 1 check: after tau={tau} one-peer gossips, max deviation "
          f"from the exact average = {err:.2e} (should be ~0)")
    return {"losses": losses, "lemma1_err": err,
            "num_compiled": plan.num_compiled}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.steps, a.device)
