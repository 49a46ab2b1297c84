"""Where the training path's time goes on the card.

Trains ``--arch`` (qwen3-0.6b by default) at full width with its depth
cut (``--layers``, 8 by default: the 28-layer 4-node state does not fit
in 80 GB) on ``--nodes`` stacked nodes with ``--optimizer`` (dmsgd) over
``--topology`` (the one-peer exponential graph), as ``chip_smoke.py``
phase 6 does (phase 9: ``--arch mamba2-1.3b --layers 4 --optimizer
d_adamw --topology random_match``; phase 12: ``--arch
granite-moe-3b-a800m --layers 2``, the experts by capacity dispatch;
phase 13: ``--arch musicgen-large --layers 4``, 4-code frames),
and traces a steady window of steps
with ``torch.profiler``.  Prints the first steps' times (the warm-up), the
untraced step time, then for the traced window the host and device time
per step, the device's idle share, the kernels that take the most device
time, and two ranges: the optimizer update (momentum, descent and the
gossip) and, inside it, the gossip (pack, roll or gather, K1, unpack); the
per-node gradients are the rest of the step.  ``--compression int8``
sends the payload as int8.  ``--overlap`` trains the one-step-delayed
pipeline: the gossip range is then the delayed round (roll or gather, the
combine, unpack), started on a side stream before the backward, and the
untraced window also prints, from CUDA events on both streams, the
delayed round's device time and how much of it ran while the gradients
ran.

  PYTHONPATH=src python -m repro_torch.launch.profile_train [--steps 3] \\
      [--overlap] [--compression int8]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .. import configs
from ..core import optim as optim_mod
from ..core import topology as topo_mod
from ..core.plan import GossipPlan, OverlapIO
from ..data import SyntheticLM
from ..device import resolve_device
from ..models import model as M
from . import steps as steps_mod
from .profile_serve import report
from .train import stack_nodes

UPDATE = "optimizer update (incl. gossip)"
GOSSIP = "gossip: pack, roll or gather, gossip_mix, unpack"


class _TracedOptimizer:
    """The optimizer with its update inside one profiler range."""

    def __init__(self, opt):
        self.opt = opt

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def update_with_mix(self, *args, **kw):
        with record_function(UPDATE):
            return self.opt.update_with_mix(*args, **kw)

    def update_pipelined(self, *args, **kw):
        with record_function(UPDATE):
            return self.opt.update_pipelined(*args, **kw)


class _TracedIO:
    """An OverlapIO whose delayed round runs inside the gossip range."""

    def __init__(self, io):
        self.io = io

    def __getattr__(self, name):
        return getattr(self.io, name)

    def start(self, *args):
        with record_function(GOSSIP):
            return self.io.start(*args)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--optimizer", default="dmsgd")
    ap.add_argument("--topology", default="one_peer_exp",
                    choices=sorted(topo_mod.TOPOLOGIES))
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--compression", default=None, choices=["int8"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("profile_train measures the card: run it on one")

    cfg = dataclasses.replace(configs.get_config(args.arch),
                              n_layers=args.layers)
    n = args.nodes
    opt = optim_mod.make_optimizer(
        args.optimizer, topo_mod.get_topology(args.topology, n), beta=0.9,
        compression=args.compression, overlap=args.overlap)
    timeline: list = []
    step_fn = steps_mod.make_train_step(cfg, _TracedOptimizer(opt),
                                        timeline=timeline)

    def traced_step(mix, *a):
        if isinstance(mix, OverlapIO):
            return step_fn(_TracedIO(mix), *a)

        def traced_mix(tree):
            with record_function(GOSSIP):
                return mix(tree)
        return step_fn(traced_mix, *a)

    plan = GossipPlan.for_optimizer(opt, fn=traced_step)
    params = M.init(cfg, args.seed, device=dev)
    stacked = stack_nodes(params, n)
    state = opt.init(stacked)
    data = SyntheticLM(cfg.vocab_size, n, hetero=0.5, seed=args.seed)
    total = 3 + 2 * args.steps
    n_codebooks = cfg.n_codebooks if cfg.family == "audio" else 0
    batches = [{"tokens": torch.from_numpy(data.sample(
        k, args.batch, args.seq, n_codebooks))} for k in range(total)]
    k = 0

    def step():
        nonlocal stacked, state, k
        stacked, state, _ = plan.step_fn(k)(stacked, state, batches[k], 0.01)
        k += 1

    for _ in range(3):                    # warm-up, timed one by one
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        print(f"warm-up step {k - 1}: {(time.perf_counter() - t0) * 1e3:.3f}"
              f" ms")
    timeline.clear()
    t0 = time.perf_counter()              # the same window, untraced
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    what = (f"{args.optimizer}" + (" overlapped" if args.overlap else "")
            + (" int8" if args.compression else ""))
    print(f"train step ({args.arch}, {what} over "
          f"{args.topology}, {n} nodes x {args.batch} x {args.seq} tokens, "
          f"{args.layers} layers), untraced: host "
          f"{(time.perf_counter() - t0) * 1e3 / args.steps:.3f} ms/step")
    for marks in timeline:
        ms, under = steps_mod.overlap_ms(marks)
        print(f"delayed round (side stream): {ms:.3f} ms device, of which "
              f"{under:.3f} ms ({100 * under / ms:.1f} %) while the "
              "gradients ran")
    timeline.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report("train step", prof, wall, args.steps, args.top)
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation)
    for key in (UPDATE, GOSSIP):
        # the range's host row, and its device row (the span of its kernels)
        host = [e.cpu_time_total for e in events
                if e.key == key and e.device_type ==
                torch.autograd.DeviceType.CPU]
        dev = [e.device_time_total for e in events
               if e.key == key and e.is_user_annotation and e.device_type ==
               torch.autograd.DeviceType.CUDA]
        print(f"{key}: host {sum(host) / 1e3 / args.steps:.3f} ms/step, "
              f"device {sum(dev) / 1e3 / args.steps:.3f} ms/step "
              f"({100 * sum(dev) / device_us:.1f} % of the step's device "
              "time)")


if __name__ == "__main__":
    main()
