"""Learning-rate schedules (the paper's training protocol, Sec. 6.1/6.2).

The JAX package's ``core/schedule.py`` with plain Python floats in place of
traced scalars: warmup over the first ``warmup_steps`` then step decay by
``decay_factor`` at each milestone, plus the linear scaling rule, and the
theory-side rate gamma = sqrt(n (1-beta)^3 / T) (Corollary 1 / Theorem 1).

Gossip: with a data-dependent skip (``transforms.gossip(when=...)``) the
topology's schedule position lives in optimizer state
(``OptState.sched_pos``, a 0-d int32 tensor on the host) and advances
only on rounds that COMMUNICATE (:func:`advance_position`), so a
finite-time family still averages exactly once ``period`` communicating
rounds complete, however many skipped rounds interleave.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["warmup_step_decay", "theory_lr", "constant",
           "initial_position", "advance_position"]


def initial_position() -> torch.Tensor:
    """The gossip schedule's starting position (optimizer state)."""
    return torch.zeros((), dtype=torch.int32)


def advance_position(pos: torch.Tensor, gate=None) -> torch.Tensor:
    """``pos_next = pos + gate``: the schedule advances ONLY on rounds that
    communicate (``gate`` a bool scalar; None = always communicated, the
    static ``every=1`` behaviour).  The position stays on the host."""
    if gate is None:
        return pos + torch.ones((), dtype=pos.dtype)
    gate = torch.as_tensor(gate).to(device=pos.device, dtype=pos.dtype)
    return pos + gate


def constant(lr: float) -> Callable[[int], float]:
    return lambda step: float(np.float32(lr))


def warmup_step_decay(base_lr: float, warmup_steps: int,
                      milestones: Sequence[int], decay_factor: float = 0.1,
                      scale: float = 1.0) -> Callable[[int], float]:
    """Linear warmup then piecewise-constant decay. ``scale`` implements the
    linear scaling rule (scale = n for n nodes).  Evaluated in float32, as
    the reference's traced schedule is, and returned as a Python float."""
    peak = np.float32(base_lr * scale)
    ms = sorted(int(m) for m in milestones)

    def fn(step: int) -> float:
        s = np.float32(step)
        warm = peak * min(np.float32(1.0),
                          (s + np.float32(1.0))
                          / np.float32(max(warmup_steps, 1)))
        n_decays = sum(1 for m in ms if s >= m)
        return float(warm * (np.float32(decay_factor)
                             ** np.float32(n_decays)))

    return fn


def theory_lr(n: int, T: int, beta: float = 0.9) -> float:
    """gamma = sqrt(n (1-beta)^3) / sqrt(T)  (Corollary 1 / Theorem 1)."""
    return math.sqrt(n * (1 - beta) ** 3) / math.sqrt(max(T, 1))
