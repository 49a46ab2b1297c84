"""Learning-rate schedules (the paper's training protocol, Sec. 6.1/6.2).

The JAX package's ``core/schedule.py`` with plain Python floats in place of
traced scalars: warmup over the first ``warmup_steps`` then step decay by
``decay_factor`` at each milestone, plus the linear scaling rule, and the
theory-side rate gamma = sqrt(n (1-beta)^3 / T) (Corollary 1 / Theorem 1).
The traced gossip schedule position (``initial_position`` /
``advance_position``) is ROADMAP slice C.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

__all__ = ["warmup_step_decay", "theory_lr", "constant"]


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
