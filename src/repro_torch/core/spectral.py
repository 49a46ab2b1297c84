"""Spectral analysis of gossip weight matrices (numpy only).

A copy of the JAX package's ``core/spectral.py``:
  * rho(W): second-largest eigenvalue magnitude (NOT the spectral radius;
    W may be non-symmetric with complex eigenvalues), and the gap 1 - rho.
  * Proposition 1's closed form of the static exponential graph's gap.
  * ||W - J||_2 and consensus-residue operator products (Lemma 1 / eq. 9).
  * eq. (4)'s transient-iteration scaling.
"""
from __future__ import annotations

import math

import numpy as np

from .topology import Topology

__all__ = ["rho", "spectral_gap", "static_exp_gap_closed_form",
           "residual_norm", "consensus_residue_products",
           "transient_iterations"]


def rho(W: np.ndarray) -> float:
    """Second largest eigenvalue magnitude of a doubly-stochastic W."""
    eigs = np.linalg.eigvals(W)
    # Remove one eigenvalue (numerically) equal to 1.
    idx = int(np.argmin(np.abs(eigs - 1.0)))
    rest = np.delete(eigs, idx)
    if rest.size == 0:
        return 0.0
    return float(np.max(np.abs(rest)))


def spectral_gap(W: np.ndarray) -> float:
    return 1.0 - rho(W)


def static_exp_gap_closed_form(n: int) -> float:
    """Proposition 1: 1 - rho = 2 / (1 + ceil(log2 n)) (equality for even n)."""
    if n == 1:
        return 1.0
    return 2.0 / (1.0 + math.ceil(math.log2(n)))


def residual_norm(W: np.ndarray) -> float:
    """||W - (1/n) 1 1^T||_2 (matrix 2-norm)."""
    n = W.shape[0]
    return float(np.linalg.norm(W - np.ones((n, n)) / n, ord=2))


def consensus_residue_products(top: Topology, steps: int,
                               x: np.ndarray | None = None,
                               seed: int = 0) -> np.ndarray:
    """||(prod_{l=0}^{k} W^(l) - (1/n)11^T) x|| for k = 0..steps-1 (Fig. 4).

    With the one-peer exponential graph and n = 2^tau this hits exactly 0 at
    k >= tau - 1 (Lemma 1).
    """
    n = top.n
    if x is None:
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((n, 4))
    J = np.ones((n, n)) / n
    P = np.eye(n)
    out = np.empty(steps)
    for k in range(steps):
        P = top.weights(k) @ P
        out[k] = np.linalg.norm((P - J) @ x)
    return out


def transient_iterations(n: int, gap: float,
                         heterogeneous: bool = False) -> float:
    """Eq. (4): T = n^3/(1-rho)^2 (homogeneous) or n^3/(1-rho)^4 (hetero)."""
    p = 4 if heterogeneous else 2
    return n ** 3 / max(gap, 1e-300) ** p
