"""Paper Fig. 4 / 10 / 11: consensus-residue decay per topology.

The port of the JAX package's ``benchmarks/bench_consensus.py`` (host
math; the same rows).  One-peer exp hits EXACTLY zero at tau = log2(n)
steps (Lemma 1); static exp and random match decay only geometrically;
non-power-of-two n and uniform sampling lose periodic exactness
(Remarks 4/5); the finite-time families average exactly in one period.
"""
from __future__ import annotations

import math
import time

from ..core import spectral, topology
from .common import emit


def residues(n: int = 32) -> dict:
    """Each row's ||(prod W - J) x|| over 3 log2(n) steps."""
    steps = 3 * int(math.log2(n))
    tops = {
        "one_peer_exp": topology.one_peer_exponential(n),
        "static_exp": topology.static_exponential(n),
        "random_match": topology.bipartite_random_match(n, seed=2),
        "one_peer_perm": topology.one_peer_exponential(
            n, schedule="random_perm"),
        "one_peer_unif": topology.one_peer_exponential(n, schedule="uniform"),
        "one_peer_n6": topology.one_peer_exponential(48),
        "base_k2": topology.base_k(n, 1),
        "base_k4": topology.base_k(n, 3),
        "ceca": topology.ceca(n),
        "ceca_n48": topology.ceca(48),
    }
    return {k: spectral.consensus_residue_products(t, steps)
            for k, t in tops.items()}


def run(n: int = 32) -> None:
    tau = int(math.log2(n))
    t0 = time.perf_counter()
    res = residues(n)
    us = 1e6 * (time.perf_counter() - t0) / len(res)
    emit("consensus_fig4", us,
         f"one_peer_zero_at_tau={res['one_peer_exp'][tau-1] < 1e-12};"
         f"static_nonzero={res['static_exp'][tau-1] > 1e-9};"
         f"perm_zero={res['one_peer_perm'][tau-1] < 1e-12};"
         f"unif_not_periodic={res['one_peer_unif'][tau-1] > 1e-12};"
         f"n48_not_periodic={res['one_peer_n6'][2*6-1] > 1e-12}")
    emit("consensus_finite_time", us,
         f"base_k2_zero_at_{topology.base_k(n, 1).period}="
         f"{res['base_k2'][topology.base_k(n, 1).period - 1] < 1e-12};"
         f"base_k4_zero_at_{topology.base_k(n, 3).period}="
         f"{res['base_k4'][topology.base_k(n, 3).period - 1] < 1e-12};"
         f"ceca_zero_at_{topology.ceca(n).period}="
         f"{res['ceca'][topology.ceca(n).period - 1] < 1e-12};"
         f"ceca_n48_zero_at_{topology.ceca(48).period}="
         f"{res['ceca_n48'][topology.ceca(48).period - 1] < 1e-12}")
    for k, v in res.items():
        emit(f"consensus_{k}", us,
             ";".join(f"k{i}={x:.2e}" for i, x in enumerate(v[:2 * tau])))
