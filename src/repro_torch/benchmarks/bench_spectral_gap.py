"""Paper Fig. 3 + Table 5: spectral gaps of topologies vs network size.

The port of the JAX package's ``benchmarks/bench_spectral_gap.py`` (host
math over the port's topologies).  Validates Proposition 1 (the static
exponential graph's gap is 2/(1+ceil(log2 n)) for even n) and the
Table-5 orderings; the derived column reports the max abs deviation of
the measured gap from the closed form.
"""
from __future__ import annotations

import time

from ..core import spectral, topology
from .common import emit

SIZES = [4, 8, 16, 32, 64, 128, 256]


def run() -> None:
    sizes = SIZES
    t0 = time.perf_counter()
    rows = {}
    for name in ["ring", "grid", "torus", "static_exp", "hypercube"]:
        gaps = []
        for n in sizes:
            if name == "hypercube" and (n & (n - 1)):
                gaps.append(float("nan"))
                continue
            gaps.append(spectral.spectral_gap(
                topology.get_topology(name, n).weights(0)))
        rows[name] = gaps
    us = 1e6 * (time.perf_counter() - t0) / (len(sizes) * len(rows))

    dev = max(abs(spectral.spectral_gap(
        topology.static_exponential(n).weights(0))
        - spectral.static_exp_gap_closed_form(n))
        for n in sizes)
    order_ok = all(rows["static_exp"][i] > rows["grid"][i] > rows["ring"][i]
                   for i in range(2, len(sizes)))
    emit("spectral_gap_fig3", us,
         f"prop1_max_dev={dev:.2e};exp>grid>ring={order_ok}")
    for name, gaps in rows.items():
        emit(f"spectral_gap_{name}", us,
             ";".join(f"n{n}={g:.4f}" for n, g in zip(sizes, gaps)))

    # finite-time families have no single-matrix gap; their figure of
    # merit is steps-to-exact-average (the "effective gap" is 1 per period)
    for name, make in [("one_peer_exp", topology.one_peer_exponential),
                       ("base_k2", lambda n: topology.base_k(n, 1)),
                       ("ceca", topology.ceca)]:
        periods = []
        for n in sizes:
            try:
                periods.append(make(n).period)
            except ValueError:
                periods.append(None)   # n not factorizable at this degree
        emit(f"finite_time_period_{name}", us,
             ";".join(f"n{n}={p}" for n, p in zip(sizes, periods)))
