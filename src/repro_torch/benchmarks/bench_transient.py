"""Paper Fig. 1 / Fig. 13 (App. D.5): transient iterations of DmSGD by
topology on distributed logistic regression, n = 32.

The port of the JAX package's ``benchmarks/bench_transient.py``: DmSGD
runs on the device through the port's optimizer (the static Shifts
rounds of one_peer_exp, static_exp and ring combine in the gossip_mix
kernel on the card).  The problem data are the reference's numpy draws,
bit for bit; the minibatch indices, which the reference draws from
``jax.random``, come from a ``torch.Generator`` on the device seeded with
the reference's seed (``draw_idx`` injects any other stream).

Derived: the area between each topology's log-MSE curve and parallel
SGD's (the transient-phase penalty, Fig. 1's shaded gap) and the final
MSE.  Expected ordering (Table 1): exp graphs ~ parallel << grid << ring.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..core import optim, topology
from ..device import resolve_device
from .common import emit

TOPS = ["parallel", "one_peer_exp", "static_exp", "grid", "ring"]


def _problem(n, d, M, seed=0):
    """Per-node logistic data (App. D.5) and the global optimum by Newton
    iterations, as float32 numpy arrays (the reference's values)."""
    rng = np.random.default_rng(seed)
    h = rng.normal(0, np.sqrt(10), size=(n, M, d)).astype(np.float32)
    y = np.empty((n, M), np.float32)
    for i in range(n):
        x_star = rng.standard_normal(d)
        x_star /= np.linalg.norm(x_star)
        p = 1 / (1 + np.exp(-h[i] @ x_star))
        y[i] = np.where(rng.random(M) <= p, 1.0, -1.0)
    X, Y = h.reshape(-1, d), y.reshape(-1)
    w = np.zeros(d)
    for _ in range(100):
        z = X @ w * Y
        s = 1 / (1 + np.exp(z))
        g = -(X * (Y * s)[:, None]).mean(0)
        H = (X.T * (s * (1 - s))) @ X / len(Y) + 1e-9 * np.eye(d)
        w -= np.linalg.solve(H, g)
    return h, y, w.astype(np.float32)


def _grads(h, y, xs, idx, batch=8):
    """Minibatch logistic-loss gradients per node; ``idx`` (n, batch)."""
    hb = torch.take_along_dim(h, idx[:, :, None], 1)
    yb = torch.take_along_dim(y, idx, 1)
    z = torch.einsum("nbd,nd->nb", hb, xs) * yb
    return -torch.einsum("nb,nbd->nd", yb * torch.sigmoid(-z), hb) / batch


def index_stream(n, M, device, seed=1, batch=8):
    """The default minibatch draws: ``k -> (n, batch)`` indices from a
    device generator seeded as the reference seeds its key."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return lambda k: torch.randint(0, M, (n, batch), generator=gen,
                                   device=device)


def curve(topname, n, h, y, x_star, T, draw_idx) -> list:
    """MSE to ``x_star`` every 25 steps of DmSGD (beta 0.8) over
    ``topname`` (``"parallel"``: parallel momentum SGD)."""
    d = h.shape[-1]
    opt = (optim.parallel_msgd(n, beta=0.8) if topname == "parallel" else
           optim.make_optimizer("dmsgd", topology.get_topology(topname, n),
                                beta=0.8))
    params = {"x": torch.zeros((n, d), device=h.device)}
    state = opt.init(params)
    mses = []
    for k in range(T):
        g = {"x": _grads(h, y, params["x"], draw_idx(k))}
        lr = 0.2 * (0.5 ** (k // 600))
        params, state = opt.update(params, state, g, k, lr)
        if k % 25 == 0:
            mses.append(torch.mean(torch.sum((params["x"] - x_star) ** 2,
                                             -1)))
    return torch.stack(mses).cpu().tolist()


def run(n: int = 32, T: int = 1500, device="cuda") -> None:
    dev = resolve_device(device)
    M = 1000
    h, y, x_star = (torch.from_numpy(a).to(dev)
                    for a in _problem(n, d=10, M=M))
    curves = {}
    t0 = time.perf_counter()
    for topname in TOPS:
        curves[topname] = curve(topname, n, h, y, x_star, T,
                                index_stream(n, M, dev))
    us = 1e6 * (time.perf_counter() - t0) / len(curves)

    # transient-phase penalty: area between each topology's MSE curve and
    # the parallel-SGD curve (log-domain, clipped at 0)
    par = curves["parallel"]

    def area(c):
        return sum(max(0.0, math.log(m) - math.log(p))
                   for m, p in zip(c, par))

    finals = {t: c[-1] for t, c in curves.items()}
    areas = {t: area(c) for t, c in curves.items()}
    order_ok = (areas["one_peer_exp"] < areas["grid"] < areas["ring"]
                and areas["static_exp"] < areas["ring"]
                and finals["one_peer_exp"] < finals["ring"])
    emit("transient_fig13", us,
         ";".join(f"{t}_area={areas[t]:.2f}" for t in curves)
         + f";exp<grid<ring={order_ok}")
    emit("transient_final_mse", us,
         ";".join(f"{t}={finals[t]:.3e}" for t in curves))
