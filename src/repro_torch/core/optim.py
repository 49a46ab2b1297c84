"""Decentralized optimizers as one-line compositions of transforms.

The port of the JAX package's ``core/optim.py``.  Every optimizer is a
:func:`repro_torch.core.transforms.chain`; the schedule machinery (which
``W^{(k)}`` to apply, the warm-up phase, executable caching) lives in
:class:`repro_torch.core.plan.GossipPlan`.  Iterates are
``dict[str, Tensor]`` trees whose leaves carry a leading node axis.

* ``dmsgd``         -- Algorithm 1 (the Yu-Jin-Yang variant the paper uses):
                         m^{k+1} = W^{(k)} (beta m^k + g^k)
                         x^{k+1} = W^{(k)} (x^k - gamma m^k)
                       One ``gossip(where=("m_next", "x_next"))`` mixes both
                       with the same W^{(k)}: one flat f32 buffer per step.
* ``dsgd``          -- DmSGD with beta = 0 (Remark 8).
* ``vanilla_dmsgd`` -- momentum is NOT exchanged (only ``x_next`` is
                       gossiped; descent uses the freshly traced momentum).
* ``qg_dmsgd``      -- quasi-global momentum: no momentum gossip; the
                       buffer EMAs the quasi-global displacement AFTER the
                       ``x_next`` mix.
* ``parallel_msgd`` -- global averaging baseline: ``average_gradients()``,
                       the paper's averaged-recursion convention.
* ``d_adamw``       -- decentralized AdamW: both moments gossiped WITH the
                       params, three f32 trees in one payload -- one flat
                       buffer, one combine per step.

Every gossiping optimizer takes ``compression="int8"`` (the
:func:`~repro_torch.core.transforms.quantize_int8` marker) and
``overlap=True`` (the one-step-delayed pipeline), as in the reference;
:func:`chain` refuses what the reference refuses (qg_dmsgd's overlap,
int8 or overlap with a runtime hook) with a ``ValueError``.  ``dmsgd``
and ``dsgd`` take the runtime-valued gossip hooks, fed by ``update(...,
aux=...)``: ``loss_aware`` (AL-DSGD weights from the per-node losses),
``deadline`` (per-node straggler gating from ``aux["alive"]``) and
``when=`` (a data-dependent whole-round skip).
"""
from __future__ import annotations

import dataclasses

from .topology import Topology, full_averaging
from .transforms import (
    DecentralizedOptimizer,
    OptState,
    adam_descent,
    al_dsgd,
    average_gradients,
    chain,
    deadline_skip,
    gossip,
    quantize_int8,
    quasi_global_momentum,
    scale_by_lr,
    trace_adam_moments,
    trace_momentum,
)

__all__ = [
    "OptState",
    "DecentralizedOptimizer",
    "dmsgd",
    "dsgd",
    "vanilla_dmsgd",
    "qg_dmsgd",
    "parallel_msgd",
    "d_adamw",
    "make_optimizer",
    "OPTIMIZERS",
]


def dmsgd(topology: Topology, beta: float = 0.9, *, momentum_dtype=None,
          compression: str | None = None, overlap: bool = False,
          loss_aware: bool | float = False, deadline: bool = False,
          when=None) -> DecentralizedOptimizer:
    """Algorithm 1 (the paper's DmSGD); fused single-payload gossip.

    Runtime-valued variants (feed ``aux=`` to ``update``):
    ``loss_aware=True`` (or a float ``pull``) binds the AL-DSGD
    adjacent-leader rule; ``deadline=True`` prepends :func:`deadline_skip`
    (nodes whose ``aux['alive']`` is False drop out of the round);
    ``when=`` (``ctx -> bool``) makes whole-round skips data-dependent,
    the schedule position riding optimizer state."""
    rule = None
    if loss_aware:
        rule = al_dsgd() if loss_aware is True else al_dsgd(pull=loss_aware)
    return chain(
        trace_momentum(beta, dtype=momentum_dtype),
        scale_by_lr("m"),
        quantize_int8() if compression == "int8" else None,
        deadline_skip() if deadline else None,
        gossip(where=("m_next", "x_next"), overlap=overlap,
               weights_from=rule, when=when),
        topology=topology, name="dmsgd", beta=beta)


def dsgd(topology: Topology, *, momentum_dtype=None,
         compression: str | None = None, overlap: bool = False,
         loss_aware: bool | float = False, deadline: bool = False,
         when=None) -> DecentralizedOptimizer:
    """Decentralized SGD = DmSGD with beta = 0 (Remark 8)."""
    opt = dmsgd(topology, beta=0.0, momentum_dtype=momentum_dtype,
                compression=compression, overlap=overlap,
                loss_aware=loss_aware, deadline=deadline, when=when)
    return dataclasses.replace(opt, name="dsgd")


def vanilla_dmsgd(topology: Topology, beta: float = 0.9, *,
                  momentum_dtype=None, compression: str | None = None,
                  overlap: bool = False) -> DecentralizedOptimizer:
    """Vanilla DmSGD: no momentum exchange."""
    return chain(
        trace_momentum(beta, dtype=momentum_dtype),
        scale_by_lr("m_next"),
        quantize_int8() if compression == "int8" else None,
        gossip(where=("x_next",), overlap=overlap),
        topology=topology, name="vanilla_dmsgd", beta=beta)


def qg_dmsgd(topology: Topology, beta: float = 0.9, *, momentum_dtype=None,
             compression: str | None = None,
             overlap: bool = False) -> DecentralizedOptimizer:
    """QG-DmSGD: quasi-global momentum tracks the averaged trajectory.

    No overlapped variant exists: the quasi-global EMA reads the MIXED
    ``x_next`` in the same step, which delayed mixing only produces one
    step later (``overlap=True`` raises ``ValueError`` from
    :func:`chain`'s validation)."""
    return chain(
        trace_momentum(beta, dtype=momentum_dtype, out="qg_dir"),
        scale_by_lr("qg_dir"),
        quantize_int8() if compression == "int8" else None,
        gossip(where=("x_next",), overlap=overlap),
        quasi_global_momentum(beta),
        topology=topology, name="qg_dmsgd", beta=beta)


def parallel_msgd(n: int, beta: float = 0.9, *,
                  momentum_dtype=None) -> DecentralizedOptimizer:
    """Parallel momentum SGD: exact global gradient averaging every step
    (the All-Reduce baseline), the paper's averaged-recursion convention
    (eqs. 50-51): x^{k+1} = x^k - gamma m^k (OLD momentum),
    m^{k+1} = beta m^k + g_avg^k."""
    return chain(
        average_gradients(),
        scale_by_lr("m"),
        trace_momentum(beta, dtype=momentum_dtype),
        topology=full_averaging(n), name="parallel_msgd", beta=beta)


def d_adamw(topology: Topology, b1: float = 0.9, b2: float = 0.999, *,
            eps: float = 1e-8, weight_decay: float = 0.0,
            momentum_dtype=None, compression: str | None = None,
            overlap: bool = False) -> DecentralizedOptimizer:
    """Decentralized AdamW: both Adam moments are gossiped together with
    the params.  The three f32 trees share one flat-buffer dtype group, so
    a one-peer round is still ONE roll (or gather) and one K1 combine."""
    return chain(
        trace_adam_moments(b1, b2, dtype=momentum_dtype),
        adam_descent(eps=eps, weight_decay=weight_decay),
        quantize_int8() if compression == "int8" else None,
        gossip(where=("mu_next", "nu_next", "x_next"), overlap=overlap),
        topology=topology, name="d_adamw", beta=b1)


OPTIMIZERS = {
    "dmsgd": dmsgd,
    "dsgd": dsgd,
    "vanilla_dmsgd": vanilla_dmsgd,
    "qg_dmsgd": qg_dmsgd,
    "d_adamw": d_adamw,
}


def make_optimizer(name: str, topology: Topology, beta: float = 0.9,
                   *, momentum_dtype=None, compression: str | None = None,
                   overlap: bool = False, loss_aware: bool | float = False,
                   deadline: bool = False) -> DecentralizedOptimizer:
    """Name-keyed construction, with the JAX package's signature and
    refusals; ``d_adamw`` takes ``beta`` as its ``b1``.  ``loss_aware=`` /
    ``deadline=`` bind the runtime-valued gossip hooks, as in the
    reference only for ``dmsgd`` and ``dsgd``; ``parallel_msgd`` has no
    gossip payload (it ignores ``compression`` and refuses ``overlap``)."""
    runtime_kw = {}
    if loss_aware or deadline:
        if name not in ("dmsgd", "dsgd"):
            raise ValueError(
                f"loss_aware/deadline runtime gossip is wired for "
                f"dmsgd/dsgd, not {name!r}")
        runtime_kw = {"loss_aware": loss_aware, "deadline": deadline}
    if name == "parallel_msgd":
        if overlap:
            raise ValueError(
                "parallel_msgd's exact all-reduce has no gossip payload "
                "to overlap; pick a decentralized optimizer")
        return parallel_msgd(topology.n, beta=beta,
                             momentum_dtype=momentum_dtype)
    if name == "dsgd":
        return dsgd(topology, momentum_dtype=momentum_dtype,
                    compression=compression, overlap=overlap, **runtime_kw)
    if name == "d_adamw":
        return d_adamw(topology, b1=beta, momentum_dtype=momentum_dtype,
                       compression=compression, overlap=overlap)
    if name in OPTIMIZERS:
        return OPTIMIZERS[name](topology, beta=beta,
                                momentum_dtype=momentum_dtype,
                                compression=compression, overlap=overlap,
                                **runtime_kw)
    raise KeyError(f"unknown optimizer {name!r}; options: "
                   f"{sorted(OPTIMIZERS) + ['parallel_msgd']}")
