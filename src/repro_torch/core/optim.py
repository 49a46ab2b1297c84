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
* ``parallel_msgd`` -- global averaging baseline: ``average_gradients()``,
                       the paper's averaged-recursion convention.

``qg_dmsgd`` and ``d_adamw``, and the ``compression`` / ``overlap`` /
``loss_aware`` / ``deadline`` options, wait for ROADMAP slice C and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

from .topology import Topology, full_averaging
from .transforms import (
    DecentralizedOptimizer,
    OptState,
    average_gradients,
    chain,
    gossip,
    scale_by_lr,
    trace_momentum,
)

__all__ = [
    "OptState",
    "DecentralizedOptimizer",
    "dmsgd",
    "dsgd",
    "vanilla_dmsgd",
    "parallel_msgd",
    "make_optimizer",
    "OPTIMIZERS",
]

_LATER = {"qg_dmsgd": "C", "d_adamw": "C"}


def _later(what: str, slice_: str = "C") -> NotImplementedError:
    return NotImplementedError(
        f"{what} waits for ROADMAP slice {slice_} of the PyTorch port")


def dmsgd(topology: Topology, beta: float = 0.9, *,
          momentum_dtype=None) -> DecentralizedOptimizer:
    """Algorithm 1 (the paper's DmSGD); fused single-payload gossip."""
    return chain(
        trace_momentum(beta, dtype=momentum_dtype),
        scale_by_lr("m"),
        gossip(where=("m_next", "x_next")),
        topology=topology, name="dmsgd", beta=beta)


def dsgd(topology: Topology, *, momentum_dtype=None) -> DecentralizedOptimizer:
    """Decentralized SGD = DmSGD with beta = 0 (Remark 8)."""
    opt = dmsgd(topology, beta=0.0, momentum_dtype=momentum_dtype)
    return dataclasses.replace(opt, name="dsgd")


def vanilla_dmsgd(topology: Topology, beta: float = 0.9, *,
                  momentum_dtype=None) -> DecentralizedOptimizer:
    """Vanilla DmSGD: no momentum exchange."""
    return chain(
        trace_momentum(beta, dtype=momentum_dtype),
        scale_by_lr("m_next"),
        gossip(where=("x_next",)),
        topology=topology, name="vanilla_dmsgd", beta=beta)


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


OPTIMIZERS = {
    "dmsgd": dmsgd,
    "dsgd": dsgd,
    "vanilla_dmsgd": vanilla_dmsgd,
}


def make_optimizer(name: str, topology: Topology, beta: float = 0.9,
                   *, momentum_dtype=None, compression: str | None = None,
                   overlap: bool = False, loss_aware: bool | float = False,
                   deadline: bool = False) -> DecentralizedOptimizer:
    """Name-keyed construction, with the JAX package's signature."""
    if compression is not None:
        raise _later(f"compression={compression!r}")
    if overlap:
        raise _later("the overlapped (delayed-mix) pipeline")
    if loss_aware or deadline:
        raise _later("runtime-valued gossip (loss_aware / deadline)")
    if name in _LATER:
        raise _later(f"the {name!r} optimizer", _LATER[name])
    if name == "parallel_msgd":
        return parallel_msgd(topology.n, beta=beta,
                             momentum_dtype=momentum_dtype)
    if name == "dsgd":
        return dsgd(topology, momentum_dtype=momentum_dtype)
    if name in OPTIMIZERS:
        return OPTIMIZERS[name](topology, beta=beta,
                                momentum_dtype=momentum_dtype)
    raise KeyError(f"unknown optimizer {name!r}; options: "
                   f"{sorted(OPTIMIZERS) + ['parallel_msgd']}")
