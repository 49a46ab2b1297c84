"""Composable decentralized-optimizer transforms over node-stacked trees.

The port of the JAX package's ``core/transforms.py`` for synchronous,
static-weight gossip.  Every quantity is a ``dict[str, Tensor]`` whose
leaves carry a leading node axis of size ``n``; a *transform* reads and
writes named tensors in a :class:`Context` and a :func:`chain` of
transforms becomes a :class:`DecentralizedOptimizer`.

Naming convention inside a chain:

* ``"x"`` -- current params (original dtypes), ``"g"`` -- this step's grads.
* Each state slot appears under its name (``"m"``) and the chain must
  produce ``"<slot>_next"`` for every slot plus ``"x_next"``; commits cast
  back to the original leaf dtypes.

Transforms: :func:`trace_momentum` (``m_next = beta m + g`` in f32),
:func:`scale_by_lr` (``x_next = x - lr m``), :func:`gossip` (which
tensors are partially averaged, as ONE tree -- DmSGD's ``(m_next,
x_next)`` payload packs into one flat buffer per dtype),
:func:`average_gradients` and the :func:`allreduce_warmup` combinator.

The gossip executor is injected: ``opt.update_with_mix(..., mix=...)``
takes the realization-bound mixing callable, which
:class:`repro_torch.core.plan.GossipPlan` resolves and caches; ``update``
resolves it from a static Python-int step.  The arithmetic is out of
place: each step allocates its new tensors.  Int8 compression, runtime
gossip hooks (loss-aware weights, deadlines, ``when=``) and the overlapped
pipeline are ROADMAP slice C.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from .topology import Topology

Tree = Any

__all__ = [
    "OptState",
    "Context",
    "Transform",
    "DecentralizedOptimizer",
    "chain",
    "trace_momentum",
    "scale_by_lr",
    "gossip",
    "allreduce_warmup",
    "average_gradients",
]


class OptState(NamedTuple):
    """Optimizer state: ``momentum`` holds the single state slot's tree;
    ``count`` is the number of steps taken (a Python int)."""

    momentum: Tree
    count: int


@dataclasses.dataclass
class Context:
    """Mutable step context a chain threads through its transforms."""

    tensors: dict          # name -> node-stacked tree
    lr: float              # scalar learning rate
    mix: Callable[[Tree], Tree]   # realization-bound gossip executor


@dataclasses.dataclass(frozen=True)
class Transform:
    """One named step of a chain.

    ``slots`` declares the state tensors this transform owns; ``init``
    builds their initial values from the params tree; ``apply`` reads and
    writes ``ctx.tensors``.  ``where``/``every`` are the gossip metadata
    set by :func:`gossip`: which tensors are mixed, and how often."""

    name: str
    slots: tuple = ()
    init: Callable[[Tree], dict] | None = None
    apply: Callable[[Context], None] | None = None
    where: tuple = ()
    every: int = 1


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def _zeros_slot(params: Tree, dtype) -> Tree:
    return {k: torch.zeros_like(p, dtype=dtype or p.dtype)
            for k, p in params.items()}


def trace_momentum(beta: float, dtype=None, *, slot: str = "m",
                   out: str = "m_next") -> Transform:
    """Heavy-ball momentum trace: ``out = beta * slot + g`` in f32.
    ``dtype`` sets the stored momentum dtype (None keeps each param
    leaf's dtype)."""

    def init(params):
        return {slot: _zeros_slot(params, dtype)}

    def apply(ctx):
        m, g = ctx.tensors[slot], ctx.tensors["g"]
        ctx.tensors[out] = {k: beta * _f32(m[k]) + _f32(g[k]) for k in m}

    return Transform(f"trace_momentum({beta})", (slot,), init, apply)


def scale_by_lr(momentum: str = "m", *, out: str = "x_next") -> Transform:
    """Descent step: ``out = x - lr * <momentum>`` in f32.

    ``momentum="m"`` descends along the OLD momentum (Algorithm 1 /
    parallel mSGD's averaged-recursion convention); ``momentum="m_next"``
    uses the freshly traced one (vanilla DmSGD)."""

    def apply(ctx):
        x, m = ctx.tensors["x"], ctx.tensors[momentum]
        ctx.tensors[out] = {k: _f32(x[k]) - ctx.lr * _f32(m[k]) for k in x}

    return Transform(f"scale_by_lr({momentum})", (), None, apply)


def gossip(where: tuple = ("x_next",), every: int = 1) -> Transform:
    """Partially average the named tensors with this step's ``W^{(k)}``.

    All tensors in one ``where`` tuple are mixed as a SINGLE tree, so the
    flat-buffer engine packs them into one buffer per dtype group: for f32
    payloads over the one-peer exponential graph that is one roll and one
    combine per step however many tensors are listed.  ``every=k``
    communicates only every k-th step; the off-steps realize as
    ``Identity`` and the schedule advances one realization per
    communicating step."""
    where = tuple(where)
    if every < 1:
        raise ValueError(f"gossip(every=...) needs every >= 1, got {every}")

    def apply(ctx):
        payload = (ctx.tensors[where[0]] if len(where) == 1
                   else tuple(ctx.tensors[k] for k in where))
        mixed = ctx.mix(payload)
        if len(where) == 1:
            ctx.tensors[where[0]] = mixed
        else:
            for k, v in zip(where, mixed):
                ctx.tensors[k] = v

    name = f"gossip{where}" + (f"@every{every}" if every > 1 else "")
    return Transform(name, (), None, apply, where, every)


def average_gradients() -> Transform:
    """Exact global gradient averaging (the All-Reduce baseline): replaces
    ``g`` with its node-mean, broadcast back to every node."""

    def apply(ctx):
        g = ctx.tensors["g"]
        ctx.tensors["g"] = {
            k: _f32(v).mean(0, keepdim=True).expand(v.shape)
            for k, v in g.items()}

    return Transform("average_gradients", (), None, apply)


@dataclasses.dataclass(frozen=True)
class DecentralizedOptimizer:
    """A chain of transforms bound to a topology.

    ``init(params)`` builds the :class:`OptState`; ``update(params, state,
    grads, step, lr)`` runs one decentralized step, resolving the gossip
    executor from the Python-int ``step``; ``update_with_mix`` takes the
    executor explicitly -- the hook :class:`repro_torch.core.plan.GossipPlan`
    caches through.
    """

    name: str
    topology: Topology
    beta: float
    transforms: tuple
    warmup_steps: int = 0

    @property
    def gossip_every(self) -> int:
        """Communication interval: k from ``gossip(where=..., every=k)``.
        All gossip transforms of one chain share one realization per step,
        so mixed ``every`` values are rejected."""
        vals = {t.every for t in self.transforms if t.where}
        if len(vals) > 1:
            raise ValueError(
                f"chain {self.name!r} mixes gossip(every=...) intervals "
                f"{sorted(vals)}; all gossip transforms in one chain share "
                "one realization per step, so they must agree on every=")
        return vals.pop() if vals else 1

    @property
    def slot_names(self) -> tuple:
        names: list = []
        for t in self.transforms:
            for s in t.slots:
                if s not in names:
                    names.append(s)
        return tuple(names)

    def init(self, params: Tree) -> OptState:
        slots: dict = {}
        for t in self.transforms:
            if t.init is None:
                continue
            for k, v in t.init(params).items():
                slots.setdefault(k, v)
        return OptState(slots[self.slot_names[0]], 0)

    def update_with_mix(self, params: Tree, state: OptState, grads: Tree,
                        lr, mix: Callable[[Tree], Tree]
                        ) -> tuple[Tree, OptState]:
        """One step with an explicitly injected gossip executor."""
        slot = self.slot_names[0]
        tensors = {slot: state.momentum, "x": params, "g": grads}
        ctx = Context(tensors=tensors, lr=lr, mix=mix)
        for t in self.transforms:
            if t.apply is not None:
                t.apply(ctx)
        new_params = {k: v.to(params[k].dtype)
                      for k, v in tensors["x_next"].items()}
        new_m = {k: v.to(state.momentum[k].dtype)
                 for k, v in tensors[slot + "_next"].items()}
        return new_params, OptState(new_m, state.count + 1)

    def update(self, params: Tree, state: OptState, grads: Tree,
               step: int, lr) -> tuple[Tree, OptState]:
        """One step; the gossip realization is resolved from the Python-int
        ``step`` (traced steps do not exist in this package)."""
        from .plan import GossipPlan
        mix = GossipPlan.for_optimizer(self).mix(int(step))
        return self.update_with_mix(params, state, grads, lr, mix)


def chain(*transforms, topology: Topology, name: str = "chain",
          beta: float = 0.0, warmup_steps: int = 0) -> DecentralizedOptimizer:
    """Compose transforms into a :class:`DecentralizedOptimizer`.

    ``None`` entries are skipped.  The port's chains carry exactly one
    state slot (every SGD-family optimizer); multi-slot chains (d_adamw)
    are ROADMAP slice C."""
    ts = tuple(t for t in transforms if t is not None)
    if not ts:
        raise ValueError("chain() needs at least one transform")
    opt = DecentralizedOptimizer(name=name, topology=topology, beta=beta,
                                 transforms=ts, warmup_steps=warmup_steps)
    if not opt.slot_names:
        raise ValueError(
            f"chain {name!r} declares no state slots; every optimizer needs "
            "at least one (e.g. trace_momentum)")
    if len(opt.slot_names) > 1:
        raise NotImplementedError(
            f"chain {name!r} declares slots {opt.slot_names}; multi-slot "
            "chains wait for ROADMAP slice C of the PyTorch port")
    opt.gossip_every   # fail fast on mixed gossip(every=...) intervals
    return opt


def allreduce_warmup(tau: int):
    """Wrapping combinator (Corollary 3): returns ``opt -> opt'`` whose
    first ``tau`` steps mix with exact global averaging ``W = (1/n) 1 1^T``.
    ``GossipPlan`` folds the warm-up phase into its cache key."""

    def wrap(opt: DecentralizedOptimizer) -> DecentralizedOptimizer:
        return dataclasses.replace(opt, warmup_steps=int(tau))

    return wrap
