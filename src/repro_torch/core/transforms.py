"""Composable decentralized-optimizer transforms over node-stacked trees.

The port of the JAX package's ``core/transforms.py`` for synchronous,
static-weight gossip.  Every quantity is a ``dict[str, Tensor]`` whose
leaves carry a leading node axis of size ``n``; a *transform* reads and
writes named tensors in a :class:`Context` and a :func:`chain` of
transforms becomes a :class:`DecentralizedOptimizer`.

Naming convention inside a chain:

* ``"x"`` -- current params (original dtypes), ``"g"`` -- this step's grads.
* Each state slot appears under its name (``"m"``, or Adam's ``"mu"``
  and ``"nu"``) and the chain must produce ``"<slot>_next"`` for every
  slot plus ``"x_next"``; commits cast back to the original leaf dtypes,
  slot by slot.

Transforms: :func:`trace_momentum` (``m_next = beta m + g`` in f32),
:func:`scale_by_lr` (``x_next = x - lr m``), :func:`gossip` (which
tensors are partially averaged, as ONE tree -- DmSGD's ``(m_next,
x_next)`` payload packs into one flat buffer per dtype),
:func:`quasi_global_momentum` (QG-DmSGD), :func:`trace_adam_moments` and
:func:`adam_descent` (AdamW), :func:`average_gradients` and the
:func:`allreduce_warmup` combinator.

The gossip executor is injected: ``opt.update_with_mix(..., mix=...)``
takes the realization-bound mixing callable, which
:class:`repro_torch.core.plan.GossipPlan` resolves and caches; ``update``
resolves it from a static Python-int step.  The arithmetic is out of
place: each step allocates its new tensors.  Int8 compression, runtime
gossip hooks (loss-aware weights, deadlines, ``when=``) and the overlapped
pipeline are ROADMAP slice C (items 8-10): :func:`chain` validates an
overlapped composition as the reference does, then refuses it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
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
    "quasi_global_momentum",
    "trace_adam_moments",
    "adam_descent",
    "allreduce_warmup",
    "average_gradients",
]


class OptState(NamedTuple):
    """Optimizer state: ``momentum`` holds the state slot's tree when the
    chain has one slot, else a dict ``{slot: tree}`` in declaration order
    (d_adamw's ``{"mu": ..., "nu": ...}``); ``count`` is the number of
    steps taken (a Python int)."""

    momentum: Tree
    count: int


@dataclasses.dataclass
class Context:
    """Mutable step context a chain threads through its transforms."""

    tensors: dict          # name -> node-stacked tree
    lr: float              # scalar learning rate
    count: int             # steps taken before this one
    mix: Callable[[Tree], Tree]   # realization-bound gossip executor


@dataclasses.dataclass(frozen=True)
class Transform:
    """One named step of a chain.

    ``slots`` declares the state tensors this transform owns; ``init``
    builds their initial values from the params tree; ``apply`` reads and
    writes ``ctx.tensors``.  ``where``/``every`` are the gossip metadata
    set by :func:`gossip`: which tensors are mixed, how often, and
    whether one step late."""

    name: str
    slots: tuple = ()
    init: Callable[[Tree], dict] | None = None
    apply: Callable[[Context], None] | None = None
    where: tuple = ()
    every: int = 1
    overlap: bool = False


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


def gossip(where: tuple = ("x_next",), every: int = 1,
           overlap: bool = False) -> Transform:
    """Partially average the named tensors with this step's ``W^{(k)}``.

    All tensors in one ``where`` tuple are mixed as a SINGLE tree, so the
    flat-buffer engine packs them into one buffer per dtype group: for f32
    payloads over the one-peer exponential graph that is one roll and one
    combine per step however many tensors are listed.  ``every=k``
    communicates only every k-th step; the off-steps realize as
    ``Identity`` and the schedule advances one realization per
    communicating step.  ``overlap=True`` (one-step-delayed mixing) is
    ROADMAP item 10: :func:`chain` checks the composition as the reference
    does and then refuses it."""
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

    name = f"gossip{where}" + (f"@every{every}" if every > 1 else "") \
        + ("@overlap" if overlap else "")
    return Transform(name, (), None, apply, where, every, overlap)


def average_gradients() -> Transform:
    """Exact global gradient averaging (the All-Reduce baseline): replaces
    ``g`` with its node-mean, broadcast back to every node."""

    def apply(ctx):
        g = ctx.tensors["g"]
        ctx.tensors["g"] = {
            k: _f32(v).mean(0, keepdim=True).expand(v.shape)
            for k, v in g.items()}

    return Transform("average_gradients", (), None, apply)


def quasi_global_momentum(beta: float, *, slot: str = "m",
                          out: str = "m_next") -> Transform:
    """QG-DmSGD's momentum: EMA of the quasi-global displacement,
    ``m_next = beta m + (1 - beta) (x - x_next) / lr`` -- tracks the
    *averaged* trajectory, so it must run AFTER the gossip of ``x_next``.
    ``lr`` is the schedule's f32-rounded float, as the reference's traced
    f32 scalar."""

    def init(params):
        return {slot: _zeros_slot(params, None)}

    def apply(ctx):
        m, x, xn = ctx.tensors[slot], ctx.tensors["x"], ctx.tensors["x_next"]
        ctx.tensors[out] = {
            k: beta * _f32(m[k]) + (1.0 - beta) * (_f32(x[k]) - xn[k])
            / ctx.lr for k in m}

    return Transform(f"quasi_global_momentum({beta})", (slot,), init, apply)


def trace_adam_moments(b1: float = 0.9, b2: float = 0.999,
                       dtype=None) -> Transform:
    """Adam first/second moment traces with bias correction.

    Writes ``mu_next``/``nu_next`` (the stored EMAs) and ``mu_hat``/
    ``nu_hat`` (bias-corrected, consumed by :func:`adam_descent`).  The
    corrections ``1 - b ** (count + 1)`` are computed in float32, as the
    reference computes them from its int32 count: in Python's float64 they
    would part from it by more than f32 rounding."""

    def init(params):
        return {"mu": _zeros_slot(params, dtype),
                "nu": _zeros_slot(params, dtype)}

    def apply(ctx):
        t = ctx.tensors
        mu, nu, g = t["mu"], t["nu"], t["g"]
        t["mu_next"] = {k: b1 * _f32(mu[k]) + (1.0 - b1) * _f32(g[k])
                        for k in mu}
        t["nu_next"] = {k: b2 * _f32(nu[k])
                        + (1.0 - b2) * torch.square(_f32(g[k])) for k in nu}
        c = np.float32(ctx.count) + np.float32(1.0)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** c)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** c)
        t["mu_hat"] = {k: v / bc1 for k, v in t["mu_next"].items()}
        t["nu_hat"] = {k: v / bc2 for k, v in t["nu_next"].items()}

    return Transform(f"trace_adam_moments({b1},{b2})", ("mu", "nu"),
                     init, apply)


def adam_descent(eps: float = 1e-8, weight_decay: float = 0.0) -> Transform:
    """AdamW descent: ``x_next = x - lr (mu_hat / (sqrt(nu_hat) + eps)
    + weight_decay * x)`` (decoupled weight decay)."""

    def apply(ctx):
        t = ctx.tensors
        x, mh, vh = t["x"], t["mu_hat"], t["nu_hat"]
        t["x_next"] = {
            k: _f32(x[k]) - ctx.lr * (mh[k] / (torch.sqrt(vh[k]) + eps)
                                      + weight_decay * _f32(x[k]))
            for k in x}

    return Transform(f"adam_descent(eps={eps},wd={weight_decay})",
                     (), None, apply)


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
    def overlap(self) -> bool:
        """True when the chain's gossip is one-step-delayed (overlapped).

        Validates the reference's structural rules for the delayed-mix
        recursion: ONE gossip transform, nothing applied after it (a
        post-gossip transform -- quasi-global momentum -- reads the mixed
        values in the SAME step, which the pipeline only produces one step
        later), and every mixed name ``x_next`` or ``<slot>_next``."""
        gossips = [t for t in self.transforms if t.where]
        flags = {t.overlap for t in gossips}
        if len(flags) > 1:
            raise ValueError(
                f"chain {self.name!r} mixes overlapped and synchronous "
                "gossip transforms; one chain carries one pipeline")
        if not flags or not flags.pop():
            return False
        if len(gossips) > 1:
            raise ValueError(
                f"chain {self.name!r} has {len(gossips)} gossip transforms; "
                "overlap=True supports exactly one (one in-flight payload)")
        after = self.transforms[self.transforms.index(gossips[0]) + 1:]
        trailing = [t.name for t in after if t.apply is not None]
        if trailing:
            raise ValueError(
                f"chain {self.name!r} applies {trailing} AFTER the "
                "overlapped gossip; delayed mixing produces the mixed "
                "values one step late, so nothing in the same step may "
                "consume them (use overlap=False)")
        for w in gossips[0].where:
            if w != "x_next" and not (w.endswith("_next")
                                      and w[:-5] in self.slot_names):
                raise ValueError(
                    f"overlapped gossip mixes {w!r}, which is neither "
                    "'x_next' nor a declared state slot's '<slot>_next'; "
                    "the delayed combine must land on committed state")
        return True

    @property
    def slot_names(self) -> tuple:
        names: list = []
        for t in self.transforms:
            for s in t.slots:
                if s not in names:
                    names.append(s)
        return tuple(names)

    def _slots_of(self, state: OptState) -> dict:
        names = self.slot_names
        if len(names) == 1:
            return {names[0]: state.momentum}
        return dict(state.momentum)

    def _state_of(self, slots: dict, count: int) -> OptState:
        names = self.slot_names
        if len(names) == 1:
            return OptState(slots[names[0]], count)
        return OptState({k: slots[k] for k in names}, count)

    def init(self, params: Tree) -> OptState:
        slots: dict = {}
        for t in self.transforms:
            if t.init is None:
                continue
            for k, v in t.init(params).items():
                slots.setdefault(k, v)
        return self._state_of(slots, 0)

    def update_with_mix(self, params: Tree, state: OptState, grads: Tree,
                        lr, mix: Callable[[Tree], Tree]
                        ) -> tuple[Tree, OptState]:
        """One step with an explicitly injected gossip executor."""
        slots = self._slots_of(state)
        tensors = dict(slots)
        tensors["x"] = params
        tensors["g"] = grads
        ctx = Context(tensors=tensors, lr=lr, count=state.count, mix=mix)
        for t in self.transforms:
            if t.apply is not None:
                t.apply(ctx)
        new_params = {k: v.to(params[k].dtype)
                      for k, v in tensors["x_next"].items()}
        new_slots = {s: {k: v.to(slots[s][k].dtype)
                         for k, v in tensors[s + "_next"].items()}
                     for s in self.slot_names}
        return new_params, self._state_of(new_slots, state.count + 1)

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

    ``None`` entries are skipped.  An overlapped gossip is validated as in
    the reference (``ValueError`` for a composition the pipeline cannot
    run, e.g. qg_dmsgd's post-gossip EMA) and then refused: the pipeline
    is ROADMAP item 10."""
    ts = tuple(t for t in transforms if t is not None)
    if not ts:
        raise ValueError("chain() needs at least one transform")
    opt = DecentralizedOptimizer(name=name, topology=topology, beta=beta,
                                 transforms=ts, warmup_steps=warmup_steps)
    if not opt.slot_names:
        raise ValueError(
            f"chain {name!r} declares no state slots; every optimizer needs "
            "at least one (e.g. trace_momentum)")
    opt.gossip_every   # fail fast on mixed gossip(every=...) intervals
    if opt.overlap:
        raise NotImplementedError(
            "the overlapped (delayed-mix) pipeline waits for ROADMAP slice "
            "C (item 10) of the PyTorch port")
    return opt


def allreduce_warmup(tau: int):
    """Wrapping combinator (Corollary 3): returns ``opt -> opt'`` whose
    first ``tau`` steps mix with exact global averaging ``W = (1/n) 1 1^T``.
    ``GossipPlan`` folds the warm-up phase into its cache key."""

    def wrap(opt: DecentralizedOptimizer) -> DecentralizedOptimizer:
        return dataclasses.replace(opt, warmup_steps=int(tau))

    return wrap
