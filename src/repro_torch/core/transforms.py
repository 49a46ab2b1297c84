"""Composable decentralized-optimizer transforms over node-stacked trees.

The port of the JAX package's ``core/transforms.py``.  Every quantity is a ``dict[str, Tensor]`` whose
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
:func:`adam_descent` (AdamW), :func:`average_gradients`, the
:func:`quantize_int8` marker (int8 gossip payloads on the wire) and the
:func:`allreduce_warmup` combinator.

The runtime gossip hooks: ``gossip(weights_from=al_dsgd(...))``
(AL-DSGD loss-aware weights, the losses riding the round's gather),
:func:`deadline_skip` (per-node straggler gating from ``aux["alive"]``)
and ``gossip(when=...)`` (a data-dependent whole-round skip, the schedule
position held in ``OptState.sched_pos``).  They read the per-node step
data passed as ``update(..., aux=...)``.

The gossip executor is injected: ``opt.update_with_mix(..., mix=...)``
takes the realization-bound mixing callable, which
:class:`repro_torch.core.plan.GossipPlan` resolves and caches; ``update``
resolves it from a static Python-int step.  The arithmetic is out of
place: each step allocates its new tensors.

``gossip(overlap=True)`` selects the one-step-delayed mix: the payload
rides the optimizer state as packed buffers (``OptState.buf``) and is
mixed at the top of the NEXT step
(:meth:`DecentralizedOptimizer.update_pipelined`); on the card that round
runs on a side CUDA stream while the step's backward runs
(:meth:`repro_torch.core.plan.OverlapIO.start`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from . import schedule as schedule_mod
from .gossip import node_mean
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
    "deadline_skip",
    "al_dsgd",
    "AdjacentLeaderPull",
    "quantize_int8",
    "quasi_global_momentum",
    "trace_adam_moments",
    "adam_descent",
    "allreduce_warmup",
    "average_gradients",
]


class OptState(NamedTuple):
    """Optimizer state, with the reference's fields in its order:
    ``momentum`` holds the state slot's tree when the chain has one slot,
    else a dict ``{slot: tree}`` in declaration order (d_adamw's
    ``{"mu": ..., "nu": ...}``); ``count`` is the number of steps taken (a
    Python int); ``buf`` is the overlap pipeline's in-flight payload: the
    tuple of packed f32 buffers of the previous step's pre-mix payload
    (None for synchronous chains and before the priming step); ``sched_pos`` is the gossip schedule
    position of a ``gossip(when=...)`` chain (a 0-d int32 tensor on the
    host, advanced only on communicating rounds), else None."""

    momentum: Tree
    count: int
    buf: Any = None
    sched_pos: Any = None


@dataclasses.dataclass
class Context:
    """Mutable step context a chain threads through its transforms."""

    tensors: dict          # name -> node-stacked tree
    lr: float              # scalar learning rate
    count: int             # steps taken before this one
    mix: Callable[[Tree], Tree]   # realization-bound gossip executor
    # per-node step data from update(..., aux=...): what loss-aware
    # weights, deadline gates and when= predicates read
    aux: dict | None = None
    # (n,) bool: which nodes take part in this step's gossip (set by
    # deadline_skip, read by the gossip transform's mix call)
    node_gate: Any = None
    # schedule position (state.sched_pos) of a when= chain, and the gate
    # the gossip transform resolved this step (drives the advance)
    sched_pos: Any = None
    sched_gate: Any = None


@dataclasses.dataclass(frozen=True)
class Transform:
    """One named step of a chain.

    ``slots`` declares the state tensors this transform owns; ``init``
    builds their initial values from the params tree; ``apply`` reads and
    writes ``ctx.tensors``; ``tag`` marks a declarative role
    (``"deadline"``).  ``where``/``every``/``overlap`` are the gossip
    metadata set by :func:`gossip` (which tensors are mixed, how often,
    whether one step late), ``weights_from``/``when`` its runtime hooks."""

    name: str
    slots: tuple = ()
    init: Callable[[Tree], dict] | None = None
    apply: Callable[[Context], None] | None = None
    tag: str | None = None
    where: tuple = ()
    every: int = 1
    overlap: bool = False
    weights_from: Any = None
    when: Any = None


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
           overlap: bool = False, weights_from=None,
           when=None) -> Transform:
    """Partially average the named tensors with this step's ``W^{(k)}``.

    All tensors in one ``where`` tuple are mixed as a SINGLE tree, so the
    flat-buffer engine packs them into one buffer per dtype group: for f32
    payloads over the one-peer exponential graph that is one roll and one
    combine per step however many tensors are listed.  ``every=k``
    communicates only every k-th step; the off-steps realize as
    ``Identity`` and the schedule advances one realization per
    communicating step.  ``overlap=True`` selects the one-step-delayed mix:
    the payload is packed into ``OptState.buf`` and mixed at the top of
    the next step (:meth:`DecentralizedOptimizer.update_pipelined`).

    ``weights_from=`` binds a loss-aware weight rule (:func:`al_dsgd`): its
    per-node metadata row (loss, grad norm) rides the round's gather and
    its ``edge_weight`` reweights each edge from (own, received) rows.
    ``when=`` makes the round's skip DATA-DEPENDENT: ``when(ctx) -> bool
    scalar`` decides whether this round communicates; the schedule
    position then lives in ``OptState.sched_pos`` and advances only on
    communicating rounds.  The wire is still issued on skipped rounds."""
    where = tuple(where)
    if every < 1:
        raise ValueError(f"gossip(every=...) needs every >= 1, got {every}")
    if when is not None and every > 1:
        raise ValueError("gossip(when=...) generalizes every=k (the runtime "
                         "gate decides which rounds communicate); set one, "
                         "not both")

    def apply(ctx):
        kw = {}
        if weights_from is not None:
            kw["meta"] = weights_from.meta(ctx)
            kw["edge_weight"] = weights_from.edge_weight
        if ctx.node_gate is not None:
            kw["node_gate"] = ctx.node_gate
        payload = (ctx.tensors[where[0]] if len(where) == 1
                   else tuple(ctx.tensors[k] for k in where))
        if when is not None:
            gate = when(ctx)
            ctx.sched_gate = gate
            mixed = ctx.mix(payload, ctx.sched_pos, gate, **kw)
        else:
            mixed = ctx.mix(payload, **kw)
        if len(where) == 1:
            ctx.tensors[where[0]] = mixed
        else:
            for k, v in zip(where, mixed):
                ctx.tensors[k] = v

    name = f"gossip{where}" + (f"@every{every}" if every > 1 else "") \
        + ("@overlap" if overlap else "") \
        + ("@loss_aware" if weights_from is not None else "") \
        + ("@when" if when is not None else "")
    return Transform(name, (), None, apply, where=where, every=every,
                     overlap=overlap, weights_from=weights_from, when=when)


def deadline_skip(flag: str = "alive") -> Transform:
    """Straggler tolerance: gate this step's gossip PER NODE on the
    deadline flag ``aux[flag]`` ((n,) bool, True = the node produced its
    payload in time).  An edge mixes only when BOTH endpoints are alive
    (the flag rides the payload's gather), the dropped edges' mass returns
    to the self weight, and symmetric Matching rounds stay exactly
    mean-preserving.  The wire is still issued.  Must come BEFORE the
    chain's gossip transform (checked by :func:`chain`)."""

    def apply(ctx):
        if ctx.aux is None or flag not in ctx.aux:
            raise ValueError(
                f"deadline_skip needs aux[{flag!r}] ((n,) bool per-node "
                "deadline flags); pass aux=... to update/update_with_mix")
        ctx.node_gate = torch.as_tensor(ctx.aux[flag])

    return Transform(f"deadline_skip({flag})", (), None, apply,
                     tag="deadline")


@dataclasses.dataclass(frozen=True)
class AdjacentLeaderPull:
    """AL-DSGD loss-aware mixing weights (adjacent-leader pull).

    Each node publishes its step loss (and with ``gn_weight`` its gradient
    norm) as a metadata row riding the gossip gather; the receiver
    reweights each edge ``w = base * 2 * sigmoid(pull * (own_score -
    recv_score))`` -- pulling harder from better-loss neighbours, up to
    twice the base weight.  The self weight is derived as ``1 - sum`` per
    node, so rows stay stochastic (not columns).  The gradient norm sums
    the squares over every leaf of a node: the port's leaves are per
    layer, the reference's layer-stacked, so the order of that sum
    differs."""

    pull: float = 2.0
    gn_weight: float = 0.0

    @property
    def cols(self) -> int:
        """Metadata columns this rule piggybacks (gossip_spec accounting)."""
        return 2 if self.gn_weight else 1

    def meta(self, ctx) -> torch.Tensor:
        if ctx.aux is None or "loss" not in ctx.aux:
            raise ValueError(
                "gossip(weights_from=al_dsgd(...)) needs aux={'loss': (n,) "
                "per-node losses}; pass aux=... to update/update_with_mix")
        loss = torch.as_tensor(ctx.aux["loss"]).to(torch.float32).reshape(-1)
        if not self.gn_weight:
            return loss
        sq = None
        for leaf in ctx.tensors["g"].values():
            s = torch.sum(torch.square(_f32(leaf)),
                          dim=tuple(range(1, leaf.ndim)))
            sq = s if sq is None else sq + s
        return torch.stack([loss.to(sq.device), torch.sqrt(sq)], 1)

    def edge_weight(self, own, recv, base):
        s = own[:, 0] - recv[:, 0]
        if self.gn_weight:
            s = s + self.gn_weight * (own[:, 1] - recv[:, 1])
        return base * 2.0 * torch.sigmoid(self.pull * s)


def al_dsgd(pull: float = 2.0, gn_weight: float = 0.0) -> AdjacentLeaderPull:
    """The :class:`AdjacentLeaderPull` rule for ``gossip(weights_from=...)``."""
    return AdjacentLeaderPull(pull=pull, gn_weight=gn_weight)


def quantize_int8() -> Transform:
    """Declarative marker: gossip payloads are int8 on the wire (one f32
    scale per node and JAX leaf; see :mod:`repro_torch.core.gossip`).
    Its place in the chain is irrelevant; it applies to every gossip of
    the optimizer.  Only Shifts and Matching rounds have a quantized wire
    format: ``GossipPlan`` refuses topologies that realize ``Dense``, and
    the all-reduce warm-up phase mixes in full precision."""
    return Transform("quantize_int8", (), None, None, tag="int8")


def average_gradients() -> Transform:
    """Exact global gradient averaging (the All-Reduce baseline): replaces
    ``g`` with its node-mean in f32, broadcast back to every node.  The
    mean is the injected executor's (``ctx.mix.mean``: on a plan's mesh
    one ``psum`` per dtype group over the node axis, divided by n); a
    bare callable ``mix`` takes the single-process mean."""

    def apply(ctx):
        mean = getattr(ctx.mix, "mean", node_mean)
        ctx.tensors["g"] = mean(ctx.tensors["g"])

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
    def compression(self) -> str | None:
        """``"int8"`` when the chain holds :func:`quantize_int8`."""
        return "int8" if any(t.tag == "int8" for t in self.transforms) \
            else None

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
    def gossip_where(self) -> tuple:
        """Union of tensor names the chain's gossip transforms mix (what
        the wire payload is made of; the dry run's accounting reads it)."""
        names: list = []
        for t in self.transforms:
            names += [w for w in t.where if w not in names]
        return tuple(names)

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
    def weights_from(self):
        """The loss-aware weight rule bound via ``gossip(weights_from=...)``
        (None for plain chains)."""
        for t in self.transforms:
            if t.where and t.weights_from is not None:
                return t.weights_from
        return None

    @property
    def scheduled_gossip(self) -> bool:
        """True when a ``gossip(when=...)`` makes the skip decision a
        runtime value: the schedule position lives in ``OptState.sched_pos``
        and :class:`repro_torch.core.plan.GossipPlan` builds ONE scheduled
        executable instead of one per realization."""
        return any(t.where and t.when is not None for t in self.transforms)

    @property
    def has_runtime_gossip(self) -> bool:
        """Any runtime-valued gossip hook: loss-aware weights, a
        data-dependent skip, or per-node deadline gating."""
        return (self.scheduled_gossip or self.weights_from is not None
                or any(t.tag == "deadline" for t in self.transforms))

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

    def _state_of(self, slots: dict, count: int, buf=None,
                  sched_pos=None) -> OptState:
        names = self.slot_names
        if len(names) == 1:
            return OptState(slots[names[0]], count, buf, sched_pos)
        return OptState({k: slots[k] for k in names}, count, buf, sched_pos)

    def init(self, params: Tree) -> OptState:
        slots: dict = {}
        for t in self.transforms:
            if t.init is None:
                continue
            for k, v in t.init(params).items():
                slots.setdefault(k, v)
        sched = (schedule_mod.initial_position()
                 if self.scheduled_gossip else None)
        return self._state_of(slots, 0, None, sched)

    def update_with_mix(self, params: Tree, state: OptState, grads: Tree,
                        lr, mix: Callable[[Tree], Tree],
                        aux: dict | None = None) -> tuple[Tree, OptState]:
        """One step with an explicitly injected gossip executor.  ``aux``
        carries per-node step data -- losses for ``weights_from``, deadline
        flags for :func:`deadline_skip`, whatever a ``when=`` predicate
        reads; it never changes which executable runs."""
        slots = self._slots_of(state)
        tensors = dict(slots)
        tensors["x"] = params
        tensors["g"] = grads
        ctx = Context(tensors=tensors, lr=lr, count=state.count, mix=mix,
                      aux=aux, sched_pos=state.sched_pos)
        for t in self.transforms:
            if t.apply is not None:
                t.apply(ctx)
        new_params = {k: v.to(params[k].dtype)
                      for k, v in tensors["x_next"].items()}
        new_slots = {s: {k: v.to(slots[s][k].dtype)
                         for k, v in tensors[s + "_next"].items()}
                     for s in self.slot_names}
        sched = state.sched_pos
        if sched is not None:
            sched = schedule_mod.advance_position(sched, ctx.sched_gate)
        return new_params, self._state_of(new_slots, state.count + 1, None,
                                          sched)

    def update(self, params: Tree, state: OptState, grads: Tree,
               step: int, lr, aux: dict | None = None
               ) -> tuple[Tree, OptState]:
        """One step; the gossip realization is resolved from the Python-int
        ``step`` (traced steps do not exist in this package; a ``when=``
        chain's executor reads ``state.sched_pos`` instead).  An overlapped
        chain takes :meth:`update_pipelined` with the step's
        :class:`~repro_torch.core.plan.OverlapIO`."""
        from .plan import GossipPlan
        plan = GossipPlan.for_optimizer(self)
        if self.overlap:
            return self.update_pipelined(params, state, grads, lr,
                                         plan.overlap_io(int(step)))
        return self.update_with_mix(params, state, grads, lr,
                                    plan.mix(int(step)), aux=aux)

    # -- overlapped (delayed-mix) pipeline ------------------------------------

    def _overlap_names(self) -> tuple:
        """The (single) overlapped gossip transform's ``where`` tuple."""
        return next(t for t in self.transforms if t.where).where

    def payload_template(self, params: Tree, state: OptState) -> Tree:
        """The in-flight payload's structure as f32 meta tensors (a bare
        tree for one name, a tuple otherwise): what the packed
        ``state.buf`` unpacks against.  The buffer is f32 whatever the
        leaves' dtypes."""
        slots = self._slots_of(state)

        def f32_like(tree):
            return {k: torch.empty(v.shape, dtype=torch.float32,
                                   device="meta") for k, v in tree.items()}

        parts = tuple(f32_like(params if w == "x_next" else slots[w[:-5]])
                      for w in self._overlap_names())
        return parts[0] if len(parts) == 1 else parts

    def start_delayed(self, params: Tree, state: OptState, io):
        """Start the delayed round of ``state.buf`` (None at a priming
        step): on the card it runs on a side stream while the caller
        computes the gradients; pass the result to
        :meth:`update_pipelined` as ``pending``."""
        if state.buf is None:
            return None
        return io.start(self.payload_template(params, state), state.buf)

    def _land(self, mixed, params: Tree, slots: dict) -> tuple[Tree, dict]:
        """The mixed payload cast onto the committed tensors it replaces
        (``x_next`` -> params, ``<slot>_next`` -> that slot)."""
        names = self._overlap_names()
        vals = (mixed,) if len(names) == 1 else tuple(mixed)
        slots = dict(slots)
        for w, v in zip(names, vals):
            ref = params if w == "x_next" else slots[w[:-5]]
            cast = {k: v[k].to(ref[k].dtype) for k in ref}
            if w == "x_next":
                params = cast
            else:
                slots[w[:-5]] = cast
        return params, slots

    def update_pipelined(self, params: Tree, state: OptState, grads: Tree,
                         lr, io, pending=None) -> tuple[Tree, OptState]:
        """One overlapped step of the one-step-delayed-mix recursion.

        ``io`` (:class:`repro_torch.core.plan.OverlapIO`) mixes the
        in-flight ``state.buf`` with the PREVIOUS step's realization and
        packs this step's payload as the new buffer.  ``grads`` were taken
        at the PRE-mix params; the local transforms run on the mixed
        iterates.  ``pending`` is :meth:`start_delayed`'s round, already
        running (on the card, on a side stream): the local transforms wait
        for it; without it the round runs here, inline.  With no buffer
        (step 0, or a re-prime after a flushed checkpoint) the step is
        local: no mix, only the new payload."""
        slots = self._slots_of(state)
        if state.buf is not None:
            mixed = (pending.wait() if pending is not None else io.delayed(
                self.payload_template(params, state), state.buf))
            params_in, slots_in = self._land(mixed, params, slots)
        else:
            params_in, slots_in = params, slots
        tensors = dict(slots_in)
        tensors["x"] = params_in
        tensors["g"] = grads
        ctx = Context(tensors=tensors, lr=lr, count=state.count, mix=None)
        for t in self.transforms:
            if t.apply is not None and not t.where:   # the gossip waits
                t.apply(ctx)
        payload = tuple({k: _f32(v) for k, v in tensors[w].items()}
                        for w in self._overlap_names())
        buf = io.pack(payload[0] if len(payload) == 1 else payload)
        new_params = {k: v.to(params[k].dtype)
                      for k, v in tensors["x_next"].items()}
        new_slots = {s: {k: v.to(slots[s][k].dtype)
                         for k, v in tensors[s + "_next"].items()}
                     for s in self.slot_names}
        return new_params, self._state_of(new_slots, state.count + 1, buf)

    def flush_pending(self, params: Tree, state: OptState, io
                      ) -> tuple[Tree, OptState]:
        """Apply the pending in-flight mix and clear the buffer: the
        returned state (``buf=None``) holds what the synchronous recursion
        would hold after the last completed step.  Pure: the live pipeline
        can go on from the unflushed state (flush-on-save checkpoints,
        logged metrics), or resume from the flushed one with a priming
        step.  The caller waits for the round; on the card it runs on the
        side stream all the same, so that its payload-sized temporaries
        reuse the blocks the side stream's allocator caches for every
        delayed round, instead of the main stream caching a second set."""
        if state.buf is None:
            return params, state
        mixed = io.start(self.payload_template(params, state),
                         state.buf).wait()
        new_params, slots = self._land(mixed, params, self._slots_of(state))
        return new_params, self._state_of(slots, state.count)


def chain(*transforms, topology: Topology, name: str = "chain",
          beta: float = 0.0, warmup_steps: int = 0) -> DecentralizedOptimizer:
    """Compose transforms into a :class:`DecentralizedOptimizer`.

    ``None`` entries are skipped (an optional :func:`quantize_int8`).  An
    overlapped gossip is validated as in the reference (``ValueError`` for
    a composition the pipeline cannot run, e.g. qg_dmsgd's post-gossip
    EMA), and int8 or the overlap with a runtime-valued hook is refused
    with the reference's words."""
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
    overlap = opt.overlap   # fail fast on an invalid overlapped composition
    whens = {t.when for t in ts if t.where}
    if len(whens) > 1:
        raise ValueError(
            f"chain {name!r} mixes gossip(when=...) predicates; all gossip "
            "transforms share one realization per step, so they must share "
            "one skip gate")
    if opt.has_runtime_gossip:
        if opt.compression:
            raise ValueError(
                f"chain {name!r} combines int8 wire compression with "
                "runtime-valued gossip (weights_from / when / "
                "deadline_skip); the quantized combine needs static "
                "weights -- drop one")
        if overlap:
            raise ValueError(
                f"chain {name!r} combines the overlap pipeline with "
                "runtime-valued gossip (weights_from / when / "
                "deadline_skip); the in-flight realization cannot depend "
                "on runtime values -- drop one")
    deadline_idx = [i for i, t in enumerate(ts) if t.tag == "deadline"]
    if deadline_idx:
        gossip_idx = [i for i, t in enumerate(ts) if t.where]
        if not gossip_idx or deadline_idx[0] > gossip_idx[0]:
            raise ValueError(
                f"chain {name!r} places deadline_skip after (or without) "
                "its gossip transform; the gate must be set before the "
                "mix consumes it")
    return opt


def allreduce_warmup(tau: int):
    """Wrapping combinator (Corollary 3): returns ``opt -> opt'`` whose
    first ``tau`` steps mix with exact global averaging ``W = (1/n) 1 1^T``.
    ``GossipPlan`` folds the warm-up phase into its cache key."""

    def wrap(opt: DecentralizedOptimizer) -> DecentralizedOptimizer:
        if opt.has_runtime_gossip:
            raise ValueError(
                f"chain {opt.name!r} has runtime-valued gossip "
                "(weights_from / when / deadline_skip); the all-reduce "
                "warm-up executor takes no runtime operands -- start the "
                "runtime schedule after the warm-up, or drop one")
        return dataclasses.replace(opt, warmup_steps=int(tau))

    return wrap
