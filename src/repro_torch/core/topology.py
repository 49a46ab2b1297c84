"""Network topologies as sequences of gossip *realizations*.

A copy of the JAX package's ``core/topology.py`` (numpy only), for the
static-weight realization IR:

* :class:`Shifts`   -- circulant round: ``x_i += sum_d w_d x_{(i-s_d) mod n}``
  (ring, static/one-peer exponential, CECA-style circulant schedules).
* :class:`Matching` -- pairwise round: node ``i`` averages with
  ``partner[i]`` (one-peer hypercube, the 2-factor rounds of Base-(k+1)).
* :class:`Dense`    -- explicit ``(n, n)`` matrix round (star, grid, the
  >=3-clique rounds of Base-(k+1)).
* :class:`Identity` -- skipped round (``W = I``).

*When* each realization applies is a :class:`Schedule`: :class:`Static`,
:class:`Cyclic`, :class:`RandomPerm`, or :class:`Aperiodic` (a fresh
seeded draw per step: random matchings, the uniform one-peer order).
Every draw is numpy, as in the JAX package, so the same ``(n, seed,
step)`` realizes the same node there and here.

Weights are STATIC (Python or NumPy scalars: part of the node's identity
and of :class:`repro_torch.core.plan.GossipPlan`'s cache key) or
RUNTIME-valued (a ``torch.Tensor``, 0-d or ``(n,)`` per receiving node:
the port's counterpart of the reference's traced values).  A runtime
node keys by its wire structure only (``structure_key``), exposes its
weights (``weight_values``) and rebinds them (``with_weights``), so a
pool of differently weighted rounds of one structure shares one
executable.  :class:`Gated` realizes its inner round or ``Identity``
from a runtime gate, per node or for the whole round.

Conventions follow the paper: ``w_ij`` scales information flowing from node
``j`` to node ``i``; every realized ``W`` is doubly stochastic.  Static
undirected graphs use the Metropolis(-Hastings) rule.  Dense matrices are
numpy float64 ``(n, n)`` arrays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator

import numpy as np

__all__ = [
    "Shifts",
    "Matching",
    "Dense",
    "Identity",
    "IDENTITY",
    "Gated",
    "Realization",
    "Schedule",
    "Static",
    "Cyclic",
    "RandomPerm",
    "Aperiodic",
    "AperiodicScheduleError",
    "Topology",
    "one_peer_hypercube",
    "ring",
    "star",
    "grid_2d",
    "torus_2d",
    "half_random",
    "bipartite_random_match",
    "hypercube",
    "static_exponential",
    "one_peer_exponential",
    "base_k",
    "ceca",
    "full_averaging",
    "get_topology",
    "TOPOLOGIES",
]

class AperiodicScheduleError(ValueError):
    """A periodic-only code path (``gossip.mix_switch``,
    ``gossip.mix_scheduled``) was handed an aperiodic :class:`Schedule`."""


def _is_static_value(w) -> bool:
    """True when ``w`` is a concrete Python/NumPy scalar (part of the cache
    key); False for tensors (runtime values)."""
    return isinstance(w, (int, float, np.integer, np.floating))


# ---------------------------------------------------------------------------
# Realization IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Shifts:
    """Circulant realization: ``x_i^+ = self_w x_i + sum_d w_d x_{(i-s_d)%n}``.

    Each ``(s, w)`` descriptor means node ``i`` *sends* its buffer by
    ``+s`` (``torch.roll(x, s, 0)`` on the node axis) and receives from
    ``(i - s) mod n`` with weight ``w``.

    Weights are Python floats on the static path; any of them may instead
    be a tensor -- 0-d, or ``(n,)`` giving each RECEIVING node its own
    weight -- and the realization is then ``traced`` (runtime-valued).  A
    traced ``self_w=None`` derives the self weight as ``1 - sum_d w_d``
    per node.
    """

    self_w: float | None
    shifts: tuple  # tuple[(int shift, float-or-tensor weight), ...]

    def __post_init__(self):
        object.__setattr__(self, "shifts", tuple(
            (int(s), float(w) if _is_static_value(w) else w)
            for s, w in self.shifts))
        if _is_static_value(self.self_w):
            object.__setattr__(self, "self_w", float(self.self_w))
        elif self.self_w is None and not self.traced:
            raise ValueError(
                "Shifts(self_w=None) is only meaningful with runtime shift "
                "weights (self_w is then derived as 1 - sum of weights)")

    @property
    def traced(self) -> bool:
        return (not _is_static_value(self.self_w)
                or any(not _is_static_value(w) for _, w in self.shifts))

    def structure_key(self) -> tuple:
        """Hashable cache key: static nodes key by VALUES, runtime nodes by
        wire structure only (their weights are arguments)."""
        if not self.traced:
            return ("shifts", self.self_w, self.shifts)
        return ("shifts*", self.self_w is None,
                tuple(s for s, _ in self.shifts))

    def weight_values(self) -> tuple:
        """The weight operands, in ``(self_w?, *shift_ws)`` order
        (``self_w`` omitted when derived)."""
        ws = tuple(w for _, w in self.shifts)
        return ws if self.self_w is None else (self.self_w,) + ws

    def with_weights(self, values: tuple) -> "Shifts":
        """Rebuild from :meth:`weight_values`-ordered operands."""
        if self.self_w is None:
            self_w, ws = None, values
        else:
            self_w, ws = values[0], values[1:]
        return Shifts(self_w, tuple(
            (s, w) for (s, _), w in zip(self.shifts, ws)))

    def __eq__(self, other):
        if not isinstance(other, Shifts):
            return NotImplemented
        if self.traced or other.traced:
            return self is other
        return (self.self_w, self.shifts) == (other.self_w, other.shifts)

    def __hash__(self):
        if self.traced:
            return id(self)
        return hash(("Shifts", self.self_w, self.shifts))

    @property
    def max_degree(self) -> int:
        return len(self.shifts)

    def wire_multiplier(self, n: int) -> int:
        """Payload multiples one node sends per step (one per shift)."""
        return len(self.shifts)

    def dense(self, n: int) -> np.ndarray:
        if self.traced:
            raise ValueError(
                "a runtime-weight Shifts has no concrete dense matrix; "
                "resolve the weights first (with_weights) or use the "
                "gossip path")
        W = np.zeros((n, n), dtype=np.float64)
        np.fill_diagonal(W, self.self_w)
        for s, w in self.shifts:
            for i in range(n):
                W[i, (i - s) % n] += w
        return W


@dataclasses.dataclass(frozen=True, eq=False)
class Matching:
    """Pairwise realization: node ``i`` averages with ``partner[i]``.

    ``partner`` must be an involution (``partner[partner[i]] == i``); a
    fixed point ``partner[i] == i`` leaves node ``i`` silent that round.
    Paired nodes take ``w_self`` on their own value and ``1 - w_self`` on
    the partner's.  ``w_self`` is a Python float on the static path; a
    0-d or ``(n,)`` tensor makes the realization ``traced`` (per-node
    values make ``W`` row- but not column-stochastic unless both ends of
    every pair agree).
    """

    partner: tuple  # tuple[int, ...], involution over range(n)
    w_self: float = 0.5

    def __post_init__(self):
        p = tuple(int(j) for j in self.partner)
        object.__setattr__(self, "partner", p)
        if _is_static_value(self.w_self):
            object.__setattr__(self, "w_self", float(self.w_self))
        for i, j in enumerate(p):
            if not 0 <= j < len(p) or p[j] != i:
                raise ValueError(
                    f"Matching.partner must be an involution; "
                    f"partner[{i}]={j} but partner[{j}]={p[j] if 0 <= j < len(p) else '?'}")

    @property
    def traced(self) -> bool:
        return not _is_static_value(self.w_self)

    def structure_key(self) -> tuple:
        if not self.traced:
            return ("matching", self.partner, self.w_self)
        return ("matching*", self.partner)

    def weight_values(self) -> tuple:
        return (self.w_self,)

    def with_weights(self, values: tuple) -> "Matching":
        return Matching(self.partner, values[0])

    def __eq__(self, other):
        if not isinstance(other, Matching):
            return NotImplemented
        if self.traced or other.traced:
            return self is other
        return (self.partner, self.w_self) == (other.partner, other.w_self)

    def __hash__(self):
        if self.traced:
            return id(self)
        return hash(("Matching", self.partner, self.w_self))

    @property
    def max_degree(self) -> int:
        return 1

    def wire_multiplier(self, n: int) -> int:
        return 1

    def dense(self, n: int) -> np.ndarray:
        if self.traced:
            raise ValueError(
                "a runtime-weight Matching has no concrete dense matrix; "
                "resolve the weights first (with_weights) or use the "
                "gossip path")
        W = np.eye(n, dtype=np.float64)
        for i, j in enumerate(self.partner):
            if j != i:
                W[i, i] = self.w_self
                W[i, j] = 1.0 - self.w_self
        return W


@dataclasses.dataclass(frozen=True, eq=False)
class Dense:
    """Explicit doubly-stochastic ``(n, n)`` W: mixing is
    ``einsum('ij,jb->ib')`` on the packed buffer (an all-gather of O(n)
    bytes per node on a multi-node wire).  A tensor ``W`` is
    runtime-valued (``traced``)."""

    W: np.ndarray

    def __post_init__(self):
        if not self.traced:
            object.__setattr__(self, "W", np.asarray(self.W,
                                                     dtype=np.float64))

    @property
    def traced(self) -> bool:
        return not isinstance(self.W, (np.ndarray, list, tuple))

    def structure_key(self) -> tuple:
        return ("dense*",) if self.traced else ("dense", self.W.shape[0])

    def weight_values(self) -> tuple:
        return (self.W,)

    def with_weights(self, values: tuple) -> "Dense":
        return Dense(values[0])

    @property
    def max_degree(self) -> int:
        off = np.asarray(self.W).copy()
        np.fill_diagonal(off, 0.0)
        return int((off > 0).sum(axis=1).max(initial=0))

    def wire_multiplier(self, n: int) -> int:
        # the packed buffer is all-gathered: (n-1) payloads cross each
        # node's links, NOT the realization's fan-in
        return max(n - 1, 0)

    def dense(self, n: int) -> np.ndarray:
        return self.W


@dataclasses.dataclass(frozen=True)
class Identity:
    """Skipped round: ``W = I``, zero bytes on the wire."""

    traced = False

    def structure_key(self) -> tuple:
        return ("identity",)

    @property
    def max_degree(self) -> int:
        return 0

    def wire_multiplier(self, n: int) -> int:
        return 0

    def dense(self, n: int) -> np.ndarray:
        return np.eye(n, dtype=np.float64)


@dataclasses.dataclass(frozen=True, eq=False)
class Gated:
    """Runtime-gated realization: ``inner`` when ``gate`` holds, else
    :class:`Identity` -- per NODE when ``gate`` is an ``(n,)`` bool tensor
    (a straggler drops out of the round; its row of ``W`` collapses to
    ``e_i``), for the whole round when ``gate`` is a 0-d tensor.

    The wire of ``inner`` is always issued -- a gated-off round still
    gathers its rows, only the combine is gated.  Under a per-node gate
    the edge ``(i, j)`` is active only when BOTH endpoints are alive, so
    symmetric ``Matching`` rounds stay exactly mean-preserving, while
    directed ``Shifts`` rounds are row- but not column-stochastic.

    A Python or NumPy bool gate folds at construction (``inner`` or
    ``IDENTITY``) and never builds a ``Gated`` node.
    """

    inner: "Realization"
    gate: object   # 0-d or (n,) bool tensor

    def __post_init__(self):
        if isinstance(self.inner, (Gated, Identity)):
            raise TypeError(
                f"Gated(inner={type(self.inner).__name__}) is not "
                "meaningful; gate a Shifts/Matching/Dense round directly")

    def __new__(cls, inner=None, gate=None):
        if isinstance(gate, (bool, np.bool_)):
            return inner if gate else IDENTITY
        return super().__new__(cls)

    traced = True

    def structure_key(self) -> tuple:
        return ("gated", getattr(self.gate, "ndim", 0) == 0,
                self.inner.structure_key())

    def weight_values(self) -> tuple:
        return (self.gate,) + self.inner.weight_values()

    def with_weights(self, values: tuple) -> "Gated":
        return Gated(self.inner.with_weights(tuple(values[1:])), values[0])

    @property
    def max_degree(self) -> int:
        return self.inner.max_degree

    def wire_multiplier(self, n: int) -> int:
        # the wire structure is always issued (see class docstring)
        return self.inner.wire_multiplier(n)

    def dense(self, n: int) -> np.ndarray:
        raise ValueError(
            "a Gated realization is runtime-valued; it has no concrete "
            "dense matrix")


Realization = Shifts | Matching | Dense | Identity | Gated
IDENTITY = Identity()


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Static:
    """One realization forever."""

    is_periodic = True
    period = 1

    def index(self, step: int) -> int:
        return 0


@dataclasses.dataclass(frozen=True)
class Cyclic:
    """Visit the ``period`` realizations in order, repeating."""

    period: int
    is_periodic = True

    def index(self, step: int) -> int:
        return step % self.period


@dataclasses.dataclass(frozen=True, eq=False)
class RandomPerm:
    """Without-replacement shuffle of the realization set per period block
    (Remark 5: exact averaging per period is preserved).  The step ->
    realization map is NOT periodic, but the realization SET stays finite,
    so compile caches stay bounded."""

    num: int
    seed: int = 0
    is_periodic = False

    def __post_init__(self):
        object.__setattr__(self, "_rng", np.random.default_rng(self.seed))
        object.__setattr__(self, "_perms", [])

    @property
    def period(self):
        return None

    def index(self, step: int) -> int:
        block, off = divmod(step, self.num)
        while len(self._perms) <= block:
            self._perms.append(self._rng.permutation(self.num))
        return int(self._perms[block][off])


@dataclasses.dataclass(frozen=True, eq=False)
class Aperiodic:
    """A fresh realization per step: ``draw(step) -> Realization``.

    Draws are deterministic in ``step`` (seeded), so replays and cache
    keys stay reproducible.  There is no step -> index map (``index``
    raises), and :class:`repro_torch.core.plan.GossipPlan` builds one
    executable per distinct realization drawn."""

    draw: Callable[[int], Realization]
    is_periodic = False

    @property
    def period(self):
        return None

    def index(self, step: int) -> int:
        raise AperiodicScheduleError(
            f"{self!r} draws realizations directly; it has no index map")


Schedule = Static | Cyclic | RandomPerm | Aperiodic


def _metropolis(adj: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings weights for an undirected adjacency (no self loops).

    w_ij = 1 / (1 + max(deg_i, deg_j)) for edges, w_ii = 1 - sum_j w_ij.
    Produces a symmetric doubly-stochastic matrix.
    """
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    W = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for j in range(n):
            if i != j and adj[i, j]:
                W[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        W[i, i] = 1.0 - W[i].sum()
    return W


@dataclasses.dataclass(frozen=True)
class Topology:
    """A (possibly time-varying) gossip topology over ``n`` nodes.

    Attributes:
      name: identifier.
      n: number of nodes.
      max_degree: maximum number of out-neighbors excluding self of any node
        in one realization -- the paper's per-iteration communication
        measure.
      realizations: the finite tuple of :data:`Realization` values the
        schedule selects from (None when the schedule is
        :class:`Aperiodic` and draws them per step).
      schedule: WHICH realization applies at each step; defaults to
        :class:`Static`/:class:`Cyclic` over ``realizations``.

    ``realization(step)`` is the one accessor the gossip stack consumes;
    ``weights(step)`` densifies for analysis code.
    """

    name: str
    n: int
    max_degree: int = 0
    realizations: tuple | None = None
    schedule: Schedule | None = None

    def __post_init__(self):
        object.__setattr__(self, "n", int(self.n))
        object.__setattr__(self, "max_degree", int(self.max_degree))
        if self.realizations is not None:
            object.__setattr__(self, "realizations",
                               tuple(self.realizations))
        if self.schedule is None:
            if not self.realizations:
                raise ValueError("Topology needs a schedule or realizations")
            object.__setattr__(
                self, "schedule",
                Static() if len(self.realizations) == 1
                else Cyclic(len(self.realizations)))
        if self.realizations is None and not isinstance(self.schedule,
                                                        Aperiodic):
            raise ValueError(
                "Topology needs realizations=... unless the schedule is "
                "Aperiodic (which draws them per step)")

    def realization(self, step: int = 0) -> Realization:
        """The IR node describing step ``step``'s gossip round."""
        if isinstance(self.schedule, Aperiodic):
            return self.schedule.draw(step)
        return self.realizations[self.schedule.index(step)]

    def realization_types(self) -> frozenset:
        """IR node types this topology realizes.  For an :class:`Aperiodic`
        schedule without a realization set this samples ``draw(0)`` (the
        draws of every family here are of one type)."""
        if self.realizations is not None:
            return frozenset(type(r) for r in self.realizations)
        return frozenset({type(self.realization(0))})

    @property
    def period(self) -> int | None:
        """Steps before the schedule repeats (None when aperiodic)."""
        return self.schedule.period

    @property
    def time_varying(self) -> bool:
        return not isinstance(self.schedule, Static)

    def weights(self, step: int = 0) -> np.ndarray:
        """Densified ``W^{(step)}`` (analysis/reference path)."""
        return self.realization(step).dense(self.n)

    def all_weights(self) -> list[np.ndarray]:
        if self.period is None:
            raise AperiodicScheduleError(
                f"{self.name!r} has an aperiodic schedule "
                f"({self.schedule!r}); there is no finite matrix list")
        return [self.weights(k) for k in range(self.period)]

    def iter_weights(self) -> Iterator[np.ndarray]:
        k = 0
        while True:
            yield self.weights(k)
            k += 1


def _static(name: str, n: int, realization: Realization,
            max_degree: int) -> Topology:
    return Topology(name, n, max_degree=max_degree,
                    realizations=(realization,), schedule=Static())


# ---------------------------------------------------------------------------
# Static topologies
# ---------------------------------------------------------------------------

def ring(n: int) -> Topology:
    """Undirected ring; Metropolis weights. 1-rho = O(1/n^2)."""
    adj = np.zeros((n, n), dtype=bool)
    for i in range(n):
        adj[i, (i + 1) % n] = adj[i, (i - 1) % n] = True
    if n <= 2:  # degenerate: fully connected
        adj = ~np.eye(n, dtype=bool)
    W = _metropolis(adj)
    if n >= 3:
        # ring is a circulant: shifts +-1 with equal weights
        w_off = W[0, 1]
        real = Shifts(1.0 - 2 * w_off, ((1, w_off), (-1, w_off)))
        return _static("ring", n, real, 2)
    return _static("ring", n, Dense(W), max(n - 1, 0))


def star(n: int) -> Topology:
    """Undirected star (node 0 is the hub); Metropolis weights."""
    adj = np.zeros((n, n), dtype=bool)
    adj[0, 1:] = adj[1:, 0] = True
    return _static("star", n, Dense(_metropolis(adj)), n - 1)


def _grid_dims(n: int) -> tuple[int, int]:
    r = int(math.floor(math.sqrt(n)))
    while n % r:
        r -= 1
    return r, n // r


def grid_2d(n: int) -> Topology:
    """Undirected 2D grid (no wraparound); Metropolis weights."""
    r, c = _grid_dims(n)
    adj = np.zeros((n, n), dtype=bool)
    for i in range(r):
        for j in range(c):
            u = i * c + j
            if i + 1 < r:
                adj[u, (i + 1) * c + j] = adj[(i + 1) * c + j, u] = True
            if j + 1 < c:
                adj[u, i * c + j + 1] = adj[i * c + j + 1, u] = True
    return _static("grid", n, Dense(_metropolis(adj)), 4)


def torus_2d(n: int) -> Topology:
    """Undirected 2D torus (wraparound grid); Metropolis weights."""
    r, c = _grid_dims(n)
    adj = np.zeros((n, n), dtype=bool)
    for i in range(r):
        for j in range(c):
            u = i * c + j
            for v in (((i + 1) % r) * c + j, i * c + (j + 1) % c):
                if v != u:
                    adj[u, v] = adj[v, u] = True
    return _static("torus", n, Dense(_metropolis(adj)), 4)


def half_random(n: int, seed: int = 0) -> Topology:
    """1/2-random graph (App. A.3.1): each edge iid with p=1/2, W = A'/d_max,
    the leftover mass on the diagonal (a lazy walk, doubly stochastic)."""
    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((n, n)) < 0.5, k=1)
    adj = adj | adj.T
    d_max = max(int(adj.sum(axis=1).max()), 1)
    W = adj.astype(np.float64) / d_max
    np.fill_diagonal(W, 1.0 - W.sum(axis=1))
    deg = int(adj.sum(axis=1).max())
    return _static("half_random", n, Dense(W), deg)


def hypercube(n: int) -> Topology:
    """Hypercube graph (Remark 2): requires n = 2^tau; symmetric, weights
    1/(1+log2 n) on each of the log2(n) bit-flip neighbors."""
    tau = int(round(math.log2(n)))
    if 2 ** tau != n:
        raise ValueError(f"hypercube requires n to be a power of 2, got {n}")
    W = np.zeros((n, n), dtype=np.float64)
    w = 1.0 / (tau + 1)
    for i in range(n):
        W[i, i] = w
        for t in range(tau):
            W[i, i ^ (1 << t)] = w
    return _static("hypercube", n, Dense(W), tau)


def static_exponential(n: int) -> Topology:
    """Static exponential graph, eq. (5): node i receives from i + 2^t
    (mod n), t = 0..ceil(log2 n)-1, each with weight 1/(tau+1).  Directed,
    circulant, doubly stochastic. 1-rho = 2/(1+ceil(log2 n)) for even n
    (Proposition 1)."""
    if n == 1:
        return _static("static_exp", 1, Dense(np.ones((1, 1))), 0)
    tau = int(math.ceil(math.log2(n)))
    offsets = sorted({(2 ** t) % n for t in range(tau)} - {0})
    w = 1.0 / (len(offsets) + 1)
    # node i receives from i + off  =>  send shift s = -off
    real = Shifts(w, tuple((-off, w) for off in offsets))
    return _static("static_exp", n, real, len(offsets))


# ---------------------------------------------------------------------------
# Time-varying topologies
# ---------------------------------------------------------------------------

def one_peer_exponential(
    n: int, schedule: str = "cyclic", seed: int = 0
) -> Topology:
    """One-peer exponential graph, eq. (7).

    W^{(k)}_{ij} = 1/2 if log2(mod(j - i, n)) == mod(k, tau), 1/2 if i == j.
    ``schedule`` selects the order the tau realizations are visited:
      - "cyclic": k -> mod(k, tau)              (paper main body; Lemma 1)
      - "random_perm": without-replacement shuffles per period (Remark 5).
      - "uniform": with replacement (Remark 5 / App. B.3.2: exact
        averaging only asymptotically) -- an :class:`Aperiodic` draw of
        ``default_rng(seed).integers(tau)`` per step.
    """
    if n == 1:
        return _static("one_peer_exp", 1, Dense(np.ones((1, 1))), 0)
    tau = int(math.ceil(math.log2(n)))
    reals = tuple(Shifts(0.5, ((-((2 ** t) % n), 0.5),)) for t in range(tau))

    if schedule == "cyclic":
        sched: Schedule = Cyclic(tau)
    elif schedule == "random_perm":
        sched = RandomPerm(tau, seed)
    elif schedule == "uniform":
        rng = np.random.default_rng(seed)
        draws: list[int] = []

        def draw(k: int) -> Realization:
            while len(draws) <= k:
                draws.append(int(rng.integers(tau)))
            return reals[draws[k]]

        sched = Aperiodic(draw)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")

    name = "one_peer_exp" if schedule == "cyclic" else f"one_peer_exp_{schedule}"
    return Topology(name, n, max_degree=1,
                    realizations=None if schedule == "uniform" else reals,
                    schedule=sched)


def _hypercube_matchings(n: int) -> tuple:
    tau = int(round(math.log2(n)))
    if 2 ** tau != n:
        raise ValueError(f"one_peer_hypercube requires n=2^tau, got {n}")
    return tuple(
        Matching(tuple(i ^ (1 << t) for i in range(n)), 0.5)
        for t in range(tau))


def one_peer_hypercube(n: int) -> Topology:
    """One-peer hypercube (Remark 6): at step k each node pairs with its
    bit-flip neighbor i ^ 2^{mod(k, tau)} and they average.  Undirected
    and symmetric, requires n = 2^tau; exact averaging after tau steps."""
    reals = _hypercube_matchings(n)
    return Topology("one_peer_hypercube", n, max_degree=1,
                    realizations=reals, schedule=Cyclic(len(reals)))


def bipartite_random_match(n: int, seed: int = 0,
                           pool: int | None = None) -> Topology:
    """Bipartite random match graph (App. A.3.1): a random perfect matching
    per step; matched pairs average (w = 1/2 each).  Requires even n.

    An :class:`Aperiodic` schedule drawing a fresh :class:`Matching` per
    step, seeded by ``(seed, k)``: stateless and reproducible.  ``pool=k``
    draws each step's matching from a pre-seeded pool of ``k`` distinct
    matchings instead, so :class:`repro_torch.core.plan.GossipPlan`'s
    cache plateaus at <= ``k`` executables."""
    if n % 2:
        raise ValueError("bipartite_random_match requires even n")

    def draw_matching(rng) -> Realization:
        perm = rng.permutation(n)
        partner = np.empty(n, dtype=np.int64)
        for j in range(n // 2):
            a, b = int(perm[2 * j]), int(perm[2 * j + 1])
            partner[a], partner[b] = b, a
        return Matching(tuple(partner), 0.5)

    if pool is None:
        def draw(k: int) -> Realization:
            return draw_matching(np.random.default_rng((seed, k)))

        return Topology("random_match", n, max_degree=1,
                        schedule=Aperiodic(draw))

    if pool < 1:
        raise ValueError(f"random_match pool must be >= 1, got {pool}")
    matchings: list = []
    rng0 = np.random.default_rng((seed, 0x9E3779B9))
    for _ in range(100 * pool):    # distinct entries; tiny n has only
        if len(matchings) == pool:  # (n-1)!! matchings, so cap the retries
            break
        m = draw_matching(rng0)
        if m not in matchings:
            matchings.append(m)
    size = len(matchings)

    def draw(k: int) -> Realization:
        return matchings[int(np.random.default_rng((seed, k)).integers(size))]

    return Topology("random_match", n, max_degree=1,
                    realizations=tuple(matchings), schedule=Aperiodic(draw))


def _factorize(n: int, kmax: int) -> list[int]:
    """Greedy largest-first factorization of ``n`` into factors <= kmax."""
    if n < 2:
        return []
    fs, m = [], n
    while m > 1:
        for f in range(min(kmax, m), 1, -1):
            if m % f == 0:
                fs.append(f)
                m //= f
                break
        else:
            raise ValueError(
                f"n={n} has a prime factor > {kmax}; pick a larger k")
    return fs


def base_k(n: int, k: int | None = None) -> Topology:
    """Finite-time Base-(k+1) graph (Takezawa et al., 2023): factor
    ``n = f_1 * ... * f_L`` with every ``f_i <= k + 1`` and at round ``t``
    average each clique of nodes differing only in mixed-radix digit ``t``
    (uniform weight ``1/f_t``).  One period's product is EXACTLY
    ``(1/n) 1 1^T``.  Rounds with ``f_t = 2`` are :class:`Matching`
    realizations; ``f_t >= 3`` cliques are :class:`Dense`.  ``k=None``
    picks the smallest degree that factors ``n``."""
    if n == 1:
        return _static("base_k", 1, Dense(np.ones((1, 1))), 0)
    if k is None:
        p, m, f = 2, n, 2
        while m > 1:
            while m % f == 0:
                p, m = f, m // f
            f += 1 if f == 2 else 2
            if f * f > m and m > 1:
                p, m = m, 1
        k = p - 1
    if k < 1:
        raise ValueError(f"base_k needs k >= 1, got {k}")
    factors = _factorize(n, k + 1)
    reals = []
    stride = 1
    for f in factors:
        # digit value of node i at this radix position: (i // stride) % f
        if f == 2:
            partner = tuple(
                i + stride if (i // stride) % 2 == 0 else i - stride
                for i in range(n))
            reals.append(Matching(partner, 0.5))
        else:
            W = np.zeros((n, n), dtype=np.float64)
            for i in range(n):
                d = (i // stride) % f
                base = i - d * stride
                for dd in range(f):
                    W[i, base + dd * stride] = 1.0 / f
            reals.append(Dense(W))
        stride *= f
    return Topology(f"base_{k + 1}", n, max_degree=max(factors) - 1,
                    realizations=tuple(reals), schedule=Cyclic(len(reals)))


def ceca(n: int) -> Topology:
    """CECA-style finite-time circulant schedule: exact average in ``L``
    rounds for ANY ``n`` using only circulant shift rounds.  Factor ``n``
    into primes ``f_1 * ... * f_L``; round ``t`` mixes ``W_t = (1/f_t)
    sum_{j<f_t} P^{j m_t}`` with ``m_t`` the prefix product of earlier
    factors, so ``prod_t W_t = (1/n) 1 1^T``.  A prime ``n`` gives one
    round of degree ``n - 1``."""
    if n == 1:
        return _static("ceca", 1, Dense(np.ones((1, 1))), 0)
    factors, m, f = [], n, 2                     # prime factors, ascending
    while m > 1:
        while m % f == 0:
            factors.append(f)
            m //= f
        f += 1 if f == 2 else 2
        if f * f > m and m > 1:
            factors.append(m)
            break
    reals = []
    stride = 1
    for f in factors:
        reals.append(Shifts(
            1.0 / f, tuple((-(j * stride), 1.0 / f) for j in range(1, f))))
        stride *= f
    return Topology("ceca", n, max_degree=max(factors) - 1,
                    realizations=tuple(reals), schedule=Cyclic(len(reals)))


def full_averaging(n: int) -> Topology:
    """Complete graph with uniform weights: W = (1/n) 1 1^T (parallel SGD)."""
    return _static("full", n, Dense(np.full((n, n), 1.0 / n)), n - 1)


TOPOLOGIES: dict[str, Callable[..., Topology]] = {
    "ring": ring,
    "star": star,
    "grid": grid_2d,
    "torus": torus_2d,
    "half_random": half_random,
    "hypercube": hypercube,
    "static_exp": static_exponential,
    "one_peer_exp": one_peer_exponential,
    "one_peer_hypercube": one_peer_hypercube,
    "random_match": bipartite_random_match,
    "base_k": base_k,
    "ceca": ceca,
    "full": full_averaging,
}


def get_topology(name: str, n: int, **kw) -> Topology:
    if name not in TOPOLOGIES:
        raise KeyError(f"unknown topology {name!r}; options: {sorted(TOPOLOGIES)}")
    return TOPOLOGIES[name](n, **kw)
