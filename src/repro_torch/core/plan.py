"""GossipPlan: realization-IR-driven executable planning + keyed cache.

The port of the JAX package's ``core/plan.py`` for synchronous gossip.
One object owns schedule resolution: a :class:`GossipPlan` pattern-matches
the realization IR (:mod:`repro_torch.core.topology`) and keys every
"executable" by the gossip REALIZATION, with the JAX package's keys:

* ``Shifts`` / ``Matching`` -- one executable per distinct realization
  (``structure_key()``: the weights and the shifts or the pairing).  An
  aperiodic matching stream (``random_match``) builds one per distinct
  pairing it visits, LRU-bounded by ``max_compiles``; a pooled stream
  plateaus at <= its pool.
* ``Dense`` -- a Static schedule bakes ``W`` into one executable
  (``("static",)``); a time-varying dense schedule shares ONE
  ``("dense",)`` executable that takes the realized ``W^{(k)}`` as its
  leading argument.
* ``Identity`` -- the skipped-communication executable (``gossip(every=k)``
  off-steps).
* Runtime-valued rounds (tensor weights, ``Gated``) key by wire STRUCTURE
  (``structure_key()``), so a pool of differently weighted rounds of one
  structure shares ONE executable, the weights fed as its leading
  argument.
* A ``gossip(when=...)`` chain (``scheduled=True``) builds ONE
  ``("scheduled",)`` executable: its mix reads the schedule position from
  optimizer state.

The all-reduce warm-up phase (Corollary 3) is folded into the key:
``realization_key(step) == ("warmup",)`` for ``step < warmup_steps``, so
a warm-up executable never serves post-warm-up steps or vice versa.

PyTorch runs eagerly, so an "executable" is the bound step function
``fn(mix, *args)`` with its realization's ``mix`` closed over, cached in a
:class:`CompileCache` -- the cache's hit/miss counters and
``num_compiled`` then match the JAX plan's on the same schedule.  The
overlapped pipeline (``OverlapIO``) is ROADMAP slice C item 10;
``flush_step_fn`` is the identity.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

from . import gossip
from .cache import CompileCache
from .topology import (AperiodicScheduleError, Dense, Identity, Static,
                       Topology, full_averaging)

Tree = Any

__all__ = ["CompileCache", "GossipPlan"]


@dataclasses.dataclass
class GossipPlan:
    """Realization resolution + executable cache for one (topology,
    warm-up phase, communication interval) triple.

    ``fn(mix, *args)`` is the function bound per realization.
    ``warmup_steps`` and ``every`` normally come from the optimizer (see
    :meth:`for_optimizer`); ``max_compiles`` bounds the cache."""

    topology: Topology
    warmup_steps: int = 0
    fn: Callable | None = None
    every: int = 1
    max_compiles: int = 256
    # data-dependent schedule: ONE executable whose mix takes
    # ``mix(t, pos, gate=None, **kw)`` with the schedule position read
    # from optimizer state (``gossip.mix_scheduled``)
    scheduled: bool = False

    def __post_init__(self):
        # LRU-bounded, as the reference's: a periodic schedule's working
        # set is its period, far below the bound; an aperiodic matching
        # stream would otherwise grow the cache for the whole run
        self._cache = CompileCache(max_entries=self.max_compiles)
        if self.scheduled:
            if self.warmup_steps:
                raise ValueError(
                    "scheduled=True cannot combine with the all-reduce "
                    "warm-up phase: the warm-up executor takes no "
                    "schedule position")
            if self.every > 1:
                raise ValueError(
                    "scheduled=True generalizes every=k (the runtime gate "
                    "decides which rounds communicate); set one, not both")
            if not self.topology.schedule.is_periodic:
                raise AperiodicScheduleError(
                    f"scheduled=True needs a periodic schedule (the "
                    f"position is taken mod the period), but "
                    f"{self.topology.name!r} carries "
                    f"{self.topology.schedule!r}")

    @classmethod
    def for_optimizer(cls, opt, fn: Callable | None = None) -> "GossipPlan":
        """Plan matching a chain-built optimizer's topology, warm-up phase,
        communication interval and data-dependent schedule
        (``gossip(when=...)`` -> ``scheduled=True``)."""
        return cls(opt.topology, warmup_steps=opt.warmup_steps, fn=fn,
                   every=opt.gossip_every,
                   scheduled=bool(getattr(opt, "scheduled_gossip", False)))

    # -- classification -------------------------------------------------------

    def realization(self, step: int):
        """The realization IR node step ``step`` executes (including the
        ``every=k`` skipped rounds, which realize as ``Identity``)."""
        k = int(step)
        if self.every > 1:
            if k % self.every:
                return Identity()
            k //= self.every
        return self.topology.realization(k)

    def realization_key(self, step: int) -> tuple:
        """Hashable cache key for ``step``'s executable."""
        k = int(step)
        if self.warmup_steps and k < self.warmup_steps:
            return ("warmup",)
        if self.scheduled:
            return ("scheduled",)
        r = self.realization(k)
        if isinstance(r, Dense):
            if not r.traced and isinstance(self.topology.schedule, Static):
                return ("static",)
            return ("dense",)   # time-varying / runtime: W an argument
        return r.structure_key()

    @property
    def num_compiled(self) -> int:
        return len(self._cache)

    def cache_stats(self) -> dict:
        """Hit/miss/eviction counters of the executable cache."""
        return self._cache.stats()

    # -- executors ------------------------------------------------------------

    def mix(self, step: int) -> Callable[[Tree], Tree]:
        """The bare gossip executor for ``step``'s realization.  It takes
        ``meta=``/``edge_weight=``/``node_gate=`` so transform hooks
        (``weights_from``, ``deadline_skip``) reach the runtime combine;
        a scheduled plan's takes ``mix(t, pos, gate=None, **kw)``."""
        k = int(step)
        if self.warmup_steps and k < self.warmup_steps:
            top_full = full_averaging(self.topology.n)
            return lambda t: gossip.mix(t, top_full, 0)
        if self.scheduled:
            top = self.topology
            return lambda t, pos, gate=None, **kw: gossip.mix_scheduled(
                t, top, pos, gate, **kw)
        r = self.realization(k)
        return lambda t, **kw: gossip.mix_realization(t, r, **kw)

    def step_fn(self, step: int) -> Callable:
        """The executable for ``step``'s realization: the same realization
        gives the SAME callable (built once).  The time-varying dense
        regime returns a per-step wrapper feeding the realized ``W^{(k)}``
        into one shared executable, and a runtime-valued round one feeding
        its weights (and gate) into its structure's executable."""
        fn = self._require_fn()
        key = self.realization_key(step)
        if key == ("dense",):
            shared = self._cache.get(key, lambda: (
                lambda W, *a: fn(lambda t: gossip.mix_dense(t, W), *a)))
            W = self.realization(int(step)).dense(self.topology.n)
            return lambda *a: shared(W, *a)
        k = int(step)
        if not (self.warmup_steps and k < self.warmup_steps) \
                and not self.scheduled:
            r = self.realization(k)
            if r.traced:
                shared = self._cache.get(key, lambda: (
                    lambda wvals, *a: fn(
                        lambda t, **kw: gossip.mix_realization(
                            t, r.with_weights(wvals), **kw), *a)))
                wvals = r.weight_values()
                return lambda *a: shared(wvals, *a)
        mix = self.mix(step)
        return self._cache.get(key, lambda: functools.partial(fn, mix))

    def flush_step_fn(self, step: int) -> Callable:
        """Drain of the overlapped pipeline (slice C): the identity for
        synchronous plans, kept so the driver's loop reads as the JAX one."""
        return lambda *a: a

    def _require_fn(self) -> Callable:
        if self.fn is None:
            raise ValueError(
                "GossipPlan has no bound step function; construct with "
                "fn=...")
        return self.fn
