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
``num_compiled`` then match the JAX plan's on the same schedule.

``compression`` (``"int8"``, from the optimizer's ``quantize_int8``)
reaches every Shifts and Matching round; a topology that realizes
``Dense`` refuses it, and the warm-up rounds mix in full precision.

``mesh`` (a live :class:`~repro_torch.launch.mesh.Mesh` whose ``node``
axis has one rank per node) sends every round -- the warm-up, Dense,
runtime and delayed ones too -- through the shard-native engine of
:mod:`repro_torch.core.gossip`: each rank's executables mix its block of
the payload over the mesh's wire (each rank's block is cut by
``launch.sharding.local_shard``; the engine reads no specs).  The keys,
and so
``num_compiled`` and the cache counters, are the same with and without
a mesh.  Every executor the step receives is a :class:`MixExecutor`,
whose ``mean`` averages over the nodes on the same wire (the all-reduce
baseline's gradients).

**Overlap plans** (``overlap=True``, from ``gossip(..., overlap=True)``
optimizers) bind the one-step-delayed step instead: ``mix``/``step_fn(k)``
hand the step an :class:`OverlapIO` whose ``delayed`` half applies the
realization in flight at ``k`` (step k-1's) to the state's packed buffer
and whose ``pack`` half packs step k's payload; the keys gain the overlap
phase (``("overlap", "prime")``, ``("overlap",) + key(k-1)``, ``("overlap",
"flush") + key(k-1)``), and ``flush_step_fn(k)`` drains the pipeline for
checkpoints and metrics.  On the card :meth:`OverlapIO.start` runs the
delayed round on a side CUDA stream, under the step's backward; on a
mesh it posts the round's wire, which moves under the backward, and the
wait combines.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from . import flatbuf, gossip
from .cache import CompileCache
from .topology import (AperiodicScheduleError, Dense, Identity, Matching,
                       Shifts, Static, Topology, full_averaging)

Tree = Any

__all__ = ["CompileCache", "GossipPlan", "OverlapIO", "InFlight",
           "MixExecutor"]


@functools.cache
def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one side stream per card that delayed rounds run on."""
    return torch.cuda.Stream(device)


class InFlight:
    """A delayed round started by :meth:`OverlapIO.start`.  ``wait()``
    makes the current stream wait for it and returns the mixed tree;
    ``begin``/``done`` are its timing events on the side stream (None when
    it ran inline, on the CPU, or on a mesh).  On a mesh ``pending`` is
    the round whose wire is posted: ``wait()`` completes the wire,
    combines and unpacks."""

    def __init__(self, mixed: Tree = None, begin=None, done=None,
                 device=None, pending=None):
        self.mixed, self.begin, self.done = mixed, begin, done
        self.device, self.pending = device, pending

    def wait(self) -> Tree:
        if self.pending is not None:
            self.mixed, self.pending = self.pending.wait(), None
        if self.done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(self.done)
            # allocated on the side stream, read and freed on this one
            seen = set()
            for leaf in flatbuf.tree_flatten(self.mixed)[0]:
                ptr = leaf.untyped_storage().data_ptr()
                if ptr not in seen:
                    seen.add(ptr)
                    leaf.record_stream(cur)
        return self.mixed


class MixExecutor:
    """A realization-bound gossip executor, as the plan hands it to the
    step: calling it mixes a payload (``fn``); :meth:`mean` is the exact
    node mean on the same wire (``gossip.node_mean``: on the plan's mesh
    a ``psum``), what ``transforms.average_gradients`` reads."""

    def __init__(self, fn: Callable, mesh=None):
        self.fn, self.mesh = fn, mesh

    def __call__(self, *args, **kw):
        return self.fn(*args, **kw)

    def mean(self, tree: Tree) -> Tree:
        return gossip.node_mean(tree, mesh=self.mesh)


@dataclasses.dataclass(frozen=True)
class OverlapIO:
    """Gossip I/O of one overlapped (delayed-mix) step, handed to the step
    in place of the synchronous ``mix``: ``pack(payload)`` packs this
    step's pre-mix payload into the in-flight buffers, and
    ``delayed(template, bufs)`` rolls or gathers and combines the PREVIOUS
    step's buffers with ``realization``.  ``realization is None`` marks
    the priming step (nothing in flight)."""

    realization: Any            # in-flight IR node (None at the prime step)
    compression: str | None = None
    mesh: Any = None
    axis_name: str = "node"

    @property
    def prime(self) -> bool:
        return self.realization is None

    def pack(self, payload: Tree) -> tuple:
        return gossip.pack_payload(payload, mesh=self.mesh,
                                   axis_name=self.axis_name)

    def delayed(self, template: Tree, bufs) -> Tree:
        """The delayed round, inline on the current stream."""
        if self.prime:
            raise ValueError("priming step has no in-flight payload to mix")
        return gossip.delayed_mix(template, bufs, self.realization,
                                  compression=self.compression,
                                  mesh=self.mesh, axis_name=self.axis_name)

    def start(self, template: Tree, bufs) -> InFlight:
        """Start :meth:`delayed`.  On a mesh the round's wire is staged and
        posted here (``gossip.delayed_post``) and the caller's next work
        overlaps it; ``wait()`` completes the wire, then combines on the
        current stream.  Without a mesh, on CUDA buffers the round runs on
        the card's side stream, after everything queued on the current
        stream (which packed ``bufs``), so the caller's next work overlaps
        it; on CPU buffers inline.  The results are the same bits either
        way."""
        if self.prime:
            raise ValueError("priming step has no in-flight payload to mix")
        if self.mesh is not None:
            return InFlight(pending=gossip.delayed_post(
                template, bufs, self.realization,
                compression=self.compression, mesh=self.mesh,
                axis_name=self.axis_name))
        dev = bufs[0].device
        if dev.type != "cuda":
            return InFlight(self.delayed(template, bufs))
        main = torch.cuda.current_stream(dev)
        side = _side_stream(dev)
        side.wait_stream(main)
        for b in bufs:          # the caller may drop them while side reads
            b.record_stream(side)
        with torch.cuda.stream(side):
            begin = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            begin.record(side)
            mixed = self.delayed(template, bufs)
            done.record(side)
        return InFlight(mixed, begin, done, dev)


@dataclasses.dataclass
class GossipPlan:
    """Realization resolution + executable cache for one (topology,
    warm-up phase, communication interval) triple.

    ``fn(mix, *args)`` is the function bound per realization.
    ``warmup_steps``, ``compression``, ``every``, ``overlap`` and
    ``scheduled`` normally come from the optimizer (see
    :meth:`for_optimizer`); ``max_compiles`` bounds the cache.  ``mesh``
    selects the shard-native engine (module docstring)."""

    topology: Topology
    warmup_steps: int = 0
    compression: str | None = None
    fn: Callable | None = None
    mesh: Any = None
    every: int = 1
    max_compiles: int = 256
    # the one-step-delayed pipeline: ``step_fn(t)`` binds an OverlapIO
    # (step t-1's realization in flight), keyed with the overlap phase
    overlap: bool = False
    # ``flush_fn(io, *args)`` drains the in-flight buffer (overlap plans;
    # ``for_optimizer`` binds the optimizer's ``flush_pending``)
    flush_fn: Callable | None = None
    # data-dependent schedule: ONE executable whose mix takes
    # ``mix(t, pos, gate=None, **kw)`` with the schedule position read
    # from optimizer state (``gossip.mix_scheduled``)
    scheduled: bool = False

    def __post_init__(self):
        # LRU-bounded, as the reference's: a periodic schedule's working
        # set is its period, far below the bound; an aperiodic matching
        # stream would otherwise grow the cache for the whole run
        self._cache = CompileCache(max_entries=self.max_compiles)
        if self.compression:
            types = self.topology.realization_types()
            if not types <= {Shifts, Matching, Identity}:
                # the int8 wire exists for the permute paths only: refuse
                # rather than silently send f32
                raise ValueError(
                    f"compression={self.compression!r} needs shift- or "
                    f"matching-structured realizations; "
                    f"{self.topology.name!r} mixes via dense matrices "
                    f"({sorted(t.__name__ for t in types)})")
        if self.overlap:
            types = self.topology.realization_types()
            # a time-varying Dense stream shares ONE executable fed W per
            # step, but an OverlapIO closes over one realization
            if Dense in types and not isinstance(self.topology.schedule,
                                                 Static):
                raise ValueError(
                    f"overlap=True supports Shifts/Matching/Identity (and "
                    f"static Dense) realizations; {self.topology.name!r} "
                    "realizes time-varying dense matrices -- use a "
                    "permute-structured family (one_peer_exp, ceca, "
                    "base_k(k=1), random_match)")
        if self.scheduled:
            if self.overlap:
                raise ValueError(
                    "scheduled=True (data-dependent skip) cannot combine "
                    "with the overlap pipeline: the in-flight realization "
                    "would depend on a runtime gate")
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
    def for_optimizer(cls, opt, fn: Callable | None = None,
                      mesh=None) -> "GossipPlan":
        """Plan matching a chain-built optimizer's topology, warm-up phase,
        wire compression, communication interval, data-dependent schedule
        (``gossip(when=...)`` -> ``scheduled=True``) and overlap pipeline
        (its flush bound to the optimizer's ``flush_pending``), on
        ``mesh`` when given."""
        overlap = bool(opt.overlap)
        flush_fn = None
        if overlap:
            def flush_fn(io, params, state):
                return opt.flush_pending(params, state, io)
        return cls(opt.topology, warmup_steps=opt.warmup_steps,
                   compression=opt.compression, fn=fn, mesh=mesh,
                   every=opt.gossip_every, overlap=overlap,
                   flush_fn=flush_fn,
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
        """Hashable cache key for ``step``'s executable.  Overlap plans key
        by the realization in flight (step - 1's) with the overlap phase:
        ``("overlap", "prime")`` at step 0 (nothing in flight), else
        ``("overlap",) + key(step - 1)``."""
        k = int(step)
        if self.overlap:
            if k == 0:
                return ("overlap", "prime")
            return ("overlap",) + self._key_for(k - 1)
        return self._key_for(k)

    def _key_for(self, k: int) -> tuple:
        """The phase/realization key, without the overlap shift."""
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
        a scheduled plan's takes ``mix(t, pos, gate=None, **kw)``.  An
        overlap plan returns the step's :class:`OverlapIO` instead."""
        if self.overlap:
            return self.overlap_io(step)
        k = int(step)
        mesh = self.mesh
        if self.warmup_steps and k < self.warmup_steps:
            top_full = full_averaging(self.topology.n)
            return MixExecutor(lambda t: gossip.mix(t, top_full, 0,
                                                    mesh=mesh), mesh)
        comp = self.compression
        if self.scheduled:
            top = self.topology
            return MixExecutor(
                lambda t, pos, gate=None, **kw: gossip.mix_scheduled(
                    t, top, pos, gate, compression=comp, mesh=mesh, **kw),
                mesh)
        r = self.realization(k)
        return MixExecutor(lambda t, **kw: gossip.mix_realization(
            t, r, compression=comp, mesh=mesh, **kw), mesh)

    def overlap_io(self, step: int) -> OverlapIO:
        """The :class:`OverlapIO` of pipelined step ``step``: its delayed
        half applies the realization IN FLIGHT at that step (step - 1's,
        through the warm-up and ``every=k`` phases; None at step 0).  A
        warm-up round is full averaging, never compressed."""
        k = int(step) - 1
        if k < 0:
            return OverlapIO(None, None, self.mesh)
        if self.warmup_steps and k < self.warmup_steps:
            return OverlapIO(full_averaging(self.topology.n).realization(0),
                             None, self.mesh)
        return OverlapIO(self.realization(k), self.compression, self.mesh)

    def step_fn(self, step: int, *, prime: bool = False) -> Callable:
        """The executable for ``step``'s realization: the same realization
        gives the SAME callable (built once).  The time-varying dense
        regime returns a per-step wrapper feeding the realized ``W^{(k)}``
        into one shared executable, and a runtime-valued round one feeding
        its weights (and gate) into its structure's executable.

        An overlap plan binds the step's :class:`OverlapIO`;
        ``prime=True`` takes the priming executable at any step -- the
        step that resumes from a FLUSHED checkpoint, whose state holds no
        in-flight buffer."""
        fn = self._require_fn()
        if self.overlap:
            if prime or int(step) == 0:
                key, io = ("overlap", "prime"), self.overlap_io(0)
            else:
                key, io = self.realization_key(step), self.overlap_io(step)
            return self._cache.get(key, lambda: functools.partial(fn, io))
        key = self.realization_key(step)
        if key == ("dense",):
            mesh = self.mesh
            shared = self._cache.get(key, lambda: (
                lambda W, *a: fn(MixExecutor(lambda t: gossip.mix_dense(
                    t, W, mesh=mesh), mesh), *a)))
            W = self.realization(int(step)).dense(self.topology.n)
            return lambda *a: shared(W, *a)
        k = int(step)
        if not (self.warmup_steps and k < self.warmup_steps) \
                and not self.scheduled:
            r = self.realization(k)
            if r.traced:
                comp, mesh = self.compression, self.mesh
                shared = self._cache.get(key, lambda: (
                    lambda wvals, *a: fn(MixExecutor(
                        lambda t, **kw: gossip.mix_realization(
                            t, r.with_weights(wvals), compression=comp,
                            mesh=mesh, **kw), mesh), *a)))
                wvals = r.weight_values()
                return lambda *a: shared(wvals, *a)
        mix = self.mix(step)
        return self._cache.get(key, lambda: functools.partial(fn, mix))

    def flush_step_fn(self, step: int) -> Callable:
        """The drain of the overlap pipeline at step ``step``: applies the
        realization in flight (step - 1's) through ``flush_fn`` and clears
        the buffer; the caller waits for it.  Pure -- the driver
        calls it on the live state for metrics and flush-on-save
        checkpoints, and once at the end.  The identity for synchronous
        plans and at step 0."""
        if not self.overlap or int(step) == 0:
            return lambda *a: a
        if self.flush_fn is None:
            raise ValueError(
                "overlap plan has no flush_fn bound; construct via "
                "for_optimizer or pass flush_fn=...")
        key = ("overlap", "flush") + self._key_for(int(step) - 1)
        io = self.overlap_io(step)
        return self._cache.get(key, lambda: functools.partial(
            self.flush_fn, io))

    def _require_fn(self) -> Callable:
        if self.fn is None:
            raise ValueError(
                "GossipPlan has no bound step function; construct with "
                "fn=...")
        return self.fn
