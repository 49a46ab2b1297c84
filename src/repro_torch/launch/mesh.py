"""Logical meshes on ``torch.distributed``: the port of the JAX package's
``launch/mesh.py``, plus the wire the shard-native gossip engine runs on.

A :class:`Mesh` is the port's counterpart of ``jax.sharding.Mesh``: an
int array of global ranks (``devices``) with ``axis_names`` -- for
example ``("node", "fsdp")`` or ``("node", "fsdp", "model")`` -- this
rank's coordinates, and one ``torch.distributed`` group per line of each
axis (the ranks that differ only in that axis).  Every rank creates every
group, in the same order, as ``dist.new_group`` requires.  The sharding
rules (:mod:`repro_torch.launch.sharding`) read only ``axis_names`` and
``devices.shape``, so an *abstract* mesh -- no process group, as
:func:`make_production_mesh` returns -- serves them too.

The wire primitives are the engine's counterparts of ``lax.ppermute``,
``lax.psum``, ``lax.pmax`` and ``lax.axis_index``: :meth:`Mesh.permute`
(explicit ``(src, dst)`` pairs in axis coordinates, one
``dist.batch_isend_irecv``), :meth:`Mesh.psum`, :meth:`Mesh.pmax`,
:meth:`Mesh.axis_index`, :meth:`Mesh.all_gather` (the global path's
gather, and ``sharding.gather``) and :meth:`Mesh.reduce_scatter`
(``lax.psum_scatter``: fsdp training's gradient shards).
:meth:`Mesh.permute_start` and
:meth:`Mesh.psum_start` are the two halves of a permute and a psum: the
start stages the buffer and posts the sends and receives, and the
:class:`~repro_torch.core.gossip.Pending` it returns completes them on
``wait()`` -- the
overlapped trainer's delayed round puts the per-node gradients between
the two.  :meth:`Mesh.gather` collects a line's blocks at one rank and
:meth:`Mesh.barrier` waits for the line (checkpoints of a mesh run).
Each op is recorded in the mesh's :class:`WireLog` -- ops, bytes this
rank sends, seconds, the seconds spent staging through the host and, for
a split op, the seconds between its start and its wait -- the port's
counterpart of the HLO collective counts the reference's tests read.

The backend is explicit (:func:`make_mesh`): ``"nccl"`` moves device
buffers and needs one card per rank (NCCL refuses two ranks on one card,
"Duplicate GPU detected"), so the mesh raises when ranks share a card
rather than switching backends; ``"gloo"`` moves CPU tensors, and when
the buffers live on a card each one is copied to pinned host memory,
sent, received there and copied back (``mesh.wire == "gloo-host"``).
The packing, the combine kernel and the unpacking stay on the card; only
the transport goes through the host.

:func:`spawn` runs a function on a world of spawned processes (one rank
each, a ``file://`` store), the way the tests, ``chip_smoke.py`` and
``benchmarks/bench_comm.py`` start their worlds.

:func:`dry_mesh` gives an abstract mesh one rank's coordinates and a
wire that moves nothing: its ops take meta tensors, log the bytes that
rank would send, and return empty results, so the dry run
(``launch/dryrun.py``) runs the real shard-native engine and reads its
wire.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import queue as queue_mod
import socket
import tempfile
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..benchmarks import common
from ..core.gossip import Pending

__all__ = ["Mesh", "WireLog", "HW", "make_mesh", "abstract_mesh",
           "dry_mesh", "make_production_mesh", "to_logical_mesh",
           "init_world", "spawn"]

# Per card, for item 23's roofline: the H100 peaks of
# benchmarks/common.py (one source), the card they are the published
# numbers of, and its memory and NVLink rate
HW = {
    "card": "NVIDIA H100 80GB HBM3 (SXM)",
    "power_limit_w": 700.0,
    "peak_flops_bf16": common.PEAK_BF16_FLOPS,   # FLOP/s, dense
    "peak_flops_tf32": common.PEAK_TF32_FLOPS,
    "peak_flops_f32": common.PEAK_F32_FLOPS,     # outside the tensor cores
    "hbm_bw": common.PEAK_BYTES,                 # B/s
    "nvlink_bw": 450e9,                          # B/s one way, 18 links
    # B/s one way between servers: a DGX H100 gives each GPU one 400 Gb/s
    # NDR InfiniBand port (ConnectX-7; NVIDIA DGX H100 user guide).  A
    # node of fsdp * model >= 16 cards spans servers of 8, so its gossip
    # crosses this network; NVLink carries what stays inside a server.
    "net_bw": 50e9,
    "hbm_bytes": 80e9,
}


def _link_bytes(kind: str, nbytes: int, group: int) -> float:
    g = max(group, 1)
    if kind in ("psum", "pmax"):
        return 2.0 * (g - 1) / g * nbytes
    if kind in ("all_gather", "reduce_scatter"):
        return float((g - 1) * nbytes)
    return float(nbytes)


@dataclasses.dataclass
class WireLog:
    """What this rank's mesh ops moved since the last :meth:`reset`: per
    kind (``permute``, ``psum``, ``pmax``, ``all_gather``,
    ``reduce_scatter``, ``gather``) the ops, the bytes this rank sent (a
    permute to itself sends none; an all-gather and a reduce-scatter
    count the rank's block), the link bytes (the reference's ``hlo_cost``
    factors for an op over a group of g ranks: a permute its buffer, an
    all-reduce 2 (g - 1) / g of it, an all-gather or a reduce-scatter
    (g - 1) times its block), the seconds of the op
    (from its start to the end of its wait), of those the seconds spent
    copying through pinned host memory (the ``gloo-host`` wire), and
    ``open_s``, the seconds between a split op's start and the call of
    its wait (the part of the op that other work can hide; about 0 for
    an op that waits at once).  Inside :meth:`scope` ``(name)`` every
    kind is recorded as ``"name:kind"``."""

    kinds: dict = dataclasses.field(default_factory=dict)
    prefix: str = ""

    def add(self, kind: str, nbytes: int, seconds: float,
            stage_s: float, group: int = 1, open_s: float = 0.0) -> None:
        k = self.kinds.setdefault(self.prefix + kind, {
            "ops": 0, "bytes": 0, "link": 0.0, "s": 0.0, "stage_s": 0.0,
            "open_s": 0.0})
        k["ops"] += 1
        k["bytes"] += int(nbytes)
        k["link"] += _link_bytes(kind, int(nbytes), group)
        k["s"] += seconds
        k["stage_s"] += stage_s
        k["open_s"] += open_s

    @contextlib.contextmanager
    def scope(self, name: str):
        """Record the block's ops as ``"name:kind"`` (a run's logging and
        checkpoints apart from its steps)."""
        prev = self.prefix
        self.prefix = f"{name}:"
        try:
            yield self
        finally:
            self.prefix = prev

    def reset(self) -> None:
        self.kinds = {}

    def counts(self) -> dict:
        """``{kind: ops}``: the engine's collective counts."""
        return {k: v["ops"] for k, v in self.kinds.items()}

    def bytes(self) -> dict:
        """``{kind: bytes sent}``."""
        return {k: v["bytes"] for k, v in self.kinds.items()}

    def seconds(self) -> tuple[float, float]:
        """(seconds in every op, of which staging through the host)."""
        return (sum(v["s"] for v in self.kinds.values()),
                sum(v["stage_s"] for v in self.kinds.values()))

    def snapshot(self) -> dict:
        return {k: dict(v) for k, v in self.kinds.items()}


class Mesh:
    """Global ranks on named axes; live when it holds process groups.

    ``devices`` is the int array of global ranks (its name and shape as
    ``jax.sharding.Mesh.devices``), ``axis_names`` one name per axis.  A
    live mesh also has ``rank``, ``coords`` (this rank's index on each
    axis), ``groups`` (this rank's line of each axis), ``backend``,
    ``device`` and ``log``."""

    def __init__(self, devices, axis_names, *, groups=None, backend=None,
                 device=None, rank=None):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d rank array for axes "
                             f"{self.axis_names}")
        self.groups = groups
        self.backend = backend
        self.device = None if device is None else torch.device(device)
        self.rank = rank
        self.coords = None
        if rank is not None:
            where = np.argwhere(self.devices == rank)
            if len(where) != 1:
                raise ValueError(f"rank {rank} is not on the mesh once")
            self.coords = dict(zip(self.axis_names, map(int, where[0])))
        self.log = WireLog()

    # -- shape --------------------------------------------------------------

    @property
    def shape(self) -> dict:
        """``{axis: extent}`` in axis order (``dict(jax_mesh.shape)``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def live(self) -> bool:
        return self.groups is not None

    @property
    def wire(self) -> str | None:
        """``"nccl"``, ``"gloo-host"`` (gloo, device buffers staged through
        pinned host memory), ``"gloo"`` (CPU buffers), or None (abstract)."""
        if not self.live:
            return None
        if self.backend == "gloo" and self.device.type == "cuda":
            return "gloo-host"
        return self.backend

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        self._need_live()
        return self.coords[axis]

    def line(self, axis: str) -> list:
        """Global ranks of this rank's line of ``axis``, in axis order."""
        self._need_live()
        idx = tuple(slice(None) if a == axis else self.coords[a]
                    for a in self.axis_names)
        return [int(r) for r in self.devices[idx]]

    def __repr__(self) -> str:
        wire = f", wire={self.wire}, rank={self.rank}" if self.live else ""
        return f"Mesh({self.shape}{wire})"

    # -- wire ---------------------------------------------------------------

    def _need_live(self) -> None:
        if not self.live:
            raise ValueError(f"{self!r} is abstract: it has no process "
                             "groups (make_mesh builds a live one)")

    def _staged(self, x: torch.Tensor) -> bool:
        return self.wire == "gloo-host" and x.device.type == "cuda"

    def _to_wire(self, x: torch.Tensor):
        """``(tensor the backend sends, staging seconds)``."""
        if not self._staged(x):
            return x.contiguous(), 0.0
        t = time.perf_counter()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host, time.perf_counter() - t

    def _wire_empty(self, like: torch.Tensor) -> torch.Tensor:
        if self._staged(like):
            return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return torch.empty_like(like, memory_format=torch.contiguous_format)

    def _from_wire(self, w: torch.Tensor, like: torch.Tensor,
                   blocking: bool = True):
        """``(w on like's device, staging seconds)``.  ``blocking=False``
        queues the copy from pinned memory on the current stream and
        returns at once (the work that follows is queued behind it)."""
        if not self._staged(like):
            return w, 0.0
        t = time.perf_counter()
        out = w.to(like.device, non_blocking=not blocking)
        if blocking:
            torch.cuda.synchronize(like.device)
        return out, time.perf_counter() - t

    def _sync_nccl(self, out: torch.Tensor) -> None:
        if out.device.type == "cuda" and self.wire == "nccl":
            torch.cuda.synchronize(out.device)

    def _peers(self, pairs, axis: str) -> tuple:
        """(the coordinate this rank sends to, the one it receives from --
        None for itself or nobody -- and its sources) under ``pairs``."""
        me = self.coords[axis]
        dst = [d for s, d in pairs if s == me]
        src = [s for s, d in pairs if d == me]
        if len(dst) > 1 or len(src) > 1:
            raise ValueError(f"pairs {pairs} send or receive twice at {me}")
        return (dst[0] if dst and dst[0] != me else None,
                src[0] if src and src[0] != me else None, src)

    def permute(self, buf: torch.Tensor, pairs, axis: str) -> torch.Tensor:
        """``lax.ppermute`` over ``axis``: ``pairs`` are ``(src, dst)`` axis
        coordinates, each source and each destination at most once; this
        rank receives its source's ``buf`` (zeros when nothing is sent to
        it; its own ``buf``, copied, for a pair ``(i, i)``).  One
        ``dist.batch_isend_irecv`` on the axis's line, waited for at
        once."""
        return self._permute(buf, pairs, axis, blocking=True).wait()

    def permute_start(self, buf: torch.Tensor, pairs, axis: str) -> Pending:
        """The first half of :meth:`permute`: stages ``buf`` (a copy to
        pinned host memory on the gloo-host wire), posts the send and the
        receive and returns; the :class:`Pending`'s ``wait()`` completes
        them and returns what :meth:`permute` returns.  On the gloo-host
        wire the received buffer's copy to the card is queued on the
        stream current at the wait, without waiting for it.  The log's
        record (the same bytes as :meth:`permute`'s) spans start to wait,
        its ``open_s`` start to the call of the wait."""
        return self._permute(buf, pairs, axis, blocking=False)

    def _permute(self, buf, pairs, axis: str, blocking: bool) -> Pending:
        self._need_live()
        t0 = time.perf_counter()
        send_to, recv_from, src = self._peers(pairs, axis)
        line = self.line(axis)
        stage = 0.0
        ops, out_w, wbuf = [], None, None
        if send_to is not None:
            wbuf, stage = self._to_wire(buf)
            ops.append(dist.P2POp(dist.isend, wbuf, line[send_to],
                                  group=self.groups[axis]))
        if recv_from is not None:
            out_w = self._wire_empty(buf)
            ops.append(dist.P2POp(dist.irecv, out_w, line[recv_from],
                                  group=self.groups[axis]))
        reqs = dist.batch_isend_irecv(ops) if ops else []
        nbytes = buf.nbytes if send_to is not None else 0
        like = torch.empty((0,), dtype=buf.dtype, device=buf.device)
        shape = buf.shape
        # a pair (i, i) copies buf at the wait; otherwise it is not held
        own = buf if (recv_from is None and src) else None
        del buf

        def finish():
            nonlocal wbuf
            called = time.perf_counter()
            for req in reqs:
                req.wait()
            wbuf = None                     # sent: the staging copy goes
            s = 0.0
            if recv_from is not None:
                out, s = self._from_wire(out_w, like, blocking)
            elif own is not None:          # a copy, no wire
                out = own.clone()
            else:
                out = torch.zeros(shape, dtype=like.dtype,
                                  device=like.device)
            self._sync_nccl(out)
            self.log.add("permute", nbytes, time.perf_counter() - t0,
                         stage + s, open_s=called - t0)
            return out

        return Pending(finish)

    def _reduce_start(self, kind: str, x: torch.Tensor, axis: str, op,
                      blocking: bool = True) -> Pending:
        t0 = time.perf_counter()
        w, stage = self._to_wire(x)
        if w is x:
            w = x.clone(memory_format=torch.contiguous_format)
        work = dist.all_reduce(w, op=op, group=self.groups[axis],
                               async_op=True)
        like = torch.empty((0,), dtype=x.dtype, device=x.device)
        nbytes = x.nbytes

        def finish():
            called = time.perf_counter()
            work.wait()
            out, s = self._from_wire(w, like, blocking)
            self._sync_nccl(out)
            self.log.add(kind, nbytes, time.perf_counter() - t0, stage + s,
                         self.shape[axis], open_s=called - t0)
            return out

        return Pending(finish)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``lax.psum`` over ``axis`` (one all-reduce on the line)."""
        self._need_live()
        return self._reduce_start("psum", x, axis, dist.ReduceOp.SUM).wait()

    def psum_start(self, x: torch.Tensor, axis: str) -> Pending:
        """The first half of :meth:`psum`: the all-reduce posted, completed
        by the :class:`Pending`'s ``wait()`` (as :meth:`permute_start`)."""
        self._need_live()
        return self._reduce_start("psum", x, axis, dist.ReduceOp.SUM,
                                  blocking=False)

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``lax.pmax`` over ``axes`` (a name or a tuple): one all-reduce
        per axis of extent above 1 (a max is exact in any order)."""
        self._need_live()
        for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
            if self.shape[a] > 1:
                x = self._reduce_start("pmax", x, a, dist.ReduceOp.MAX).wait()
        return x

    def all_gather(self, x: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """The line's blocks of ``x`` concatenated on ``dim`` in axis
        order."""
        self._need_live()
        t0 = time.perf_counter()
        w, stage = self._to_wire(x)
        parts = [torch.empty_like(w) for _ in range(self.shape[axis])]
        dist.all_gather(parts, w, group=self.groups[axis])
        full = torch.cat(parts, dim)
        out, s = self._from_wire(full, x)
        self.log.add("all_gather", x.nbytes, time.perf_counter() - t0,
                     stage + s, self.shape[axis])
        return out

    def reduce_scatter(self, x: torch.Tensor, axis: str,
                       dim: int = 0) -> torch.Tensor:
        """``lax.psum_scatter`` over ``axis``: the sum over the line of
        ``x``, whose ``dim`` holds the line's blocks in axis order, and of
        which this rank keeps its own block (``x.shape[dim] // g`` along
        ``dim``).  One ``dist.reduce_scatter_tensor`` on the line (its
        newer name ``reduce_scatter_single`` where the torch has it)."""
        self._need_live()
        g = self.shape[axis]
        if x.shape[dim] % g:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"{g} ways over {axis!r}")
        t0 = time.perf_counter()
        w, stage = self._to_wire(x.movedim(dim, 0).contiguous())
        out_w = w.new_empty((w.shape[0] // g,) + tuple(w.shape[1:]))
        op = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        op(out_w, w, group=self.groups[axis])
        out, s = self._from_wire(out_w, x)
        self._sync_nccl(out)
        self.log.add("reduce_scatter", out_w.nbytes,
                     time.perf_counter() - t0, stage + s, g)
        return out.movedim(0, dim)

    def gather(self, x: torch.Tensor, axis: str, dst: int = 0):
        """The line's blocks of ``x`` concatenated on dim 0 in axis order,
        at the rank whose ``axis`` coordinate is ``dst`` (None at the
        others): one ``dist.gather`` on the line."""
        self._need_live()
        t0 = time.perf_counter()
        w, stage = self._to_wire(x)
        root = self.coords[axis] == dst
        parts = ([torch.empty_like(w) for _ in range(self.shape[axis])]
                 if root else None)
        dist.gather(w, parts, dst=self.line(axis)[dst],
                    group=self.groups[axis])
        out, s = None, 0.0
        if root:
            out, s = self._from_wire(torch.cat(parts, 0), x)
        self.log.add("gather", 0 if root else x.nbytes,
                     time.perf_counter() - t0, stage + s)
        return out

    def barrier(self, axis: str) -> None:
        """Wait until every rank of this rank's ``axis`` line is here."""
        self._need_live()
        dist.barrier(group=self.groups[axis])


class _DryMesh(Mesh):
    """An abstract mesh seen from one rank, whose wire moves nothing
    (:func:`dry_mesh`)."""

    @property
    def wire(self) -> str:
        return "dry"

    def _need_live(self) -> None:
        pass

    def _dry(self, kind: str, x: torch.Tensor) -> None:
        if x.device.type != "meta":
            raise ValueError(f"the dry mesh's {kind} takes meta tensors; got "
                             f"one on {x.device}")

    def permute(self, buf, pairs, axis):
        self._dry("permute", buf)
        send_to = self._peers(pairs, axis)[0]
        self.log.add("permute", 0 if send_to is None else buf.nbytes, 0.0,
                     0.0)
        return torch.empty_like(buf)

    def permute_start(self, buf, pairs, axis):
        out = self.permute(buf, pairs, axis)
        return Pending(lambda: out)

    def psum(self, x, axis):
        self._dry("psum", x)
        self.log.add("psum", x.nbytes, 0.0, 0.0, self.shape[axis])
        return torch.empty_like(x)

    def psum_start(self, x, axis):
        out = self.psum(x, axis)
        return Pending(lambda: out)

    def pmax(self, x, axes):
        self._dry("pmax", x)
        for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
            if self.shape[a] > 1:
                self.log.add("pmax", x.nbytes, 0.0, 0.0, self.shape[a])
        return torch.empty_like(x)

    def all_gather(self, x, axis, dim: int = 0):
        self._dry("all_gather", x)
        self.log.add("all_gather", x.nbytes, 0.0, 0.0, self.shape[axis])
        shape = list(x.shape)
        shape[dim] *= self.shape[axis]
        return x.new_empty(shape)

    def reduce_scatter(self, x, axis, dim: int = 0):
        self._dry("reduce_scatter", x)
        shape = list(x.shape)
        shape[dim] //= self.shape[axis]
        out = x.new_empty(shape)
        self.log.add("reduce_scatter", out.nbytes, 0.0, 0.0, self.shape[axis])
        return out


def dry_mesh(mesh: Mesh, rank: int = 0) -> Mesh:
    """``mesh``'s ranks and axes seen from ``rank`` (its coordinates, its
    lines), with a wire that moves nothing: ``permute``, ``psum``,
    ``pmax``, ``all_gather`` and ``reduce_scatter`` take meta tensors
    only (any other tensor
    raises), log into its own ``log`` the bytes that rank would send, by the
    live wire's rules (a permute to itself sends none), and return empty
    results of the live ops' shapes (``permute_start`` and
    ``psum_start`` log at the start).  The shard-native engine runs on it
    unchanged; ``wire`` is ``"dry"``."""
    return _DryMesh(mesh.devices, mesh.axis_names, backend="dry",
                    device="meta", rank=rank)


def abstract_mesh(shape, axis_names) -> Mesh:
    """A mesh of ``prod(shape)`` ranks with no process groups, for the
    sharding rules and the dry run."""
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's layouts as an abstract mesh: one pod (16, 16) on
    ``("data", "model")``, two pods (2, 16, 16) on ``("pod", "data",
    "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def to_logical_mesh(mesh: Mesh, nodes: int, fsdp: int,
                    model: int | None = None) -> Mesh:
    """Reshape a mesh's ranks into ``("node", "fsdp", "model")``, row-major
    over its axes (the reference's rule): ``model`` defaults to the last
    axis's extent, and ``nodes * fsdp * model`` must be the rank count.
    A live mesh gives a live one (every rank must call, as it makes new
    groups); an abstract one an abstract one."""
    devs = mesh.devices
    total = devs.size
    if model is None:
        model = devs.shape[-1]
    if nodes * fsdp * model != total:
        raise ValueError(
            f"nodes*fsdp*model ({nodes}*{fsdp}*{model}) != {total} devices")
    ranks = devs.reshape(nodes, fsdp, model)
    axes = ("node", "fsdp", "model")
    if not mesh.live:
        return Mesh(ranks, axes)
    return _live_mesh(ranks, axes, mesh.backend, mesh.device)


def init_world(rank: int, world: int, init_method: str) -> None:
    """Join a world of ``world`` ranks through ``init_method`` (a
    ``file://`` path or ``tcp://localhost:<port>``).  The default group
    is gloo: it carries the mesh's set-up; each mesh makes its own groups
    on its backend."""
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world)


def _live_mesh(ranks: np.ndarray, axes: tuple, backend: str,
               device) -> Mesh:
    me = dist.get_rank()
    groups = {}
    for ax_i, axis in enumerate(axes):
        lines = np.moveaxis(ranks, ax_i, -1).reshape(-1, ranks.shape[ax_i])
        for line in lines:
            g = dist.new_group([int(r) for r in line], backend=backend)
            if me in line:
                groups[axis] = g
    return Mesh(ranks, axes, groups=groups, backend=backend, device=device,
                rank=me)


def make_mesh(shape, axes, *, backend: str | None = None,
              device="cpu") -> Mesh:
    """A live mesh over the current world (``init_world`` first): ranks
    ``0 .. prod(shape) - 1`` row-major on ``axes``.

    ``backend`` defaults to ``"nccl"`` for a CUDA ``device`` and
    ``"gloo"`` for the CPU.  ``"nccl"`` raises when two ranks would share
    a card (NCCL cannot run them); ``"gloo"`` with a CUDA device stages
    every buffer through pinned host memory (``mesh.wire ==
    "gloo-host"``).  Nothing switches backend by itself."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("backend 'nccl' moves CUDA buffers; give a cuda "
                         "device, or use backend 'gloo'")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {tuple(shape)} needs {int(np.prod(shape))} "
                         f"ranks; the world has {world}")
    if backend == "nccl":
        cards = [None] * world
        dist.all_gather_object(cards, (socket.gethostname(), device.index))
        if len(set(cards)) < world:
            shared = sorted({c for c in cards if cards.count(c) > 1})
            raise ValueError(
                f"backend 'nccl' needs one card per rank: {world} ranks "
                f"share {len(set(cards))} card(s) ({shared}); NCCL refuses "
                "two ranks on one card ('Duplicate GPU detected'). Use "
                "backend='gloo' (staged through host memory) on one card")
    ranks = np.arange(world).reshape(tuple(shape))
    return _live_mesh(ranks, tuple(axes), backend, device)


# ---------------------------------------------------------------------------
# Spawned worlds
# ---------------------------------------------------------------------------

def _entry(rank: int, world: int, init_method: str, fn: Callable,
           args: tuple, threads: int | None, results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        init_world(rank, world, init_method)
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:               # reported to the parent, re-raised
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *,
          store_dir: str | None = None, timeout: float = 600.0,
          threads: int | None = None) -> list:
    """Run ``fn(rank, *args)`` on ``world`` spawned processes that have
    joined one world (:func:`init_world` through a ``file://`` store in
    ``store_dir``, a fresh temporary directory by default) and return the
    ``world`` results in rank order.  ``fn`` must be importable by name
    (a module-level function) and its results picklable.  A rank that
    raises fails the call with its traceback; every process is stopped
    before this returns.  ``threads`` sets each rank's torch thread
    count (CPU worlds: ``world`` ranks on a few cores)."""
    import torch.multiprocessing as mp

    own = store_dir is None
    store_dir = tempfile.mkdtemp() if own else store_dir
    store = os.path.join(store_dir, f"store-{os.getpid()}-{time.time_ns()}")
    env_set = False
    if "GLOO_SOCKET_IFNAME" not in os.environ and \
            os.path.exists("/sys/class/net/lo"):
        # one host: the loopback device, whatever the host name resolves to
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
        env_set = True
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry, args=(r, world, f"file://{store}",
                                              fn, args, threads, results))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        out: dict[int, Any] = {}
        deadline = time.monotonic() + timeout
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"world of {world}: {len(out)} ranks "
                                   f"answered within {timeout} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank exited with {dead[0]} "
                                       "before answering")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(timeout=60)
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        if env_set:
            del os.environ["GLOO_SOCKET_IFNAME"]
        if own:
            for f in os.listdir(store_dir):
                os.remove(os.path.join(store_dir, f))
            os.rmdir(store_dir)
