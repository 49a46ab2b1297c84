"""Partial averaging (gossip) over the node axis: the single-process path.

The port of the JAX package's ``core/gossip.py`` for static realizations
without a mesh.  Every quantity is a tree (``dict[str, Tensor]``, or a
tuple/list of such dicts) whose leaves carry a leading node axis of size
``n``; each mix first packs the tree into one ``(n, B)`` buffer per dtype
(:mod:`repro_torch.core.flatbuf`), so its cost does not depend on the leaf
count.  One lowering per realization-IR node:

* ``Shifts``   -> :func:`mix_shifts`: ``torch.roll(buf, s, 0)`` per shift
  (node i receives from (i - s) mod n, ``jnp.roll``'s sign) and one
  weighted combine per dtype group.
* ``Matching`` -> :func:`mix_matching`: one gather of the partner rows and
  one combine; fixed points keep their value bit-exactly.
* ``Dense``    -> :func:`mix_dense`: one ``einsum('ij,jb->ib')`` in f32.
* ``Identity`` -> no-op.

The combine of Shifts and Matching rounds is the ``gossip_mix`` kernel
(``kernels/gossip_mix``): its wrapper launches the CUDA kernel on a CUDA
buffer and takes the plain version on a CPU one.  :func:`set_kernel_mode`
``("off")`` forces the plain combine on any device, as the JAX package's
``set_pallas_mode("off")`` does; it exists to hold the kernel against the
plain version on the card.

:func:`mix_switch` is the reference's traced-step entry point: this
package has no traced step, so it takes an int or a 0-d tensor and mixes
with realization ``step % period``, refusing aperiodic schedules as the
reference does.

Not here yet: int8 wire compression (ROADMAP slice C), runtime-valued
rounds and data-dependent schedules (slice C), the overlapped pipeline
(slice C) and the shard-native multi-process engine (``mesh=``, slice
F).  Each raises ``NotImplementedError`` naming its slice.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..kernels.gossip_mix import ops as gm_ops
from ..kernels.gossip_mix import ref as gm_ref
from . import flatbuf
from .topology import (AperiodicScheduleError, Dense, Identity, Matching,
                       Shifts, Topology)

Tree = Any

__all__ = ["mix_dense", "mix_shifts", "mix_matching", "mix_realization",
           "mix", "mix_switch", "gossip_spec", "set_kernel_mode",
           "AperiodicScheduleError"]

# "auto": the tensors' device picks (CUDA -> the kernel, CPU -> plain);
# "off": the plain combine everywhere
_KERNEL_MODE = "auto"


def set_kernel_mode(mode: str) -> None:
    """Select the combine backend: ``"auto"`` | ``"off"``."""
    global _KERNEL_MODE
    if mode not in ("auto", "off"):
        raise ValueError(f"unknown kernel mode {mode!r}")
    _KERNEL_MODE = mode


def _refuse(compression, mesh) -> None:
    if compression is not None:
        raise NotImplementedError(
            f"compression={compression!r} waits for ROADMAP slice C of the "
            "PyTorch port")
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the shard-native multi-process engine) waits for "
            "ROADMAP slice F of the PyTorch port")


def _combine(x, recvs, w_self: float, ws: tuple):
    """out = w_self*x + sum_d ws[d]*recvs[d] over packed buffers."""
    ws = tuple(float(w) for w in ws)
    if _KERNEL_MODE == "off":
        return gm_ref.gossip_mix_ref(x, recvs, float(w_self), ws)
    return gm_ops.gossip_mix(x, recvs, w_self=float(w_self), ws=ws)


def mix_dense(tree: Tree, W, *, mesh=None) -> Tree:
    """x_i <- sum_j W[i, j] x_j over the leading node axis of every leaf:
    one ``einsum('ij,jb->ib')`` in f32 per dtype group."""
    _refuse(None, mesh)
    layout, bufs = flatbuf.pack(tree)
    out = []
    for b in bufs:
        Wt = torch.as_tensor(np.asarray(W), dtype=torch.float32,
                             device=b.device)
        out.append(torch.einsum("ij,jb->ib", Wt, b.float()).to(b.dtype))
    return flatbuf.unpack(layout, out)


def mix_shifts(tree: Tree, self_weight: float,
               shifts: list[tuple[int, float]],
               compression: str | None = None, *, mesh=None) -> Tree:
    """x_i <- self_weight * x_i + sum_d w_d * x_{(i - s_d) mod n}.

    Each (s_d, w_d) descriptor means node i *sends* its buffer to node
    (i + s_d) mod n: one ``torch.roll`` of each packed buffer per shift,
    then the weighted combine."""
    _refuse(compression, mesh)
    layout, bufs = flatbuf.pack(tree)
    ws = tuple(w for _, w in shifts)
    out = []
    for buf in bufs:
        recvs = [torch.roll(buf, s, 0) for s, _ in shifts]
        out.append(_combine(buf, recvs, self_weight, ws))
    return flatbuf.unpack(layout, out)


def mix_matching(tree: Tree, partner: tuple, w_self: float = 0.5,
                 compression: str | None = None, mesh=None) -> Tree:
    """Pairwise gossip: x_i <- w_self * x_i + (1 - w_self) * x_{partner[i]}.

    ``partner`` is an involution; fixed points keep their value EXACTLY
    (bit-for-bit, enforced with a mask)."""
    _refuse(compression, mesh)
    n = len(partner)
    fixed = np.fromiter((j == i for i, j in enumerate(partner)),
                        dtype=bool, count=n)
    layout, bufs = flatbuf.pack(tree)
    out = []
    for buf in bufs:
        idx = torch.as_tensor(partner, dtype=torch.long, device=buf.device)
        recv = buf.index_select(0, idx)
        o = _combine(buf, [recv], w_self, (1.0 - w_self,))
        if fixed.any():
            keep = torch.as_tensor(fixed, device=buf.device)[:, None]
            o = torch.where(keep, buf, o)
        out.append(o)
    return flatbuf.unpack(layout, out)


def mix_realization(tree: Tree, realization, *,
                    compression: str | None = None, mesh=None) -> Tree:
    """Lower one realization-IR node onto its path."""
    if isinstance(realization, Identity):
        return tree
    if isinstance(realization, Shifts):
        return mix_shifts(tree, realization.self_w, list(realization.shifts),
                          compression, mesh=mesh)
    if isinstance(realization, Matching):
        return mix_matching(tree, realization.partner, realization.w_self,
                            compression, mesh)
    if isinstance(realization, Dense):
        if compression is not None:
            raise ValueError(
                f"compression={compression!r} has no dense-matrix wire "
                f"format; only Shifts/Matching realizations quantize")
        return mix_dense(tree, realization.W, mesh=mesh)
    raise TypeError(f"not a realization IR node: {realization!r}")


def mix(tree: Tree, topology: Topology, step: int,
        compression: str | None = None, mesh=None) -> Tree:
    """Apply W^(step) of ``topology`` to ``tree``; ``step`` is a Python
    int.  Dispatches on the realization IR node type."""
    return mix_realization(tree, topology.realization(int(step)),
                           compression=compression, mesh=mesh)


def mix_switch(tree: Tree, topology: Topology, step, mesh=None) -> Tree:
    """The reference's traced-step mix: realization ``step % period`` of a
    periodic schedule.  ``step`` is an int or a 0-d integer tensor (read
    on the host: this package has no traced step, so one call serves the
    whole period by dispatching here).

    Aperiodic schedules (``RandomPerm``, ``Aperiodic``) have no step ->
    realization map over a period and raise
    :class:`~repro_torch.core.topology.AperiodicScheduleError`; they take
    the static-step path (:func:`mix`, or ``GossipPlan``)."""
    _refuse(None, mesh)
    if not topology.schedule.is_periodic:
        raise AperiodicScheduleError(
            f"mix_switch needs a periodic schedule, but {topology.name!r} "
            f"carries {topology.schedule!r}; aperiodic schedules must use "
            "the static-step path (GossipPlan builds one executable per "
            "realization)")
    k = int(step.item()) if isinstance(step, torch.Tensor) else int(step)
    return mix(tree, topology, k % topology.schedule.period)


def gossip_spec(topology: Topology, step: int,
                layout: flatbuf.FlatLayout | None = None,
                compression: str | None = None) -> dict:
    """Structural description of one gossip round, read off the
    realization IR (for roofline accounting).

    ``wire_multiplier`` is the number of per-node payload copies the round
    moves: one per shift for ``Shifts``, exactly 1 for any ``Matching``,
    ``n - 1`` for ``Dense`` (an all-gather), 0 for ``Identity``.  With a
    ``layout`` (from :func:`flatbuf.layout_of`), adds the packed-path byte
    accounting: collectives per step and bytes sent per node."""
    r = topology.realization(step)
    n = topology.n
    mult = r.wire_multiplier(n)
    if isinstance(r, Shifts):
        spec = {"kind": "ppermute", "rounds": len(r.shifts),
                "shifts": [s for s, _ in r.shifts]}
        rounds = len(r.shifts)
    elif isinstance(r, Matching):
        paired = sum(1 for i, j in enumerate(r.partner) if j != i)
        spec = {"kind": "matching", "rounds": 1, "paired_nodes": paired}
        rounds = 1
    elif isinstance(r, Identity):
        spec = {"kind": "identity", "rounds": 0}
        rounds = 0
    else:
        spec = {"kind": "dense", "rounds": 1, "fanin": r.max_degree}
        rounds = 1
    spec["wire_multiplier"] = mult
    if layout is not None:
        split = flatbuf.wire_bytes_split(layout, compression)
        spec["dtype_groups"] = len(layout.groups)
        spec["collectives_per_step"] = rounds * len(layout.groups)
        spec["payload_bytes_per_node_per_step"] = split["payload"] * mult
        spec["scale_bytes_per_node_per_step"] = split["scales"] * mult
        spec["meta_bytes_per_node_per_step"] = 0
        spec["bytes_per_node_per_step"] = (
            (split["payload"] + split["scales"]) * mult)
    return spec
