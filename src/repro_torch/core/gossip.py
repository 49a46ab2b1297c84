"""Partial averaging (gossip) over the node axis: the single-process path.

The port of the JAX package's ``core/gossip.py`` without a mesh.  Every
quantity is a tree (``dict[str, Tensor]``, or a tuple/list of such dicts)
whose leaves carry a leading node axis of size ``n``; each mix first packs
the tree into one ``(n, B)`` buffer per dtype
(:mod:`repro_torch.core.flatbuf`), so its cost does not depend on the leaf
count.  One lowering per realization-IR node:

* ``Shifts``   -> :func:`mix_shifts`: ``torch.roll(buf, s, 0)`` per shift
  (node i receives from (i - s) mod n, ``jnp.roll``'s sign) and one
  weighted combine per dtype group.  :func:`mix_shifts_per_leaf` is the
  historical one-roll-per-leaf path the benchmarks compare it with.
* ``Matching`` -> :func:`mix_matching`: one gather of the partner rows and
  one combine; fixed points keep their value bit-exactly.
* ``Dense``    -> :func:`mix_dense`: one ``einsum('ij,jb->ib')`` in f32.
* ``Identity`` -> no-op.
* ``Gated``    -> the inner round, its combine gated (per node, or the
  whole round selected by ``torch.where``).

The combine of static Shifts and Matching rounds is the ``gossip_mix``
kernel (``kernels/gossip_mix``): its wrapper launches the CUDA kernel on a
CUDA buffer and takes the plain version on a CPU one.

``compression="int8"`` quantizes what a Shifts or Matching round sends:
each packed buffer is rounded to int8 against one f32 scale per (node,
scale group) (``max|x| / 127 + 1e-30``, the groups of
:mod:`~repro_torch.core.flatbuf`: one per JAX leaf, so the scales are the
reference's), and the int8 buffer and its scale rows are rolled or
gathered.  The receiver dequantizes and combines in plain f32 torch, as
the reference combines in ``jnp``, in its order of operations
(``self_w * x`` first, then ``+ w * (q * scale)`` per received buffer);
its own term stays full precision, and matching fixed points keep their
full-precision buffer bit for bit.  Quantizing and dequantizing go slot by
slot through views of the buffer, so a round holds one int8 copy and one
f32 accumulator beside the payload, never an f32 tensor of scales.

:func:`pack_payload` and :func:`delayed_mix` are the two halves of the
overlapped pipeline (a payload packed at one step and mixed at the next);
:func:`delayed_mix` of a Shifts or Matching round combines the packed
buffers as they are, bit for bit what :func:`mix_realization` gives the
unpacked tree.
:func:`set_kernel_mode` ``("off")`` forces the plain combine on any
device, as the JAX package's ``set_pallas_mode("off")`` does; it exists to
hold the kernel against the plain version on the card.

Runtime-valued rounds -- tensor weights, piggybacked metadata
(``meta=``), loss-aware edge weights (``edge_weight=``) or a per-node
gate (``node_gate=``) -- gather exactly what the static round gathers and
combine in plain f32 torch, as the reference combines them in ``jnp``
(the kernel takes static float weights).  :func:`mix_scheduled` mixes
with realization ``pos % period`` of a schedule position held in
optimizer state.

:func:`mix_switch` is the reference's traced-step entry point: this
package has no traced step, so it takes an int or a 0-d tensor and mixes
with realization ``step % period``, refusing aperiodic schedules as the
reference does.

Not here yet: the shard-native multi-process engine (``mesh=``, ROADMAP
slice F), which raises ``NotImplementedError`` naming its slice.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..kernels.gossip_mix import ops as gm_ops
from ..kernels.gossip_mix import ref as gm_ref
from . import flatbuf
from .topology import (AperiodicScheduleError, Dense, Gated, Identity,
                       Matching, Shifts, Topology, _is_static_value)

Tree = Any

__all__ = ["mix_dense", "mix_shifts", "mix_shifts_per_leaf", "mix_matching",
           "mix_realization", "mix", "mix_switch", "mix_scheduled",
           "pack_payload", "delayed_mix", "gossip_spec", "set_kernel_mode",
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


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the shard-native multi-process engine) waits for "
            "ROADMAP slice F of the PyTorch port")


def _check_compression(compression) -> None:
    if compression not in (None, "int8"):
        raise ValueError(f"unknown compression {compression!r}; the wire "
                         "format is None (full precision) or 'int8'")


def _combine(x, recvs, w_self: float, ws: tuple):
    """out = w_self*x + sum_d ws[d]*recvs[d] over packed buffers."""
    ws = tuple(float(w) for w in ws)
    if _KERNEL_MODE == "off":
        return gm_ref.gossip_mix_ref(x, recvs, float(w_self), ws)
    return gm_ops.gossip_mix(x, recvs, w_self=float(w_self), ws=ws)


def mix_dense(tree: Tree, W, *, mesh=None) -> Tree:
    """x_i <- sum_j W[i, j] x_j over the leading node axis of every leaf:
    one ``einsum('ij,jb->ib')`` in f32 per dtype group."""
    _refuse_mesh(mesh)
    layout, bufs = flatbuf.pack(tree)
    out = []
    for b in bufs:
        Wt = (W if isinstance(W, torch.Tensor) else np.asarray(W))
        Wt = torch.as_tensor(Wt, dtype=torch.float32, device=b.device)
        out.append(torch.einsum("ij,jb->ib", Wt, b.float()).to(b.dtype))
    return flatbuf.unpack(layout, out)


# ---------------------------------------------------------------------------
# Runtime-valued rounds: tensor weights, metadata piggyback, node gating
# ---------------------------------------------------------------------------
#
# A round is RUNTIME-valued when any of its weights is a tensor, or when it
# carries per-node metadata (``meta=``), loss-aware edge weights
# (``edge_weight=``) or a straggler gate (``node_gate=``).  It gathers
# exactly the rows the static round gathers (a gated-off edge still moves
# its bytes) and combines in plain f32 torch with weights that are
# tensors.  Metadata rides the f32 dtype group's gather, cast to that
# group's dtype (group 0's when the payload has no f32 group): the
# receiver reads its sender's (loss, grad-norm, alive) row from the rows
# the round moves anyway.  The reference concatenates the columns onto
# the buffer before its permute; in one process that only moves data, so
# gathering the (n, M) meta rows with the payload's index gives the same
# bits without a second payload-sized copy.
#
# ``edge_weight(own_meta, recv_meta, base_w) -> w`` gives the RECEIVING
# node's weight for that edge.  Under gating or edge_weight the self
# weight is derived as ``1 - sum_d w_d`` per node in f32 tensors, so every
# realized row stays stochastic (a dropped edge's mass returns to self).

def _assemble_meta(meta, node_gate, device):
    """Stack user metadata and the alive flag into one (n, M) f32 matrix
    on ``device``.  Returns ``(meta_mat | None, n_user_cols, has_gate)``;
    the gate flag is always the LAST column."""
    cols = []
    n_user = 0
    if meta is not None:
        m = torch.as_tensor(meta, dtype=torch.float32, device=device)
        if m.ndim == 1:
            m = m[:, None]
        n_user = m.shape[1]
        cols.append(m)
    if node_gate is not None:
        g = torch.as_tensor(node_gate, device=device)
        cols.append(g.to(torch.float32)[:, None])
    if not cols:
        return None, 0, False
    return torch.cat(cols, 1), n_user, node_gate is not None


def _f32_group_index(layout: flatbuf.FlatLayout) -> int:
    """The dtype group the metadata columns ride on (f32 if present)."""
    for i, g in enumerate(layout.groups):
        if g.dtype == torch.float32:
            return i
    return 0


def _wcol(w, device):
    """A weight as an f32 tensor on ``device``, broadcast against an
    (n, B) buffer when per-node."""
    w = torch.as_tensor(w, dtype=torch.float32, device=device)
    return w[:, None] if w.ndim == 1 else w


def _runtime_combine(bufs: list, layout: flatbuf.FlatLayout, permute,
                     base_ws: list, self_w, meta_mat, n_user: int,
                     has_gate: bool, edge_weight, keep) -> list:
    """Weighted combine with runtime weights / piggybacked metadata.

    ``permute(arr, d)`` returns edge ``d``'s received rows (a roll or a
    gather, the static round's primitive).  ``keep`` is an optional (n, 1)
    mask of rows that keep their value bit-exactly (matching fixed
    points)."""
    D = len(base_ws)
    dev = bufs[0].device
    gi = _f32_group_index(layout)
    recv_meta: list = [None] * D
    if meta_mat is not None:
        wire = meta_mat.to(bufs[gi].dtype)
        for d in range(D):
            recv_meta[d] = permute(wire, d).to(torch.float32)
    own_user = meta_mat[:, :n_user] if n_user else None
    own_alive = meta_mat[:, -1] > 0.5 if has_gate else None
    eff = []
    for d in range(D):
        w = base_ws[d]
        if edge_weight is not None:
            w = edge_weight(own_user, recv_meta[d][:, :n_user]
                            if n_user else None, w)
        w = torch.as_tensor(w, dtype=torch.float32, device=dev)
        if has_gate:
            both = torch.logical_and(own_alive, recv_meta[d][:, -1] > 0.5)
            w = torch.where(both, w, torch.zeros_like(w))
        eff.append(w)
    if self_w is None or has_gate or edge_weight is not None:
        # dropped-edge mass returns to self: rows stay stochastic
        total = 0
        for w in eff:
            total = total + _wcol(w, dev)
        self_col = 1.0 - total
    else:
        self_col = _wcol(self_w, dev)
    outs = []
    for buf in bufs:
        x32 = buf.to(torch.float32)
        acc = self_col * x32
        for d in range(D):
            # a fresh gathered f32 buffer, scaled in place: one extra
            # payload-sized tensor at a time
            r = permute(buf, d).to(torch.float32)
            acc.add_(r.mul_(_wcol(eff[d], dev)))
            del r
        if keep is not None:
            acc = torch.where(keep, x32, acc)
        outs.append(acc.to(buf.dtype))
    return outs


def _runtime_mix(tree: Tree, *, permute, base_ws: list, self_w, meta,
                 node_gate, edge_weight, fixed_mask, mesh) -> Tree:
    """Runtime-valued Shifts/Matching round on the global path.
    ``permute(arr, d)`` is edge ``d``'s wire primitive; ``base_ws[d]`` its
    base weight (float, 0-d or per-node tensor; ``edge_weight`` may
    override)."""
    _refuse_mesh(mesh)
    layout, bufs = flatbuf.pack(tree)
    dev = bufs[0].device
    meta_mat, n_user, has_gate = _assemble_meta(meta, node_gate, dev)
    keep = (None if fixed_mask is None
            else torch.as_tensor(fixed_mask, device=dev)[:, None])
    outs = _runtime_combine(bufs, layout, permute, base_ws, self_w,
                            meta_mat, n_user, has_gate, edge_weight, keep)
    return flatbuf.unpack(layout, outs)


def _is_runtime_round(self_w, ws, meta, edge_weight, node_gate) -> bool:
    """True when the round needs the runtime combine (a tensor weight, a
    derived self weight, metadata, loss-aware weights, or gating).  A
    plain static round returns False and takes the kernel path."""
    return (meta is not None or edge_weight is not None
            or node_gate is not None
            or not _is_static_value(self_w)
            or any(not _is_static_value(w) for w in ws))


def _refuse_runtime_compression(compression) -> None:
    if compression is not None:
        raise ValueError(
            "compression is not supported on runtime-valued rounds "
            "(tensor weights / metadata / gating); drop compression= "
            "or use static weights")


# ---------------------------------------------------------------------------
# Static rounds on packed buffers: the K1 combine, or the int8 wire
# ---------------------------------------------------------------------------

def _scale_columns(buf: torch.Tensor, g: flatbuf.GroupLayout) -> torch.Tensor:
    """(n, G + 1) f32 int8 scales of one packed group: ``max|x| / 127 +
    1e-30`` per (node, scale group) -- a JAX leaf's layers are one column
    range -- then a column of 1.0 for the padding."""
    cols = []
    for a, b in g.scale_ranges:
        lo, hi = torch.aminmax(buf[:, a:b], dim=1)
        cols.append(torch.maximum(lo.float().abs(), hi.float().abs()))
    m = torch.stack(cols, 1)
    return torch.cat([m / 127.0 + 1e-30, torch.ones_like(m[:, :1])], 1)


def _quantize(buf: torch.Tensor, g: flatbuf.GroupLayout,
              sc: torch.Tensor) -> torch.Tensor:
    """``round(x / scale)`` as int8, one scale group at a time (half to
    even, as ``jnp.round``); the padding stays 0."""
    q = torch.zeros(buf.shape, dtype=torch.int8, device=buf.device)
    for j, (a, b) in enumerate(g.scale_ranges):
        q[:, a:b] = torch.div(buf[:, a:b], sc[:, j:j + 1]).round_()
    return q


def _add_dequantized(acc, rq: torch.Tensor, rs: torch.Tensor,
                     g: flatbuf.GroupLayout, w: float) -> torch.Tensor:
    """``acc + w * (rq * rs)`` in f32 with the reference's roundings
    (product, weight, sum), one scale group at a time; ``acc=None``
    starts the sum."""
    if acc is None:
        acc = rq.to(torch.float32)
        for j, (a, b) in enumerate(g.scale_ranges):
            acc[:, a:b].mul_(rs[:, j:j + 1])
        return acc.mul_(w)
    for j, (a, b) in enumerate(g.scale_ranges):
        acc[:, a:b].add_(rq[:, a:b].to(torch.float32)
                         .mul_(rs[:, j:j + 1]).mul_(w))
    return acc


def _shifts_bufs(layout: flatbuf.FlatLayout, bufs, self_weight: float,
                 shifts, compression) -> list:
    """A static Shifts round on packed buffers: one roll per shift, then
    K1 (or, under int8, the quantized wire and the f32 combine)."""
    _check_compression(compression)
    out = []
    for g, buf in zip(layout.groups, bufs):
        if compression is None:
            recvs = [torch.roll(buf, s, 0) for s, _ in shifts]
            out.append(_combine(buf, recvs, self_weight,
                                tuple(w for _, w in shifts)))
            continue
        sc = _scale_columns(buf, g)
        q = _quantize(buf, g, sc)
        acc = (self_weight * buf.float()) if self_weight else None
        for s, w in shifts:
            # the int8 buffer and its scale rows over the wire
            acc = _add_dequantized(acc, torch.roll(q, s, 0),
                                   torch.roll(sc, s, 0), g, float(w))
        del q
        out.append(acc.to(buf.dtype))
    return out


def _matching_bufs(layout: flatbuf.FlatLayout, bufs, partner: tuple,
                   w_self: float, compression) -> list:
    """A static Matching round on packed buffers: one gather of the
    partner rows, then K1 (or the int8 wire); fixed points keep their
    full-precision buffer bit for bit."""
    _check_compression(compression)
    fixed = np.fromiter((j == i for i, j in enumerate(partner)),
                        dtype=bool, count=len(partner))
    out = []
    for g, buf in zip(layout.groups, bufs):
        idx = torch.as_tensor(partner, dtype=torch.long, device=buf.device)
        if compression is None:
            o = _combine(buf, [buf.index_select(0, idx)], w_self,
                         (1.0 - w_self,))
            if fixed.any():
                keep = torch.as_tensor(fixed, device=buf.device)[:, None]
                o = torch.where(keep, buf, o)
            out.append(o)
            continue
        sc = _scale_columns(buf, g)
        q = _quantize(buf, g, sc)
        x32 = buf.float()
        acc = _add_dequantized(w_self * x32, q.index_select(0, idx),
                               sc.index_select(0, idx), g, 1.0 - w_self)
        del q
        if fixed.any():
            # in place: no second payload-sized tensor
            rows = np.flatnonzero(fixed).tolist()
            acc[rows] = x32[rows]
        out.append(acc.to(buf.dtype))
    return out


def mix_shifts(tree: Tree, self_weight: float,
               shifts: list[tuple[int, float]],
               compression: str | None = None, *, mesh=None, meta=None,
               edge_weight=None, node_gate=None) -> Tree:
    """x_i <- self_weight * x_i + sum_d w_d * x_{(i - s_d) mod n}.

    Each (s_d, w_d) descriptor means node i *sends* its buffer to node
    (i + s_d) mod n: one ``torch.roll`` of each packed buffer per shift,
    then the weighted combine.  Runtime-valued rounds (tensor weights,
    ``meta=``/``edge_weight=``/``node_gate=``) roll the same buffers and
    take the plain f32 combine; ``compression`` is refused there."""
    ws_list = [w for _, w in shifts]
    if _is_runtime_round(self_weight, ws_list, meta, edge_weight,
                         node_gate):
        _refuse_runtime_compression(compression)
        return _runtime_mix(
            tree, permute=lambda arr, d: torch.roll(arr, shifts[d][0], 0),
            base_ws=ws_list, self_w=self_weight,
            meta=meta, node_gate=node_gate, edge_weight=edge_weight,
            fixed_mask=None, mesh=mesh)
    _refuse_mesh(mesh)
    layout, bufs = flatbuf.pack(tree)
    return flatbuf.unpack(layout, _shifts_bufs(layout, bufs, self_weight,
                                               shifts, compression))


def mix_shifts_per_leaf(tree: Tree, self_weight: float,
                        shifts: list[tuple[int, float]],
                        compression: str | None = None) -> Tree:
    """The historical path: one ``torch.roll`` PER LEAF per shift, in
    plain torch (no kernel) -- what ``benchmarks/bench_comm`` holds the
    flat engine against.

    Each leaf is accumulated in f32 in :func:`mix_shifts`'s order (the
    self term, then ``+= w * roll`` per shift) and cast back.  Under int8
    each leaf has one scale per node over all its other axes (``max|x| /
    127 + 1e-30``), as the reference's per-leaf path.  So this is bit for
    bit :func:`mix_shifts` wherever the flat path's scale groups are the
    tree's leaves; a layer-stacked model's per-layer leaves share one
    scale group in the flat path (:func:`flatbuf.scale_group_key`) and get
    a scale each here, so under int8 the two part on such trees."""
    _check_compression(compression)

    def _leaf(x):
        if compression is None:
            return gm_ref.gossip_mix_ref(
                x, [torch.roll(x, s, 0) for s, _ in shifts], self_weight,
                tuple(w for _, w in shifts))
        x32 = x.float()
        scale = (x32.abs().amax(dim=tuple(range(1, x.ndim)), keepdim=True)
                 / 127.0 + 1e-30)
        q = torch.round(x32 / scale).to(torch.int8)
        acc = (self_weight * x32) if self_weight else None
        for s, w in shifts:
            r = torch.roll(q, s, 0).float() * torch.roll(scale, s, 0) * w
            acc = r if acc is None else acc + r
        return acc.to(x.dtype)

    leaves, treedef = flatbuf.tree_flatten(tree)
    return flatbuf.tree_unflatten(treedef, [_leaf(x) for x in leaves])


def mix_matching(tree: Tree, partner: tuple, w_self: float = 0.5,
                 compression: str | None = None, mesh=None, *, meta=None,
                 edge_weight=None, node_gate=None) -> Tree:
    """Pairwise gossip: x_i <- w_self * x_i + (1 - w_self) * x_{partner[i]}.

    ``partner`` is an involution; fixed points keep their value EXACTLY
    (bit-for-bit, enforced with a mask).  Runtime-valued rounds (tensor
    ``w_self``, ``meta=``/``edge_weight=``/``node_gate=``) gather the
    same rows and take the plain f32 combine; under a per-node gate a pair
    averages only when BOTH endpoints are alive."""
    n = len(partner)
    fixed = np.fromiter((j == i for i, j in enumerate(partner)),
                        dtype=bool, count=n)
    if _is_runtime_round(w_self, (), meta, edge_weight, node_gate):
        _refuse_runtime_compression(compression)
        dev = flatbuf.tree_flatten(tree)[0][0].device
        idx = torch.as_tensor(partner, dtype=torch.long, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        base = (torch.tensor(0.5, **f32) if w_self is None
                else 1.0 - torch.as_tensor(w_self, **f32))
        # paired nodes carry the peer weight; fixed points contribute 0 so
        # the derived self weight stays 1 there (the keep mask then makes
        # the row bit-exact)
        base = torch.where(torch.as_tensor(fixed, device=dev),
                           torch.zeros((), **f32), base.broadcast_to((n,)))
        return _runtime_mix(
            tree, permute=lambda arr, d: arr.index_select(0, idx),
            base_ws=[base],
            self_w=None if (node_gate is not None or edge_weight is not None
                            or w_self is None) else w_self,
            meta=meta, node_gate=node_gate, edge_weight=edge_weight,
            fixed_mask=fixed if fixed.any() else None, mesh=mesh)
    _refuse_mesh(mesh)
    layout, bufs = flatbuf.pack(tree)
    return flatbuf.unpack(layout, _matching_bufs(layout, bufs, partner,
                                                 w_self, compression))


def mix_realization(tree: Tree, realization, *,
                    compression: str | None = None, mesh=None, meta=None,
                    edge_weight=None, node_gate=None) -> Tree:
    """Lower one realization-IR node onto its path.

    ``meta``/``edge_weight``/``node_gate`` flow to the runtime combine of
    Shifts/Matching rounds; a :class:`Gated` node realizes its inner round
    or Identity from its gate -- the wire is always issued, only the
    combine is gated."""
    if isinstance(realization, Identity):
        return tree
    if isinstance(realization, Gated):
        gate = realization.gate
        if getattr(gate, "ndim", 0) == 0:
            # whole-round gate: run the round, select the result
            mixed = mix_realization(
                tree, realization.inner, compression=compression, mesh=mesh,
                meta=meta, edge_weight=edge_weight, node_gate=node_gate)
            return _select(gate, mixed, tree)
        if node_gate is not None:
            raise ValueError("Gated realization with an explicit node_gate=;"
                             " pass one or the other")
        if isinstance(realization.inner, Dense):
            raise ValueError(
                "per-node gating of a Dense round is not supported; gate "
                "Shifts/Matching rounds (or use a scalar whole-round gate)")
        return mix_realization(
            tree, realization.inner, compression=compression, mesh=mesh,
            meta=meta, edge_weight=edge_weight, node_gate=gate)
    if isinstance(realization, Shifts):
        return mix_shifts(tree, realization.self_w, list(realization.shifts),
                          compression, mesh=mesh, meta=meta,
                          edge_weight=edge_weight, node_gate=node_gate)
    if isinstance(realization, Matching):
        return mix_matching(tree, realization.partner, realization.w_self,
                            compression, mesh, meta=meta,
                            edge_weight=edge_weight, node_gate=node_gate)
    if isinstance(realization, Dense):
        if compression is not None:
            raise ValueError(
                f"compression={compression!r} has no dense-matrix wire "
                f"format; only Shifts/Matching realizations quantize")
        if meta is not None or edge_weight is not None or node_gate is not None:
            raise ValueError(
                "metadata piggyback / loss-aware weights / gating need a "
                "permute wire (Shifts or Matching); Dense rounds all-gather")
        return mix_dense(tree, realization.W, mesh=mesh)
    raise TypeError(f"not a realization IR node: {realization!r}")


def _select(gate, mixed: Tree, tree: Tree) -> Tree:
    """``torch.where(gate, mixed, tree)`` leaf by leaf (a scalar gate)."""
    m_leaves, treedef = flatbuf.tree_flatten(mixed)
    t_leaves, _ = flatbuf.tree_flatten(tree)
    out = []
    for m, t in zip(m_leaves, t_leaves):
        g = torch.as_tensor(gate, device=m.device).to(torch.bool)
        out.append(torch.where(g, m, t))
    return flatbuf.tree_unflatten(treedef, out)


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
    _refuse_mesh(mesh)
    if not topology.schedule.is_periodic:
        raise AperiodicScheduleError(
            f"mix_switch needs a periodic schedule, but {topology.name!r} "
            f"carries {topology.schedule!r}; aperiodic schedules must use "
            "the static-step path (GossipPlan builds one executable per "
            "realization)")
    k = int(step.item()) if isinstance(step, torch.Tensor) else int(step)
    return mix(tree, topology, k % topology.schedule.period)


def mix_scheduled(tree: Tree, topology: Topology, pos, gate=None, *,
                  compression: str | None = None, mesh=None, meta=None,
                  edge_weight=None, node_gate=None) -> Tree:
    """Mix with realization ``pos % period``, where ``pos`` is the schedule
    position held in optimizer state (a 0-d int tensor, advanced only on
    rounds that communicate: ``schedule.advance_position``).  ``pos`` is
    read on the host once (one scalar sync) and only that realization
    runs.  An optional scalar ``gate`` selects between the mixed result
    and the unmixed tree AFTER the round, so a gated-off round still
    gathers and combines (as the reference still issues its permute).

    Exactness: since ``pos`` only advances on communicating rounds, a
    finite-time family (one_peer_exp / base_k / ceca) averages exactly
    once ``period`` COMMUNICATING rounds complete, however many skipped
    rounds interleave.  Periodic schedules only, as :func:`mix_switch`."""
    if not topology.schedule.is_periodic:
        raise AperiodicScheduleError(
            f"mix_scheduled needs a periodic schedule, but "
            f"{topology.name!r} carries {topology.schedule!r}")
    k = int(pos.item()) if isinstance(pos, torch.Tensor) else int(pos)
    mixed = mix_realization(
        tree, topology.realization(k % topology.schedule.period),
        compression=compression, mesh=mesh, meta=meta,
        edge_weight=edge_weight, node_gate=node_gate)
    if gate is None:
        return mixed
    return _select(gate, mixed, tree)


def pack_payload(tree: Tree, *, mesh=None) -> tuple:
    """SEND half of the overlapped pipeline: ``tree`` packed into its wire
    buffers (one ``(n, B)`` buffer per dtype group), not mixed."""
    _refuse_mesh(mesh)
    return tuple(flatbuf.pack(tree)[1])


def delayed_mix(template: Tree, bufs, realization, *,
                compression: str | None = None, mesh=None) -> Tree:
    """COMBINE half of the overlapped pipeline: apply ``realization`` to
    the packed buffers of :func:`pack_payload` and unpack them to
    ``template``'s structure (tensors, meta ones too: only shapes and
    dtypes are read).  Every realization kind is taken: ``Identity`` just
    unpacks; a static Shifts or Matching round rolls or gathers and
    combines the buffers as they are (no second pack); any other round
    mixes the unpacked tree.  Each is bit for bit what
    :func:`mix_realization` gives the unpacked tree."""
    _refuse_mesh(mesh)
    layout = flatbuf.layout_of(template)
    bufs = list(bufs)
    r = realization
    if isinstance(r, Identity):
        return flatbuf.unpack(layout, bufs)
    if isinstance(r, Shifts) and not r.traced:
        return flatbuf.unpack(layout, _shifts_bufs(
            layout, bufs, r.self_w, list(r.shifts), compression))
    if isinstance(r, Matching) and not r.traced:
        return flatbuf.unpack(layout, _matching_bufs(
            layout, bufs, r.partner, r.w_self, compression))
    return mix_realization(flatbuf.unpack(layout, bufs), r,
                           compression=compression)


def gossip_spec(topology: Topology, step: int,
                layout: flatbuf.FlatLayout | None = None,
                compression: str | None = None,
                meta_cols: int = 0) -> dict:
    """Structural description of one gossip round, read off the
    realization IR (for roofline accounting).

    ``wire_multiplier`` is the number of per-node payload copies the round
    moves: one per shift for ``Shifts``, exactly 1 for any ``Matching``,
    ``n - 1`` for ``Dense`` (an all-gather), 0 for ``Identity``; a
    ``Gated`` round moves its inner round's bytes (the wire is always
    issued).  With a ``layout`` (from :func:`flatbuf.layout_of`), adds the
    packed-path byte accounting: collectives per step and bytes sent per
    node, payload and int8 scale rows apart (an int8 round moves two
    buffers per dtype group).  ``meta_cols`` counts the piggybacked
    per-node metadata columns (the gate column included): they ride the
    f32 group's existing gather -- zero extra collectives, ``4 *
    meta_cols`` bytes per payload copy, reported as
    ``meta_bytes_per_node_per_step``."""
    r = topology.realization(step)
    n = topology.n
    gated = isinstance(r, Gated)
    if gated:
        r = r.inner          # the wire structure is always issued
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
    if gated:
        spec["gated"] = True
    if meta_cols:
        spec["meta_cols"] = meta_cols
    if layout is not None:
        split = flatbuf.wire_bytes_split(layout, compression)
        meta_bytes = 4 * meta_cols * mult
        # an int8 round moves the scale rows too: a second roll or gather
        # per dtype group
        quantized = (compression == "int8"
                     and spec["kind"] in ("ppermute", "matching"))
        spec["dtype_groups"] = len(layout.groups)
        spec["collectives_per_step"] = (
            rounds * len(layout.groups) * (2 if quantized else 1))
        spec["payload_bytes_per_node_per_step"] = split["payload"] * mult
        spec["scale_bytes_per_node_per_step"] = split["scales"] * mult
        spec["meta_bytes_per_node_per_step"] = meta_bytes
        spec["bytes_per_node_per_step"] = (
            (split["payload"] + split["scales"]) * mult + meta_bytes)
    return spec
