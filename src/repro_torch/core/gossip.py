"""Partial averaging (gossip) over the node axis.

The port of the JAX package's ``core/gossip.py``.  Without a mesh every
quantity is a tree (``dict[str, Tensor]``, or a tuple/list of such dicts)
whose leaves carry a leading node axis of size ``n``; each mix first packs
the tree into one ``(n, B)`` buffer per dtype
(:mod:`repro_torch.core.flatbuf`), so its cost does not depend on the leaf
count.  One lowering per realization-IR node:

* ``Shifts``   -> :func:`mix_shifts`: one gather of rows per shift,
  ``torch.roll(buf, s, 0)``'s permutation (node i receives from
  (i - s) mod n, ``jnp.roll``'s sign), and one
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

**Shard-native path** (``mesh=``, a live
:class:`~repro_torch.launch.mesh.Mesh` whose node axis has one rank per
node): every rank passes ITS block of the payload -- a leading node axis
of 1, inner dims cut by the specs (``launch.sharding.local_shard``) --
and gets its block of the mixed payload back.  Each rank packs its
leaves with ``pad_multiple=1``, so the wire moves exactly the local
shard's bytes, and the reference's lowering runs on the mesh's wire
(:meth:`Mesh.permute`, ``psum``, ``pmax``): one explicit-pairs permute
per shift per dtype group for Shifts and Matching rounds, then K1 on the
local buffers (a CUDA buffer launches the kernel, a CPU one takes the
plain version, as in one process); under int8 the payload and its scale
rows are each permuted, the scales being the per-group max over the
rank's local slices completed by a ``pmax`` over the inner axes; a Dense
round with uniform rows is one ``psum`` per dtype group, any other
concrete ``W`` one permute per nonzero circulant distance class, each
weighted by the receiving node's own entry (a tensor ``W`` keeps the
global ``einsum``); runtime rounds piggyback their metadata on the f32
group's permute and act on each rank's own row.  It is bit for bit the
global path for Shifts, Matching and int8 (fixed points included), and
within rounding for Dense (another summation order).  Where the mesh's
node extent is not the node count -- a rank holds ``L > 1`` nodes -- the
global path runs as the reference's does under GSPMD: the ranks' node
blocks are gathered over the node axis (an all-gather of the payload),
mixed, and each rank keeps its rows; a runtime round gathers its
per-node values with them.  The reference's ``specs=`` map
global arrays to the blocks at ``shard_map``'s boundary; here each rank
already holds its block (``sharding.local_shard(tree, specs, mesh)``), so
the engine takes no specs.

The single-process path and the mesh path run one body: a static round
is :func:`_round_start` over a wire -- the mesh, or :data:`_ROWS`, whose
permute gathers the rows of a buffer that holds every node -- and a
runtime round is :func:`_runtime_bufs` over the same two.  A round posts
its wire and then finishes (waits, combines): :func:`delayed_post` hands
the two halves to the overlapped trainer, which computes the gradients
between them; every other entry point runs them back to back.
:func:`node_mean` is the all-reduce baseline's gradient average, a
``psum`` per dtype group on a mesh.
"""
from __future__ import annotations

import contextlib
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
           "pack_payload", "delayed_mix", "delayed_post", "node_mean",
           "Pending", "gossip_spec", "set_kernel_mode", "kernel_mode",
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


@contextlib.contextmanager
def kernel_mode(mode: str):
    """:func:`set_kernel_mode` for the block, the previous mode restored
    on exit."""
    prev = _KERNEL_MODE
    set_kernel_mode(mode)
    try:
        yield
    finally:
        set_kernel_mode(prev)


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


def _einsum_bufs(bufs, W) -> list:
    out = []
    for b in bufs:
        Wt = (W if isinstance(W, torch.Tensor) else np.asarray(W))
        Wt = torch.as_tensor(Wt, dtype=torch.float32, device=b.device)
        out.append(torch.einsum("ij,jb->ib", Wt, b.float()).to(b.dtype))
    return out


def mix_dense(tree: Tree, W, *, mesh=None,
              axis_name: str = "node") -> Tree:
    """x_i <- sum_j W[i, j] x_j over the leading node axis of every leaf:
    one ``einsum('ij,jb->ib')`` in f32 per dtype group.

    On a mesh with one rank per node and a concrete (numpy) ``W``, the
    shard-native round (:func:`_local_dense`): one ``psum`` per dtype
    group for uniform rows, else one permute per nonzero circulant
    distance class.  A tensor ``W`` (the time-varying dense executable's
    argument) keeps the global einsum, through the gathered fallback."""
    if mesh is None:
        layout, bufs = flatbuf.pack(tree)
        return flatbuf.unpack(layout, _einsum_bufs(bufs, W))
    n, L = _mesh_nodes(tree, mesh, axis_name)
    if tuple(np.shape(W)) != (n, n):
        raise ValueError(f"W of shape {tuple(np.shape(W))} for {n} nodes")
    if L == 1 and not isinstance(W, torch.Tensor):
        layout = flatbuf.layout_of(tree, pad_multiple=1)
        layout, bufs = flatbuf.pack(tree, layout)
        return flatbuf.unpack(layout, _local_dense(
            bufs, np.asarray(W, np.float64), mesh, axis_name)())
    return _gathered_bufs(tree, mesh, axis_name,
                          lambda layout, bufs: _einsum_bufs(bufs, W))


# ---------------------------------------------------------------------------
# Wires: the mesh, or the rows of one process's buffers
# ---------------------------------------------------------------------------

class Pending:
    """Work in flight: ``wait()`` runs ``finish`` and returns its result,
    once; the handle keeps nothing, so a received buffer lives only as
    long as its caller holds it.  A mesh's split ops return one (the
    wire posted, ``finish`` completing it); a synchronous round wraps
    each permute in one, so that it runs where the combine reads it, one
    received buffer alive at a time."""

    def __init__(self, finish):
        self._finish = finish

    def wait(self):
        finish, self._finish = self._finish, None
        if finish is None:
            raise RuntimeError("a Pending is waited for once")
        return finish()


class _Rows:
    """The single-process wire: a buffer holds every node's row, and a
    permute over send pairs ``(src, dst)`` is one gather of rows (row
    ``dst`` takes row ``src``), as the mesh's permute moves rank ``src``'s
    block to rank ``dst``."""

    def permute(self, buf: torch.Tensor, pairs, axis_name=None):
        idx = list(range(buf.shape[0]))
        for src, dst in pairs:
            idx[dst] = src
        return buf.index_select(0, torch.as_tensor(idx, dtype=torch.long,
                                                   device=buf.device))


_ROWS = _Rows()


def _starter(wire, axis_name: str, split: bool):
    """``start(buf, pairs)`` -> a pending permute over ``wire``: with
    ``split`` posted at once (the mesh's ``permute_start``), else run when
    it is waited for."""
    if split:
        return lambda buf, pairs: wire.permute_start(buf, pairs, axis_name)
    return lambda buf, pairs: Pending(
        lambda: wire.permute(buf, pairs, axis_name))


def _mesh_nodes(tree: Tree, mesh, axis_name: str) -> tuple[int, int]:
    """(n, L): the node count of a payload whose rank blocks hold ``L``
    nodes each over the mesh's node axis."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no {axis_name!r} axis")
    leaves, _ = flatbuf.tree_flatten(tree)
    L = int(leaves[0].shape[0])
    return L * mesh.axis_size(axis_name), L


def _node_count(tree: Tree, mesh, axis_name: str) -> int:
    if mesh is None:
        return int(flatbuf.tree_flatten(tree)[0][0].shape[0])
    return _mesh_nodes(tree, mesh, axis_name)[0]


def _scale_reduce(mesh, axis_name: str):
    """The int8 scales' ``pmax`` over the mesh's inner axes (None without
    a mesh, or on a mesh with only a node axis)."""
    if mesh is None:
        return None
    inner = tuple(a for a in mesh.axis_names if a != axis_name)
    return (lambda m: mesh.pmax(m, inner)) if inner else None


def _shift_pairs(n: int, shift: int) -> list:
    """Send pairs of a circulant +shift: node i sends to (i + s) mod n, so
    node i receives from (i - s) mod n -- ``torch.roll(x, s, 0)``."""
    return [(i, (i + shift) % n) for i in range(n)]


def _matching_pairs(partner: tuple) -> list:
    return [(src, dst) for dst, src in enumerate(partner)]


# ---------------------------------------------------------------------------
# Runtime-valued rounds: tensor weights, metadata piggyback, node gating
# ---------------------------------------------------------------------------
#
# A round is RUNTIME-valued when any of its weights is a tensor, or when it
# carries per-node metadata (``meta=``), loss-aware edge weights
# (``edge_weight=``) or a straggler gate (``node_gate=``).  It gathers
# exactly the rows the static round gathers (a gated-off edge still moves
# its bytes) and combines in plain f32 torch with weights that are
# tensors.  Metadata rides the f32 dtype group's permute, cast to that
# group's dtype (group 0's when the payload has no f32 group): the
# receiver reads its sender's (loss, grad-norm, alive) row from the rows
# the round moves anyway.  On a mesh the columns are concatenated onto
# the buffer before its permute, as the reference does; in one process
# that only moves data, so the (n, M) meta rows are gathered with the
# payload's index: the same bits without a second payload-sized copy.
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


def _runtime_combine(bufs: list, recv, recv_meta: list, base_ws: list,
                     self_w, meta_mat, n_user: int, has_gate: bool,
                     edge_weight, keep) -> list:
    """Weighted combine with runtime weights / piggybacked metadata.

    ``recv(j, d)`` returns group ``j``'s buffer as received over edge
    ``d`` (a roll, a gather, or the mesh's permute); ``recv_meta[d]`` the
    (rows, M) f32 metadata received over edge ``d`` (None without
    metadata).  ``keep`` is an optional (rows, 1) mask of rows that keep
    their value bit-exactly (matching fixed points)."""
    D = len(base_ws)
    dev = bufs[0].device
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
    for j, buf in enumerate(bufs):
        x32 = buf.to(torch.float32)
        acc = self_col * x32
        for d in range(D):
            # a fresh received f32 buffer, scaled in place: one extra
            # payload-sized tensor at a time
            r = recv(j, d).to(torch.float32)
            acc.add_(r.mul_(_wcol(eff[d], dev)))
            del r
        if keep is not None:
            acc = torch.where(keep, x32, acc)
        outs.append(acc.to(buf.dtype))
    return outs


def _own_rows(x, rows: slice, n: int):
    """A per-node value on the wire's rows: a tensor or array of length
    ``n`` (the whole node axis) is cut to ``rows``; anything else (a
    scalar, or already the rank's own row) is kept."""
    if x is None or np.ndim(x) == 0 or n == 1 or len(x) != n:
        return x
    return x[rows]


def _permute_meta(wire, buf, meta_mat, pairs, axis_name: str) -> tuple:
    """The metadata's ride on ``buf``'s permute: (the received ``buf``, or
    None where only the metadata moved, and the received (rows, M) f32
    metadata)."""
    wired = meta_mat.to(buf.dtype)
    if wire is _ROWS:
        return None, wire.permute(wired, pairs).to(torch.float32)
    width = buf.shape[1]
    r = wire.permute(torch.cat([buf, wired], 1), pairs, axis_name)
    return r[:, :width], r[:, width:].to(torch.float32)


def _runtime_round(tree: Tree, *, rounds: list, base_ws: list, self_w,
                   meta, node_gate, edge_weight, fixed_mask, mesh,
                   axis_name: str) -> Tree:
    """A runtime-valued Shifts/Matching round: ``rounds[d]`` are edge
    ``d``'s send pairs, ``base_ws[d]`` its base weight (float, 0-d or
    per-node tensor; ``edge_weight`` may override).  Without a mesh the
    buffers hold every node and the wire is :data:`_ROWS`; on a mesh with
    one rank per node each rank packs its block and the combine acts on
    its own row; with several nodes a rank the global path runs on the
    gathered buffers (:func:`_gathered_runtime`)."""
    n = _node_count(tree, mesh, axis_name)
    kw = dict(rounds=rounds, base_ws=base_ws, self_w=self_w, meta=meta,
              node_gate=node_gate, edge_weight=edge_weight,
              fixed_mask=fixed_mask)
    if mesh is None:
        wire, rows = _ROWS, slice(None)
        layout, bufs = flatbuf.pack(tree)
    else:
        if _mesh_nodes(tree, mesh, axis_name)[1] != 1:
            return _gathered_runtime(tree, mesh, axis_name, n, kw)
        wire, i = mesh, mesh.axis_index(axis_name)
        rows = slice(i, i + 1)
        layout, bufs = flatbuf.pack(tree,
                                    flatbuf.layout_of(tree, pad_multiple=1))
    return flatbuf.unpack(layout, _runtime_bufs(layout, bufs, wire, rows, n,
                                                axis_name, **kw))


def _gathered_runtime(tree: Tree, mesh, axis_name: str, n: int,
                      kw: dict) -> Tree:
    """A runtime round where each rank holds ``L > 1`` nodes: the rank
    blocks' buffers gathered over the node axis (:func:`_gathered_bufs`),
    and so is every per-node value given for the rank's ``L`` rows (the
    metadata, the gate, a per-node weight; a value of all ``n`` nodes is
    kept); the single-process combine runs over :data:`_ROWS` on all n
    nodes, and the rank keeps its rows -- the reference's global path
    outside ``shard_map``."""
    L = _mesh_nodes(tree, mesh, axis_name)[1]

    def full(x):
        if x is None or np.ndim(x) == 0 or len(x) != L:
            return x
        t = torch.as_tensor(x)
        # the gather moves f32 (a gate is bool): every value is exact
        return mesh.all_gather(t.to(torch.float32), axis_name).to(t.dtype)

    kw = dict(kw, meta=full(kw["meta"]), node_gate=full(kw["node_gate"]),
              self_w=full(kw["self_w"]),
              base_ws=[full(w) for w in kw["base_ws"]])
    return _gathered_bufs(tree, mesh, axis_name, lambda layout, bufs: (
        _runtime_bufs(layout, bufs, _ROWS, slice(None), n, axis_name,
                      **kw)))


def _runtime_bufs(layout, bufs, wire, rows: slice, n: int, axis_name: str,
                  *, rounds, base_ws, self_w, meta, node_gate, edge_weight,
                  fixed_mask) -> list:
    """The runtime round's body on packed buffers holding the nodes
    ``rows`` over ``wire`` (the mesh, or :data:`_ROWS`); returns the
    combined buffers."""
    dev = bufs[0].device
    own = lambda x: _own_rows(x, rows, n)  # noqa: E731
    meta_mat, n_user, has_gate = _assemble_meta(own(meta), own(node_gate),
                                                dev)
    base_ws = [own(w) for w in base_ws]
    keep = None
    if fixed_mask is not None and fixed_mask[rows].any():
        keep = torch.as_tensor(fixed_mask[rows], device=dev)[:, None]
    gi = _f32_group_index(layout)
    D = len(rounds)
    recv_meta, recv_f32 = [None] * D, [None] * D
    if meta_mat is not None:
        for d in range(D):
            recv_f32[d], recv_meta[d] = _permute_meta(
                wire, bufs[gi], meta_mat, rounds[d], axis_name)

    def recv(j, d):
        if j == gi and recv_f32[d] is not None:
            r, recv_f32[d] = recv_f32[d], None
            return r
        return wire.permute(bufs[j], rounds[d], axis_name)

    return _runtime_combine(bufs, recv, recv_meta, base_ws, own(self_w),
                            meta_mat, n_user, has_gate, edge_weight, keep)


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

def _scale_columns(buf: torch.Tensor, g: flatbuf.GroupLayout,
                   reduce=None) -> torch.Tensor:
    """(n, G + 1) f32 int8 scales of one packed group: ``max|x| / 127 +
    1e-30`` per (node, scale group) -- a JAX leaf's layers are one column
    range -- then a column of 1.0 for the padding.  On a mesh each rank
    holds its local slices of a group: ``reduce`` (a ``pmax`` over the
    inner axes) completes the group's max before the division."""
    cols = []
    for a, b in g.scale_ranges:
        lo, hi = torch.aminmax(buf[:, a:b], dim=1)
        cols.append(torch.maximum(lo.float().abs(), hi.float().abs()))
    m = torch.stack(cols, 1)
    if reduce is not None:
        m = reduce(m)
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


def _post_group(g: flatbuf.GroupLayout, buf, start, rounds: list,
                compression, reduce) -> list:
    """One dtype group's wire of a static round: a pending permute of the
    buffer per edge, or under int8 (the buffer quantized against its
    scale rows, the scales completed by ``reduce``) a pending permute of
    the int8 buffer and one of its scale rows per edge."""
    if compression is None:
        return [start(buf, pairs) for pairs, _ in rounds]
    sc = _scale_columns(buf, g, reduce)
    q = _quantize(buf, g, sc)
    return [(start(q, pairs), start(sc, pairs)) for pairs, _ in rounds]


def _finish_group(g: flatbuf.GroupLayout, buf, posted: list, rounds: list,
                  self_w: float, compression, keep, matching: bool):
    """One dtype group's combine of a static round over its received
    buffers: K1, or the int8 receiver (dequantize and combine in f32)."""
    rows = None if keep is None else np.flatnonzero(keep).tolist()
    if compression is None:
        recvs = [p.wait() for p in posted]
        o = _combine(buf, recvs, self_w, tuple(w for _, w in rounds))
        del recvs
        if rows:
            o = torch.where(torch.as_tensor(keep, device=buf.device)
                            [:, None], buf, o)
        return o
    x32 = buf.float()
    acc = (self_w * x32) if (self_w or matching) else None
    for (pq, ps), (_, w) in zip(posted, rounds):
        acc = _add_dequantized(acc, pq.wait(), ps.wait(), g, float(w))
    del posted
    if rows:
        # in place: no second payload-sized tensor
        acc[rows] = x32[rows]
    return acc.to(buf.dtype)


def _round_start(layout: flatbuf.FlatLayout, bufs, wire, axis_name: str,
                 rounds: list, self_w: float, compression, keep,
                 matching: bool, reduce=None, split: bool = False):
    """One static Shifts or Matching round on packed buffers over ``wire``
    (the mesh, or :data:`_ROWS`): ``rounds`` is ``[(send pairs, weight),
    ...]``, one permute each per dtype group, then K1 -- or the int8
    wire: the payload and its scale rows permuted, the scales completed
    by ``reduce`` (a ``pmax`` over a mesh's inner axes), the receiver
    dequantizing and combining in f32.  ``keep`` (a bool array over the
    buffers' rows, or None) marks matching fixed points, which keep their
    full-precision buffer bit for bit; ``matching`` starts the int8 sum
    with the self term even at a self weight of 0.

    Returns ``finish()``, which gives the combined buffers.  With
    ``split`` every group's wire is posted here (``wire.permute_start``)
    and ``finish`` waits for it; without, each group's permutes and
    combine run inside ``finish``, one group after the other."""
    _check_compression(compression)
    start = _starter(wire, axis_name, split)
    groups = list(zip(layout.groups, bufs))

    def one(g, buf, posted):
        return _finish_group(g, buf, posted, rounds, self_w, compression,
                             keep, matching)

    if split:
        posted = [_post_group(g, buf, start, rounds, compression, reduce)
                  for g, buf in groups]
        return lambda: [one(g, buf, p) for (g, buf), p in zip(groups,
                                                                posted)]
    return lambda: [one(g, buf, _post_group(g, buf, start, rounds,
                                            compression, reduce))
                    for g, buf in groups]


def _static_start(layout, bufs, wire, n: int, *, shifts=None, partner=None,
                  self_w: float, compression, rows=slice(None),
                  axis_name: str = "node", reduce=None, split: bool = False):
    """A static Shifts (``shifts``) or Matching (``partner``) round of
    ``n`` nodes on packed buffers holding the nodes ``rows``:
    :func:`_round_start`'s ``finish``."""
    if shifts is not None:
        return _round_start(layout, bufs, wire, axis_name,
                            [(_shift_pairs(n, s), w) for s, w in shifts],
                            self_w, compression, None, False, reduce, split)
    fixed = np.fromiter((j == i for i, j in enumerate(partner)), dtype=bool,
                        count=n)[rows]
    return _round_start(layout, bufs, wire, axis_name,
                        [(_matching_pairs(partner), 1.0 - self_w)], self_w,
                        compression, fixed if fixed.any() else None, True,
                        reduce, split)


# ---------------------------------------------------------------------------
# Shard-native engine: each rank's block, the mesh's wire
# ---------------------------------------------------------------------------

def _local_dense(bufs, W: np.ndarray, mesh, axis_name: str,
                 split: bool = False):
    """One dense round on a rank's packed block, as ``finish()`` (see
    :func:`_round_start`; ``split`` posts the whole wire first).
    Uniform-row ``W`` (exact averaging, the all-reduce warm-up) is ONE
    ``psum`` per dtype group; any other ``W`` is the self term plus one
    explicit-pairs permute per nonzero circulant distance class ``s``
    (``W[i, (i - s) % n] != 0`` for some ``i``), each received buffer
    weighted by the receiving node's own entry."""
    n = W.shape[0]
    i = mesh.axis_index(axis_name)
    if np.allclose(W, W[0:1, :]):
        row = torch.as_tensor(W[0], dtype=torch.float32)

        def psum(buf):
            x = row[i].to(buf.device) * buf.float()
            if split:
                return mesh.psum_start(x, axis_name)
            return Pending(lambda: mesh.psum(x, axis_name))

        if split:
            posted = [psum(buf) for buf in bufs]
            return lambda: [p.wait().to(buf.dtype)
                            for p, buf in zip(posted, bufs)]
        return lambda: [psum(buf).wait().to(buf.dtype) for buf in bufs]
    diag = torch.as_tensor(np.ascontiguousarray(np.diagonal(W)),
                           dtype=torch.float32)
    shifts = []
    for s in range(1, n):
        col = np.array([W[j, (j - s) % n] for j in range(n)])
        if np.any(col):
            shifts.append((s, torch.as_tensor(col, dtype=torch.float32)))
    start = _starter(mesh, axis_name, split)

    def post(buf):
        return [start(buf, _shift_pairs(n, s)) for s, _ in shifts]

    def one(buf, posted):
        acc = diag[i].to(buf.device) * buf.float()
        for (_, col), p in zip(shifts, posted):
            acc = acc + col[i].to(buf.device) * p.wait().float()
        return acc.to(buf.dtype)

    if split:
        posted = [post(buf) for buf in bufs]
        return lambda: [one(buf, p) for buf, p in zip(bufs, posted)]
    return lambda: [one(buf, post(buf)) for buf in bufs]


def _gathered_bufs(tree: Tree, mesh, axis_name: str, fn) -> Tree:
    """The global path on a mesh whose ranks hold several nodes each: the
    rank blocks' packed buffers gathered over the node axis (an all-gather
    of the payload, what GSPMD does for the reference's global path),
    ``fn(layout, bufs)`` on the (n, B) buffers, this rank's rows kept."""
    n, L = _mesh_nodes(tree, mesh, axis_name)
    layout, bufs = flatbuf.pack(tree)
    full = [mesh.all_gather(b, axis_name) for b in bufs]
    i = mesh.axis_index(axis_name)
    out = [o[i * L:(i + 1) * L] for o in fn(layout, full)]
    return flatbuf.unpack(layout, out)


def _static(tree: Tree, mesh, axis_name: str, *, shifts=None,
            partner=None, self_w: float, compression) -> Tree:
    """A static Shifts (``shifts``) or Matching (``partner``) round of
    ``tree``: in one process, shard-natively on a mesh with one rank per
    node, else through the gathered global path."""
    n = _node_count(tree, mesh, axis_name)
    if partner is not None and len(partner) != n:
        raise ValueError(f"a matching of {len(partner)} nodes on {n}")
    kw = dict(shifts=shifts, partner=partner, self_w=self_w,
              compression=compression, axis_name=axis_name,
              reduce=_scale_reduce(mesh, axis_name))
    if mesh is None:
        layout, bufs = flatbuf.pack(tree)
        return flatbuf.unpack(layout, _static_start(layout, bufs, _ROWS, n,
                                                    **kw)())
    if not _shard_native(mesh, axis_name, tree):
        return _gathered_bufs(tree, mesh, axis_name, lambda lay, b: (
            _static_start(lay, b, _ROWS, n, **kw)()))
    i = mesh.axis_index(axis_name)
    layout = flatbuf.layout_of(tree, pad_multiple=1)
    layout, bufs = flatbuf.pack(tree, layout)
    return flatbuf.unpack(layout, _static_start(
        layout, bufs, mesh, n, rows=slice(i, i + 1), **kw)())


def mix_shifts(tree: Tree, self_weight: float,
               shifts: list[tuple[int, float]],
               compression: str | None = None, *, mesh=None,
               axis_name: str = "node", meta=None,
               edge_weight=None, node_gate=None) -> Tree:
    """x_i <- self_weight * x_i + sum_d w_d * x_{(i - s_d) mod n}.

    Each (s_d, w_d) descriptor means node i *sends* its buffer to node
    (i + s_d) mod n: one gather of each packed buffer's rows per shift
    (``torch.roll``'s permutation), then the weighted combine -- or, with
    ``mesh=``, one permute of each rank's packed block per shift (see the
    module docstring).
    Runtime-valued rounds (tensor weights,
    ``meta=``/``edge_weight=``/``node_gate=``) move the same buffers and
    take the plain f32 combine; ``compression`` is refused there."""
    ws_list = [w for _, w in shifts]
    if _is_runtime_round(self_weight, ws_list, meta, edge_weight,
                         node_gate):
        _refuse_runtime_compression(compression)
        n = _node_count(tree, mesh, axis_name)
        return _runtime_round(
            tree, rounds=[_shift_pairs(n, s) for s, _ in shifts],
            base_ws=ws_list, self_w=self_weight,
            meta=meta, node_gate=node_gate, edge_weight=edge_weight,
            fixed_mask=None, mesh=mesh, axis_name=axis_name)
    return _static(tree, mesh, axis_name, shifts=list(shifts),
                   self_w=self_weight, compression=compression)


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
                 compression: str | None = None, mesh=None,
                 axis_name: str = "node", *, meta=None,
                 edge_weight=None, node_gate=None) -> Tree:
    """Pairwise gossip: x_i <- w_self * x_i + (1 - w_self) * x_{partner[i]}.

    ``partner`` is an involution; fixed points keep their value EXACTLY
    (bit-for-bit, enforced with a mask).  One gather of the partner rows,
    or with ``mesh=`` one explicit-pairs permute of each rank's block per
    dtype group.  Runtime-valued rounds (tensor ``w_self``,
    ``meta=``/``edge_weight=``/``node_gate=``) move the same rows and take
    the plain f32 combine; under a per-node gate a pair averages only when
    BOTH endpoints are alive."""
    n = len(partner)
    fixed = np.fromiter((j == i for i, j in enumerate(partner)),
                        dtype=bool, count=n)
    if _is_runtime_round(w_self, (), meta, edge_weight, node_gate):
        _refuse_runtime_compression(compression)
        dev = flatbuf.tree_flatten(tree)[0][0].device
        f32 = dict(dtype=torch.float32, device=dev)
        base = (torch.tensor(0.5, **f32) if w_self is None
                else 1.0 - torch.as_tensor(w_self, **f32))
        # paired nodes carry the peer weight; fixed points contribute 0 so
        # the derived self weight stays 1 there (the keep mask then makes
        # the row bit-exact)
        base = torch.where(torch.as_tensor(fixed, device=dev),
                           torch.zeros((), **f32), base.broadcast_to((n,)))
        return _runtime_round(
            tree, rounds=[_matching_pairs(partner)], base_ws=[base],
            self_w=None if (node_gate is not None or edge_weight is not None
                            or w_self is None) else w_self,
            meta=meta, node_gate=node_gate, edge_weight=edge_weight,
            fixed_mask=fixed if fixed.any() else None, mesh=mesh,
            axis_name=axis_name)
    return _static(tree, mesh, axis_name, partner=tuple(partner),
                   self_w=w_self, compression=compression)


def mix_realization(tree: Tree, realization, *,
                    compression: str | None = None, mesh=None,
                    axis_name: str = "node", meta=None,
                    edge_weight=None, node_gate=None) -> Tree:
    """Lower one realization-IR node onto its path.

    ``meta``/``edge_weight``/``node_gate`` flow to the runtime combine of
    Shifts/Matching rounds; a :class:`Gated` node realizes its inner round
    or Identity from its gate -- the wire is always issued, only the
    combine is gated."""
    kw = dict(mesh=mesh, axis_name=axis_name)
    if isinstance(realization, Identity):
        return tree
    if isinstance(realization, Gated):
        gate = realization.gate
        if getattr(gate, "ndim", 0) == 0:
            # whole-round gate: run the round, select the result
            mixed = mix_realization(
                tree, realization.inner, compression=compression, meta=meta,
                edge_weight=edge_weight, node_gate=node_gate, **kw)
            return _select(gate, mixed, tree)
        if node_gate is not None:
            raise ValueError("Gated realization with an explicit node_gate=;"
                             " pass one or the other")
        if isinstance(realization.inner, Dense):
            raise ValueError(
                "per-node gating of a Dense round is not supported; gate "
                "Shifts/Matching rounds (or use a scalar whole-round gate)")
        return mix_realization(
            tree, realization.inner, compression=compression, meta=meta,
            edge_weight=edge_weight, node_gate=gate, **kw)
    if isinstance(realization, Shifts):
        return mix_shifts(tree, realization.self_w, list(realization.shifts),
                          compression, meta=meta, edge_weight=edge_weight,
                          node_gate=node_gate, **kw)
    if isinstance(realization, Matching):
        return mix_matching(tree, realization.partner, realization.w_self,
                            compression, meta=meta, edge_weight=edge_weight,
                            node_gate=node_gate, **kw)
    if isinstance(realization, Dense):
        if compression is not None:
            raise ValueError(
                f"compression={compression!r} has no dense-matrix wire "
                f"format; only Shifts/Matching realizations quantize")
        if meta is not None or edge_weight is not None or node_gate is not None:
            raise ValueError(
                "metadata piggyback / loss-aware weights / gating need a "
                "permute wire (Shifts or Matching); Dense rounds all-gather")
        return mix_dense(tree, realization.W, **kw)
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
    if not topology.schedule.is_periodic:
        raise AperiodicScheduleError(
            f"mix_switch needs a periodic schedule, but {topology.name!r} "
            f"carries {topology.schedule!r}; aperiodic schedules must use "
            "the static-step path (GossipPlan builds one executable per "
            "realization)")
    k = int(step.item()) if isinstance(step, torch.Tensor) else int(step)
    return mix(tree, topology, k % topology.schedule.period, mesh=mesh)


def mix_scheduled(tree: Tree, topology: Topology, pos, gate=None, *,
                  compression: str | None = None, mesh=None,
                  meta=None, edge_weight=None, node_gate=None) -> Tree:
    """Mix with realization ``pos % period``, where ``pos`` is the schedule
    position held in optimizer state (a 0-d int tensor, advanced only on
    rounds that communicate: ``schedule.advance_position``).  ``pos`` is
    read on the host once (one scalar sync) and only that realization
    runs.  An optional scalar ``gate`` selects between the mixed result
    and the unmixed tree AFTER the round, so a gated-off round still
    moves and combines (as the reference still issues its permute).

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


def _shard_native(mesh, axis_name: str, tree: Tree) -> bool:
    """The mesh path runs when the mesh's node extent is the node count:
    each rank's block holds one node."""
    return mesh is not None and _mesh_nodes(tree, mesh, axis_name)[1] == 1


def pack_payload(tree: Tree, *, mesh=None,
                 axis_name: str = "node") -> tuple:
    """SEND half of the overlapped pipeline: ``tree`` packed into its wire
    buffers (one buffer per dtype group), not mixed.  On a mesh with one
    rank per node each rank packs its block with ``pad_multiple=1``, the
    granularity the synchronous mesh round packs at."""
    if _shard_native(mesh, axis_name, tree):
        return tuple(flatbuf.pack(
            tree, flatbuf.layout_of(tree, pad_multiple=1))[1])
    return tuple(flatbuf.pack(tree)[1])


def delayed_mix(template: Tree, bufs, realization, *,
                compression: str | None = None, mesh=None,
                axis_name: str = "node") -> Tree:
    """COMBINE half of the overlapped pipeline: apply ``realization`` to
    the packed buffers of :func:`pack_payload` and unpack them to
    ``template``'s structure (tensors, meta ones too: only shapes and
    dtypes are read; on a mesh the rank's block).  Every realization kind
    is taken: ``Identity`` just unpacks; a static Shifts or Matching round
    rolls, gathers or permutes and combines the buffers as they are (no
    second pack); a Dense round on a mesh runs the shard-native dense
    round; any other round mixes the unpacked tree.  Each is bit for bit
    what :func:`mix_realization` gives the unpacked tree."""
    return _delayed(template, bufs, realization, compression, mesh,
                    axis_name, split=False).wait()


def delayed_post(template: Tree, bufs, realization, *,
                 compression: str | None = None, mesh=None,
                 axis_name: str = "node"):
    """:func:`delayed_mix` in two halves: on a mesh with one rank per node
    the round's whole wire -- every permute (two per edge under int8) or
    ``psum`` of every dtype group -- is posted here, and the returned
    handle's ``wait()`` completes it, combines (K1 on the rank's block,
    or the int8 / dense receiver) and unpacks: the same bits as
    :func:`delayed_mix`.  The work between the two overlaps the wire.
    Anywhere else the round runs at ``wait()``."""
    return _delayed(template, bufs, realization, compression, mesh,
                    axis_name, split=True)


def _delayed(template, bufs, r, compression, mesh, axis_name: str,
             split: bool):
    native = _shard_native(mesh, axis_name, template)
    split = split and native
    layout = flatbuf.layout_of(template, pad_multiple=1 if native else
                               flatbuf.PAD_MULTIPLE)
    bufs = list(bufs)
    if isinstance(r, Identity):
        return Pending(lambda: flatbuf.unpack(layout, bufs))
    static = isinstance(r, (Shifts, Matching)) and not r.traced
    if static and (native or mesh is None):
        n = _node_count(template, mesh, axis_name)
        wire, rows = _ROWS, slice(None)
        if native:
            i = mesh.axis_index(axis_name)
            wire, rows = mesh, slice(i, i + 1)
        kw = (dict(shifts=list(r.shifts), self_w=r.self_w)
              if isinstance(r, Shifts) else
              dict(partner=tuple(r.partner), self_w=r.w_self))
        finish = _static_start(
            layout, bufs, wire, n, compression=compression, rows=rows,
            axis_name=axis_name, reduce=_scale_reduce(mesh, axis_name),
            split=split, **kw)
        return Pending(lambda: flatbuf.unpack(layout, finish()))
    if native and isinstance(r, Dense) and not isinstance(r.W, torch.Tensor):
        if compression is not None:
            raise ValueError(
                f"compression={compression!r} has no dense-matrix wire "
                f"format; only Shifts/Matching realizations quantize")
        finish = _local_dense(bufs, np.asarray(r.W, np.float64), mesh,
                              axis_name, split)
        return Pending(lambda: flatbuf.unpack(layout, finish()))
    return Pending(lambda: mix_realization(
        flatbuf.unpack(layout, bufs), r, compression=compression, mesh=mesh,
        axis_name=axis_name))


def node_mean(tree: Tree, *, mesh=None, axis_name: str = "node") -> Tree:
    """Every leaf's exact mean over the node axis in f32, broadcast back
    to its node rows (the all-reduce baseline's gradient average).  On a
    mesh with one rank per node each rank holds its block: the tree is
    packed (``pad_multiple=1``) and each dtype group's f32 buffer is one
    ``psum`` over the node axis, divided by the node count."""
    if mesh is None:
        return {k: v.float().mean(0, keepdim=True).expand(v.shape)
                for k, v in tree.items()}
    n, L = _mesh_nodes(tree, mesh, axis_name)
    if L != 1:
        raise ValueError(f"node_mean on a mesh takes one node a rank; the "
                         f"block holds {L}")
    layout = flatbuf.layout_of(tree, pad_multiple=1)
    layout, bufs = flatbuf.pack(tree, layout)
    return flatbuf.unpack(layout, [mesh.psum(b.float(), axis_name) / n
                                   for b in bufs])


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
