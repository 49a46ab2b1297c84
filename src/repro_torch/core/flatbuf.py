"""Flat-buffer packing: one contiguous (n, B) gossip payload per dtype.

The port of the JAX package's ``core/flatbuf.py`` (global granularity).
The gossip state is a tree -- a ``dict[str, Tensor]`` of node-stacked
leaves, or a tuple/list of such dicts (DmSGD's ``(m_next, x_next)``
payload) -- whose leaves all carry a leading node axis of size ``n``.
:func:`pack` lays every leaf of one dtype side by side in ONE ``(n, B)``
buffer, so the gossip engine rolls each dtype group once per shift and
feeds the ``gossip_mix`` kernel one flat buffer, whatever the leaf count.

Padding follows the port's kernel, not the TPU's (8, 1024) tile: each
group's width is rounded up to :data:`PAD_MULTIPLE` = 8 elements, which
keeps every node's row 16-byte aligned for the kernel's vector loads.  So
``GroupLayout.size`` (the used columns) equals the JAX package's, while
``padded`` does not.  Leaves keep the tree's order (dict insertion
order) but for the grouping below, so a port buffer is a column
permutation of the JAX one.

Each slot belongs to a *scale group*, the unit of the int8 wire format's
scales (one f32 scale per node and group).  The JAX package scales per
JAX leaf, and its layer leaves are stacked on a layer axis, so the port's
per-layer leaves of one JAX leaf share one group: a dict key
``layers.<i>.<rest>`` is grouped as ``layers.<rest>`` (the tree position
kept, so DmSGD's ``m`` and ``x`` halves stay apart).  Every other leaf is
a group of its own.  The slots of one scale group are adjacent in the
buffer (groups in order of first appearance, leaves in tree order within
a group: all layers of ``wq`` side by side, as the JAX package packs its
stacked leaf), so each int8 pass runs once per group over one column
range (``GroupLayout.scale_ranges``).

The layout depends only on the tree's structure, dtypes and shapes and is
kept in an LRU-bounded cache.  :func:`unpack` returns views into the
buffer (no copy).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np
import torch

from .cache import CompileCache

Tree = Any

__all__ = ["FlatLayout", "GroupLayout", "LeafSlot", "layout_of", "pack",
           "unpack", "tree_flatten", "tree_unflatten", "wire_bytes_split",
           "wire_bytes_per_round", "scale_group_key", "PAD_MULTIPLE"]

# 8 elements = 16 bytes of bf16 (32 of f32): every row of a group buffer
# starts on a 16-byte boundary, as the kernel's vector loads want
PAD_MULTIPLE = 8


def _treedef(t, leaves: list):
    if isinstance(t, dict):
        return ("dict", tuple(t), tuple(_treedef(v, leaves)
                                        for v in t.values()))
    if isinstance(t, (tuple, list)):
        return (type(t).__name__, len(t), tuple(_treedef(v, leaves)
                                                for v in t))
    leaves.append(t)
    return None


def tree_flatten(tree: Tree) -> tuple[list, tuple | None]:
    """Leaves of a dict/tuple/list tree in order, and a hashable treedef.
    (Module-level recursion: a recursive closure would hold the leaves in
    a reference cycle, alive until the garbage collector runs.)"""
    leaves: list = []
    return leaves, _treedef(tree, leaves)


def _build(d, it):
    if d is None:
        return next(it)
    kind, _, children = d
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(d[1], children)}
    vals = [_build(c, it) for c in children]
    return tuple(vals) if kind == "tuple" else vals


def tree_unflatten(treedef: tuple | None, leaves) -> Tree:
    """Inverse of :func:`tree_flatten`."""
    return _build(treedef, iter(leaves))


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One leaf's strip inside its dtype group's flat buffer."""

    leaf_index: int        # position in tree_flatten order
    offset: int            # start column in the (n, B) group buffer
    size: int              # number of elements per node (prod(shape[1:]))
    shape: tuple           # full leaf shape, including the node axis
    scale_group: int = 0   # int8 scale column within the dtype group


@dataclasses.dataclass(frozen=True, eq=False)
class GroupLayout:
    dtype: torch.dtype     # dtype of every leaf in the group
    slots: tuple           # tuple[LeafSlot, ...] in buffer order
    size: int              # used columns (sum of slot sizes)
    padded: int            # allocated columns (size rounded up)
    # the scale groups' keys (scale_group_key), in column order; the int8
    # scale rows carry one more column, 1.0, for the padding
    scale_groups: tuple
    # (start, stop) columns of each scale group's adjacent slots
    scale_ranges: tuple


@dataclasses.dataclass(frozen=True, eq=False)
class FlatLayout:
    treedef: Any
    n: int                 # node-axis size shared by every leaf
    groups: tuple          # tuple[GroupLayout, ...]
    n_leaves: int

    def group_for(self, dtype) -> GroupLayout:
        for g in self.groups:
            if g.dtype == dtype:
                return g
        raise KeyError(f"no group with dtype {dtype}")


# LRU-bounded: one entry per (tree structure, shapes, pad granularity)
_LAYOUT_CACHE = CompileCache(max_entries=256)


def _pad_up(size: int, multiple: int) -> int:
    return max(-(-size // multiple) * multiple, multiple)


_LAYER = re.compile(r"((?:cross_)?layers)\.\d+\.(.+)")


def _leaf_paths(tree: Tree, path: tuple = ()):
    """Each leaf's path (dict keys, sequence positions), in
    :func:`tree_flatten` order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, path + (i,))
    else:
        yield path


def scale_group_key(path: tuple) -> tuple:
    """The scale group of the leaf at ``path``: a last key
    ``layers.<i>.<rest>`` becomes ``layers.<rest>`` (the JAX leaf that
    stacks the layers -- for vlm both of its stack axes, as the port
    numbers its self layers flat) and ``cross_layers.<g>.<rest>``
    becomes ``cross_layers.<rest>``; anything else is kept."""
    if path and isinstance(path[-1], str):
        m = _LAYER.fullmatch(path[-1])
        if m:
            return path[:-1] + (f"{m.group(1)}.{m.group(2)}",)
    return path


def layout_of(tree: Tree, pad_multiple: int = PAD_MULTIPLE) -> FlatLayout:
    """Compute (or fetch) the packing layout for ``tree``'s structure."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("cannot pack an empty tree")
    n = leaves[0].shape[0] if leaves[0].ndim else None
    for leaf in leaves:
        if leaf.ndim == 0 or leaf.shape[0] != n:
            raise ValueError(
                "every gossip leaf needs the same leading node axis; got "
                f"shapes {[tuple(x.shape) for x in leaves]}")
    key = (treedef, tuple((str(x.dtype), tuple(x.shape)) for x in leaves),
           int(pad_multiple))

    def build() -> FlatLayout:
        by_dtype: dict = {}
        for i, leaf in enumerate(leaves):
            by_dtype.setdefault(leaf.dtype, []).append(i)
        keys = [scale_group_key(p) for p in _leaf_paths(tree)]

        groups = []
        for dt, idxs in by_dtype.items():
            members: dict = {}
            for i in idxs:
                members.setdefault(keys[i], []).append(i)
            slots, ranges, off = [], [], 0
            for j, group in enumerate(members.values()):
                start = off
                for i in group:
                    size = int(np.prod(leaves[i].shape[1:], dtype=np.int64))
                    slots.append(LeafSlot(i, off, size,
                                          tuple(leaves[i].shape), j))
                    off += size
                ranges.append((start, off))
            groups.append(GroupLayout(dt, tuple(slots), off,
                                      _pad_up(off, pad_multiple),
                                      tuple(members), tuple(ranges)))

        return FlatLayout(treedef, int(n), tuple(groups), len(leaves))

    return _LAYOUT_CACHE.get(key, build)


def pack(tree: Tree, layout: FlatLayout | None = None):
    """tree -> (layout, [(n, padded) buffer per dtype group]).  Each buffer
    is one new contiguous tensor (one ``torch.cat`` per group)."""
    if layout is None:
        layout = layout_of(tree)
    leaves, _ = tree_flatten(tree)
    n = layout.n
    bufs = []
    for g in layout.groups:
        strips = [leaves[s.leaf_index].reshape(n, -1) for s in g.slots]
        if g.padded != g.size:
            strips.append(strips[0].new_zeros((n, g.padded - g.size)))
        bufs.append(torch.cat(strips, 1))
    return layout, bufs


def unpack(layout: FlatLayout, bufs) -> Tree:
    """Inverse of :func:`pack` (padding is discarded).  The leaves are
    views into ``bufs``."""
    leaves = [None] * layout.n_leaves
    for g, buf in zip(layout.groups, bufs):
        for s in g.slots:
            leaves[s.leaf_index] = (
                buf[:, s.offset:s.offset + s.size].reshape(s.shape))
    return tree_unflatten(layout.treedef, leaves)


def wire_bytes_split(layout: FlatLayout,
                     compression: str | None = None) -> dict:
    """Per-round wire bytes one node sends: ``{"payload", "scales"}``.
    Under int8 the payload is 1 byte per element and each dtype group
    sends one f32 scale per scale group plus the padding's (``scales`` is
    0 uncompressed), the JAX package's count of its per-leaf scales."""
    payload = scales = 0
    for g in layout.groups:
        if compression == "int8":
            payload += g.padded
            scales += 4 * (len(g.scale_groups) + 1)
        else:
            payload += g.padded * g.dtype.itemsize
    return {"payload": payload, "scales": scales}


def wire_bytes_per_round(layout: FlatLayout,
                         compression: str | None = None) -> int:
    """Total bytes one node sends per gossip round (payload + scales)."""
    split = wire_bytes_split(layout, compression)
    return split["payload"] + split["scales"]
