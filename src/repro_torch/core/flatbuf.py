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
``padded`` does not.  Leaf order is the tree's order (dict insertion
order), so a port buffer is a column permutation of the JAX one.

The layout depends only on the tree's structure, dtypes and shapes and is
kept in an LRU-bounded cache.  :func:`unpack` returns views into the
buffer (no copy).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .cache import CompileCache

Tree = Any

__all__ = ["FlatLayout", "GroupLayout", "LeafSlot", "layout_of", "pack",
           "unpack", "tree_flatten", "tree_unflatten", "wire_bytes_split",
           "wire_bytes_per_round", "PAD_MULTIPLE"]

# 8 elements = 16 bytes of bf16 (32 of f32): every row of a group buffer
# starts on a 16-byte boundary, as the kernel's vector loads want
PAD_MULTIPLE = 8


def tree_flatten(tree: Tree) -> tuple[list, tuple | None]:
    """Leaves of a dict/tuple/list tree in order, and a hashable treedef."""
    leaves: list = []

    def go(t):
        if isinstance(t, dict):
            return ("dict", tuple(t), tuple(go(v) for v in t.values()))
        if isinstance(t, (tuple, list)):
            return (type(t).__name__, len(t), tuple(go(v) for v in t))
        leaves.append(t)
        return None

    return leaves, go(tree)


def tree_unflatten(treedef: tuple | None, leaves) -> Tree:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, _, children = d
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], children)}
        vals = [build(c) for c in children]
        return tuple(vals) if kind == "tuple" else vals

    return build(treedef)


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One leaf's strip inside its dtype group's flat buffer."""

    leaf_index: int        # position in tree_flatten order
    offset: int            # start column in the (n, B) group buffer
    size: int              # number of elements per node (prod(shape[1:]))
    shape: tuple           # full leaf shape, including the node axis


@dataclasses.dataclass(frozen=True, eq=False)
class GroupLayout:
    dtype: torch.dtype     # dtype of every leaf in the group
    slots: tuple           # tuple[LeafSlot, ...] in leaf order
    size: int              # used columns (sum of slot sizes)
    padded: int            # allocated columns (size rounded up)
    # (padded,) int32: element -> slot position within this group; padding
    # elements map to len(slots) (the per-leaf int8 scales of slice C)
    seg_ids: np.ndarray


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

        groups = []
        for dt, idxs in by_dtype.items():
            slots, off = [], 0
            for i in idxs:
                size = int(np.prod(leaves[i].shape[1:], dtype=np.int64))
                slots.append(LeafSlot(i, off, size, tuple(leaves[i].shape)))
                off += size
            padded = _pad_up(off, pad_multiple)
            seg = np.full((padded,), len(slots), np.int32)
            for pos, s in enumerate(slots):
                seg[s.offset:s.offset + s.size] = pos
            groups.append(GroupLayout(dt, tuple(slots), off, padded, seg))

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
    """Per-round wire bytes one node sends: ``{"payload", "scales"}``
    (``scales`` is the int8 scale rows of slice C, 0 here)."""
    if compression is not None:
        raise NotImplementedError(
            f"compression={compression!r} waits for ROADMAP slice C of the "
            "PyTorch port")
    payload = sum(g.padded * g.dtype.itemsize for g in layout.groups)
    return {"payload": payload, "scales": 0}


def wire_bytes_per_round(layout: FlatLayout,
                         compression: str | None = None) -> int:
    """Total bytes one node sends per gossip round (payload + scales)."""
    split = wire_bytes_split(layout, compression)
    return split["payload"] + split["scales"]
