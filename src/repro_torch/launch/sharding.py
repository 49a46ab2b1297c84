"""Sharding rules mapping parameter and cache trees onto the logical mesh
("node", "fsdp", "model"): the port of the JAX package's
``launch/sharding.py``.

A spec is a tuple with one entry per dim: an axis name, a tuple of axis
names, or None (replicated).  The rules are the reference's, rule for
rule: Megatron-style tensor-parallel placements per parameter name with
divisibility guards, the expert-stacked branch, the generic fallback and,
for node-stacked training leaves, the ZeRO-style fsdp placement of
leaves that would otherwise replicate.  Training trees carry a leading
``node`` axis; serving trees do not.

The port's trees hold one leaf per layer (``layers.{i}.attn.wq``), where
the reference stacks the layers on an axis (``layers.attn.wq`` (n, L, d,
h)).  So each port leaf's spec is its JAX leaf's -- the JAX shape
rebuilt with the stack axes :mod:`repro_torch.convert` knows (``(L,)``,
or for vlm ``(n_groups, n_self)`` and ``(n_groups,)``) -- with the stack
axes dropped.  The rules read the JAX leaf's whole shape: its size, and
which dims divide the mesh.  Where the reference shards a stack axis
itself, the port's per-layer leaf has no such axis and is replicated over
that mesh axis, keeping the reference's placement of its other dims.
That happens in the expert-stacked branch, which takes every ``w_gate``
/ ``w_up`` / ``w_down`` with three or more dims past the node axis --
the dense MLP's (n, L, d, f) too, with E = L -- and shards E over
``model`` when it divides the model extent: a dense layer's ``w_gate``
is then ("node", fsdp-or-None, None) in the port, replicated over
``model``.  Without ``cfg`` the stack is read off the tree (``layers``
indices 0 .. L-1 give (L,)); the vlm family's doubly stacked layers need
``cfg``.

In eager PyTorch a rank holds its block of each leaf, so
:func:`local_shard` (a rank's block, as views) and :func:`gather` (the
blocks back into the whole leaf, over the mesh) take the place of
``named``.  The gossip's numbers do not depend on the specs: they decide
only which bytes each rank holds and moves.

fsdp-sharded training (a mesh whose fsdp extent is above 1) needs what
GSPMD inserts around the reference's jitted step: :func:`fsdp_gather`
turns a rank's fsdp shards of its node's leaves into the node's whole
leaves for the gradient pass, and :func:`fsdp_reduce_scatter_mean` turns
the rank's whole-leaf gradients into its shard of their mean over the
node's fsdp ranks.  Both pack the leaves of one dtype side by side
(:mod:`repro_torch.core.flatbuf`'s layout at ``pad_multiple=1``), so a
step makes one ``all_gather`` and one ``reduce_scatter`` a dtype group;
a leaf replicated over fsdp (``embed`` on a mesh without a ``model``
axis, the moe ``router``) is not gathered, and its gradient mean is one
``psum`` a dtype group.  Their specs are :func:`node_param_specs`: the
rules read at the GLOBAL node-stacked shapes, never at a shard's.  Both
act on the fsdp dim alone: on a mesh whose model extent is above 1 a
rank's leaves stay its model shards (the tensor-parallel pass,
:mod:`repro_torch.launch.tp`, runs on them), and :func:`gather_axis`
over ``model`` makes them whole where a checkpoint needs the node's
whole leaves.
"""
from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

from ..core import flatbuf
from .mesh import Mesh

Tree = Any

__all__ = ["param_specs", "batch_spec", "input_spec", "batch_block",
           "cache_specs", "axis_size",
           "gossip_payload_spec_fn", "local_shard", "gather", "map_specs",
           "node_param_specs", "axis_dim", "fsdp_dim", "inner_only",
           "gather_axis", "fsdp_gather", "fsdp_reduce_scatter_mean"]


def axis_size(mesh: Mesh, name: str) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape))[name]


def _fits(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


# Trailing-dims rules per leaf name: preferred axes per dim, tried with
# divisibility checks
_TRAILING_RULES: dict[str, tuple] = {
    # attention
    "wq": ("fsdp", "model"),
    "wk": ("fsdp", "model"),
    "wv": ("fsdp", "model"),
    "wo": ("model", "fsdp"),
    # mlp
    "w_gate": ("fsdp", "model"),
    "w_up": ("fsdp", "model"),
    "w_down": ("model", "fsdp"),
    # mamba2
    "in_proj": ("fsdp", "model"),
    "out_proj": ("model", "fsdp"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
}

_MOE_LEAVES = {"w_gate", "w_up", "w_down"}


def _spec_for_shape(name: str, shape: tuple, mesh: Mesh, *,
                    node_axis: bool) -> tuple:
    """The reference's ``_spec_for_leaf`` on a leaf's (JAX) shape."""
    ndim = len(shape)
    size = int(np.prod(shape, dtype=np.int64))
    # axes the mesh lacks count as size 0: _fits never matches them
    have = dict(zip(mesh.axis_names, mesh.devices.shape))
    sizes = {a: have.get(a, 0) for a in ("fsdp", "model")}
    lead = 1 if node_axis else 0

    def guard(dim_len, ax):
        return ax if (ax in sizes and _fits(dim_len, sizes[ax])) else None

    def with_lead(trailing):
        n_stack = ndim - lead - len(trailing)
        assert n_stack >= 0, (shape, trailing)
        return (("node",) if lead else ()) + (None,) * n_stack \
            + tuple(trailing)

    rank = ndim - lead
    if name == "embed":
        # (V, d), or (K, V, d) for audio
        if rank == 2:
            spec = (guard(shape[-2], "model"), guard(shape[-1], "fsdp"))
            if spec[0] is None:
                spec = (None, guard(shape[-1], "model"))
        else:
            spec = (None, guard(shape[-2], "model"), guard(shape[-1], "fsdp"))
            if spec[1] is None:
                spec = (None, None, guard(shape[-1], "model"))
        return with_lead(spec)
    if name == "lm_head":
        if rank == 2:
            spec = (guard(shape[-2], "fsdp"), guard(shape[-1], "model"))
            if spec[1] is None:
                spec = (guard(shape[-2], "model"), None)
        else:
            spec = (None, guard(shape[-2], "fsdp"), guard(shape[-1], "model"))
            if spec[2] is None:
                spec = (None, guard(shape[-2], "model"), None)
        return with_lead(spec)
    if name in _MOE_LEAVES and rank >= 3:
        # expert-stacked (..., E, a, b): expert-parallel over model when E
        # divides, else tensor-parallel on the ff dim
        E, a, b = shape[-3], shape[-2], shape[-1]
        if _fits(E, sizes["model"]):
            spec = ("model", guard(a, "fsdp"), None)
        elif name == "w_down":
            spec = (None, guard(a, "model"), guard(b, "fsdp"))
        else:
            spec = (None, guard(a, "fsdp"), guard(b, "model"))
        return with_lead(spec)
    if name == "router":
        return with_lead((None, None))

    rule = _TRAILING_RULES.get(name)
    if rule is not None and rank >= len(rule):
        return with_lead(tuple(
            guard(shape[-len(rule) + i], ax) if ax else None
            for i, ax in enumerate(rule)))

    # generic fallback: shard the biggest divisible dims
    if rank >= 2 and size >= 1 << 16:
        dims = list(range(ndim - rank, ndim))
        order = sorted(dims, key=lambda i: -shape[i])
        spec = [None] * rank
        used = []
        for ax in ("model", "fsdp"):
            for i in order:
                si = i - (ndim - rank)
                if spec[si] is None and _fits(shape[i], sizes[ax]) \
                        and si not in used:
                    spec[si] = ax
                    used.append(si)
                    break
        return with_lead(tuple(spec))
    if node_axis and rank >= 1:
        # node-stacked leaves that would replicate (norm scales, biases)
        # shard their largest divisible dim over fsdp (ZeRO-style)
        dims = list(range(ndim - rank, ndim))
        for i in sorted(dims, key=lambda i: -shape[i]):
            if shape[i] > 1 and _fits(shape[i], sizes["fsdp"]):
                spec = [None] * rank
                spec[i - (ndim - rank)] = "fsdp"
                return with_lead(tuple(spec))
    return with_lead((None,) * rank)


_LAYER = re.compile(r"((?:cross_)?layers)\.(\d+)\.(.+)")


def _stacks_of(names, cfg) -> dict:
    """Stack axes per stacked key: ``cfg``'s (``convert``'s), else
    ``layers`` -> (number of layers in the tree,)."""
    if cfg is not None:
        from ..convert import _stacks
        return _stacks(cfg)
    found: dict = {}
    for name in names:
        m = _LAYER.fullmatch(name)
        if m:
            found.setdefault(m.group(1), set()).add(int(m.group(2)))
    if "cross_layers" in found:
        raise ValueError("a vlm tree (cross_layers) is doubly stacked: "
                         "pass cfg= to read its stack axes")
    return {k: (len(v),) for k, v in found.items()}


def _leaf_spec(name: str, shape: tuple, stacks: dict, mesh: Mesh, *,
               node_axis: bool) -> tuple:
    """A port leaf's spec: its JAX leaf's with the stack axes dropped."""
    lead = 1 if node_axis else 0
    m = _LAYER.fullmatch(name)
    if m is None:
        return _spec_for_shape(name.split(".")[-1], tuple(shape), mesh,
                               node_axis=node_axis)
    stack = tuple(stacks[m.group(1)])
    jshape = tuple(shape[:lead]) + stack + tuple(shape[lead:])
    spec = _spec_for_shape(m.group(3).split(".")[-1], jshape, mesh,
                           node_axis=node_axis)
    return spec[:lead] + spec[lead + len(stack):]


def map_specs(fn, tree: Tree, specs: Tree) -> Tree:
    """``fn(leaf, spec)`` over a dict/tuple/list tree and its spec tree
    (a spec is a tuple of axis names or None, so spec trees stop at
    tuples of those)."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, torch.Size):
        vals = [map_specs(fn, v, s) for v, s in zip(tree, specs)]
        if hasattr(tree, "_fields"):          # a NamedTuple of leaves
            return type(tree)(*vals)
        return type(tree)(vals)
    return fn(tree, specs)


def _params_specs(tree: Tree, stacks: dict, mesh: Mesh, node_axis: bool,
                  fsdp_params: bool, prefix: str = "") -> Tree:
    if isinstance(tree, (tuple, list)):
        return type(tree)(_params_specs(t, stacks, mesh, node_axis,
                                        fsdp_params) for t in tree)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _params_specs(v, stacks, mesh, node_axis, fsdp_params,
                                   f"{prefix}{k}.")
            continue
        spec = _leaf_spec(prefix + k, tuple(v.shape), stacks, mesh,
                          node_axis=node_axis)
        if not fsdp_params:
            spec = tuple(None if s == "fsdp" else s for s in spec)
        out[k] = spec
    return out


def _names(tree: Tree, prefix: str = ""):
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _names(t)
        return
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _names(v, f"{prefix}{k}.")
        else:
            yield prefix + k


def param_specs(params: Tree, mesh: Mesh, *, cfg=None, node_axis: bool = True,
                fsdp_params: bool = True) -> Tree:
    """The spec tree of a port parameter tree (``{name: tensor}``, or a
    tuple/list of such: a gossip payload); only shapes are read.

    node_axis: training replicas carry a leading node axis.
    fsdp_params: if False, drop the fsdp axis (pure tensor parallel)."""
    stacks = _stacks_of(_names(params), cfg)
    return _params_specs(params, stacks, mesh, node_axis, fsdp_params)


def batch_spec(mesh: Mesh, *, node_axis: bool = True,
               batch_dim_size: int = 0) -> tuple:
    """Tokens / labels: (node, batch, ...) or (batch, ...) for serving."""
    fs = axis_size(mesh, "fsdp")
    nd = axis_size(mesh, "node")
    if node_axis:
        inner = "fsdp" if (batch_dim_size == 0 or _fits(batch_dim_size, fs)) \
            else None
        return ("node", inner)
    if batch_dim_size and _fits(batch_dim_size, nd * fs):
        return (("node", "fsdp"),)
    if batch_dim_size and _fits(batch_dim_size, nd):
        return ("node",)
    return (None,)


def input_spec(mesh: Mesh, t: torch.Tensor, *, node_axis: bool = True
               ) -> tuple:
    """The reference's placement of one step input: its batch dim (dim 1
    of a node-stacked input, else dim 0) by :func:`batch_spec`, the rest
    replicated; a 0-d input is replicated."""
    if t.ndim == 0:
        return ()
    inner = batch_spec(mesh, node_axis=node_axis,
                       batch_dim_size=t.shape[1 if node_axis else 0])
    return tuple(inner) + (None,) * (t.ndim - len(inner))


def batch_block(batch: dict, mesh: Mesh, *, node_axis: bool = True,
                coords: dict | None = None) -> dict:
    """A rank's block of each tensor input of ``batch`` (another rank's at
    ``coords``) by :func:`input_spec`: for serving (``node_axis=False``)
    its rows of the global batch -- over ``("node", "fsdp")`` where
    their extents divide it, else over ``node`` (replicated over fsdp),
    else every row -- replicated over ``model``.  Other values pass."""
    return {k: (local_shard(v, input_spec(mesh, v, node_axis=node_axis),
                            mesh, coords)
                if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


def cache_specs(cache: Tree, mesh: Mesh, batch: int) -> Tree:
    """Decode caches (``models.model.init_cache``'s, stacked as the
    reference's: (L, B, heads, T, hd), conv (L, B, w, C), state (L, B, H,
    P, N)): batch over ("node", "fsdp") when divisible, then the heads or
    state dim (or head_dim) over ``model``."""
    nd, fs, md = (axis_size(mesh, a) for a in ("node", "fsdp", "model"))

    def bspec():
        if _fits(batch, nd * fs):
            return ("node", "fsdp")
        if _fits(batch, nd):
            return "node"
        return None

    def one(leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        bdim = next((i for i, s in enumerate(shape) if s == batch and i > 0),
                    None)
        if bdim is not None:
            spec[bdim] = bspec()
        for i in [2] + list(range(len(shape) - 1, 2, -1)):
            if 0 <= i < len(shape) and i != bdim and spec[i] is None \
                    and _fits(shape[i], md) and shape[i] >= md:
                spec[i] = "model"
                break
        return tuple(spec)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            vals = [walk(v) for v in t]
            return type(t)(*vals) if hasattr(t, "_fields") else type(t)(vals)
        return one(t)

    return walk(cache)


def gossip_payload_spec_fn(mesh: Mesh, *, cfg=None,
                           fsdp_params: bool = True):
    """``payload -> spec tree`` with :func:`param_specs`' rules for a
    node-stacked gossip payload (a tree, or DmSGD's ``(m, x)`` tuple) at
    its GLOBAL shapes: the specs a train step's payload is sharded by, so
    each rank's block (:func:`local_shard`) is what the shard-native
    engine packs and permutes.  Axes the mesh lacks are never emitted."""
    if "node" not in mesh.axis_names:
        raise ValueError(
            f"gossip_payload_spec_fn needs a 'node' mesh axis; got "
            f"{mesh.axis_names}")

    def spec_fn(payload: Tree) -> Tree:
        return param_specs(payload, mesh, cfg=cfg, node_axis=True,
                           fsdp_params=fsdp_params)

    return spec_fn


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shard(tree: Tree, specs: Tree, mesh: Mesh,
                coords: dict | None = None) -> Tree:
    """This rank's block of every leaf (``coords``: another rank's, e.g.
    ``{"node": 1, "fsdp": 0}``): each dim cut evenly over its spec's
    axes, a tuple of axes row-major.  Views, no copy."""
    coords = mesh.coords if coords is None else coords
    sizes = mesh.shape

    def one(x, spec):
        for d, entry in enumerate(spec):
            axes = _axes(entry)
            if not axes:
                continue
            parts = int(np.prod([sizes[a] for a in axes]))
            idx = 0
            for a in axes:
                idx = idx * sizes[a] + coords[a]
            if x.shape[d] % parts:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"split {parts} ways ({entry})")
            step = x.shape[d] // parts
            x = x.narrow(d, idx * step, step)
        return x

    return map_specs(one, tree, specs)


def gather(tree: Tree, specs: Tree, mesh: Mesh) -> Tree:
    """Inverse of :func:`local_shard`: every rank's blocks concatenated
    back into the whole leaves, on every rank (one all-gather per sharded
    axis of each leaf)."""

    def one(x, spec):
        for d in reversed(range(len(spec))):
            for a in reversed(_axes(spec[d])):
                x = mesh.all_gather(x, a, dim=d)
        return x

    return map_specs(one, tree, specs)


# ---------------------------------------------------------------------------
# fsdp-sharded training: the gather and the scatter GSPMD inserts
# ---------------------------------------------------------------------------

def node_param_specs(cfg, n: int, mesh: Mesh) -> dict:
    """The spec tree of ``cfg``'s node-stacked training params at their
    GLOBAL shapes, ``(n,)`` + each parameter's (meta tensors: nothing is
    allocated), with ``cfg`` giving the stack axes: what a rank's fsdp
    shards are cut by and gathered by.  Read at a shard's shapes, the
    divisibility guards would decide otherwise."""
    from ..models import model as M
    shapes = {k: torch.empty((n,) + tuple(p.shape), dtype=p.dtype,
                             device="meta")
              for k, p in M.init(cfg, 0, device="meta").named_parameters()}
    return param_specs(shapes, mesh, cfg=cfg)


def axis_dim(spec: tuple, axis: str) -> int | None:
    """The dim a spec cuts over ``axis`` (None: replicated over it)."""
    for d, entry in enumerate(spec):
        if axis in _axes(entry):
            return d
    return None


def fsdp_dim(spec: tuple) -> int | None:
    """The dim a spec cuts over ``fsdp`` (None: replicated over it)."""
    return axis_dim(spec, "fsdp")


def inner_only(specs: dict) -> dict:
    """``specs`` with the ``node`` axis dropped: the rank's (fsdp, model)
    cut of its node row (:func:`local_shard` at the rank's fsdp and
    model coordinates)."""
    return {k: tuple(None if e == "node" else e for e in spec)
            for k, spec in specs.items()}


def _leaves_specs(tree: Tree, specs: Tree,
                  axis: str = "fsdp") -> tuple[list, list]:
    leaves, dims = [], []

    def take(x, spec):
        leaves.append(x)
        dims.append(axis_dim(spec, axis))
        return x

    map_specs(take, tree, specs)
    return leaves, dims


def _rebuild(tree: Tree, specs: Tree, leaves: list) -> Tree:
    it = iter(leaves)
    return map_specs(lambda x, spec: next(it), tree, specs)


def _by_dtype(idxs: list, leaves: list) -> dict:
    groups: dict = {}
    for i in idxs:
        groups.setdefault(leaves[i].dtype, []).append(i)
    return groups


def _blocks(x: torch.Tensor, d: int, parts: int) -> torch.Tensor:
    """A view of ``x`` with its dim ``d`` split into ``parts`` blocks,
    the block index moved to the front: ``(parts,) + block shape``."""
    shape = tuple(x.shape)
    split = shape[:d] + (parts, shape[d] // parts) + shape[d + 1:]
    return x.reshape(split).movedim(d, 0)


def fsdp_gather(tree: Tree, specs: Tree, mesh: Mesh,
                dst: int | None = None) -> Tree:
    """This rank's fsdp shards of its node's leaves -> the node's leaves
    whole over fsdp, on every rank of the node's fsdp line (a model cut
    stays): :func:`gather_axis` over ``fsdp``."""
    return gather_axis(tree, specs, mesh, "fsdp", dst)


def gather_axis(tree: Tree, specs: Tree, mesh: Mesh, axis: str,
                dst: int | None = None) -> Tree:
    """This rank's shards over ``axis`` of its node's leaves -> the leaves
    whole over ``axis``, on every rank of the node's ``axis`` line: the
    line's shards concatenated along each leaf's ``axis`` dim, in axis
    order.  The sharded leaves of one dtype are packed side by side
    (``flatbuf``'s layout at ``pad_multiple=1``) and gathered by ONE
    ``all_gather``; a leaf replicated over ``axis`` is returned as it
    is.  Each whole leaf is a new tensor (the gathered buffer is freed).
    ``dst``: gathered at the line's rank of ``axis`` coordinate ``dst``
    alone (one ``gather`` a dtype group; None at the others)."""
    parts = mesh.axis_size(axis)
    root = dst is None or mesh.axis_index(axis) == dst
    leaves, dims = _leaves_specs(tree, specs, axis)
    out = list(leaves)
    sharded = [i for i, d in enumerate(dims) if d is not None]
    for idxs in _by_dtype(sharded, leaves).values():
        group = [leaves[i] for i in idxs]
        layout = flatbuf.layout_of(group, pad_multiple=1)
        (buf,) = flatbuf.pack(group, layout)[1]
        rows = buf.shape[0]
        full = (mesh.all_gather(buf, axis, dim=0) if dst is None
                else mesh.gather(buf, axis, dst))
        del buf
        if not root:
            continue
        full = full.view(parts, rows, -1)
        for slot in layout.groups[0].slots:
            i = idxs[slot.leaf_index]
            shard = leaves[i].shape
            d = dims[i]
            whole = list(shard)
            whole[d] *= parts
            x = full.new_empty(whole)
            _blocks(x, d, parts).copy_(
                full[:, :, slot.offset:slot.offset + slot.size]
                .view((parts,) + tuple(shard)))
            out[i] = x
        del full
    return _rebuild(tree, specs, out) if root else None


def fsdp_reduce_scatter_mean(tree: Tree, specs: Tree, mesh: Mesh) -> Tree:
    """The rank's whole-leaf gradients -> its fsdp shard of their mean
    over its node's fsdp line (``specs`` as :func:`fsdp_gather`'s).  The
    sharded leaves of one dtype are packed, block by block, into one
    ``(F x rows, B)`` buffer -- block f holds fsdp rank f's shards at the
    layout :func:`fsdp_gather` packs -- and ONE ``reduce_scatter`` a
    dtype group sums it; a leaf replicated over fsdp keeps its whole
    shape, its mean one ``psum`` a dtype group.  Each sum is divided by
    F; the shards are views into the scattered buffer.  A model cut
    stays: each leaf is the rank's model shard, cut over fsdp within
    it."""
    parts = mesh.axis_size("fsdp")
    leaves, dims = _leaves_specs(tree, specs)
    out = list(leaves)
    sharded = [i for i, d in enumerate(dims) if d is not None]
    for idxs in _by_dtype(sharded, leaves).values():
        shards = []
        for i in idxs:
            shp = list(leaves[i].shape)
            shp[dims[i]] //= parts
            shards.append(torch.empty(shp, dtype=leaves[i].dtype,
                                      device="meta"))
        layout = flatbuf.layout_of(shards, pad_multiple=1)
        g = layout.groups[0]
        rows = shards[0].shape[0]
        buf = leaves[idxs[0]].new_empty((parts, rows, g.padded))
        for slot in g.slots:
            i = idxs[slot.leaf_index]
            buf[:, :, slot.offset:slot.offset + slot.size].view(
                (parts,) + tuple(shards[slot.leaf_index].shape)).copy_(
                    _blocks(leaves[i], dims[i], parts))
        mine = mesh.reduce_scatter(buf.view(parts * rows, g.padded), "fsdp")
        del buf
        mine = mine.div_(parts)
        for i, got in zip(idxs, flatbuf.tree_flatten(
                flatbuf.unpack(layout, [mine]))[0]):
            out[i] = got
    replicated = [i for i, d in enumerate(dims) if d is None]
    for idxs in _by_dtype(replicated, leaves).values():
        group = [leaves[i] for i in idxs]
        layout = flatbuf.layout_of(group, pad_multiple=1)
        (buf,) = flatbuf.pack(group, layout)[1]
        total = mesh.psum(buf, "fsdp").div_(parts)
        for i, got in zip(idxs, flatbuf.tree_flatten(
                flatbuf.unpack(layout, [total]))[0]):
            out[i] = got
    return _rebuild(tree, specs, out)
