"""Carry weights and optimizer state between the JAX package and the port.

``params_from_jax(tree, cfg)`` takes the JAX params with every leaf
already a numpy array (``jax.tree.map(np.asarray, params)`` on the JAX
side) and returns a ``state_dict`` for :class:`repro_torch.models.model.Model`.
It unstacks the leading layer axis of ``tree["layers"]`` into the per-layer
modules (the moe family's (L, E, d, f) experts into (E, d, f) per layer;
the vlm family's doubly stacked (n_groups, n_self, ...) leaves into
``layers.{g * n_self + j}``, and its (n_groups, ...) ``cross_layers``
into ``cross_layers.{g}``, the (n_groups,) ``gate`` into 0-d gates);
every other leaf (``embed``, ``final_norm``, the hybrid family's
``shared_attn.*``, the audio family's (K, V, d) embed and (K, d, V)
heads) keeps its dotted name.  ``stacked_from_jax(tree, cfg)`` does the
same for a node-stacked tree (params or momentum: a leading node axis,
then the layer axis of the layer leaves), giving the train path's
``{name: (n, ...)}`` dict, and ``stacked_to_jax`` is its inverse view, in
numpy.  bf16 leaves
(``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects) cross as an
int16 view reinterpreted with ``.view(torch.bfloat16)``: the same bits.

``stacked_to_nested`` / ``stacked_from_nested`` are the same layout
change on torch tensors, dtype and device kept, and
``train_state_to_jax`` / ``train_state_from_jax`` apply it to a train
state ``{"params", "momentum"}`` (one momentum slot, or d_adamw's
``{"mu", "nu"}``): the tree :mod:`repro_torch.checkpoint` writes, leaf
for leaf what the JAX driver writes.  ``opt_state_to_jax`` /
``opt_state_from_jax`` carry a whole ``OptState`` the same way: its
``count`` as an int32 scalar and, for a ``gossip(when=...)`` chain, its
``sched_pos`` as one more int32 scalar after it, where the reference's
``OptState`` flattens them.  ``gossip_buf_to_jax`` / ``gossip_buf_from_jax``
carry the overlap pipeline's in-flight buffer (a carry-buffer
checkpoint's ``gossip_buf``): the reference packs the nested, layer-stacked
payload in JAX's flatten order, padded to 8,192 columns, where the port
packs its per-layer tree padded to 8, so the buffer goes through the
unpacked trees.
Plain numpy <-> torch; nothing of JAX is imported.
"""
from __future__ import annotations

import numpy as np
import torch

from .checkpoint.ckpt import _flatten as _jax_items, _unflatten_like
from .core import flatbuf
from .core.transforms import OptState
from .models.model import ModelConfig, _check_family, _vlm_groups

__all__ = ["params_from_jax", "stacked_from_jax", "stacked_to_jax",
           "stacked_to_nested", "stacked_from_nested",
           "train_state_to_jax", "train_state_from_jax",
           "opt_state_to_jax", "opt_state_from_jax", "gossip_buf_to_jax",
           "gossip_buf_from_jax"]

# the reference pads each packed group to its Pallas tile, (8, 1024)
JAX_PAD_MULTIPLE = 8 * 1024


def _tensor(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def _stacks(cfg: ModelConfig) -> dict[str, tuple]:
    """The layer-stacked subtrees of ``cfg``'s JAX params and their stack
    axes: ``layers`` on (n_layers,), or for vlm (n_groups, n_self), and
    the vlm ``cross_layers`` on (n_groups,)."""
    _check_family(cfg)
    if cfg.family == "vlm":
        n_groups, n_self = _vlm_groups(cfg)
        return {"layers": (n_groups, n_self), "cross_layers": (n_groups,)}
    return {"layers": (cfg.n_layers,)}


def _unstack(out: dict, key: str, name: str, t: torch.Tensor,
             lead: tuple, at: int) -> None:
    """Put the layers of ``t``, stacked on ``lead`` from axis ``at`` (0,
    or 1 behind a node axis), into ``out`` as ``{key}.{i}.{name}``,
    numbered in row-major order of ``lead``."""
    if tuple(t.shape[at:at + len(lead)]) != lead:
        raise ValueError(f"{key}.{name}: shape {tuple(t.shape)} has no "
                         f"{lead} stack at axis {at}")
    flat = t.reshape(t.shape[:at] + (-1,) + t.shape[at + len(lead):])
    for i in range(flat.shape[at]):
        out[f"{key}.{i}.{name}"] = flat.select(at, i).clone()


def params_from_jax(tree: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX params (numpy leaves) of any family -> ``Model`` state_dict
    (``layers.attn.wq`` stacked on L -> ``layers.{i}.attn.wq``;
    ``layers.mixer.in_proj`` -> ``layers.{i}.mixer.in_proj``; the moe
    experts ``layers.moe.w_gate`` (L, E, d, f) -> ``layers.{i}.moe.w_gate``
    (E, d, f); vlm ``layers.attn.wq`` (n_groups, n_self, ...) ->
    ``layers.{g * n_self + j}.attn.wq`` and ``cross_layers.xattn.gate``
    (n_groups,) -> ``cross_layers.{g}.xattn.gate`` ()), each leaf in its
    own dtype (the moe router stays f32 under bf16 expert weights)."""
    stacks = _stacks(cfg)
    sd: dict[str, torch.Tensor] = {}
    for name, leaf in _flatten({k: v for k, v in tree.items()
                                if k not in stacks}):
        sd[name] = _tensor(leaf)
    for key, lead in stacks.items():
        for name, leaf in _flatten(tree[key]):
            _unstack(sd, key, name, _tensor(leaf), lead, 0)
    return sd


def stacked_from_jax(tree: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """Node-stacked JAX tree (numpy leaves: ``(n, ...)``, and ``(n, L,
    ...)`` under ``layers``) -> ``{name: (n, ...) tensor}`` named as
    ``Model``'s parameters."""
    return stacked_from_nested(_map(_tensor, tree), cfg)


def stacked_to_jax(stacked: dict[str, torch.Tensor],
                   cfg: ModelConfig) -> dict:
    """Inverse view of :func:`stacked_from_jax`: the JAX nested layout
    with the layer leaves restacked on axis 1, as numpy arrays (bf16
    widened to float32)."""
    def np_(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return _map(np_, stacked_to_nested(stacked, cfg))


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def stacked_from_nested(tree: dict, cfg: ModelConfig
                        ) -> dict[str, torch.Tensor]:
    """Node-stacked tree in the JAX layout, torch leaves (``(n, L, ...)``
    under ``layers``; vlm ``(n, n_groups, n_self, ...)`` there and ``(n,
    n_groups, ...)`` under ``cross_layers``) -> ``{name: (n, ...) tensor}``
    named as ``Model``'s parameters; dtype and device kept."""
    stacks = _stacks(cfg)
    out = dict(_flatten({k: v for k, v in tree.items() if k not in stacks}))
    for key, lead in stacks.items():
        for name, t in _flatten(tree[key]):
            _unstack(out, key, name, t, lead, 1)
    return out


def stacked_to_nested(stacked: dict[str, torch.Tensor],
                      cfg: ModelConfig) -> dict:
    """Inverse of :func:`stacked_from_nested`: the JAX nested layout, the
    layer leaves stacked on axis 1 (``(n, L, ...)``; vlm ``(n, n_groups,
    n_self, ...)`` and ``(n, n_groups, ...)``), dtype and device kept."""
    stacks = _stacks(cfg)
    tree: dict = {}

    def put(path, val):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = val

    layer_leaves: dict = {}
    for name, t in stacked.items():
        parts = name.split(".")
        if parts[0] in stacks:
            layer_leaves.setdefault((parts[0], ".".join(parts[2:])), {})[
                int(parts[1])] = t.detach()
        else:
            put(parts, t.detach())
    for (key, name), per_layer in layer_leaves.items():
        lead = stacks[key]
        t = torch.stack([per_layer[i] for i in range(len(per_layer))], 1)
        put([key] + name.split("."),
            t.reshape(t.shape[:1] + lead + t.shape[2:]))
    return tree


def train_state_to_jax(params: dict, momentum: dict,
                       cfg: ModelConfig) -> dict:
    """``{"params", "momentum"}`` in the JAX driver's checkpoint layout.
    ``momentum`` is one slot's tree (``{name: tensor}``) or a dict of
    slots (``{"mu": tree, "nu": tree}``)."""
    return {"params": stacked_to_nested(params, cfg),
            "momentum": _momentum_to_jax(momentum, cfg)}


def train_state_from_jax(tree: dict, cfg: ModelConfig) -> tuple[dict, dict]:
    """Inverse of :func:`train_state_to_jax` -> ``(params, momentum)``.
    A one-slot momentum is a params-like tree (it has ``"layers"``); else
    each of its keys is a slot."""
    return (stacked_from_nested(tree["params"], cfg),
            _momentum_from_jax(tree["momentum"], cfg))


def _momentum_to_jax(momentum: dict, cfg):
    if cfg is None:
        return momentum
    if all(isinstance(v, dict) for v in momentum.values()):
        return {s: stacked_to_nested(t, cfg) for s, t in momentum.items()}
    return stacked_to_nested(momentum, cfg)


def _momentum_from_jax(mom: dict, cfg):
    if cfg is None:
        return mom
    if "layers" in mom:
        return stacked_from_nested(mom, cfg)
    return {s: stacked_from_nested(t, cfg) for s, t in mom.items()}


def opt_state_to_jax(state, cfg: ModelConfig | None = None):
    """The port's ``OptState`` as the reference's flattens: the momentum
    (in the JAX layout when ``cfg`` is given; a plain tree as it is), the
    step count as an int32 0-d tensor, no in-flight buffer, and the
    schedule position (None, or an int32 0-d tensor)."""
    sched = (None if state.sched_pos is None
             else torch.as_tensor(state.sched_pos, dtype=torch.int32))
    return OptState(_momentum_to_jax(state.momentum, cfg),
                    torch.tensor(int(state.count), dtype=torch.int32),
                    None, sched)


def opt_state_from_jax(tree, cfg: ModelConfig | None = None):
    """Inverse of :func:`opt_state_to_jax`: the count back to a Python int
    and the schedule position to a host int32 tensor."""
    sched = (None if tree.sched_pos is None
             else torch.as_tensor(tree.sched_pos).to("cpu", torch.int32))
    return OptState(_momentum_from_jax(tree.momentum, cfg),
                    int(tree.count), None, sched)


def _jax_leaves(tree) -> list:
    """Leaves in JAX's flatten order (dict keys sorted), as checkpoints
    write them."""
    return [leaf for _, leaf in _jax_items(tree)]


def _payload_parts(tree) -> tuple:
    return tree if isinstance(tree, tuple) else (tree,)


def _nested(part: dict, cfg):
    return part if cfg is None else stacked_to_nested(part, cfg)


def _jax_groups(leaves) -> dict:
    """Leaf positions by dtype, groups in order of first appearance (the
    reference's packing)."""
    groups: dict = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(leaf.dtype, []).append(i)
    return groups


def gossip_buf_to_jax(buf, template, cfg: ModelConfig | None,
                      pad_multiple: int = flatbuf.PAD_MULTIPLE) -> tuple:
    """The port's in-flight buffer (one ``(n, B)`` tensor per dtype group,
    packed against ``template``: ``opt.payload_template(params, state)``,
    at ``pad_multiple``) -> the reference's: the payload unpacked, its
    layer leaves restacked (``stacked_to_nested``; ``cfg=None`` for a tree
    without layers), packed in JAX's flatten order and zero-padded to a
    multiple of 8,192 columns.  A row of the result depends only on its
    node's row, so a mesh rank converts its own block (packed at
    ``pad_multiple=1``) and the blocks' rows stacked are the whole run's
    buffer."""
    payload = flatbuf.unpack(flatbuf.layout_of(template, pad_multiple),
                             list(buf))
    nested = tuple(_nested(p, cfg) for p in _payload_parts(payload))
    leaves = _jax_leaves(nested)
    n = leaves[0].shape[0]
    out = []
    for idxs in _jax_groups(leaves).values():
        strips = [leaves[i].reshape(n, -1) for i in idxs]
        width = sum(s.shape[1] for s in strips)
        pad = -width % JAX_PAD_MULTIPLE
        if pad:
            strips.append(strips[0].new_zeros((n, pad)))
        out.append(torch.cat(strips, 1))
    return tuple(out)


def gossip_buf_from_jax(jbuf, template, cfg: ModelConfig | None) -> tuple:
    """Inverse of :func:`gossip_buf_to_jax`: the reference's packed
    buffers (tensors) -> the port's, packed against ``template``."""
    parts = _payload_parts(template)
    like = tuple(_nested(p, cfg) for p in parts)
    shapes = _jax_leaves(like)
    leaves = [None] * len(shapes)
    for idxs, b in zip(_jax_groups(shapes).values(), jbuf):
        off = 0
        for i in idxs:
            size = int(np.prod(shapes[i].shape[1:], dtype=np.int64))
            leaves[i] = b[:, off:off + size].reshape(shapes[i].shape)
            off += size
    nested = _unflatten_like(like, iter(leaves))
    flat = []
    for p, tpl in zip(nested, parts):
        got = p if cfg is None else stacked_from_nested(p, cfg)
        flat.append({k: got[k] for k in tpl})
    payload = tuple(flat) if isinstance(template, tuple) else flat[0]
    return tuple(flatbuf.pack(payload, flatbuf.layout_of(template))[1])
