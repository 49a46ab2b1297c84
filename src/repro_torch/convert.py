"""Carry weights and optimizer state between the JAX package and the port.

``params_from_jax(tree, cfg)`` takes the JAX params with every leaf
already a numpy array (``jax.tree.map(np.asarray, params)`` on the JAX
side) and returns a ``state_dict`` for :class:`repro_torch.models.model.Model`.
It unstacks the leading layer axis of ``tree["layers"]`` into the per-layer
modules; every other leaf (``embed``, ``final_norm``, the hybrid family's
``shared_attn.*``) keeps its dotted name.  ``stacked_from_jax(tree, cfg)`` does the same for a node-stacked
tree (params or momentum: a leading node axis, then the layer axis of the
layer leaves), giving the train path's ``{name: (n, ...)}`` dict, and
``stacked_to_jax`` is its inverse view, in numpy.  bf16 leaves
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
``OptState`` flattens them.
Plain numpy <-> torch; nothing of JAX is imported.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.transforms import OptState
from .models.model import ModelConfig, _check_family

__all__ = ["params_from_jax", "stacked_from_jax", "stacked_to_jax",
           "stacked_to_nested", "stacked_from_nested",
           "train_state_to_jax", "train_state_from_jax",
           "opt_state_to_jax", "opt_state_from_jax"]


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


def params_from_jax(tree: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX params (numpy leaves) of a dense, ssm or hybrid config ->
    ``Model`` state_dict (``layers.attn.wq`` stacked on L -> ``layers.{i}.attn.wq``;
    ``layers.mixer.in_proj`` -> ``layers.{i}.mixer.in_proj``)."""
    _check_family(cfg)
    sd: dict[str, torch.Tensor] = {}
    for name, leaf in _flatten({k: v for k, v in tree.items()
                                if k != "layers"}):
        sd[name] = _tensor(leaf)
    for name, leaf in _flatten(tree["layers"]):
        stacked = _tensor(leaf)
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"layers.{name}: leading axis "
                             f"{stacked.shape[0]} != n_layers {cfg.n_layers}")
        for i in range(cfg.n_layers):
            sd[f"layers.{i}.{name}"] = stacked[i].clone()
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
    under ``layers``) -> ``{name: (n, ...) tensor}`` named as ``Model``'s
    parameters; dtype and device kept."""
    _check_family(cfg)
    out = dict(_flatten({k: v for k, v in tree.items() if k != "layers"}))
    for name, stacked in _flatten(tree["layers"]):
        if stacked.ndim < 2 or stacked.shape[1] != cfg.n_layers:
            raise ValueError(f"layers.{name}: shape {tuple(stacked.shape)} "
                             f"has no (n, n_layers={cfg.n_layers}) lead")
        for i in range(cfg.n_layers):
            out[f"layers.{i}.{name}"] = stacked[:, i].clone()
    return out


def stacked_to_nested(stacked: dict[str, torch.Tensor],
                      cfg: ModelConfig) -> dict:
    """Inverse of :func:`stacked_from_nested`: the JAX nested layout, the
    layer leaves stacked on axis 1 (``(n, L, ...)``), dtype and device
    kept."""
    tree: dict = {}

    def put(path, val):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = val

    layer_leaves: dict = {}
    for name, t in stacked.items():
        parts = name.split(".")
        if parts[0] == "layers":
            layer_leaves.setdefault(".".join(parts[2:]), {})[int(parts[1])] = t
        else:
            put(parts, t.detach())
    for name, per_layer in layer_leaves.items():
        put(["layers"] + name.split("."),
            torch.stack([per_layer[i].detach()
                         for i in range(cfg.n_layers)], 1))
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
