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
Plain numpy <-> torch; nothing of JAX is imported.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.model import ModelConfig, _check_family

__all__ = ["params_from_jax", "stacked_from_jax", "stacked_to_jax"]


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
    _check_family(cfg)
    out: dict[str, torch.Tensor] = {}
    for name, leaf in _flatten({k: v for k, v in tree.items()
                                if k != "layers"}):
        out[name] = _tensor(leaf)
    for name, leaf in _flatten(tree["layers"]):
        stacked = _tensor(leaf)
        if stacked.ndim < 2 or stacked.shape[1] != cfg.n_layers:
            raise ValueError(f"layers.{name}: shape {tuple(stacked.shape)} "
                             f"has no (n, n_layers={cfg.n_layers}) lead")
        for i in range(cfg.n_layers):
            out[f"layers.{i}.{name}"] = stacked[:, i].clone()
    return out


def stacked_to_jax(stacked: dict[str, torch.Tensor],
                   cfg: ModelConfig) -> dict:
    """Inverse view of :func:`stacked_from_jax`: the JAX nested layout
    with the layer leaves restacked on axis 1, as numpy arrays (bf16
    widened to float32)."""
    def np_(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

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
            put(parts, np_(t))
    for name, per_layer in layer_leaves.items():
        put(["layers"] + name.split("."),
            np.stack([np_(per_layer[i]) for i in range(cfg.n_layers)], 1))
    return tree
