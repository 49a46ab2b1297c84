"""Carry weights from the JAX package's params pytree into the port.

``params_from_jax(tree, cfg)`` takes the JAX params with every leaf
already a numpy array (``jax.tree.map(np.asarray, params)`` on the JAX
side) and returns a ``state_dict`` for :class:`repro_torch.models.model.Model`.
It unstacks the leading layer axis of ``tree["layers"]`` into the per-layer
modules.  bf16 leaves (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
rejects) cross as an int16 view reinterpreted with
``.view(torch.bfloat16)``: the same bits.  Plain numpy -> torch; nothing of
JAX is imported.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.model import ModelConfig, _check_family

__all__ = ["params_from_jax"]


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
    """JAX params (numpy leaves) of a dense config -> ``Model`` state_dict."""
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
