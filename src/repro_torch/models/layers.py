"""Shared neural-net layers.

Functions take tensors (or the small modules holding them) and mirror the
JAX package's ``models/layers.py`` operation for operation, so the same
inputs give the same numbers up to the order of floating-point sums.
Weights stay in the JAX layout: a dense weight is ``(fan_in, fan_out)``
and is applied as ``x @ w``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "RMSNorm", "MLP", "rms_norm", "rope", "softcap", "silu", "mlp_apply",
    "dense_init",
]


def dense_init(gen: torch.Generator, shape, scale=None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated normal on [-2, 2] times ``scale`` (default fan_in^-0.5),
    drawn in f32 from ``gen`` (which lives on ``device``)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


class RMSNorm(nn.Module):
    """Holds the ``scale`` of an RMSNorm (zeros: the (1 + scale) form)."""

    def __init__(self, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))


def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with (1 + scale) parameterization, computed in f32."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embeddings (half-split).  x: (..., seq, heads, head_dim);
    positions: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None].float() * freq     # (..., s, half)
    angles = angles[..., :, None, :]                    # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * (1 / (1 + exp(-x))), op by op as ``jax.nn.silu`` computes it: in
    bf16 each op rounds, where ``F.silu`` rounds once and differs from the
    reference in about 4 of 10 elements by an ulp, flips that the mamba
    layers and the MLPs would otherwise carry through every layer."""
    return x * (1 / (1 + torch.exp(-x)))


class MLP(nn.Module):
    """Gated MLP weights: w_gate, w_up (d_model, d_ff); w_down (d_ff, d_model)."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.float32,
                 device=None):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))

        self.w_gate = p(d_model, d_ff)
        self.w_up = p(d_model, d_ff)
        self.w_down = p(d_ff, d_model)


def mlp_apply(p: MLP, x: torch.Tensor, kind: str = "swiglu",
              tp=None) -> torch.Tensor:
    """Gated MLP: swiglu (silu gate) or geglu (tanh-gelu gate, gemma).
    ``tp`` (a bound :class:`~repro_torch.launch.tp.TP`): the rank's model
    shards, ``w_gate`` / ``w_up`` column-parallel and ``w_down``
    row-parallel where their leaves are cut."""
    dt = x.dtype
    if tp is None:
        gate = x @ p.w_gate.to(dt)
        up = x @ p.w_up.to(dt)
    else:
        (gate, cut), (up, _) = tp.columns(x, (p.w_gate, p.w_up), dt)
    act = silu(gate) if kind == "swiglu" else F.gelu(gate, approximate="tanh")
    if tp is None:
        return (act * up) @ p.w_down.to(dt)
    return tp.linear(act * up, p.w_down, dt, cut)[0]
