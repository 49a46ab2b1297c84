"""Gossip-mix entry point: dispatch on the device of the tensors.

A CPU tensor takes the plain PyTorch version (``ref.gossip_mix_ref``); a
CUDA tensor launches the hand-written kernel (``kernel.py``) or raises --
there is no fallback.  ``gossip_mix.launches`` counts kernel launches, so
a run can show that its path went through the kernel.
"""
from __future__ import annotations

import torch

from . import kernel as K
from .ref import gossip_mix_ref

__all__ = ["gossip_mix"]


def gossip_mix(x: torch.Tensor, recvs, *, w_self: float,
               ws: tuple) -> torch.Tensor:
    """out = w_self * x + sum_d ws[d] * recvs[d]; any shape, f32 or bf16
    (any float dtype on the CPU)."""
    if x.device.type == "cpu":
        return gossip_mix_ref(x, recvs, w_self, ws)
    if x.device.type != "cuda":
        raise ValueError(f"gossip_mix runs on cpu or cuda, not {x.device}")
    out = K.gossip_mix_cuda(x, recvs, w_self, ws)
    gossip_mix.launches += 1
    return out


gossip_mix.launches = 0
