"""Gossip-mix entry point: dispatch on the device of the tensors.

A CPU tensor takes the plain PyTorch version (``ref.gossip_mix_ref``); a
CUDA tensor launches the hand-written kernel (``kernel.py``) or raises --
there is no fallback.  A meta tensor (the dry run) gets an empty output
of the kernel's shape and dtype; nothing runs.  On a CUDA or meta tensor
under an active :class:`repro_torch.launch.cost.Cost` the call records
the kernel's work (:func:`cost`).  ``gossip_mix.launches`` counts kernel
launches, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import torch

from ...launch import cost as cost_mod
from . import kernel as K
from .ref import gossip_mix_ref

__all__ = ["gossip_mix", "cost"]


def cost(x: torch.Tensor, n_recv: int) -> tuple[int, int]:
    """Operations and bytes of one call: a multiply and an add per
    received element and a multiply for the self term; every input read
    once and the output written once."""
    n = x.numel()
    return (1 + 2 * n_recv) * n, (2 + n_recv) * n * x.element_size()


def gossip_mix(x: torch.Tensor, recvs, *, w_self: float,
               ws: tuple) -> torch.Tensor:
    """out = w_self * x + sum_d ws[d] * recvs[d]; any shape, f32 or bf16
    (any float dtype on the CPU)."""
    if x.device.type == "cpu":
        return gossip_mix_ref(x, recvs, w_self, ws)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"gossip_mix runs on cpu, cuda or meta, not "
                         f"{x.device}")
    counted = cost_mod.active()
    with cost_mod.hidden():
        if x.device.type == "meta":
            out = torch.empty_like(x)
        else:
            out = K.gossip_mix_cuda(x, recvs, w_self, ws)
            gossip_mix.launches += 1
    if counted:
        cost_mod.kernel("gossip_mix", *cost(x, len(recvs)), out)
    return out


gossip_mix.launches = 0
