"""Flash-attention entry point: dispatch on the device of the tensors.

A CPU tensor takes the plain PyTorch version (``ref.attention_ref``); a
CUDA tensor launches the hand-written kernel (``kernel.py``) or raises --
there is no fallback and no switch.  The kernel is forward-only, as the
JAX package's is (its Pallas kernel has no gradient), so on a CUDA tensor
it refuses to run where autograd would need its gradient: the train path
takes the plain attention (``models.attention._sdpa``) instead.  A meta
tensor (the dry run) gets an empty output of the kernel's shape and
dtype; nothing runs.  On a CUDA or meta tensor under an active
:class:`repro_torch.launch.cost.Cost` the call records the kernel's work
by ``benchmarks/bench_kernels.py: flash_cost`` (:func:`cost`).
``flash_attention.launches`` counts kernel launches, so a run can show
that its path went through the kernel.
"""
from __future__ import annotations

import torch

from ...launch import cost as cost_mod
from . import kernel as K
from .ref import attention_ref

__all__ = ["flash_attention", "cost"]


def cost(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
         window: int | None = None) -> tuple[int, int]:
    """Operations and bytes of one call: ``bench_kernels.flash_cost`` for
    the causal (square) call; without the mask every (row, column) pair
    is visible."""
    from ...benchmarks.bench_kernels import flash_cost

    B, S, H, D = q.shape
    T, Kv = k.shape[1], k.shape[2]
    el = q.element_size()
    if causal:
        return flash_cost((B, S, H, Kv, D), el, window)
    return (4 * B * H * D * S * T,
            el * (2 * B * S * H * D + 2 * B * T * Kv * D))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    attn_cap: float | None = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, Kv, D) -> (B, S, H, D)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             attn_cap=attn_cap)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cpu, cuda or meta, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention: the CUDA kernel is forward-only (the JAX "
            "package's kernel has no gradient either); the train path uses "
            "the plain attention (models.attention.attn_apply(kernel=False))")
    counted = cost_mod.active()
    with cost_mod.hidden():
        if q.device.type == "meta":
            out = torch.empty_like(q)
        else:
            out = K.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window, attn_cap=attn_cap)
            flash_attention.launches += 1
    if counted:
        cost_mod.kernel("flash_attention",
                        *cost(q, k, causal=causal, window=window), out)
    return out


flash_attention.launches = 0
