"""Flash-attention entry point: dispatch on the device of the tensors.

A CPU tensor takes the plain PyTorch version (``ref.attention_ref``); a
CUDA tensor launches the hand-written kernel (``kernel.py``) or raises --
there is no fallback and no switch.  The kernel is forward-only, as the
JAX package's is (its Pallas kernel has no gradient), so on a CUDA tensor
it refuses to run where autograd would need its gradient: the train path
takes the plain attention (``models.attention._sdpa``) instead.
``flash_attention.launches`` counts kernel launches, so a run can show
that its path went through the kernel.
"""
from __future__ import annotations

import torch

from . import kernel as K
from .ref import attention_ref

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    attn_cap: float | None = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, Kv, D) -> (B, S, H, D)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             attn_cap=attn_cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention: the CUDA kernel is forward-only (the JAX "
            "package's kernel has no gradient either); the train path uses "
            "the plain attention (models.attention.attn_apply(kernel=False))")
    out = K.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                 attn_cap=attn_cap)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
