"""Flash-attention entry point: dispatch on the device of the tensors.

A CPU tensor takes the plain PyTorch version (``ref.attention_ref``); a
CUDA tensor launches the hand-written kernel (``kernel.py``) or raises --
there is no fallback and no switch.  ``flash_attention.launches`` counts
kernel launches, so a run can show that its path went through the kernel.
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
    out = K.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                 attn_cap=attn_cap)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
