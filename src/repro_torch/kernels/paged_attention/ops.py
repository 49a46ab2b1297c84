"""Paged-attention entry point: dispatch on the device of the tensors.

A CPU tensor takes the plain PyTorch version (``ref.paged_attention_ref``);
a CUDA tensor launches the hand-written kernel (``kernel.py``) or raises --
there is no fallback and no switch.  As in the JAX wrapper the pools are
cast to q's dtype first (a no-op on the serving path, where both are
bf16).  ``paged_attention.launches`` counts kernel launches, so a run can
show that its path went through the kernel.
"""
from __future__ import annotations

import torch

from . import kernel as K
from .ref import paged_attention_ref

__all__ = ["paged_attention"]


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, *, window: int | None = None,
                    attn_cap: float | None = None) -> torch.Tensor:
    """q: (B, H, D); k_pages, v_pages: (Kv, n_pages, page_size, D);
    page_table: (B, Pmax) int32; lengths: (B,) int32.  Returns (B, H, D)."""
    k_pages, v_pages = k_pages.to(q.dtype), v_pages.to(q.dtype)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                                   window=window, attn_cap=attn_cap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    out = K.paged_attention_cuda(q, k_pages, v_pages, page_table, lengths,
                                 window=window, attn_cap=attn_cap)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
