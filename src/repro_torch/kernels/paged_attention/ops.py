"""Paged-attention entry point: dispatch on the device of the tensors.

A CPU tensor takes the plain PyTorch version (``ref.paged_attention_ref``);
a CUDA tensor launches the hand-written kernel (``kernel.py``) or raises --
there is no fallback and no switch.  As in the JAX wrapper the pools are
cast to q's dtype first (a no-op on the serving path, where both are
bf16).  A meta tensor (the dry run) gets an empty output of the
kernel's shape and dtype; nothing runs.  On a CUDA or meta tensor under
an active :class:`repro_torch.launch.cost.Cost` the call records the
kernel's work by ``launch/time_paged.py: cost`` (:func:`cost`).
``paged_attention.launches`` counts kernel launches, so a run can show
that its path went through the kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ...launch import cost as cost_mod
from . import kernel as K
from .ref import paged_attention_ref

__all__ = ["paged_attention", "cost"]


def cost(q: torch.Tensor, k_pages: torch.Tensor, page_table: torch.Tensor,
         lengths: torch.Tensor, *,
         window: int | None = None) -> tuple[int, int]:
    """Operations and bytes of one call, ``time_paged.cost``: the visible
    tokens are read from ``lengths`` (a copy to the host), or on the meta
    device, which holds no lengths, taken as every slot of the page
    table: the most the call could need."""
    from ...launch.time_paged import cost as paged_cost

    B, H, D = q.shape
    Kv, _, page_size, _ = k_pages.shape
    pmax = page_table.shape[1]
    if lengths.device.type == "meta":
        ln = np.full(B, pmax * page_size, dtype=np.int64)
    else:
        ln = lengths.detach().cpu().numpy().astype(np.int64)
    return paged_cost(ln, pmax, q.element_size(), (H, Kv, D), window)


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
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"paged_attention runs on cpu, cuda or meta, not "
                         f"{q.device}")
    counted = cost_mod.active()
    with cost_mod.hidden():
        if q.device.type == "meta":
            out = torch.empty_like(q)
        else:
            out = K.paged_attention_cuda(q, k_pages, v_pages, page_table,
                                         lengths, window=window,
                                         attn_cap=attn_cap)
            paged_attention.launches += 1
        if counted:
            work = cost(q, k_pages, page_table, lengths, window=window)
    if counted:
        cost_mod.kernel("paged_attention", *work, out)
    return out


paged_attention.launches = 0
