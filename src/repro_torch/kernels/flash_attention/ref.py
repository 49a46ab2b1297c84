"""Plain PyTorch version of the flash-attention kernel.

A straight port of the JAX package's ``kernels/flash_attention/ref.py``:
causal GQA attention with optional sliding window and logit soft-capping,
matching ``models.attention._sdpa`` with positions = arange.  The wrapper
in ``ops.py`` takes it for CPU tensors; ``chip_smoke.py`` holds the CUDA
kernel against it on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  attn_cap: float | None = None):
    """q: (B, S, H, D); k, v: (B, T, Kv, D). Returns (B, S, H, D)."""
    B, S, H, D = q.shape
    T, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    qg = q.reshape(B, S, Kv, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    logits = logits * D ** -0.5
    if attn_cap is not None:
        logits = attn_cap * torch.tanh(logits / attn_cap)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)
