"""Plain PyTorch version of the paged-attention decode kernel.

A straight port of the JAX package's ``kernels/paged_attention/ref.py``:
one query token per sequence attends over its first ``lengths[b]`` cached
tokens, which live scattered across fixed-size pages of a shared pool;
``page_table[b, p]`` names the pool page holding tokens
``[p * page_size, (p + 1) * page_size)`` of sequence ``b``.  GQA, optional
sliding window and logit soft-capping, float32 softmax.  The wrapper in
``ops.py`` takes it for CPU tensors; ``chip_smoke.py`` holds the CUDA
kernel against it on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                        window=None, attn_cap=None):
    """q: (B, H, D); k_pages, v_pages: (Kv, n_pages, page_size, D);
    page_table: (B, Pmax) int32; lengths: (B,) int32.  Returns (B, H, D).
    """
    B, H, D = q.shape
    Kv, _, page_size, _ = k_pages.shape
    Pmax = page_table.shape[1]
    G = H // Kv

    # gather this batch's pages: (Kv, B, Pmax, ps, D) -> (B, Kv, T, D)
    idx = page_table.long()
    k = k_pages[:, idx]
    v = v_pages[:, idx]
    T = Pmax * page_size
    k = k.permute(1, 0, 2, 3, 4).reshape(B, Kv, T, D)
    v = v.permute(1, 0, 2, 3, 4).reshape(B, Kv, T, D)

    qg = q.reshape(B, Kv, G, D)
    logits = torch.einsum("bkgd,bktd->bkgt", qg.float(), k.float())
    logits = logits * D ** -0.5
    if attn_cap is not None:
        logits = attn_cap * torch.tanh(logits / attn_cap)
    t = torch.arange(T, dtype=torch.int32, device=q.device)[None, :]  # (1, T)
    ln = lengths[:, None]                                           # (B, 1)
    valid = t < ln
    if window is not None:
        # query position is lengths - 1: token j visible iff j > i - window
        valid &= t > ln - 1 - window
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", probs, v.float())
    return out.reshape(B, H, D).to(q.dtype)
