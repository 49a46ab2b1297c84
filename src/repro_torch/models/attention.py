"""Self-attention: GQA, qk-norm, soft-capping, sliding windows, the
one-token decodes over a ring-buffer KV cache and over a paged KV pool,
and the vlm family's gated cross-attention.

Mirrors the JAX package's ``models/attention.py``.  The full-sequence path
(:func:`attn_apply`) runs the flash-attention kernel in serving prefill
and the positions-masked plain attention (:func:`_sdpa`) in the train
forward, which needs gradients the forward-only kernel does not have --
the JAX train path takes the same plain attention (its default
``attention_impl="jnp"``); the hybrid family's shared block reads
``attention_impl`` instead, as the reference's does.  The paged decode
(:func:`attn_decode_paged`) runs the paged-attention kernel; the
ring-cache decode (:func:`attn_decode`: the legacy ``generate``, the
hybrid shared block and the model-sharded serve step) is plain PyTorch,
as the reference's is.  Each
kernel's ``ops`` wrapper dispatches on the tensors' device, so a CPU run
takes the plain versions with no switch here.  The cross-attention
(:func:`cross_attn_apply`) is plain PyTorch through :func:`_sdpa`, as the
reference's is ``jnp``.  Weights are cast to the activation dtype on use,
as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..kernels.flash_attention import ops as flash_ops
from ..kernels.paged_attention import ops as paged_ops
from .layers import RMSNorm, rms_norm, rope

__all__ = ["Attention", "CrossAttention", "attn_apply", "attn_decode",
           "attn_decode_paged", "cross_attn_apply", "KVCache",
           "init_kv_cache", "NEG_INF"]

# finite fill for masked scores (never -inf): fully-masked and padded rows
# then give the same finite numbers as the reference
NEG_INF = -2.0 ** 30


class KVCache(NamedTuple):
    """Ring-buffer KV cache.

    k, v: (batch, n_kv, cache_len, head_dim), with any leading stack axes
    (layers, shared-block groups) in front.  After the decode of token
    ``idx``, slot ``s`` holds token ``t(s) = idx - mod(idx - s,
    cache_len)`` -- for a cache that never wraps (cache_len >= max_seq)
    simply token ``s``.  Keys are stored *rotated* (RoPE applied at their
    absolute position when written), which is valid because RoPE is
    relative.
    """
    k: torch.Tensor
    v: torch.Tensor


def init_kv_cache(batch: int, n_kv: int, cache_len: int, head_dim: int,
                  dtype=torch.bfloat16, *, stack: tuple = (),
                  device=None) -> KVCache:
    """Zeroed ``KVCache`` of shape ``stack + (batch, n_kv, cache_len,
    head_dim)``."""
    shape = tuple(stack) + (batch, n_kv, cache_len, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


class Attention(nn.Module):
    """wq (d, H*hd), wk/wv (d, Kv*hd), wo (H*hd, d); q_norm/k_norm scales
    (hd,) when qk_norm."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 qk_norm: bool = False, dtype=torch.float32, device=None):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))

        self.wq = p(d_model, n_heads * head_dim)
        self.wk = p(d_model, n_kv * head_dim)
        self.wv = p(d_model, n_kv * head_dim)
        self.wo = p(n_heads * head_dim, d_model)
        if qk_norm:
            self.q_norm = RMSNorm(head_dim, dtype, device)
            self.k_norm = RMSNorm(head_dim, dtype, device)


class CrossAttention(Attention):
    """llama-3.2-vision's gated cross-attention: an :class:`Attention`
    with qk-norm, plus the 0-d ``gate`` (zero at init, so a fresh cross
    layer adds nothing: ``tanh(0) = 0``)."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 dtype=torch.float32, device=None):
        super().__init__(d_model, n_heads, n_kv, head_dim, True, dtype,
                         device)
        self.gate = nn.Parameter(torch.zeros((), dtype=dtype, device=device))


def _project_qkv(p: Attention, x, n_heads, n_kv, head_dim, qk_norm,
                 positions, rope_theta):
    dt = x.dtype
    B, S, _ = x.shape
    q = (x @ p.wq.to(dt)).reshape(B, S, n_heads, head_dim)
    k = (x @ p.wk.to(dt)).reshape(B, S, n_kv, head_dim)
    v = (x @ p.wv.to(dt)).reshape(B, S, n_kv, head_dim)
    if qk_norm:                          # per head, before rope
        q = rms_norm(p.q_norm.scale, q)
        k = rms_norm(p.k_norm.scale, k)
    if rope_theta:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    return q, k, v


def _heads_tp(tp, q, k, v, q_cut, kv_cut, n_heads, n_kv, head_dim):
    """The tensor-parallel heads (``tp``: :class:`~repro_torch.launch.tp.
    TP`) of the projections ``q`` (B, S, cols) and ``k``, ``v`` (B, T,
    cols), each the rank's columns where cut: ``(q, k, v, local)`` as
    (B, S, Hl, hd) and (B, T, Kvl, hd).  Query columns that are whole
    heads give the rank's heads alone (``local``); otherwise q is
    gathered and every head attends, replicated.  k / v keep the rank's
    columns where they are whole kv heads and exactly the ones its
    queries read; otherwise they are gathered whole and those heads are
    picked -- a contiguous run where the rank's queries fill whole
    groups, else one kv head per query head (a group of 1).  Read by the
    rank's own heads alone, gathered k / v take the ranks' partial
    gradients summed (``gather_from(partial=True)``)."""
    B, S, T, hd = q.shape[0], q.shape[1], k.shape[1], head_dim
    G = n_heads // n_kv
    local = q_cut and q.shape[-1] % hd == 0
    if not local:
        q = tp.whole(q, q_cut)
    Hl = q.shape[-1] // hd
    q0 = tp.rank * Hl if local else 0
    Kvl = k.shape[-1] // hd
    if not (kv_cut and k.shape[-1] % hd == 0 and Kvl * G == Hl):
        k, v = tp.whole(k, kv_cut, local), tp.whole(v, kv_cut, local)
        if Hl % G == 0:
            k = k[..., q0 // G * hd:(q0 + Hl) // G * hd]
            v = v[..., q0 // G * hd:(q0 + Hl) // G * hd]
        else:
            idx = torch.div(torch.arange(q0, q0 + Hl, device=k.device), G,
                            rounding_mode="floor")
            k = k.reshape(B, T, n_kv, hd).index_select(2, idx)
            v = v.reshape(B, T, n_kv, hd).index_select(2, idx)
    return (q.reshape(B, S, Hl, hd), k.reshape(B, T, -1, hd),
            v.reshape(B, T, -1, hd), local)


def _per_head(tp, scale, local: bool):
    """A whole leaf read by the rank's own heads: through ``copy_to``."""
    return tp.copy_to(scale) if local else scale


def _project_qkv_tp(tp, p: Attention, x, n_heads, n_kv, head_dim, qk_norm,
                    positions, rope_theta):
    """:func:`_project_qkv` on the rank's model shards: the projections
    column-parallel where their leaves are cut (one ``copy_to`` of x),
    the heads by :func:`_heads_tp`; qk-norm and rope per head, as in one
    process -- on the rank's own heads (``local``) the norm scales enter
    through ``copy_to``, their gradients partial.  Returns (q, k, v,
    local)."""
    dt = x.dtype
    (q, q_cut), (k, kv_cut), (v, _) = tp.columns(x, (p.wq, p.wk, p.wv), dt)
    q, k, v, local = _heads_tp(tp, q, k, v, q_cut, kv_cut, n_heads, n_kv,
                               head_dim)
    if qk_norm:
        q = rms_norm(_per_head(tp, p.q_norm.scale, local), q)
        k = rms_norm(_per_head(tp, p.k_norm.scale, local), k)
    if rope_theta:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    return q, k, v, local


def _sdpa(q, k, v, mask, attn_cap=None, gqa_layout="grouped"):
    """Masked attention: the train forward's attention, and the
    positions-masked oracle the kernel path is held to.  q: (B,S,H,hd);
    k,v: (B,T,Kv,hd); mask: (B,1,S,T) or (1,1,S,T) bool.

    gqa_layout, as in the reference: ``"grouped"`` shapes the scores (B,
    Kv, G, S, T); ``"flat"`` repeats K and V to H heads and shapes them
    (B, H, S, T) -- the same values, more bytes (the dry run's knob)."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    if gqa_layout == "flat":
        kf = torch.repeat_interleave(k, G, dim=2)        # (B,T,H,hd)
        vf = torch.repeat_interleave(v, G, dim=2)
        logits = torch.einsum("bshd,bthd->bhst", q, kf).float()
        logits = logits * hd ** -0.5
        if attn_cap is not None:
            logits = attn_cap * torch.tanh(logits / attn_cap)
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhst,bthd->bshd", probs, vf)
    qg = q.reshape(B, S, Kv, G, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    logits = logits * hd ** -0.5
    if attn_cap is not None:
        logits = attn_cap * torch.tanh(logits / attn_cap)
    logits = torch.where(mask[:, :, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    # the product in the probabilities' own (k, g, s) order, so that no
    # (S, T) tensor is copied; the small output is permuted after
    out = torch.einsum("bkgst,btkh->bkgsh", probs, v)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def attn_apply(p: Attention, x, *, n_heads, n_kv, head_dim, positions,
               rope_theta=10000.0, qk_norm=False, window=None,
               attn_cap=None, return_kv=False, kernel=True,
               gqa_layout="grouped", tp=None):
    """Causal self-attention on a full sequence.

    kernel: True (serving prefill; the hybrid shared block when
      ``attention_impl="pallas"``) runs the flash-attention kernel, whose
      causal mask assumes positions = arange(S) per row, as the
      reference's kernel path does; False (the train forward) runs
      :func:`_sdpa` under the mask ``positions_j <= positions_i`` (and
      ``> positions_i - window``), as the JAX train path does -- the CUDA
      kernel is forward-only and refuses to run under autograd.
    window: if set, token i attends to (i-window, i] (sliding window).
    return_kv: also return the (rotated, normed) k, v as (B, S, Kv, hd) --
      exactly what a decode cache stores.
    gqa_layout: the plain attention's score layout (:func:`_sdpa`); the
      kernel takes no layout.
    tp: a bound :class:`~repro_torch.launch.tp.TP`: the rank's model
      shards, the projections and heads by :func:`_project_qkv_tp` and
      ``wo`` row-parallel (its output summed over the line).
    """
    B, S, _ = x.shape
    if tp is None:
        q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, qk_norm,
                               positions, rope_theta)
    else:
        q, k, v, local = _project_qkv_tp(tp, p, x, n_heads, n_kv, head_dim,
                                         qk_norm, positions, rope_theta)
    if kernel:
        out = flash_ops.flash_attention(q, k, v, causal=True, window=window,
                                        attn_cap=attn_cap)
    else:
        i = positions[:, :, None]   # (B,S,1)
        j = positions[:, None, :]   # (B,1,T)
        mask = j <= i
        if window is not None:
            mask &= j > i - window
        out = _sdpa(q, k, v, mask[:, None], attn_cap, gqa_layout)
    if tp is None:
        y = out.reshape(B, S, n_heads * head_dim) @ p.wo.to(x.dtype)
    else:
        y = tp.linear(out.reshape(B, S, -1), p.wo, x.dtype, local)[0]
    if return_kv:
        return y, k, v
    return y


def _ring_cut(tp, cache: KVCache, n_kv: int, head_dim: int) -> str:
    """The model cut of a rank's ring-cache shard (``sharding.cache_specs``
    cuts the kv heads where they divide the model extent, else the head
    dim): ``"heads"`` or ``"head_dim"``.  Any other cut raises, naming
    it: the decode never gathers a cache whole."""
    kv, hd = cache.k.shape[-3], cache.k.shape[-1]
    if kv * tp.size == n_kv and hd == head_dim:
        return "heads"
    if hd * tp.size == head_dim and kv == n_kv:
        return "head_dim"
    raise ValueError(
        f"a ring-cache shard of {kv} kv heads x head dim {hd} is cut over "
        f"model {tp.size} on neither its {n_kv} kv heads nor its head dim "
        f"{head_dim}: the decode runs those two cuts only")


def _decode_qkv_tp(tp, p: Attention, x, cut: str, head_dim, qk_norm,
                   positions, rope_theta):
    """The decode token's (q, k, v) on the rank's model shards, for a ring
    cache cut by ``cut`` (:func:`_ring_cut`).  The projections are
    column-parallel where their leaves are cut; qk-norm and rope act on
    whole heads.  ``"heads"``: the rank's query heads and the kv heads
    they read (its block of the columns).  ``"head_dim"``: every head,
    then the rank's block of the head dim -- after the norm, which
    reduces over it, and rope, which pairs dim i with i + hd / 2."""
    dt = x.dtype
    B = x.shape[0]
    qkv = tp.columns(x, (p.wq, p.wk, p.wv), dt)
    if cut == "heads":
        q, k, v = (y if c else tp.scatter_to(y, -1) for y, c in qkv)
    else:
        q, k, v = (tp.whole(y, c) for y, c in qkv)
    q, k, v = (y.reshape(B, 1, -1, head_dim) for y in (q, k, v))
    if qk_norm:
        q = rms_norm(p.q_norm.scale, q)
        k = rms_norm(p.k_norm.scale, k)
    if rope_theta:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    if cut == "head_dim":
        q, k, v = (tp.scatter_to(y, -1) for y in (q, k, v))
    return q, k, v


def attn_decode(p: Attention, x, cache: KVCache, idx: int, *, n_heads,
                n_kv, head_dim, rope_theta=10000.0, qk_norm=False,
                window=None, attn_cap=None, tp=None):
    """One-token decode over a ring-buffer KV cache.  x: (B, 1, d); idx:
    the absolute position of the token (a Python int, the same for every
    row); cache: one layer's ``KVCache`` (B, Kv, cache_len, hd).

    Writes the token's (k, v) into ring slot ``idx % cache_len`` and
    attends over the slots that hold tokens ``t(s) >= 0`` (and ``t(s) >
    idx - window`` when a window is set).  The cache is cast to the
    activation dtype before both products, the softmax runs in f32 with
    the -2^30 fill, as in the reference.  Unlike the JAX reference, which
    returns new arrays, the write is IN PLACE into the cache passed in
    (as :func:`attn_decode_paged` writes its pools), which is returned.
    Returns (y (B, 1, d), cache).

    ``tp`` (a bound :class:`~repro_torch.launch.tp.TP`): the rank's model
    shards and its shard of the cache as ``sharding.cache_specs`` cuts
    it (:func:`_ring_cut`).  Kv heads cut: the rank writes and attends
    with its own heads, ``wo`` row-parallel.  Head dim cut: the rank
    writes its block of every head, the partial logits of every query
    head are summed over the line in f32 (one psum), then the scale, the
    soft-cap, the mask and the softmax run replicated; its block of the
    output is made whole along the head dim before ``wo``.
    """
    B = x.shape[0]
    cache_len = cache.k.shape[2]
    idx = int(idx)
    pos = torch.full((B, 1), idx, dtype=torch.int32, device=x.device)
    if tp is None:
        cut = None
        q, k_new, v_new = _project_qkv(p, x, n_heads, n_kv, head_dim,
                                       qk_norm, pos, rope_theta)
    else:
        cut = _ring_cut(tp, cache, n_kv, head_dim)
        q, k_new, v_new = _decode_qkv_tp(tp, p, x, cut, head_dim, qk_norm,
                                         pos, rope_theta)
    slot = idx % cache_len
    cache.k[:, :, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, :, slot] = v_new[:, 0].to(cache.v.dtype)
    # slot s holds token t(s) = idx - mod(idx - s, cache_len)
    s = torch.arange(cache_len, device=x.device)
    t = idx - torch.remainder(idx - s, cache_len)
    valid = t >= 0
    if window is not None:
        valid &= t > idx - window
    G = n_heads // n_kv
    kv, hd = cache.k.shape[1], cache.k.shape[-1]     # the shard's
    qg = q.reshape(B, 1, kv, G, hd)
    logits = torch.einsum("bskgh,bkth->bkgst", qg,
                          cache.k.to(q.dtype)).float()
    if cut == "head_dim":
        logits = tp.reduce_from(logits)
    logits = logits * head_dim ** -0.5
    if attn_cap is not None:
        logits = attn_cap * torch.tanh(logits / attn_cap)
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,bkth->bskgh", probs, cache.v.to(q.dtype))
    if tp is None:
        y = out.reshape(B, 1, n_heads * head_dim) @ p.wo.to(x.dtype)
    elif cut == "heads":
        y = tp.linear(out.reshape(B, 1, -1), p.wo, x.dtype, True)[0]
    else:
        out = tp.gather_from(out, -1)
        y = tp.linear(out.reshape(B, 1, -1), p.wo, x.dtype)[0]
    return y, cache


def attn_decode_paged(p: Attention, x, k_pages, v_pages, page_table,
                      positions, *, page_size, n_heads, n_kv, head_dim,
                      rope_theta=10000.0, qk_norm=False, window=None,
                      attn_cap=None):
    """One-token decode over a PAGED KV cache (continuous batching).

    x: (B, 1, d); positions: (B,) int32, each sequence's own absolute
    position.  k_pages, v_pages: (Kv, n_pages, page_size, hd) pools of one
    layer; page_table: (B, Pmax) int32.

    Writes (k, v) for positions[b] into page ``page_table[b, pos //
    page_size]`` slot ``pos % page_size`` and then attends over the first
    ``positions + 1`` tokens, so the new token is covered.  Unlike the JAX
    reference, which returns new arrays, the write is IN PLACE
    (``index_put_``) into the pools passed in, which are returned.
    Returns (y, k_pages, v_pages).
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, n_heads, n_kv, head_dim, qk_norm,
                                   positions[:, None], rope_theta)
    pages = page_table.gather(1, (positions // page_size)[:, None].long())[:, 0]
    slots = positions % page_size
    pages, slots = pages.long(), slots.long()
    # in-place write into the caller's pools (an index_put_ with the index
    # tensors at dims 1 and 2), where the reference builds new arrays
    k_pages[:, pages, slots] = k_new[:, 0].transpose(0, 1).to(k_pages.dtype)
    v_pages[:, pages, slots] = v_new[:, 0].transpose(0, 1).to(v_pages.dtype)
    lengths = (positions + 1).to(torch.int32)
    out = paged_ops.paged_attention(q[:, 0], k_pages, v_pages, page_table,
                                    lengths, window=window, attn_cap=attn_cap)
    y = (out.reshape(B, n_heads * head_dim) @ p.wo.to(x.dtype))[:, None]
    return y, k_pages, v_pages


def cross_attn_apply(p: CrossAttention, x, kv_src, *, n_heads, n_kv,
                     head_dim, tp=None):
    """Cross-attention: queries from x (B, S, d), keys and values from
    ``kv_src`` (B, T, d), the image embeddings, cast to x's dtype.
    qk-norm, no RoPE, no causality (an all-true mask through
    :func:`_sdpa`); the output is scaled by ``tanh(gate)``, taken in f32
    and cast to the activation dtype, as the reference does.  ``tp``: the
    rank's model shards, as :func:`attn_apply` (queries from x, keys and
    values from the images, each entering its column-parallel products
    once)."""
    dt = x.dtype
    B, S, _ = x.shape
    T = kv_src.shape[1]
    src = kv_src.to(dt)
    if tp is None:
        q = (x @ p.wq.to(dt)).reshape(B, S, n_heads, head_dim)
        k = (src @ p.wk.to(dt)).reshape(B, T, n_kv, head_dim)
        v = (src @ p.wv.to(dt)).reshape(B, T, n_kv, head_dim)
    else:
        ((q, q_cut),) = tp.columns(x, (p.wq,), dt)
        (k, kv_cut), (v, _) = tp.columns(src, (p.wk, p.wv), dt)
        q, k, v, local = _heads_tp(tp, q, k, v, q_cut, kv_cut, n_heads,
                                   n_kv, head_dim)
    q_scale, k_scale = p.q_norm.scale, p.k_norm.scale
    if tp is not None:
        q_scale = _per_head(tp, q_scale, local)
        k_scale = _per_head(tp, k_scale, local)
    q = rms_norm(q_scale, q)
    k = rms_norm(k_scale, k)
    mask = torch.ones((B, 1, S, T), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k, v, mask)
    if tp is None:
        y = out.reshape(B, S, n_heads * head_dim) @ p.wo.to(dt)
    else:
        y = tp.linear(out.reshape(B, S, -1), p.wo, dt, local)[0]
    return torch.tanh(p.gate.float()).to(dt) * y
