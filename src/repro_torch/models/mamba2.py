"""Mamba-2 block (SSD -- state-space duality, arXiv:2405.21060).

Mirrors the JAX package's ``models/mamba2.py``: the chunked SSD for the
full-sequence forward (quadratic within chunks, a linear recurrence across
them) and the O(1)-state single-token decode.  ``mamba2_apply`` with
``impl="pallas"`` runs the scan through the SSD-scan kernel
(:func:`repro_torch.kernels.ssd_scan.ops.ssd_scan`: the CUDA kernel on the
card, the naive recurrence on the CPU); any other ``impl`` takes
:func:`ssd_chunked`, the plain chunked algorithm that autograd
differentiates (the train path).

Shapes follow the paper: x (B,S,H,P) heads, A (H,) scalar-per-head decay,
B/C (B,S,G,N) with G groups, dt (B,S,H) softplus-positive step sizes.
Weights stay in the JAX layout (``in_proj`` (d_model, K), applied as
``x @ w``) under the JAX names.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ssd_scan import ops as ssd_ops
from .layers import RMSNorm, rms_norm, silu

__all__ = ["Mamba2", "mamba2_apply", "mamba2_decode", "SSMCache",
           "init_ssm_cache", "ssd_chunked"]


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, conv_dim) rolling window of conv inputs
    state: torch.Tensor   # (B, H, P, N) ssm state, float32


def init_ssm_cache(batch, d_conv, conv_dim, n_heads, head_dim, d_state,
                   dtype=torch.float32, device=None) -> SSMCache:
    return SSMCache(
        torch.zeros((batch, d_conv - 1, conv_dim), dtype=dtype, device=device),
        torch.zeros((batch, n_heads, head_dim, d_state), dtype=torch.float32,
                    device=device),
    )


class Mamba2(nn.Module):
    """The parameters of ``mamba2_init``, allocated but not initialised:
    ``in_proj`` emits [z (d_inner), x (d_inner), B, C (2 G N), dt (H)];
    ``A_log``, ``dt_bias`` and ``D`` are float32 whatever ``dtype``."""

    def __init__(self, d_model: int, *, d_state: int = 128,
                 head_dim: int = 64, expand: int = 2, d_conv: int = 4,
                 n_groups: int = 1, dtype=torch.float32, device=None):
        super().__init__()
        d_inner = expand * d_model
        n_heads = d_inner // head_dim
        conv_dim = d_inner + 2 * n_groups * d_state

        def p(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.in_proj = p(d_model, 2 * d_inner + 2 * n_groups * d_state
                         + n_heads)
        self.conv_w = p(d_conv, conv_dim)
        self.conv_b = p(conv_dim)
        self.A_log = p(n_heads, dt=torch.float32)
        self.dt_bias = p(n_heads, dt=torch.float32)
        self.D = p(n_heads, dt=torch.float32)
        self.norm = RMSNorm(d_inner, dtype, device)
        self.out_proj = p(d_inner, d_model)


def _split_proj(proj, d_inner, n_groups, d_state, n_heads):
    gn = n_groups * d_state
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner:d_inner + d_inner + 2 * gn]
    dt = proj[..., -n_heads:]
    return z, xBC, dt


def _causal_conv(xBC, conv_w, conv_b, history=None):
    """Depthwise causal conv1d along seq. xBC: (B,S,C); conv_w: (K,C)."""
    K = conv_w.shape[0]
    if history is None:
        pad = torch.zeros((xBC.shape[0], K - 1, xBC.shape[2]),
                          dtype=xBC.dtype, device=xBC.device)
    else:
        pad = history.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)                    # (B, S+K-1, C)
    out = sum(xp[:, i:i + xBC.shape[1], :] * conv_w[i][None, None]
              for i in range(K))
    return silu(out + conv_b[None, None])


def ssd_chunked(x, dt, A, B, C, chunk: int = 128, h0=None):
    """Chunked SSD. x: (b,s,h,p); dt: (b,s,h); A: (h,); B,C: (b,s,g,n).

    Recurrence: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t;  y_t = C_t h_t.
    Returns (y (b,s,h,p), h_final (b,h,p,n)).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"ssd_chunked: chunk {chunk} does not divide s {s}")
    nc = s // chunk
    rep = h // g

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n)
    Cc = C.reshape(b, nc, chunk, g, n)

    dA = dtc * A[None, None, None]                 # (b,nc,l,h)  (negative)
    cum = torch.cumsum(dA, dim=2)                  # within-chunk cumsum
    # intra-chunk (causal "attention" with decay):
    #   y_t += sum_{u<=t} C_t . B_u  exp(cum_t - cum_u) dt_u x_u
    Bh = Bc.repeat_interleave(rep, dim=3)          # (b,nc,l,h,n)
    Ch = Cc.repeat_interleave(rep, dim=3)
    scores = torch.einsum("bcthn,bcuhn->bchtu", Ch, Bh)      # (b,nc,h,l,l)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    # mask the exponent BEFORE exp: for u > t, cum_t - cum_u > 0 overflows
    # and would leak NaN through where() in the backward pass.
    cum_t = cum.permute(0, 1, 3, 2)                # (b,nc,h,l)
    diff = cum_t[..., :, None] - cum_t[..., None, :]
    decay = torch.exp(diff.masked_fill(~tri, -1e30))
    M = scores * decay
    xdt = xc * dtc[..., None]                      # (b,nc,l,h,p)
    y_intra = torch.einsum("bchtu,bcuhp->bcthp", M, xdt)

    # chunk-final states: S_c = sum_u exp(cumend - cum_u) dt_u B_u x_u^T
    cum_end = cum[:, :, -1:, :]                    # (b,nc,1,h)
    dec_end = torch.exp(cum_end - cum)             # (b,nc,l,h)
    states = torch.einsum("bclhn,bclhp,bclh->bchpn", Bh, xc,
                          dtc * dec_end)           # (b,nc,h,p,n)

    # inter-chunk scan: H_c = exp(sum dA_c) H_{c-1} + S_c, emitting the
    # state ENTERING each chunk
    chunk_decay = torch.exp(cum_end[:, :, 0, :])   # (b,nc,h)
    carry = (torch.zeros((b, h, p, n), dtype=states.dtype, device=x.device)
             if h0 is None else h0)
    h_in = []
    for c in range(nc):
        h_in.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                # (b,nc,h,p,n)

    # inter-chunk contribution: y_t += C_t exp(cum_t) H_in
    y_inter = torch.einsum("bcthn,bchpn,bcth->bcthp", Ch, h_in,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, carry


def _ssd_inputs(p: Mamba2, x, d_state, head_dim, expand, n_groups,
                tp=None):
    """in_proj and its split: (z, xBC, dt_raw, d_inner, n_heads).  ``tp``:
    a column-parallel ``in_proj`` where its leaf is cut, the packed
    z, x, B, C, dt then gathered whole (the split does not follow the
    column cut)."""
    d_inner = expand * x.shape[-1]
    n_heads = d_inner // head_dim
    if tp is None:
        proj = x @ p.in_proj.to(x.dtype)
    else:
        proj = tp.whole(*tp.linear(x, p.in_proj, x.dtype))
    z, xBC, dt_raw = _split_proj(proj, d_inner, n_groups, d_state, n_heads)
    return z, xBC, dt_raw, d_inner, n_heads


def mamba2_apply(p: Mamba2, x, *, d_state: int = 128, head_dim: int = 64,
                 expand: int = 2, d_conv: int = 4, n_groups: int = 1,
                 chunk: int = 128, impl: str = "jnp", tp=None):
    """Full-sequence Mamba2 block. x: (B,S,d_model) -> (B,S,d_model).
    ``tp`` (a bound :class:`~repro_torch.launch.tp.TP`): ``in_proj``
    column-parallel and gathered, the conv, the scan and the gated norm
    replicated along the model line, ``out_proj`` row-parallel (its input
    scattered)."""
    dt_ = x.dtype
    z, xBC, dt_raw, d_inner, n_heads = _ssd_inputs(p, x, d_state, head_dim,
                                                   expand, n_groups, tp)
    xBC = _causal_conv(xBC, p.conv_w.to(dt_), p.conv_b.to(dt_))
    xi = xBC[..., :d_inner]
    Bv = xBC[..., d_inner:d_inner + n_groups * d_state]
    Cv = xBC[..., d_inner + n_groups * d_state:]

    b, s = x.shape[:2]
    xh = xi.reshape(b, s, n_heads, head_dim).float()
    Bm = Bv.reshape(b, s, n_groups, d_state).float()
    Cm = Cv.reshape(b, s, n_groups, d_state).float()
    dt = F.softplus(dt_raw.float() + p.dt_bias[None, None])
    A = -torch.exp(p.A_log)

    if impl == "pallas":
        y, _ = ssd_ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk)
    else:
        y, _ = ssd_chunked(xh, dt, A, Bm, Cm, chunk=chunk)
    y = y + p.D[None, None, :, None] * xh
    y = y.reshape(b, s, d_inner).to(dt_)
    # the inner norm keeps its default eps (1e-6), not cfg.norm_eps, as the
    # reference does
    y = rms_norm(p.norm.scale, y * silu(z))
    if tp is not None:
        return tp.linear(y, p.out_proj, dt_)[0]
    return y @ p.out_proj.to(dt_)


def _ssm_cut(tp, cache: SSMCache, conv_dim: int, n_heads: int) -> None:
    """Check a rank's SSM-cache shard is cut as ``sharding.cache_specs``
    cuts it where the decode can run it: the conv history on its packed
    channels, the state on its heads.  Any other cut raises, naming it."""
    c, (h, hp, n) = cache.conv.shape[-1], cache.state.shape[-3:]
    if c * tp.size != conv_dim or h * tp.size != n_heads:
        raise ValueError(
            f"an SSM-cache shard of conv channels {c} of {conv_dim} and "
            f"state (heads, P, N) {(h, hp, n)} of {n_heads} heads is not "
            f"cut over model {tp.size} on the channels and the heads: the "
            "decode runs that cut only")


def _own(tp, w):
    """A bound leaf cut on its last dim over model: the rank's block, as
    it is or cut from the whole leaf."""
    return w if tp.dim(w) is not None else tp.scatter_to(w, -1)


def mamba2_decode(p: Mamba2, x, cache: SSMCache, *, d_state: int = 128,
                  head_dim: int = 64, expand: int = 2, d_conv: int = 4,
                  n_groups: int = 1, tp=None):
    """Single-token decode. x: (B,1,d_model).  Returns (out, new cache);
    the given cache is not modified.

    ``tp`` (a bound :class:`~repro_torch.launch.tp.TP`): the rank's model
    shards and its shard of the cache (:func:`_ssm_cut`); ``in_proj``
    column-parallel and gathered whole.  The rank convolves its block of
    the packed x, B, C channels over its own history (the block may
    straddle their split) and the conv output is made whole; it updates
    its heads' state alone, and their y is made whole; the gated norm
    runs replicated and ``out_proj`` is row-parallel.  The new cache is
    the rank's blocks."""
    dt_ = x.dtype
    z, xBC, dt_raw, d_inner, n_heads = _ssd_inputs(p, x, d_state, head_dim,
                                                   expand, n_groups, tp)
    conv_w, conv_b = p.conv_w, p.conv_b
    h0, nh = 0, n_heads
    if tp is not None:
        _ssm_cut(tp, cache, xBC.shape[-1], n_heads)
        xBC, conv_w, conv_b = (tp.scatter_to(xBC, -1), _own(tp, conv_w),
                               _own(tp, conv_b))
        nh = n_heads // tp.size
        h0 = tp.rank * nh
    new_conv = torch.cat([cache.conv[:, 1:],
                          xBC[:, 0:1].to(cache.conv.dtype)], dim=1)
    xBC = _causal_conv(xBC, conv_w.to(dt_), conv_b.to(dt_),
                       history=cache.conv)
    if tp is not None:
        xBC = tp.gather_from(xBC, -1)
    xi = xBC[..., :d_inner]
    Bv = xBC[..., d_inner:d_inner + n_groups * d_state]
    Cv = xBC[..., d_inner + n_groups * d_state:]

    b = x.shape[0]
    xh = xi.reshape(b, n_heads, head_dim).float()
    Bm = Bv.reshape(b, n_groups, d_state).float()
    Cm = Cv.reshape(b, n_groups, d_state).float()
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias[None])   # (b,h)
    A = -torch.exp(p.A_log)
    rep = n_heads // n_groups
    Bh = Bm.repeat_interleave(rep, dim=1)                     # (b,h,n)
    Ch = Cm.repeat_interleave(rep, dim=1)
    D = p.D
    if tp is not None:                     # the rank's heads
        xh, dt, Bh, Ch = (t[:, h0:h0 + nh] for t in (xh, dt, Bh, Ch))
        A, D = A[h0:h0 + nh], D[h0:h0 + nh]

    decay = torch.exp(dt * A[None])                           # (b,h)
    new_state = (cache.state * decay[:, :, None, None]
                 + torch.einsum("bhn,bhp,bh->bhpn", Bh, xh, dt))
    y = torch.einsum("bhn,bhpn->bhp", Ch, new_state)
    y = y + D[None, :, None] * xh
    if tp is not None:
        y = tp.gather_from(y, 1)
    y = y.reshape(b, 1, d_inner).to(dt_)
    y = rms_norm(p.norm.scale, y * silu(z))
    if tp is not None:
        out = tp.linear(y, p.out_proj, dt_)[0]
    else:
        out = y @ p.out_proj.to(dt_)
    return out, SSMCache(new_conv, new_state)
