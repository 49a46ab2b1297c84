"""Decoder-only model composer: the six families of the JAX package.

Mirrors the JAX package's ``models/model.py``.  ``ModelConfig`` is the
same dataclass with torch dtypes, so every arch config copies across:
  dense   -- [attn + mlp] x L      (llama / qwen / gemma / deepseek)
  moe     -- [attn + moe_ffn] x L  (granite-moe, dbrx)
  ssm     -- [mamba2] x L          (mamba2; attention-free)
  hybrid  -- mamba2 x L with ONE shared attn + mlp block applied after
             every ``shared_attn_every`` mamba layers to concat(hidden,
             embedding) through ``in_proj``                      (zamba2)
  vlm     -- n_groups x ([attn + mlp] x n_self, then one gated
             cross-attention layer over the image embeddings), with
             n_self = cross_attn_every - 1       (llama-3.2-vision)
  audio   -- dense over the sum of K codebook embeddings, K lm heads
                                                               (musicgen)

Parameters live in an ``nn.Module`` whose names follow the JAX dict keys
(``embed``, ``layers.{i}.attn.wq``, ``layers.{i}.ln1.scale``,
``layers.{i}.mixer.in_proj``, ``layers.{i}.moe.w_gate``,
``shared_attn.in_proj``, ``cross_layers.{g}.xattn.gate``,
``final_norm.scale``, ...) in the JAX layout;
the layer ``scan`` of the reference becomes a Python loop over a
``ModuleList``, so each layer's window is a plain ``int | None``.  The
vlm family's doubly stacked ``layers`` leaves, (n_groups, n_self, ...) in
the reference, are numbered flat: JAX ``layers[g, j]`` is the port's
``layers.{g * n_self + j}``, and JAX ``cross_layers[g]`` is
``cross_layers.{g}`` (its 0-d ``gate`` a 0-d parameter).  The audio
family's ``embed`` is (K, V, d) and its ``lm_head`` (K, d, V), as the
reference's; its tokens are (..., K) and its logits (..., K, V).

Entry points (the JAX signatures, with the module in place of the
params pytree):
  init(cfg, seed, device)                             -> Model
  forward(params, cfg, tokens, image_embeds=None)     -> logits, aux
                                          (aux: the moe layers' summed
                                           load-balance loss, else 0)
  forward_prefill(params, cfg, tokens)                -> logits, (k, v)
  decode_step_paged(params, cfg, token, pool, ...)    -> logits, pool
  init_cache(cfg, batch, cache_len, dtype, device)    -> cache
  decode_step(params, cfg, token, cache, idx,
              image_embeds=None)                      -> logits, cache

The paged serving entry points take the uniform-attention families
(:data:`PAGED_FAMILIES`) only, as the reference's do.  ``init_cache`` and
``decode_step`` are the legacy one-batch decode that
``launch.serve.generate`` loops: a ring-buffer KV cache per layer for
dense, moe and audio (vlm: per self layer, stacked (n_groups, n_self),
the cross-attention recomputed from the images every step, as the
reference's), an SSM cache per layer for ssm, and for hybrid both an SSM
cache per mamba layer and one ring KV cache per application of the
shared block.

``params`` may also be :func:`params_view` of a flat ``{name: tensor}``
dict -- how the train step runs one node's slice of the node-stacked
parameters.  ``forward`` (train and eval) takes the plain attention with a
gradient and, when ``cfg.remat``, recomputes each layer (hybrid: each
mamba layer; vlm: each self layer) in backward (``torch.utils.checkpoint``,
as the reference's ``jax.checkpoint``); ``forward_prefill`` (serving)
takes the forward-only
flash-attention kernel.  The ssm and hybrid ``forward`` read
``cfg.attention_impl`` as the reference does: "pallas" runs the
forward-only SSD-scan kernel (and, in the hybrid shared block, the
flash-attention kernel), anything else the plain chunked scan and
attention; ``forward(attn_kernel=True)`` runs the [attn + ffn] layers'
attention through the kernel too (the prefill step under "pallas").

The moe family's FFN is :func:`repro_torch.models.moe.moe_apply`:
``forward`` and ``forward_prefill`` dispatch as ``cfg.moe_dropless`` says
(the train loss turns it off for the capacity dispatch), and both decodes
are always dropless, as the reference's, so a token's logits never depend
on its co-batched requests.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import attention as attn
from . import mamba2 as m2
from .moe import MoE, moe_apply
from .layers import MLP, RMSNorm, dense_init, mlp_apply, rms_norm, softcap

__all__ = ["ModelConfig", "Model", "init", "forward", "forward_prefill",
           "decode_step_paged", "init_cache", "decode_step", "param_count",
           "active_param_count", "params_view", "SUPPORTED_FAMILIES",
           "PAGED_FAMILIES"]

# the families this package runs: every family of the reference
SUPPORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# families still to port, by ROADMAP item: none
_LATER: dict[str, str] = {}
# families whose layers are all [attn + ffn] (vlm adds cross layers)
_ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")
# families whose decode state is a uniform per-layer self-attention KV --
# the ones the paged serving plane supports (the reference's list)
PAGED_FAMILIES = ("dense", "moe", "audio")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # attention behaviour
    qk_norm: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    sliding_window: int | None = None      # static window for ALL attn layers
    local_global: bool = False             # gemma2: even layers use window
    rope_theta: float = 10000.0
    mlp_kind: str = "swiglu"
    tie_embeddings: bool = False
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dropless: bool = True
    # ssm / hybrid
    d_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    d_conv: int = 4
    ssm_n_groups: int = 1
    shared_attn_every: int = 0             # zamba2
    # vlm
    cross_attn_every: int = 0              # llama-3.2-vision
    n_image_tokens: int = 1024
    # audio
    n_codebooks: int = 0                   # musicgen
    # numerics
    norm_eps: float = 1e-6
    param_dtype: Any = torch.float32
    activation_dtype: Any = torch.bfloat16
    ssd_chunk: int = 128
    # jnp | pallas.  The ssm and hybrid forwards read it, as the reference
    # does: "pallas" runs the SSD-scan kernel (and in the hybrid shared
    # block the flash-attention kernel; both forward only), anything else
    # the plain chunked scan and attention that autograd differentiates.
    # The dense forward's train path ignores it and takes the plain
    # attention (the reference's default "jnp"); the prefill step
    # (launch/steps.py) reads it, as the reference's forward does, and
    # forward_prefill (the engine) always takes the kernel.  Each kernel
    # wrapper dispatches on the tensors' device.
    attention_impl: str = "jnp"
    remat: bool = True
    attention_override_window: int | None = None
    # the reference's two layout knobs (the dry run's --knob): the default
    # positions as one (1, S) row, broadcast over the batch, so the causal
    # mask is (1, S, S); and the plain attention's score layout, "grouped"
    # (B, Kv, G, S, T) or "flat" (K/V repeated to H heads, (B, H, S, T))
    broadcast_positions: bool = False
    gqa_layout: str = "grouped"

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def window_for(self, layer_flag_local: bool) -> int | None:
        if self.attention_override_window is not None:
            return self.attention_override_window
        if self.local_global:
            return self.sliding_window if layer_flag_local else None
        return self.sliding_window


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in SUPPORTED_FAMILIES:
        raise NotImplementedError(
            f"the PyTorch port runs {SUPPORTED_FAMILIES}, not "
            f"{cfg.family} ({_LATER.get(cfg.family, 'unknown family')})")


def _vlm_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, n_self) of the vlm family: n_self self layers then one
    cross layer, n_groups times (a remainder of n_layers is dropped, as
    in the reference)."""
    return cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


def _check_paged(cfg: ModelConfig) -> None:
    _check_family(cfg)
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"paged serving supports {PAGED_FAMILIES}, not {cfg.family}; "
            f"the {cfg.family} family is served by launch.serve.generate")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _has_moe(cfg: ModelConfig) -> bool:
    """Whether an [attn + ffn] layer holds experts (the reference's
    condition, ``_dense_layer_init``)."""
    return cfg.family == "moe" or bool(cfg.n_experts and cfg.top_k)


class DenseLayer(nn.Module):
    """[attn + mlp], or [attn + moe] where :func:`_has_moe`."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = cfg.param_dtype
        self.ln1 = RMSNorm(cfg.d_model, dt, device)
        self.attn = attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, cfg.qk_norm, dt, device)
        self.ln2 = RMSNorm(cfg.d_model, dt, device)
        if _has_moe(cfg):
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, dt, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, cfg.param_dtype, device)
        self.mixer = m2.Mamba2(cfg.d_model, d_state=cfg.d_state,
                               head_dim=cfg.ssm_head_dim,
                               expand=cfg.ssm_expand, d_conv=cfg.d_conv,
                               n_groups=cfg.ssm_n_groups,
                               dtype=cfg.param_dtype, device=device)


class SharedBlock(DenseLayer):
    """zamba2's one shared attention + MLP block: a dense layer's weights
    plus ``in_proj`` (2 d_model, d_model), which projects concat(hidden,
    embedding) to d_model."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        self.in_proj = nn.Parameter(torch.empty(
            2 * cfg.d_model, cfg.d_model, dtype=cfg.param_dtype,
            device=device))


class CrossLayer(nn.Module):
    """The vlm family's cross layer: [gated cross-attention + mlp] (the
    reference's ``_cross_layer_init``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = cfg.param_dtype
        self.ln1 = RMSNorm(cfg.d_model, dt, device)
        self.xattn = attn.CrossAttention(cfg.d_model, cfg.n_heads,
                                         cfg.n_kv_heads, cfg.head_dim, dt,
                                         device)
        self.ln2 = RMSNorm(cfg.d_model, dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)


class Model(nn.Module):
    """The parameters of a decoder of any family, allocated but not
    initialised (see :func:`init`, or ``load_state_dict`` of
    :func:`repro_torch.convert.params_from_jax`)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        super().__init__()
        _check_family(cfg)
        device = resolve_device(device)
        dt = cfg.param_dtype
        V, d = cfg.vocab_size, cfg.d_model

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        if cfg.family == "audio":        # K embeddings and K heads, untied
            self.embed = param(cfg.n_codebooks, V, d)
            self.lm_head = param(cfg.n_codebooks, d, V)
        else:
            self.embed = param(V, d)
            if not cfg.tie_embeddings:
                self.lm_head = param(d, V)
        n_layers = cfg.n_layers
        if cfg.family == "vlm":
            n_groups, n_self = _vlm_groups(cfg)
            n_layers = n_groups * n_self
        layer = DenseLayer if cfg.family in _ATTN_FAMILIES else MambaLayer
        self.layers = nn.ModuleList(layer(cfg, device)
                                    for _ in range(n_layers))
        if cfg.family == "vlm":
            self.cross_layers = nn.ModuleList(CrossLayer(cfg, device)
                                              for _ in range(n_groups))
        if cfg.family == "hybrid":
            self.shared_attn = SharedBlock(cfg, device)
        self.final_norm = RMSNorm(cfg.d_model, dt, device)


@torch.no_grad()
def init(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Model:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device``, with the values of the reference's init (not its random
    stream): truncated normals at fan_in^-0.5, fan_in = ``shape[-2]`` (embed:
    d_model^-0.5; the mamba conv_w: d_conv^-0.5; the hybrid
    ``shared_attn.in_proj``: fan_in 2 d_model; the moe experts (E, d, f)
    and (E, f, d): d and f; the moe router, always f32: d_model; the
    audio heads (K, d, V): d), norm scales zero, the vlm cross layers'
    0-d ``gate`` zero, and the mamba mixer's
    deterministic leaves A_log = log(linspace(1, 16, H)), dt_bias = 0,
    D = 1, conv_b = 0.  On ``device="meta"`` the model is shape-only (no
    generator, no values), as ``eval_shape`` of the reference's init."""
    model = Model(cfg, device=device)
    dev = model.embed.device
    if dev.type == "meta":
        return model
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, w in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("scale", "dt_bias", "conv_b", "gate"):
            w.zero_()
        elif leaf == "D":
            w.fill_(1.0)
        elif leaf == "A_log":
            w.copy_(torch.log(torch.linspace(1.0, 16.0, w.shape[0],
                                             device=dev)))
        else:
            scale = {"embed": cfg.d_model ** -0.5,
                     "conv_w": cfg.d_conv ** -0.5}.get(leaf)
            w.copy_(dense_init(gen, tuple(w.shape), scale=scale,
                               dtype=w.dtype, device=dev))
    return model


def param_count(params: Model) -> int:
    return sum(p.numel() for p in params.parameters())


def active_param_count(params: Model, cfg: ModelConfig) -> int:
    """MoE: count only top_k / n_experts of the layers' expert weights (for
    MODEL_FLOPS), as the reference does on each layer-stacked leaf."""
    total = param_count(params)
    if not cfg.n_experts:
        return total
    inactive = 0
    for name in ("w_gate", "w_up", "w_down"):
        stacked = sum(p.numel() for n, p in params.named_parameters()
                      if n.startswith("layers.")
                      and n.endswith(f".moe.{name}"))
        inactive += stacked * (cfg.n_experts - cfg.top_k) // cfg.n_experts
    return total - inactive


def params_view(flat: dict[str, torch.Tensor]):
    """An attribute tree over a flat ``{name: tensor}`` dict named as
    :class:`Model`'s parameters (``layers.3.attn.wq`` -> ``.layers[3].attn
    .wq``): what the model functions read, holding the given tensors
    themselves.  The train step binds one node's leaves this way, so
    remat's recomputation in backward reads the same tensors
    (``torch.func.functional_call`` would have undone its swap by then)."""
    root: dict = {}
    for name, t in flat.items():
        node = root
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t

    def build(d):
        if all(k.isdigit() for k in d):
            return [build(d[str(i)]) for i in range(len(d))]
        return types.SimpleNamespace(**{
            k: build(v) if isinstance(v, dict) else v for k, v in d.items()})

    return build(root)


# ---------------------------------------------------------------------------
# Forward (train / eval, and serving prefill)
# ---------------------------------------------------------------------------

def _effective_window(cfg: ModelConfig, layer: int) -> int | None:
    """The static window of layer ``layer`` (gemma-2: even layers local)."""
    return cfg.window_for(layer % 2 == 0)


def _ffn(cfg: ModelConfig, p: DenseLayer, h, dropless: bool, aux, tp=None,
         route=None):
    """The layer's FFN on the normed activations: the MLP, or the experts
    (dispatched dropless or by capacity; ``route``: the capacity routing
    over the rank's routing group).  Returns (out, aux plus the experts'
    load-balance loss); the MLP passes ``aux`` through."""
    if _has_moe(cfg):
        out, aux_l = moe_apply(p.moe, h, n_experts=cfg.n_experts,
                               top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor,
                               dropless=dropless, tp=tp, route=route)
        return out, aux + aux_l
    return mlp_apply(p.mlp, h, cfg.mlp_kind, tp), aux


def _cross_block(cfg: ModelConfig, p: CrossLayer, x, img, tp=None):
    """One vlm cross layer: pre-norm residual gated cross-attention over
    the image embeddings ``img`` (in the activation dtype), then the
    MLP."""
    h = rms_norm(p.ln1.scale, x, cfg.norm_eps)
    x = x + attn.cross_attn_apply(p.xattn, h, img, n_heads=cfg.n_heads,
                                  n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                                  tp=tp)
    h = rms_norm(p.ln2.scale, x, cfg.norm_eps)
    return x + mlp_apply(p.mlp, h, cfg.mlp_kind, tp)


def _dense_block(cfg: ModelConfig, p: DenseLayer, x, positions, layer: int,
                 aux, prefill=False, tp=None, route=None, kernel=False):
    """One [attn + ffn] layer -> (x, aux plus the layer's load-balance loss,
    kv).  With ``prefill`` (serving)
    the attention kernel runs and kv is the layer's (k, v); otherwise
    (train/eval) the plain attention, which autograd differentiates, and kv
    is None -- or, with ``kernel`` (the prefill step under
    ``attention_impl="pallas"``), the kernel.  The experts dispatch as
    ``cfg.moe_dropless`` says."""
    h = rms_norm(p.ln1.scale, x, cfg.norm_eps)
    out = attn.attn_apply(
        p.attn, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, positions=positions,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        window=_effective_window(cfg, layer), attn_cap=cfg.attn_softcap,
        return_kv=prefill, kernel=prefill or kernel,
        gqa_layout=cfg.gqa_layout,
        tp=tp)
    h, kv = (out[0], out[1:]) if prefill else (out, None)
    x = x + h
    h, aux = _ffn(cfg, p, rms_norm(p.ln2.scale, x, cfg.norm_eps),
                  cfg.moe_dropless, aux, tp, route)
    return x + h, aux, kv


def _mamba_block(cfg: ModelConfig, p: MambaLayer, x, tp=None):
    """One [mamba2] layer: "pallas" runs the SSD-scan kernel, anything else
    the plain chunked scan."""
    h = rms_norm(p.ln.scale, x, cfg.norm_eps)
    h = m2.mamba2_apply(p.mixer, h, d_state=cfg.d_state,
                        head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
                        d_conv=cfg.d_conv, n_groups=cfg.ssm_n_groups,
                        chunk=cfg.ssd_chunk, impl=cfg.attention_impl
                        if cfg.attention_impl == "pallas" else "jnp", tp=tp)
    return x + h


def _attn_kw(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                qk_norm=cfg.qk_norm, attn_cap=cfg.attn_softcap)


def _attn_mlp(cfg: ModelConfig, p: DenseLayer, x, attend, tp=None):
    """Pre-norm residual attention then FFN: ``attend`` maps the normed
    activations to the attention's output (a full sequence or one decode
    token).  The experts, where the layer has them, run dropless: the
    decodes' and the shared block's path."""
    x = x + attend(rms_norm(p.ln1.scale, x, cfg.norm_eps))
    h = rms_norm(p.ln2.scale, x, cfg.norm_eps)
    return x + _ffn(cfg, p, h, dropless=True, aux=0.0, tp=tp)[0]


def _shared_block(cfg: ModelConfig, p: SharedBlock, x, x0, attend,
                  tp=None):
    """zamba2's shared block on concat(x, x0): ``h = concat @ in_proj``,
    then h's own attention and MLP residuals, and the block returns
    ``x + h`` -- h, in_proj output included, is what joins the stream.
    ``tp``: ``in_proj`` column-parallel, its output gathered whole."""
    cat = torch.cat([x, x0], dim=-1)
    if tp is None:
        h = cat @ p.in_proj.to(x.dtype)
    else:
        h = tp.whole(*tp.linear(cat, p.in_proj, x.dtype))
    return x + _attn_mlp(cfg, p, h, attend, tp)


def _rows(table, ids):
    """``table[ids]`` of a (V, d) table, or of audio's (K, V, d) with ids
    (..., K): codebook k's rows for id k."""
    if table.ndim == 2:
        return table[ids]
    return table[torch.arange(table.shape[0], device=ids.device), ids]


def _lookup_tp(tp, table, ids):
    """:func:`_rows` on the rank's model shard of an embedding table: V
    cut -- ids outside the rank's rows give zero rows, summed over the
    line by ``reduce_from`` (one collective for audio's K codebooks);
    d cut -- the rows' columns gathered."""
    d = tp.dim(table)
    if d is None:
        return _rows(table, ids)
    if d == table.ndim - 1:
        return tp.gather_from(_rows(table, ids), -1)
    Vl = table.shape[-2]
    local = ids - tp.vocab_offset(Vl)
    ok = (local >= 0) & (local < Vl)
    rows = _rows(table, local.clamp(0, Vl - 1))
    return tp.reduce_from(torch.where(ok[..., None], rows, 0.0))


def _embed_tokens(params: Model, cfg: ModelConfig, tokens, tp=None):
    """tokens: (B, S) int (audio: (B, S, K)) -> activations (B, S, d).
    Gathers, then casts to the activation dtype (the same bits as the
    reference's cast-then-gather); audio sums the K codebooks' embeddings
    from left to right in the activation dtype, each add rounded as the
    reference's Python ``sum``.  Then, for the families the reference
    scales (not ssm), applies the gemma-style sqrt(d_model) scale, rounded
    to the activation dtype as the reference does for qwen3 too."""
    adt = cfg.activation_dtype
    tokens = tokens.long()
    if tp is not None:
        return _scale_embedding(cfg, _embed_tp(params, cfg, tokens, tp))
    if cfg.family == "audio":
        x = params.embed[0][tokens[..., 0]].to(adt)
        for k in range(1, cfg.n_codebooks):
            x = x + params.embed[k][tokens[..., k]].to(adt)
    else:
        x = params.embed[tokens].to(adt)
    return _scale_embedding(cfg, x)


def _embed_tp(params, cfg: ModelConfig, tokens, tp):
    """:func:`_embed_tokens`' lookups on the rank's model shard of
    ``embed`` (:func:`_lookup_tp`), cast and summed as in one process."""
    adt = cfg.activation_dtype
    rows = _lookup_tp(tp, params.embed, tokens)
    if cfg.family != "audio":
        return rows.to(adt)
    x = rows[..., 0, :].to(adt)
    for k in range(1, cfg.n_codebooks):
        x = x + rows[..., k, :].to(adt)
    return x


def _scale_embedding(cfg: ModelConfig, x):
    adt = cfg.activation_dtype
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=adt, device=x.device)
    return x


def _default_positions(cfg: ModelConfig, tokens):
    """``arange(S)`` for each of the B rows, or one (1, S) row that
    broadcasts over the batch under ``cfg.broadcast_positions``."""
    B, S = tokens.shape[0], tokens.shape[1]
    rows = 1 if cfg.broadcast_positions else B
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device).expand(rows, S)


def forward(params: Model, cfg: ModelConfig, tokens, *, image_embeds=None,
            positions=None, tp=None, route=None, attn_kernel=False):
    """Train / eval forward.  tokens: (B, S) int (audio: (B, S, K)).
    Returns logits (B, S, V) (audio: (B, S, K, V)) and the f32 scalar aux
    loss: the moe layers' load-balance losses summed (zero for the other
    families).  The vlm family needs ``image_embeds`` (B, T, d); the
    others ignore it, as in the reference.  ``tp`` (a bound
    :class:`~repro_torch.launch.tp.TP`): ``params`` are the rank's model
    shards and each layer follows its leaves' cuts; the logits are then
    the rank's block of the vocabulary where the head cuts it
    (:func:`logits_cut`), else whole.  ``route`` (a
    :class:`~repro_torch.launch.moe_group.MoeGroup`): the tokens are the
    rank's share of a moe routing group spread over fsdp ranks, and the
    experts' capacity routing is the group's (``models/moe.py``).
    ``attn_kernel``: the [attn + ffn] layers' attention through the
    forward-only flash-attention kernel, whose causal mask assumes the
    default positions (the prefill step under ``attention_impl=
    "pallas"``, as the reference's forward reads it); by default the
    plain attention, which autograd differentiates."""
    return _forward(params, cfg, tokens, positions, prefill=False,
                    image_embeds=image_embeds, tp=tp, route=route,
                    attn_kernel=attn_kernel)


def _head(params, cfg: ModelConfig):
    """(the head's leaf, the dim of it that is the vocabulary)."""
    if cfg.family == "audio" or not cfg.tie_embeddings:
        return params.lm_head, -1
    return params.embed, -2


def logits_cut(params, cfg: ModelConfig, tp) -> bool:
    """Whether :func:`forward` under ``tp`` returns the rank's block of
    the vocabulary (the head's vocabulary dim cut over model)."""
    if tp is None:
        return False
    w, v = _head(params, cfg)
    return tp.dim(w) == v % w.ndim


def forward_prefill(params: Model, cfg: ModelConfig, tokens, *,
                    positions=None):
    """Full-sequence serving prefill: one forward pass that ALSO returns
    the per-layer decode KV.  tokens: (B, S) (audio: (B, S, K)).  Returns
    ``(logits, (k, v))`` with k, v shaped (L, B, S, Kv, hd) -- the
    rotated/normed tensors the page pool stores.  Uniform-attention
    families only (:data:`PAGED_FAMILIES`)."""
    _check_paged(cfg)
    return _forward(params, cfg, tokens, positions, prefill=True)


def _forward(params, cfg, tokens, positions, prefill, image_embeds=None,
             tp=None, route=None, attn_kernel=False):
    _check_family(cfg)
    if cfg.family == "vlm":
        if image_embeds is None:
            raise ValueError("the vlm family needs image_embeds")
        img = image_embeds.to(cfg.activation_dtype)
        n_self = _vlm_groups(cfg)[1]
    x = _embed_tokens(params, cfg, tokens, tp)
    x0 = x                     # hybrid: the shared block's embedding input
    if positions is None:
        positions = _default_positions(cfg, tokens)
    remat = cfg.remat and not prefill and torch.is_grad_enabled()

    def run(block, *args):
        return (checkpoint(block, *args, use_reentrant=False) if remat
                else block(*args))

    every = cfg.shared_attn_every
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for i, layer in enumerate(params.layers):
        if prefill:
            x, aux, (k, v) = _dense_block(cfg, layer, x, positions, i,
                                          aux, prefill=True)
            ks.append(k)
            vs.append(v)
            continue
        if cfg.family in _ATTN_FAMILIES:
            x, aux, _ = run(_dense_block, cfg, layer, x, positions, i, aux,
                            False, tp, route, attn_kernel)
        else:
            x = run(_mamba_block, cfg, layer, x, tp)
        if cfg.family == "vlm" and (i + 1) % n_self == 0:
            # the group's cross layer; remat covers the self layers only,
            # as the reference's _maybe_remat(inner)
            x = _cross_block(cfg, params.cross_layers[i // n_self], x, img,
                             tp)
        if cfg.family == "hybrid" and (i + 1) % every == 0:
            # after each group of `every` mamba layers (none after the
            # L % every tail); remat covers the mamba layers only, as the
            # reference's _maybe_remat(mamba_body)
            shared = params.shared_attn
            x = _shared_block(cfg, shared, x, x0, lambda h: attn.attn_apply(
                shared.attn, h, positions=positions,
                window=cfg.window_for(True),
                kernel=cfg.attention_impl == "pallas",
                gqa_layout=cfg.gqa_layout, tp=tp, **_attn_kw(cfg)), tp)
    x = rms_norm(params.final_norm.scale, x, cfg.norm_eps)
    logits = _lm_head(params, cfg, x, tp)
    if prefill:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits, aux


def _lm_head(params: Model, cfg: ModelConfig, x, tp=None):
    """Logits in the activation dtype: audio's K heads
    (``bsd,kdv->bskv``, no softcap, never tied, as the reference's), else
    the tied or untied head, soft-capped.  ``tp``: the head's vocabulary
    cut -- the rank's logits (x entering by ``copy_to``) -- or its d cut
    (row-parallel: x scattered, the partial logits summed)."""
    if tp is not None:
        return _lm_head_tp(params, cfg, x, tp)
    if cfg.family == "audio":
        return torch.einsum("bsd,kdv->bskv", x, params.lm_head.to(x.dtype))
    if cfg.tie_embeddings:
        logits = x @ params.embed.to(x.dtype).T
    else:
        logits = x @ params.lm_head.to(x.dtype)
    return softcap(logits, cfg.final_softcap)


def _lm_head_tp(params, cfg: ModelConfig, x, tp):
    w, v = _head(params, cfg)
    d = tp.dim(w)
    dt = x.dtype
    if cfg.family == "audio":
        def prod(a):
            return torch.einsum("bsd,kdv->bskv", a, w.to(dt))
    elif w is params.embed:
        def prod(a):
            return a @ w.to(dt).T
    else:
        def prod(a):
            return a @ w.to(dt)
    if d is None:
        logits = prod(x)
    elif d == v % w.ndim:                     # the vocabulary cut
        logits = prod(tp.copy_to(x))
    else:                                     # the d cut: row-parallel
        logits = tp.reduce_from(prod(tp.scatter_to(x, -1)))
    return logits if cfg.family == "audio" else softcap(logits,
                                                        cfg.final_softcap)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_step_paged(params: Model, cfg: ModelConfig, token, pool,
                      page_table, positions, *, page_size: int):
    """One-token decode over a PAGED KV pool (continuous batching).

    token: (B, 1) int (audio: (B, 1, K)); positions: (B,) int32 -- each
    sequence decodes at its OWN absolute position.  pool: ``{"k", "v"}``
    shaped (L, Kv, n_pages, page_size, hd); page_table: (B, Pmax) int32.  The
    new k/v are written into ``pool`` in place; returns (logits, pool).
    Uniform-attention families only (:data:`PAGED_FAMILIES`); the experts
    run dropless whatever ``cfg.moe_dropless`` is.
    """
    _check_paged(cfg)
    x = _embed_tokens(params, cfg, token)
    for i, p in enumerate(params.layers):
        x = _attn_mlp(cfg, p, x, lambda h: attn.attn_decode_paged(
            p.attn, h, pool["k"][i], pool["v"][i], page_table, positions,
            page_size=page_size, window=_effective_window(cfg, i),
            **_attn_kw(cfg))[0])
    x = rms_norm(params.final_norm.scale, x, cfg.norm_eps)
    return _lm_head(params, cfg, x), pool


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, *, device="cuda") -> dict:
    """Stacked decode caches, as the reference's ``init_cache``:

    - dense, moe and audio: ``{"kv": KVCache}``, k and v (L, B, Kv,
      cache_len, hd);
    - vlm: ``{"kv": KVCache}`` of the self layers, (n_groups, n_self, B,
      Kv, cache_len, hd) (the cross layers keep no cache);
    - ssm: ``{"ssm": SSMCache}``, conv (L, B, d_conv-1, conv_dim) and
      state (L, B, H, P, N) in float32 (``cache_len`` is unused);
    - hybrid: both, the ``KVCache`` as ``"shared_kv"`` with one ring per
      application of the shared block, (L // shared_attn_every, B, Kv,
      cache_len, hd).

    Every tensor but the SSM state is in ``dtype``."""
    _check_family(cfg)
    device = resolve_device(device)

    def kv(*stack):
        return attn.init_kv_cache(batch, cfg.n_kv_heads, cache_len,
                                  cfg.head_dim, dtype, stack=stack,
                                  device=device)

    if cfg.family in ("dense", "moe", "audio"):
        return {"kv": kv(cfg.n_layers)}
    if cfg.family == "vlm":
        return {"kv": kv(*_vlm_groups(cfg))}
    d_inner = cfg.ssm_expand * cfg.d_model
    conv_dim = d_inner + 2 * cfg.ssm_n_groups * cfg.d_state
    nh = d_inner // cfg.ssm_head_dim
    L = cfg.n_layers
    ssm = m2.SSMCache(
        torch.zeros((L, batch, cfg.d_conv - 1, conv_dim), dtype=dtype,
                    device=device),
        torch.zeros((L, batch, nh, cfg.ssm_head_dim, cfg.d_state),
                    dtype=torch.float32, device=device))
    if cfg.family == "ssm":
        return {"ssm": ssm}
    return {"ssm": ssm, "shared_kv": kv(L // cfg.shared_attn_every)}


def _mamba_decode(cfg: ModelConfig, p: MambaLayer, x, conv, state,
                  tp=None):
    """One mamba layer's decode; its SSM cache (under ``tp`` the rank's
    shard of it) is updated in place."""
    h = rms_norm(p.ln.scale, x, cfg.norm_eps)
    h, c2 = m2.mamba2_decode(p.mixer, h, m2.SSMCache(conv, state),
                             d_state=cfg.d_state, head_dim=cfg.ssm_head_dim,
                             expand=cfg.ssm_expand, d_conv=cfg.d_conv,
                             n_groups=cfg.ssm_n_groups, tp=tp)
    conv.copy_(c2.conv)
    state.copy_(c2.state)
    return x + h


def decode_step(params: Model, cfg: ModelConfig, token, cache: dict,
                idx: int, *, image_embeds=None, tp=None):
    """One-token decode.  token: (B, 1) int (audio: (B, 1, K)); idx: the
    token's absolute position (a Python int; the ssm family ignores it).
    Returns (logits (B, 1, V) (audio: (B, 1, K, V)), cache); the cache's
    tensors are updated in place, as ``decode_step_paged`` updates its
    pool.  Dense, moe and audio layers attend over their own ring (each
    with its static window; the experts always dropless); vlm self layer
    ``g * n_self + j`` over ``kv[g, j]``, and each group's cross layer
    attends to ``image_embeds`` (B, T, d), recomputed every step; the
    hybrid shared block's g-th application over ``shared_kv[g]``.

    ``tp`` (a bound :class:`~repro_torch.launch.tp.TP`): ``params`` are
    the rank's model shards and ``cache`` its shard of the cache as
    ``launch.sharding.cache_specs`` cuts it (``attention.attn_decode``,
    ``mamba2.mamba2_decode``); the embedding, the experts, the cross
    layers and the head follow their leaves' cuts as in :func:`forward`,
    and the logits are the rank's block of the vocabulary where
    :func:`logits_cut` says so."""
    _check_family(cfg)
    n_self = 0
    if cfg.family == "vlm":
        if image_embeds is None:
            raise ValueError("the vlm family needs image_embeds")
        img = image_embeds.to(cfg.activation_dtype)
        n_self = _vlm_groups(cfg)[1]
    x = _embed_tokens(params, cfg, token, tp)
    if cfg.family in _ATTN_FAMILIES:
        kv = cache["kv"]
        for i, p in enumerate(params.layers):
            at = divmod(i, n_self) if n_self else i
            x = _attn_mlp(cfg, p, x, lambda h: attn.attn_decode(
                p.attn, h, attn.KVCache(kv.k[at], kv.v[at]), idx,
                window=_effective_window(cfg, i), tp=tp,
                **_attn_kw(cfg))[0], tp)
            if n_self and (i + 1) % n_self == 0:
                x = _cross_block(cfg, params.cross_layers[i // n_self], x,
                                 img, tp)
    else:
        x0 = x                 # hybrid: this token's embedding
        conv, state = cache["ssm"]
        every = cfg.shared_attn_every
        for i, p in enumerate(params.layers):
            x = _mamba_decode(cfg, p, x, conv[i], state[i], tp)
            if cfg.family == "hybrid" and (i + 1) % every == 0:
                g = (i + 1) // every - 1         # this application's ring
                kv, shared = cache["shared_kv"], params.shared_attn
                x = _shared_block(
                    cfg, shared, x, x0, lambda h: attn.attn_decode(
                        shared.attn, h, attn.KVCache(kv.k[g], kv.v[g]), idx,
                        window=cfg.window_for(True), tp=tp,
                        **_attn_kw(cfg))[0], tp)
    x = rms_norm(params.final_norm.scale, x, cfg.norm_eps)
    return _lm_head(params, cfg, x, tp), cache
