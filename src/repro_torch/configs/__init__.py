"""Architecture configs (one module per arch) + registry.

A copy of the JAX package's registry.  The arch modules are plain data;
every family runs in this package.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.model import ModelConfig

ARCHS = [
    "mamba2_1p3b",
    "granite_34b",
    "musicgen_large",
    "gemma2_27b",
    "llama32_vision_90b",
    "zamba2_1p2b",
    "qwen3_0p6b",
    "granite_moe_3b_a800m",
    "deepseek_67b",
    "dbrx_132b",
]

_ALIAS = {
    "mamba2-1.3b": "mamba2_1p3b",
    "granite-34b": "granite_34b",
    "musicgen-large": "musicgen_large",
    "gemma2-27b": "gemma2_27b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen3-0.6b": "qwen3_0p6b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-67b": "deepseek_67b",
    "dbrx-132b": "dbrx_132b",
}


def get_config(arch: str) -> ModelConfig:
    mod_name = _ALIAS.get(arch, arch.replace("-", "_").replace(".", "p"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def get_layout(arch: str) -> dict:
    """Mesh factorization + per-arch runtime knobs (the train driver reads
    ``momentum_dtype``)."""
    mod_name = _ALIAS.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return dict(mod.LAYOUT)


def reduced_config(cfg: ModelConfig, n_layers: int = 2,
                   d_model: int | None = None) -> ModelConfig:
    """Smoke-test variant: same family/blocks, tiny dims (<=512 d_model,
    <=4 experts), CPU-runnable."""
    d_model = min(cfg.d_model, d_model or 256)
    head_dim = min(cfg.head_dim, 64)
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    upd = dict(
        n_layers=max(n_layers, cfg.shared_attn_every and 7 or n_layers,
                     cfg.cross_attn_every and cfg.cross_attn_every or n_layers),
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        n_image_tokens=min(cfg.n_image_tokens, 16),
        d_state=min(cfg.d_state, 16) if cfg.d_state else 0,
        ssm_head_dim=min(cfg.ssm_head_dim, 32),
        ssd_chunk=8,
        remat=False,
    )
    if cfg.n_experts:
        upd["n_experts"] = min(cfg.n_experts, 4)
        upd["top_k"] = min(cfg.top_k, 2)
    if cfg.shared_attn_every:
        upd["n_layers"] = 7           # 1 group of 3 + remainder
        upd["shared_attn_every"] = 3
    if cfg.cross_attn_every:
        upd["n_layers"] = 6           # 2 groups of (2 self + 1 cross)
        upd["cross_attn_every"] = 3
    return dataclasses.replace(cfg, **upd)
