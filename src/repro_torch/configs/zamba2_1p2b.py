"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64.
One SHARED (weight-tied) attention+MLP block applied every 6 mamba layers,
consuming concat(hidden, embedding) -> d_model projection (zamba2 style).
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    d_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    d_conv=4,
    ssm_n_groups=1,
    shared_attn_every=6,
    tie_embeddings=True,
)

LAYOUT = dict(nodes=16, fsdp=1, model=16, micro=8, momentum_dtype=None,
              grads_dtype=None, long_500k="native")
