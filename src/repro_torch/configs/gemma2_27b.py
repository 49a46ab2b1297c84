"""gemma2-27b [dense] — local+global alternating, logit softcap [arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
Sliding window 4096 on alternating (even) layers; attn softcap 50, final 30;
GeGLU; tied embeddings.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    local_global=True,
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_kind="geglu",
    tie_embeddings=True,
)

LAYOUT = dict(nodes=8, fsdp=2, model=16, micro=4, momentum_dtype=None,
              grads_dtype=None, long_500k="sliding_window")
