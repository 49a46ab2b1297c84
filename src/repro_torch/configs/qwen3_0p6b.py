"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
)

LAYOUT = dict(nodes=16, fsdp=1, model=16, micro=16, momentum_dtype=None,
              grads_dtype=None, long_500k="sliding_window")
