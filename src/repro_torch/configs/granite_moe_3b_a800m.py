"""granite-moe-3b-a800m [moe] — fine-grained MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base family].

32L d_model=1536 24H (GQA kv=8) d_ff=512 (per expert) vocab=49155,
MoE 40 experts top-8 (per assignment).
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    capacity_factor=1.25,
)

LAYOUT = dict(nodes=16, fsdp=1, model=16, micro=8, momentum_dtype=None,
              grads_dtype=None, long_500k="sliding_window")
