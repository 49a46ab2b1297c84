"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per expert) vocab=100352,
MoE 16 experts top-4.  Momentum kept in bf16 to fit 16 GB/chip HBM at
nodes=4 x fsdp=4 x model=16 (see DESIGN §4).
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    top_k=4,
    capacity_factor=1.25,
    rope_theta=500000.0,
)

LAYOUT = dict(nodes=4, fsdp=4, model=16, micro=2, momentum_dtype="bfloat16",
              grads_dtype="bfloat16", param_dtype="bfloat16",
              long_500k="sliding_window")
