"""llama-3.2-vision-90b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
Every 5th layer is a gated cross-attention layer over (stubbed) vision
embeddings; the ViT encoder + projector are STUBS per the carve-out —
``input_specs`` provides (B, n_image_tokens, d_model) patch embeddings.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,
    cross_attn_every=5,
    n_image_tokens=1024,
)

LAYOUT = dict(nodes=4, fsdp=4, model=16, micro=2, momentum_dtype="bfloat16",
              grads_dtype="bfloat16", long_500k="sliding_window")
