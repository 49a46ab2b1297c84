"""deepseek-67b [dense] — llama-arch [arXiv:2401.02954].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10000.0,
)

LAYOUT = dict(nodes=4, fsdp=4, model=16, micro=2, momentum_dtype="bfloat16",
              grads_dtype=None, long_500k="sliding_window")
