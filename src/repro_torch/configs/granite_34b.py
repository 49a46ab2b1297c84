"""granite-34b [dense] — llama-arch code model [arXiv:2405.04324].

88L d_model=6144 48H (GQA kv=1, i.e. MQA) d_ff=24576 vocab=49152.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=10000.0,
)

LAYOUT = dict(nodes=8, fsdp=2, model=16, micro=2, momentum_dtype="bfloat16",
              grads_dtype=None, long_500k="sliding_window")
