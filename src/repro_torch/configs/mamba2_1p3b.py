"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048 (attention-free) vocab=50280, ssm_state=128.
Mamba-2 1.3B card: expand=2 (d_inner 4096), headdim=64, ngroups=1, d_conv=4.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    d_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    d_conv=4,
    ssm_n_groups=1,
    tie_embeddings=True,
)

LAYOUT = dict(nodes=16, fsdp=1, model=16, micro=8, momentum_dtype=None,
              grads_dtype=None, long_500k="native")
