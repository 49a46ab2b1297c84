"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=2048 32H (GQA kv=32, i.e. MHA) d_ff=8192 vocab=2048.
4 EnCodec codebooks (delay pattern): token input (B, S, 4), 4 lm heads.
The EnCodec frontend is a STUB per the assignment carve-out —
``input_specs`` provides the token streams directly.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    n_codebooks=4,
)

LAYOUT = dict(nodes=16, fsdp=1, model=16, micro=8, momentum_dtype=None,
              grads_dtype=None, long_500k="sliding_window")
