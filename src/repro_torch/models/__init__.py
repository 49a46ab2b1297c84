"""Model substrate of the port: the decoder stacks of every family."""
from .model import (ModelConfig, Model, decode_step_paged, forward,  # noqa: F401
                    forward_prefill, init, param_count,
                    params_view)
