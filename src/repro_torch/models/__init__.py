"""Model substrate of the port: the dense decoder stack so far."""
from .model import (ModelConfig, Model, decode_step_paged, forward,  # noqa: F401
                    forward_prefill, init, param_count,
                    params_view)
