"""Plain PyTorch version of the gossip-mix kernel.

out = w_self * x + sum_d w_d * recv_d, accumulated in f32 and cast to x's
dtype, as the JAX package's ``kernels/gossip_mix/ref.py``.  Each term is
added in place (``add_(alpha=w)``), so the version holds one f32
accumulator however large the buffer: at the training payload that is the
difference between one and three extra payload-sized buffers.  The
wrapper in ``ops.py`` takes it for CPU tensors; ``chip_smoke.py`` holds
the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch


def gossip_mix_ref(x: torch.Tensor, recvs, w_self: float, ws) -> torch.Tensor:
    acc = x.float() * w_self
    for r, w in zip(recvs, ws):
        acc.add_(r.float(), alpha=w)
    return acc.to(x.dtype)
