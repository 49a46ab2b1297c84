"""Launch of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

The kernel replaces the JAX package's Pallas TPU kernel
(``kernels/flash_attention/kernel.py: flash_attention_kernel``); the
source's header says what bounds it on the H100 and how its design
answers.  This module checks what the kernel takes, allocates the output,
and launches on PyTorch's current stream; it never synchronises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _fn():
    fn = build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _F, _F, _P]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int | None = None,
                         attn_cap: float | None = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, Kv, D), CUDA, one dtype (f32 or bf16),
    D in {64, 128}.  Returns (B, S, H, D) in q's dtype."""
    B, S, H, D = q.shape
    T, Kv = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         "takes one of float32 or bfloat16")
    if D not in (64, 128):
        raise ValueError(f"head_dim {D}: the kernel takes 64 or 128")
    if k.shape != (B, T, Kv, D) or v.shape != k.shape or H % Kv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not causal and T % 64:
        # as the TPU wrapper: padded key columns are masked only by causality
        raise ValueError("non-causal attention needs T a multiple of 64")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    q, k, v = (build.aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, S, T, H, Kv, D, build.DTYPE_CODES[q.dtype], int(causal),
                   window or 0, int(attn_cap is not None),
                   float(attn_cap or 0.0), D ** -0.5,
                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    return out
