"""Launch of the CUDA paged-attention kernel (``csrc/paged_attention.cu``).

The kernel replaces the JAX package's Pallas TPU kernel
(``kernels/paged_attention/kernel.py: paged_attention_kernel``); the
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
    fn = build.load("paged_attention").paged_attention_fwd
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, _I, _F, _F, _P]
    fn.restype = ctypes.c_int
    return fn


def paged_attention_cuda(q, k_pages, v_pages, page_table, lengths, *,
                         window: int | None = None,
                         attn_cap: float | None = None) -> torch.Tensor:
    """q: (B, H, D); k_pages, v_pages: (Kv, n_pages, page_size, D) of q's
    dtype (f32 or bf16); page_table: (B, Pmax) int32; lengths: (B,) int32;
    all CUDA, D in {64, 128}.  Returns (B, H, D) in q's dtype."""
    B, H, D = q.shape
    Kv, n_pages, page_size, _ = k_pages.shape
    Pmax = page_table.shape[1]
    tensors = (q, k_pages, v_pages, page_table, lengths)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_attention_cuda takes CUDA tensors")
    if q.dtype not in build.DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k_pages.dtype}/{v_pages.dtype}: "
                         "the kernel takes one of float32 or bfloat16")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page_table and lengths must be int32")
    if D not in (64, 128):
        raise ValueError(f"head_dim {D}: the kernel takes 64 or 128")
    if k_pages.shape[3] != D or v_pages.shape != k_pages.shape or H % Kv \
            or page_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"shapes q {tuple(q.shape)} pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         f"page_table {tuple(page_table.shape)} "
                         f"lengths {tuple(lengths.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    q, k_pages, v_pages = (build.aligned(t) for t in (q, k_pages, v_pages))
    page_table, lengths = page_table.contiguous(), lengths.contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _fn()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                   page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                   B, H, Kv, D, n_pages, page_size, Pmax, build.DTYPE_CODES[q.dtype],
                   window or 0, int(attn_cap is not None),
                   float(attn_cap or 0.0), D ** -0.5,
                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    return out
