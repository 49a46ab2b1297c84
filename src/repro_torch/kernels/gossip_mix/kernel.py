"""Launch of the CUDA gossip-mix kernel (``csrc/gossip_mix.cu``).

The kernel replaces the JAX package's Pallas TPU kernel
(``kernels/gossip_mix/kernel.py: gossip_mix_kernel``); the source's header
says what bounds it on the H100 and how its design answers.  This module
checks what the kernel takes, builds the receive table (the receives'
pointers, then their weights as float64, one int64 tensor copied to the
card), allocates the output and launches on PyTorch's current stream; it
never synchronises.  Element counts cross ctypes as 64-bit integers: the
training payload holds more than 2^31 elements.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64


@functools.cache
def _fn():
    fn = build.load("gossip_mix").gossip_mix
    fn.argtypes = [_P, _P, _I, _F, _P, _L, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def gossip_mix_cuda(x: torch.Tensor, recvs, w_self: float,
                    ws) -> torch.Tensor:
    """x and every recvs[d]: CUDA, one shape and dtype (f32 or bf16).
    Returns ``w_self * x + sum_d ws[d] * recvs[d]`` in x's dtype."""
    recvs = list(recvs)
    if len(recvs) != len(ws):
        raise ValueError(f"{len(recvs)} receives but {len(ws)} weights")
    if not (x.is_cuda and all(r.is_cuda and r.device == x.device
                              for r in recvs)):
        raise ValueError("gossip_mix_cuda takes CUDA tensors on one device")
    if x.dtype not in build.DTYPE_CODES or any(r.dtype != x.dtype
                                               for r in recvs):
        raise ValueError("the kernel takes one dtype, float32 or bfloat16; "
                         f"got {x.dtype} / {[r.dtype for r in recvs]}")
    if any(r.shape != x.shape for r in recvs):
        raise ValueError(f"shapes {tuple(x.shape)} / "
                         f"{[tuple(r.shape) for r in recvs]}")
    x = build.aligned(x)
    recvs = [build.aligned(r) for r in recvs]
    out = torch.empty_like(x)
    deg = len(recvs)
    table = torch.empty(2 * deg, dtype=torch.int64)
    table[:deg] = torch.tensor([r.data_ptr() for r in recvs],
                               dtype=torch.int64)
    table[deg:].view(torch.float64)[:] = torch.tensor(
        [float(w) for w in ws], dtype=torch.float64)
    table = table.pin_memory().to(x.device, non_blocking=True)
    with torch.cuda.device(x.device):
        rc = _fn()(x.data_ptr(), table.data_ptr(), deg, float(w_self),
                   out.data_ptr(), x.numel(), build.DTYPE_CODES[x.dtype],
                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gossip_mix kernel launch failed: cudaError {rc}")
    return out
