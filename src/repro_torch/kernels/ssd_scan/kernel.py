"""Launch of the CUDA SSD-scan kernel (``csrc/ssd_scan.cu``).

The kernel replaces the JAX package's Pallas TPU kernel
(``kernels/ssd_scan/kernel.py: ssd_scan_kernel``); the source's header says
what bounds it on the H100 and how its design answers.  This module checks
what the kernel takes, allocates the outputs and the scratch (the chunk
states and chunk decays passed between its three launches), and launches
on PyTorch's current stream; it never synchronises.  Where the kernel
takes its tensor-core branch (``tensor_core_branch``) it also allocates
the chunks' shared scores C Bᵀ, which the first launch computes once per
group.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

_P, _I = ctypes.c_void_p, ctypes.c_int

HEAD_DIMS = (32, 64)
STATE_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 256
TC_CHUNKS = (64, 128)   # csrc/ssd_scan.cu: ssd_chunk_out_pair's chunks


def tensor_core_branch(chunk: int, n: int) -> bool:
    """Whether the kernel runs its 3xTF32 tensor-core branch at chunk
    length ``chunk`` (after ``ops.chunk_len``) and d_state ``n``; the FMA
    branch runs otherwise.  Chosen by shape alone."""
    return chunk in TC_CHUNKS and n % 64 == 0


@functools.cache
def _fn():
    fn = build.load("ssd_scan").ssd_scan_fwd
    fn.argtypes = [_P] * 10 + [_I] * 7 + [_P]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_cuda(x, dt, A, B, C, *, chunk: int):
    """x: (b,s,h,p); dt: (b,s,h); A: (h,); B, C: (b,s,g,n), all CUDA
    float32; ``chunk`` divides s.  Returns (y (b,s,h,p), h_final
    (b,h,p,n)), float32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    ts = (x, dt, A, B, C)
    if not all(t.is_cuda for t in ts):
        raise ValueError("ssd_scan_cuda takes CUDA tensors")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("dtypes " + "/".join(str(t.dtype) for t in ts)
                         + ": the kernel takes float32 (mamba2_apply casts "
                         "to float32 before the scan)")
    if (dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, g, n)
            or C.shape != B.shape or g < 1 or h % g):
        raise ValueError(f"shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} B {tuple(B.shape)} "
                         f"C {tuple(C.shape)}")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"head_dim {p}, d_state {n}: the kernel takes "
                         f"head_dim in {HEAD_DIMS}, d_state in {STATE_DIMS}")
    if not (0 < chunk <= MAX_CHUNK) or s % chunk:
        raise ValueError(f"chunk {chunk} must divide s {s} and be <= "
                         f"{MAX_CHUNK}")
    x, dt, A, B, C = (build.aligned(t) for t in ts)
    nc = s // chunk
    y = torch.empty_like(x)
    h_final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    states = torch.empty((b, nc, h, p, n), dtype=torch.float32,
                         device=x.device)
    chunk_cum = torch.empty((b, h, nc), dtype=torch.float32, device=x.device)
    # the shared scores C B^T of each chunk and group, where the
    # tensor-core branch runs
    scores = (torch.empty((b, nc, g, chunk, chunk), dtype=torch.float32,
                          device=x.device)
              if tensor_core_branch(chunk, n) else None)
    with torch.cuda.device(x.device):
        rc = _fn()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                   C.data_ptr(), y.data_ptr(), h_final.data_ptr(),
                   states.data_ptr(), chunk_cum.data_ptr(),
                   None if scores is None else scores.data_ptr(), b, s, h, g,
                   p, n, chunk, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {rc}")
    return y, h_final
