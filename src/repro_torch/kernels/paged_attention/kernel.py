"""Launch of the CUDA paged-attention kernel (``csrc/paged_attention.cu``).

The kernel replaces the JAX package's Pallas TPU kernel
(``kernels/paged_attention/kernel.py: paged_attention_kernel``); the
source's header says what bounds it on the H100 and how its design
answers.  This module checks what the kernel takes, sizes the split over
the sequence from the shapes alone (``split_plan``; ``lengths`` is never
read on the host, so a call can be captured in a CUDA graph), allocates
the output and the call's scratch (the split partials and the merge's
counters, which the kernel's entry point zeroes on the stream), and
launches on PyTorch's current stream; it never synchronises.  Nothing is
kept between calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

SPLIT_TOKENS = 128      # tokens a split at least, where the page allows
WAVE_BLOCKS = 264       # 2 blocks on each of the H100's 132 SMs
MAX_SPLIT_PAGES = 128   # csrc/paged_attention.cu: page entries of a split
MAX_SPLITS = 1024       # the merge keeps 8 x n_split weights in 32 KB
GROUP_ROWS = 8          # csrc/paged_attention.cu: query rows a block at most


def split_plan(pmax: int, page_size: int, rows: int = 1) -> tuple[int, int]:
    """(pages_per_split, n_split) for a page table of ``pmax`` columns and
    ``rows`` = sequences x kv heads x head groups: splits of at least
    ``SPLIT_TOKENS`` tokens (and one page), and long enough that the grid
    of rows x n_split blocks is about one wave of ``WAVE_BLOCKS``.  Shapes
    only: the values of ``lengths`` never enter."""
    pps = min(MAX_SPLIT_PAGES, pmax, max(1, SPLIT_TOKENS // page_size,
                                         -(-pmax * rows // WAVE_BLOCKS)))
    n_split = -(-pmax // pps)
    if n_split > MAX_SPLITS:
        raise ValueError(f"page table of {pmax} pages of {page_size}: more "
                         f"than {MAX_SPLITS} splits of {MAX_SPLIT_PAGES} "
                         "pages")
    return pps, n_split


@functools.cache
def _fn():
    fn = build.load("paged_attention").paged_attention_fwd
    fn.argtypes = [_P] * 9 + [_I] * 11 + [_F, _F, _P]
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
    n_hg = -(-(H // Kv) // GROUP_ROWS)    # query-row groups a kv head
    pages_per_split, n_split = split_plan(Pmax, page_size, B * Kv * n_hg)
    out = torch.empty_like(q)
    # one scratch for the partials, f32 acc (B, H, n_split, D) then m and l
    # (2, B, H, n_split), and the merge's int32 counters (B, Kv * n_hg);
    # none where one split writes out directly
    scratch, part_acc, part_ml, counters = None, None, None, None
    if n_split > 1:
        n_acc, n_ml = B * H * n_split * D, 2 * B * H * n_split
        scratch = torch.empty(n_acc + n_ml + B * Kv * n_hg,
                              dtype=torch.float32, device=q.device)
        part_acc = scratch.data_ptr()
        part_ml = part_acc + 4 * n_acc
        counters = part_ml + 4 * n_ml
    with torch.cuda.device(q.device):
        rc = _fn()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                   page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                   part_ml, part_acc, counters, B, H, Kv, D,
                   n_pages, page_size, Pmax, pages_per_split,
                   build.DTYPE_CODES[q.dtype], window or 0,
                   int(attn_cap is not None), float(attn_cap or 0.0),
                   D ** -0.5, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    return out
