"""Paged KV cache: a shared page pool + a host-side free-list allocator.

Mirrors the JAX package's ``serve/pages.py``.  A sequence holding ``T``
tokens owns ``ceil(T / page_size)`` fixed-size pages of one pool per
layer, so KV memory scales with live tokens, not with the worst case.

Device side (:func:`init_page_pool`): ``{"k", "v"}`` tensors shaped
``(L, Kv, n_pages, page_size, head_dim)`` -- the per-layer pools the
paged-attention kernel gathers from via a page table.

Host side (:class:`PageAllocator`): a free-list over page indices with
all-or-nothing allocation and peak-usage tracking.  Page 0 is RESERVED as
the trash page: padded rows of a bucketed batch point their page tables at
it, so their writes land somewhere harmless.
"""
from __future__ import annotations

from collections import deque

import torch

from ..device import resolve_device
from ..models import model as M

__all__ = ["PageAllocator", "init_page_pool", "pages_needed", "page_bytes",
           "TRASH_PAGE"]

TRASH_PAGE = 0


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


def init_page_pool(cfg: M.ModelConfig, *, n_pages: int, page_size: int,
                   dtype=torch.bfloat16, device="cuda") -> dict:
    """Per-layer KV page pools for a supported config, zeroed, on
    ``device``."""
    M._check_paged(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, cfg.n_kv_heads, n_pages, page_size, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def page_bytes(cfg: M.ModelConfig, page_size: int,
               dtype=torch.bfloat16) -> int:
    """Device bytes one pool page costs across all layers (k AND v)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (2 * cfg.n_layers * cfg.n_kv_heads * page_size * cfg.head_dim
            * itemsize)


class PageAllocator:
    """Free-list allocator over pool page indices (page 0 reserved).

    ``alloc`` is all-or-nothing: it returns ``None`` rather than a partial
    grant, so the scheduler's admission/preemption logic sees one atomic
    can-I-fit decision.  ``peak_used`` tracks the high-water mark.
    """

    def __init__(self, n_pages: int, reserved: int = 1):
        if n_pages <= reserved:
            raise ValueError(f"pool of {n_pages} pages leaves nothing to "
                             f"allocate past {reserved} reserved")
        self.n_pages = n_pages
        self.reserved = reserved
        self._free: deque[int] = deque(range(reserved, n_pages))
        self.peak_used = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - self.reserved - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        got = [self._free.popleft() for _ in range(n)]
        self.peak_used = max(self.peak_used, self.used_pages)
        return got

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if not (self.reserved <= p < self.n_pages):
                raise ValueError(f"freeing page {p} outside pool")
        self._free.extend(pages)
        if len(self._free) > self.n_pages - self.reserved:
            raise RuntimeError("double free: free list exceeds pool")
