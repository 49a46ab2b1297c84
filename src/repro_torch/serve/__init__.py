"""Serving plane of the port: paged KV cache + continuous batching.

Layers (host -> device):
  pages.py      -- page pool tensors + free-list :class:`PageAllocator`
  scheduler.py  -- admission / page growth / LIFO preemption (numpy only)
  engine.py     -- :class:`ServeEngine` step loop over bucketed callables

The decode attention kernel lives in
:mod:`repro_torch.kernels.paged_attention`; the model-side entry points are
:func:`repro_torch.models.model.forward_prefill` and
:func:`repro_torch.models.model.decode_step_paged`.
"""
from .engine import ServeEngine
from .pages import TRASH_PAGE, PageAllocator, init_page_pool, page_bytes, \
    pages_needed
from .scheduler import Request, Scheduler, StepPlan

__all__ = ["ServeEngine", "PageAllocator", "init_page_pool", "page_bytes",
           "pages_needed", "TRASH_PAGE", "Request", "Scheduler", "StepPlan"]
