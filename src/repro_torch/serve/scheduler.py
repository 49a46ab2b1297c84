"""Continuous-batching request scheduler: admission, page growth,
preemption.

Requests flow WAITING -> RUNNING -> FINISHED, with RUNNING -> WAITING
preemption when the page pool runs dry.  Each engine step asks for a
:class:`StepPlan`: which waiting requests to prefill this step (admission,
under a token budget so one giant prompt cannot starve decode latency) and
which running requests decode one token.  The scheduler owns the
:class:`repro_torch.serve.pages.PageAllocator`; the engine owns the device
arrays and executables.

Cache-length invariant for a RUNNING request: the pool holds
``len(prompt) + len(generated) - 1`` tokens -- everything except the last
generated token, which is fed (and written) by the next decode step.  A
preempted request keeps its generated tokens and releases its pages; on
re-admission its history minus that last token is re-prefilled, so a
greedy continuation is exactly the one it would have produced unpreempted.

Preemption policy is LIFO (the latest-admitted running request is the
victim), which frees the most recently granted pages and keeps the oldest
requests -- closest to finishing -- on the device.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np

from .pages import PageAllocator, pages_needed

__all__ = ["Request", "StepPlan", "Scheduler"]

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (P,) int32 -- audio: (P, K)
    max_new: int
    arrival: float = 0.0
    state: str = WAITING
    generated: list = dataclasses.field(default_factory=list)
    pages: list[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    t_first_token: float | None = None
    t_finish: float | None = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new

    def history(self) -> np.ndarray:
        """prompt + generated tokens (the full causal record)."""
        if not self.generated:
            return self.prompt
        gen = np.asarray(self.generated, dtype=self.prompt.dtype)
        return np.concatenate([self.prompt, gen], axis=0)

    def prefill_tokens(self) -> np.ndarray:
        """What (re-)admission must run through prefill: the history minus
        the trailing generated token (fed by the next decode step)."""
        h = self.history()
        return h[:-1] if self.generated else h

    def cache_len(self) -> int:
        """Tokens currently materialized in the pool (see invariant)."""
        n = self.prompt_len + len(self.generated)
        return n - 1 if self.generated else n


@dataclasses.dataclass
class StepPlan:
    prefill: list[Request]
    decode: list[Request]
    preempted: list[Request]

    @property
    def empty(self) -> bool:
        return not (self.prefill or self.decode)


class Scheduler:
    """Admission/eviction over a shared page pool (continuous batching)."""

    def __init__(self, allocator: PageAllocator, *, page_size: int,
                 max_batch: int = 32, prefill_token_budget: int = 512):
        self.alloc = allocator
        self.page_size = page_size
        self.max_batch = max_batch
        self.prefill_token_budget = prefill_token_budget
        self.waiting: deque[Request] = deque()
        self.running: list[Request] = []
        self.n_preemptions = 0

    # -- lifecycle ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        req.state = WAITING
        self.waiting.append(req)

    def finish(self, req: Request) -> None:
        req.state = FINISHED
        self.running.remove(req)
        if req.pages:
            self.alloc.free(req.pages)
            req.pages = []

    def _preempt(self, req: Request) -> None:
        self.n_preemptions += 1
        req.preemptions += 1
        req.state = WAITING
        self.running.remove(req)
        if req.pages:
            self.alloc.free(req.pages)
            req.pages = []
        self.waiting.appendleft(req)    # resumes before fresh arrivals

    # -- planning ----------------------------------------------------------

    def _grow_for_decode(self, req: Request) -> bool:
        """Ensure req's pages cover its next decode write; allocate the
        next page at a boundary.  Returns False if the pool is dry."""
        need = pages_needed(req.cache_len() + 1, self.page_size)
        while len(req.pages) < need:
            got = self.alloc.alloc(1)
            if got is None:
                return False
            req.pages.extend(got)
        return True

    def plan(self) -> StepPlan:
        """One engine step: decode every running request (preempting LIFO
        when a page-boundary allocation fails), then admit waiting
        requests under the prefill token budget."""
        preempted: list[Request] = []
        decode: list[Request] = []
        for req in list(self.running):
            if req.state != RUNNING:
                continue                 # preempted earlier in this loop
            while not self._grow_for_decode(req):
                victim = self.running[-1]
                self._preempt(victim)
                preempted.append(victim)
                if victim is req:
                    break
            if req.state == RUNNING:
                decode.append(req)
        # a late preemption may have evicted a request already planned
        decode = [r for r in decode if r.state == RUNNING]

        prefill: list[Request] = []
        budget = self.prefill_token_budget
        while self.waiting and len(self.running) < self.max_batch:
            req = self.waiting[0]
            ptoks = int(req.prefill_tokens().shape[0])
            if prefill and ptoks > budget:
                break                    # first prefill always admitted
            pages = self.alloc.alloc(pages_needed(ptoks, self.page_size))
            if pages is None:
                break                    # pool dry: wait, never thrash
            self.waiting.popleft()
            req.pages = pages
            req.state = RUNNING
            self.running.append(req)
            prefill.append(req)
            budget -= ptoks

        return StepPlan(prefill=prefill, decode=decode, preempted=preempted)

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict[str, Any]:
        return {
            "waiting": len(self.waiting),
            "running": len(self.running),
            "free_pages": self.alloc.free_pages,
            "used_pages": self.alloc.used_pages,
            "peak_pages": self.alloc.peak_used,
            "preemptions": self.n_preemptions,
        }
