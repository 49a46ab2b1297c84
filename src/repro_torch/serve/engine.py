"""Continuous-batching serve engine: scheduler plans -> bucketed
executables over a paged KV pool.

Mirrors the JAX package's ``serve/engine.py``.  Each :meth:`ServeEngine.step`
runs at most one batched prefill (all admissions this step padded into one
``(Bb, Lb)`` call of :func:`repro_torch.models.model.forward_prefill`, whose
per-layer KV is scattered straight into the page pool) and one batched
decode (:func:`repro_torch.models.model.decode_step_paged` over every
running request, each at its OWN absolute position).  Batch and sequence
dims are bucketed to powers of two; the "executables" are eager callables
cached in a :class:`repro_torch.core.cache.CompileCache` under the JAX
engine's keys, ``("prefill", Bb, Lb)`` and ``("decode", Bb)``.

Padded rows of a bucket point their page tables at the TRASH page and
their logits are dropped, so they never touch a live request's state.  The
pool is updated in place.

Sampling is per-request: ``temperature=0`` is greedy argmax of the f32
logits on the host; otherwise a ``torch.Generator`` seeded from (seed,
rid, n_generated) draws the token, so a request's stream does not depend
on how it was co-batched (it cannot reproduce the JAX ``fold_in`` stream).
The audio family's tokens are frames of K codes: prompts (P, K), token
buffers (Bb, Lb, K) and (Bb, 1, K), and one frame sampled per step, the
argmax of each codebook's logits or K independent draws, one per
codebook row.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.cache import CompileCache
from ..device import resolve_device
from ..models import model as M
from .pages import TRASH_PAGE, PageAllocator, init_page_pool, page_bytes, \
    pages_needed
from .scheduler import Request, Scheduler

__all__ = ["ServeEngine"]


def _bucket(n: int, lo: int = 1) -> int:
    """Next power of two >= n (floored at lo) -- the executable shape."""
    b = lo
    while b < n:
        b *= 2
    return b


class ServeEngine:
    """Step-loop serving over a paged KV pool (continuous batching)."""

    def __init__(self, cfg: M.ModelConfig, params: M.Model, *, n_pages: int,
                 page_size: int = 16, max_seq: int = 256,
                 max_batch: int = 8, prefill_token_budget: int = 256,
                 temperature: float = 0.0, seed: int = 0,
                 pool_dtype=torch.bfloat16, max_cached_executables: int = 32,
                 compile_cache: CompileCache | None = None, device="cuda"):
        M._check_paged(cfg)
        self.device = resolve_device(device)
        param_dev = params.embed.device
        if param_dev.type != self.device.type:
            raise ValueError(f"params live on {param_dev}, the engine runs "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.page_size = page_size
        self.max_seq = max_seq
        self.pmax = pages_needed(max_seq, page_size)
        self.pool = init_page_pool(cfg, n_pages=n_pages, page_size=page_size,
                                   dtype=pool_dtype, device=self.device)
        self.pool_dtype = pool_dtype
        self.alloc = PageAllocator(n_pages)
        self.sched = Scheduler(self.alloc, page_size=page_size,
                               max_batch=max_batch,
                               prefill_token_budget=prefill_token_budget)
        self.temperature = temperature
        self.seed = seed
        # pass a shared cache to reuse executables across engines
        self.compile_cache = compile_cache if compile_cache is not None \
            else CompileCache(max_entries=max_cached_executables)
        self.finished: list[Request] = []
        self._next_rid = 0
        self.n_steps = 0
        self.decoded_tokens = 0
        self.prefill_calls = 0
        self.decode_calls = 0

    # -- request intake ----------------------------------------------------

    def submit(self, prompt, max_new: int, arrival: float = 0.0) -> Request:
        prompt = np.asarray(prompt, np.int32)
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if prompt.shape[0] + max_new > self.max_seq:
            raise ValueError(
                f"request needs {prompt.shape[0] + max_new} tokens > "
                f"max_seq={self.max_seq}")
        req = Request(rid=self._next_rid, prompt=prompt, max_new=max_new,
                      arrival=arrival)
        self._next_rid += 1
        self.sched.submit(req)
        return req

    # -- bucketed executables ---------------------------------------------

    def _prefill_exe(self, Bb: int, Lb: int):
        cfg = self.cfg

        def build():
            def fn(params, tokens, positions, pool, page_idx, slot_idx,
                   last_idx):
                logits, (k, v) = M.forward_prefill(params, cfg, tokens,
                                                   positions=positions)
                # (L, B, S, Kv, hd) -> (L, Kv, B, S, hd) to match the pool's
                # advanced-index layout at dims (pages, slots); in place
                pool["k"][:, :, page_idx, slot_idx] = \
                    k.permute(0, 3, 1, 2, 4).to(pool["k"].dtype)
                pool["v"][:, :, page_idx, slot_idx] = \
                    v.permute(0, 3, 1, 2, 4).to(pool["v"].dtype)
                rows = torch.arange(logits.shape[0], device=logits.device)
                return logits[rows, last_idx], pool

            return fn

        return self.compile_cache.get(("prefill", Bb, Lb), build)

    def _decode_exe(self, Bb: int):
        cfg, page_size = self.cfg, self.page_size

        def build():
            def fn(params, token, pool, page_table, positions):
                return M.decode_step_paged(params, cfg, token, pool,
                                           page_table, positions,
                                           page_size=page_size)

            return fn

        return self.compile_cache.get(("decode", Bb), build)

    # -- sampling ----------------------------------------------------------

    def _sample(self, logits_row: np.ndarray, req: Request):
        """logits_row: (V,) f32 -- audio: (K, V).  Greedy at temperature
        0; otherwise a draw from a generator seeded by (seed, rid, step),
        for audio K independent draws, one per codebook row.  Returns an
        int (audio: a (K,) int32 array)."""
        if self.temperature == 0.0:
            tok = np.argmax(logits_row, axis=-1)
        else:
            state = np.random.SeedSequence(
                [self.seed, req.rid, len(req.generated)]).generate_state(1)[0]
            gen = torch.Generator().manual_seed(int(state))
            probs = torch.softmax(
                torch.from_numpy(logits_row) / self.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)[..., 0].numpy()
        if self.cfg.family == "audio":
            return tok.astype(np.int32)
        return int(tok)

    def _token_shape(self, *lead) -> tuple:
        """A token buffer's shape: ``lead``, and K for audio frames."""
        if self.cfg.family == "audio":
            return lead + (self.cfg.n_codebooks,)
        return lead

    # -- step loop ---------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _run_prefill(self, reqs: list[Request], now: float) -> None:
        toks = [r.prefill_tokens() for r in reqs]
        Bb = _bucket(len(reqs))
        Lb = _bucket(max(t.shape[0] for t in toks), lo=self.page_size)
        tokens = np.zeros(self._token_shape(Bb, Lb), np.int32)
        page_idx = np.full((Bb, Lb), TRASH_PAGE, np.int64)
        slot_idx = np.broadcast_to(
            np.arange(Lb, dtype=np.int64) % self.page_size, (Bb, Lb)).copy()
        last_idx = np.zeros((Bb,), np.int64)
        for i, (r, t) in enumerate(zip(reqs, toks)):
            n = t.shape[0]
            tokens[i, :n] = t
            pages = np.asarray(r.pages, np.int64)
            page_idx[i, :n] = pages[np.arange(n) // self.page_size]
            last_idx[i] = n - 1
        positions = np.broadcast_to(np.arange(Lb, dtype=np.int32), (Bb, Lb)).copy()
        exe = self._prefill_exe(Bb, Lb)
        last_logits, self.pool = exe(
            self.params, self._dev(tokens), self._dev(positions), self.pool,
            self._dev(page_idx), self._dev(slot_idx), self._dev(last_idx))
        self.prefill_calls += 1
        last_logits = last_logits.float().cpu().numpy()
        for i, r in enumerate(reqs):
            if not r.generated:          # fresh: sample the first token
                r.generated.append(self._sample(last_logits[i], r))
                if r.t_first_token is None:
                    r.t_first_token = now
                self._maybe_finish(r, now)
            # resumed requests re-filled their pages; logits are dropped

    def _run_decode(self, reqs: list[Request], now: float) -> None:
        Bb = _bucket(len(reqs))
        tokens = np.zeros(self._token_shape(Bb, 1), np.int32)
        positions = np.zeros((Bb,), np.int32)
        page_table = np.full((Bb, self.pmax), TRASH_PAGE, np.int32)
        for i, r in enumerate(reqs):
            tokens[i, 0] = r.generated[-1]
            positions[i] = r.cache_len()
            page_table[i, :len(r.pages)] = r.pages
        exe = self._decode_exe(Bb)
        logits, self.pool = exe(self.params, self._dev(tokens), self.pool,
                                self._dev(page_table), self._dev(positions))
        self.decode_calls += 1
        logits = logits[:, 0].float().cpu().numpy()
        for i, r in enumerate(reqs):
            r.generated.append(self._sample(logits[i], r))
            self.decoded_tokens += 1
            if r.t_first_token is None:
                r.t_first_token = now
            self._maybe_finish(r, now)

    def _maybe_finish(self, req: Request, now: float) -> None:
        if req.done:
            req.t_finish = now
            self.sched.finish(req)
            self.finished.append(req)

    @torch.no_grad()
    def step(self, now: float = 0.0) -> bool:
        """One engine step.  Returns True if any work ran."""
        plan = self.sched.plan()
        if plan.decode:
            self._run_decode(plan.decode, now)
        if plan.prefill:
            self._run_prefill(plan.prefill, now)
        if not plan.empty:
            self.n_steps += 1
        return not plan.empty

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drive steps until every submitted request finishes."""
        for _ in range(max_steps):
            if not self.step():
                if not (self.sched.waiting or self.sched.running):
                    return self.finished
                raise RuntimeError(
                    f"stalled: {self.sched.stats()} -- pool too small for "
                    f"even one request?")
        raise RuntimeError(f"no convergence in {max_steps} steps")

    # -- introspection -----------------------------------------------------

    def peak_kv_bytes(self) -> int:
        return self.alloc.peak_used * page_bytes(self.cfg, self.page_size,
                                                 self.pool_dtype)

    def stats(self) -> dict:
        s = self.sched.stats()
        s.update(steps=self.n_steps, decoded_tokens=self.decoded_tokens,
                 finished=len(self.finished),
                 prefill_calls=self.prefill_calls,
                 decode_calls=self.decode_calls,
                 peak_kv_bytes=self.peak_kv_bytes(),
                 compile_cache=self.compile_cache.stats())
        return s
