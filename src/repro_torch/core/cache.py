"""Keyed build-once caches shared across the core/launch layers.

A copy of the JAX package's ``core/cache.py``.  In this package an
"executable" is an eager callable: the serving engine keys one per
bucketed shape, ``("prefill", Bb, Lb)`` and ``("decode", Bb)``, exactly as
the JAX engine keys its jitted functions, so the hit/miss/evict counters
of the two engines agree.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable

__all__ = ["CompileCache"]


class CompileCache:
    """Keyed build-once cache (hashable key -> callable).

    ``max_entries`` bounds the cache with least-recently-used eviction, so
    a long process visiting fresh keys does not grow the dict for its
    whole lifetime.  Steady-state servers never evict (their working set
    of bucketed shapes is tiny).
    """

    def __init__(self, max_entries: int | None = None):
        self._cache: "OrderedDict" = OrderedDict()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, build: Callable[[], Any]):
        if key in self._cache:
            self.hits += 1
            self._cache.move_to_end(key)
            return self._cache[key]
        self.misses += 1
        val = self._cache[key] = build()
        if self.max_entries is not None and len(self._cache) > self.max_entries:
            self._cache.popitem(last=False)
            self.evictions += 1
        return val

    def stats(self) -> dict:
        """Hit/miss/eviction counters + current size.  A serving loop whose
        bucketed shapes are working: misses stop growing after warmup."""
        return {"entries": len(self._cache), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions}

    def __len__(self) -> int:
        return len(self._cache)

    def __contains__(self, key) -> bool:
        return key in self._cache
