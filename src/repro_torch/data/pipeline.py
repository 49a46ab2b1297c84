"""Synthetic LM data pipeline with controllable per-node heterogeneity.

A copy of the JAX package's ``data/pipeline.py`` (numpy only): the same
seed gives bit-identical batches.  Each decentralized node samples from
its own bigram language model; ``hetero`` in [0, 1] interpolates between
one shared bigram table (homogeneous, b = 0) and fully node-specific
tables (b > 0, eq. 4 / Assumption A.3).

Deterministic, seeded, stateless iteration (step -> batch): no iterator
state to save.  So a process keeps the last few tables and batches it
sampled: at a 152k vocabulary a step's batch costs seconds of host time,
and runs of one configuration would draw the same batches again.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Per-node bigram generators over a shared vocab."""
    vocab_size: int
    n_nodes: int
    hetero: float = 0.0
    seed: int = 0
    n_modes: int = 8   # bigram table rank (keeps tables small for big vocabs)

    def sample(self, step: int, per_node_batch: int, seq_len: int,
               n_codebooks: int = 0) -> np.ndarray:
        """Returns int32 tokens (n_nodes, per_node_batch, seq_len[, K])."""
        out = _sampled(self, step, per_node_batch, seq_len).copy()
        if n_codebooks:
            reps = np.stack([np.roll(out, k, axis=-1)
                             for k in range(n_codebooks)], axis=-1)
            return reps
        return out


@functools.lru_cache(maxsize=4)
def _tables_of(ds: SyntheticLM) -> list:
    """Each node's (u, w) bigram factors (read only)."""
    rng = np.random.default_rng(ds.seed)
    V, M = ds.vocab_size, ds.n_modes
    shared_u = rng.standard_normal((V, M)).astype(np.float32)
    shared_w = rng.standard_normal((M, V)).astype(np.float32)
    outs = []
    for i in range(ds.n_nodes):
        r = np.random.default_rng(ds.seed * 1000 + i + 1)
        u = ((1 - ds.hetero) * shared_u
             + ds.hetero * r.standard_normal((V, M)).astype(np.float32))
        w = ((1 - ds.hetero) * shared_w
             + ds.hetero * r.standard_normal((M, V)).astype(np.float32))
        outs.append((u, w))
    return outs


@functools.lru_cache(maxsize=64)
def _sampled(ds: SyntheticLM, step: int, per_node_batch: int,
             seq_len: int) -> np.ndarray:
    """Step ``step``'s tokens (n_nodes, per_node_batch, seq_len); callers
    get a copy."""
    out = np.empty((ds.n_nodes, per_node_batch, seq_len), np.int32)
    for i, (u, w) in enumerate(_tables_of(ds)):
        rng = np.random.default_rng(
            (ds.seed + 17) * 10_000_019 + step * 977 + i)
        tok = rng.integers(0, ds.vocab_size, size=per_node_batch)
        seq = np.empty((per_node_batch, seq_len), np.int32)
        for t in range(seq_len):
            seq[:, t] = tok
            logits = u[tok] @ w / np.sqrt(ds.n_modes)  # (B, V)
            logits -= logits.max(axis=-1, keepdims=True)
            p = np.exp(2.0 * logits)
            p /= p.sum(axis=-1, keepdims=True)
            cum = np.cumsum(p, axis=-1)
            r = rng.random((per_node_batch, 1))
            tok = (r > cum).sum(axis=-1).astype(np.int32)
            tok = np.minimum(tok, ds.vocab_size - 1)
        out[i] = seq
    return out


def make_batches(dataset: SyntheticLM, per_node_batch: int, seq_len: int,
                 *, n_codebooks: int = 0, start_step: int = 0):
    """Infinite generator of (step, CPU int32 tensor batch)."""
    step = start_step
    while True:
        arr = dataset.sample(step, per_node_batch, seq_len, n_codebooks)
        yield step, torch.from_numpy(arr)
        step += 1
