"""Serving CLI: continuous-batching engine over a paged KV pool, driven
by a Poisson arrival trace.

Mirrors the JAX package's ``launch/serve.py`` (``poisson_trace``,
``serve_trace``, ``latency_summary`` and ``main``).  ``main`` builds a
:class:`repro_torch.serve.ServeEngine` on ``--device`` (the card by
default) and feeds it requests as their (virtual) arrival times pass,
printing latency percentiles, throughput, and page/compile-cache
statistics.  It serves the REDUCED config, as the JAX CLI does; the
full-width path is driven by ``chip_smoke.py``.

:func:`generate` is the reference's legacy one-batch loop over
``models.model.decode_step``: the serving baseline of the dense and moe
families (a fast prefill, one ``forward_prefill`` through the flash-attention
kernel whose k/v fill a ring cache, then ``attn_decode`` per token), and
the way the families the paged engine refuses are served (ssm and hybrid
prefill and decode token by token over their SSM caches and, for hybrid,
the shared block's rings; vlm token by token over its self layers'
rings, with ``image_embeds`` handed to every step).  The audio family's
prompts are (B, P, K) frames, in ``generate`` as in the engine (``main
--arch musicgen-large``).  ``generate`` adds no CLI (the JAX ``main``
serves paged families only):

  >>> from repro_torch import configs
  >>> from repro_torch.launch.serve import generate
  >>> from repro_torch.models import model as M
  >>> cfg = configs.reduced_config(configs.get_config("zamba2-1.2b"))
  >>> params = M.init(cfg, 0, device="cpu")
  >>> prompts = torch.zeros((2, 8), dtype=torch.long)
  >>> generate(cfg, params, prompts, max_new=4, temperature=0.0,
  ...          device="cpu").shape
  torch.Size([2, 12])

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch granite-moe-3b-a800m       # the experts dropless
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch musicgen-large --temperature 0.8   # K draws a frame
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..device import resolve_device
from ..models import model as M
from ..models.attention import KVCache
from ..serve import ServeEngine


def poisson_trace(n: int, rate: float, mean_prompt: int, max_new: int,
                  vocab: int, seed: int, n_codebooks: int = 0):
    """[(arrival_s, prompt, max_new)] with exponential inter-arrivals
    (numpy only: the same trace as the JAX package's for the same seed)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    trace = []
    for a in arrivals:
        plen = max(1, int(rng.poisson(mean_prompt)))
        shape = (plen, n_codebooks) if n_codebooks else (plen,)
        prompt = rng.integers(0, vocab, shape, dtype=np.int64)
        trace.append((float(a), prompt, max_new))
    return trace


def serve_trace(engine: ServeEngine, trace, *, realtime: bool = False):
    """Feed a trace through the engine.  ``realtime=False`` runs a virtual
    clock: wall time plus the idle gaps skipped by jumping to the next
    arrival whenever the engine goes idle.  Returns the clock at the end.

    Unlike the JAX driver, whose clock falls back to wall time on the step
    after a jump (so latencies after an idle gap can come out negative),
    the skipped gaps are kept, so the clock never runs backwards."""
    pending = sorted(trace, key=lambda r: r[0])
    t0 = time.perf_counter()
    skipped = 0.0
    now = 0.0
    i = 0
    while i < len(pending) or engine.sched.waiting or engine.sched.running:
        if realtime:
            now = time.perf_counter() - t0
        while i < len(pending) and pending[i][0] <= now:
            a, prompt, max_new = pending[i]
            engine.submit(prompt, max_new, arrival=a)
            i += 1
        worked = engine.step(now=now)
        if not realtime:
            now = time.perf_counter() - t0 + skipped
        if not worked and not engine.sched.waiting and not engine.sched.running:
            if i < len(pending):
                if pending[i][0] > now:         # idle: jump to next arrival
                    skipped += pending[i][0] - now
                    now = pending[i][0]
            else:
                break
    return now


def latency_summary(finished):
    first = np.array([r.t_first_token - r.arrival for r in finished])
    total = np.array([r.t_finish - r.arrival for r in finished])

    def pct(a, q):
        return float(np.percentile(a, q)) if len(a) else float("nan")

    return {
        "first_token_p50_s": pct(first, 50), "first_token_p99_s": pct(first, 99),
        "total_p50_s": pct(total, 50), "total_p99_s": pct(total, 99),
    }


def sample_tokens(logits: torch.Tensor, temperature: float,
                  gen: torch.Generator | None = None) -> torch.Tensor:
    """One token per row.  logits: (B, V) -- audio: (B, K, V).  Returns
    (B, 1) (audio: (B, 1, K)).  ``temperature == 0`` is greedy argmax of
    the f32 logits, as the engine samples; otherwise a draw from
    softmax(logits / temperature) with ``gen``, one independent draw per
    codebook.  (The reference's ``fold_in`` key streams cannot be
    reproduced.)"""
    lg = logits.float()
    if temperature == 0:
        cur = lg.argmax(-1)
    else:
        probs = torch.softmax(lg / temperature, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        cur = torch.multinomial(flat, 1, generator=gen).reshape(
            probs.shape[:-1])
    return cur.unsqueeze(1)


def _ring_fill(k_all, v_all, cache_len: int, dtype) -> KVCache:
    """A ring ``KVCache`` filled from full-sequence prefill k/v.

    k_all, v_all: (L, B, S, Kv, hd).  Ring slot ``s`` holds token ``t(s) =
    (S-1) - mod(S-1-s, cache_len)`` (the newest token whose position is
    congruent to s), so for S > cache_len only the last cache_len tokens
    survive -- the state the token-by-token loop would have left; slots
    with t(s) < 0 are zero.  Returns k, v as (L, B, Kv, cache_len, hd)."""
    S = k_all.shape[2]
    s = torch.arange(cache_len, device=k_all.device)
    t_s = (S - 1) - torch.remainder(S - 1 - s, cache_len)
    valid = (t_s >= 0)[:, None]
    tc = t_s.clamp(min=0)

    def take(a):
        a = a.permute(0, 1, 3, 2, 4).to(dtype)          # (L, B, Kv, S, hd)
        return torch.where(valid, a[:, :, :, tc], 0.0)

    return KVCache(take(k_all), take(v_all))


def prefill_cache(cfg, params, prompts, *, cache_len: int = 128,
                  mode: str = "auto", image_embeds=None):
    """The prompt's decode state: ``(logits (B, 1, V) at its last token
    (audio: (B, 1, K, V)), cache)``, with an f32 cache as the reference's
    ``generate`` keeps.  prompts: (B, P) (audio: (B, P, K)).

    mode "auto" takes the fast path for the uniform-attention families
    (:data:`models.model.PAGED_FAMILIES`) when no ``image_embeds`` are
    given: one ``forward_prefill``, which runs the flash-attention kernel
    once per layer, and its k/v ring-filled (:func:`_ring_fill`).
    "loop", and every other family, feeds the prompt token by token
    through ``decode_step`` (with ``image_embeds``, as the reference)."""
    if mode not in ("auto", "loop"):
        raise ValueError(f"prefill mode {mode!r}: 'auto' or 'loop'")
    device = params.embed.device
    toks = torch.as_tensor(prompts, device=device).long()
    if (mode == "auto" and cfg.family in M.PAGED_FAMILIES
            and image_embeds is None):
        logits, (k, v) = M.forward_prefill(params, cfg, toks)
        return logits[:, -1:], {"kv": _ring_fill(k, v, cache_len,
                                                 torch.float32)}
    cache = M.init_cache(cfg, batch=toks.shape[0], cache_len=cache_len,
                         dtype=torch.float32, device=device)
    for t in range(toks.shape[1]):
        logits, cache = M.decode_step(params, cfg, toks[:, t:t + 1], cache,
                                      t, image_embeds=image_embeds)
    return logits, cache


def generate(cfg, params, prompts, *, max_new: int = 32,
             cache_len: int = 128, temperature: float = 1.0, seed: int = 0,
             image_embeds=None, prefill: str = "auto",
             device="cuda") -> torch.Tensor:
    """prompts: (B, P) int (audio: (B, P, K)).  Returns (B, P + max_new)
    (audio: (B, P + max_new, K)) on ``device``.

    The reference's legacy one-batch serving loop: :func:`prefill_cache`
    (fast for the uniform-attention families unless ``prefill="loop"`` or
    ``image_embeds`` are given, token by token otherwise), then
    ``max_new`` tokens are sampled (``sample_tokens``, with a
    ``torch.Generator`` seeded from ``seed``) and fed back through
    ``decode_step``.  ``image_embeds`` (B, T, d), the vlm family's, go to
    every decode step.
    """
    device = resolve_device(device)
    if params.embed.device.type != device.type:
        raise ValueError(f"params live on {params.embed.device}, generate "
                         f"runs on {device}")
    toks = torch.as_tensor(prompts, device=device).long()
    if image_embeds is not None:
        image_embeds = torch.as_tensor(image_embeds, device=device)
    plen = toks.shape[1]
    gen = torch.Generator(device=device).manual_seed(seed)
    out = [toks]
    with torch.no_grad():
        logits, cache = prefill_cache(cfg, params, toks,
                                      cache_len=cache_len, mode=prefill,
                                      image_embeds=image_embeds)
        for t in range(plen, plen + max_new):
            cur = sample_tokens(logits[:, -1], temperature, gen)
            out.append(cur)
            logits, cache = M.decode_step(params, cfg, cur, cache, t,
                                          image_embeds=image_embeds)
    return torch.cat(out, dim=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--n-requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson arrival rate (requests/s)")
    ap.add_argument("--mean-prompt", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--pages", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.reduced_config(configs.get_config(args.arch))
    params = M.init(cfg, args.seed, device=device)
    engine = ServeEngine(cfg, params, n_pages=args.pages,
                         page_size=args.page_size, max_seq=args.max_seq,
                         max_batch=args.max_batch,
                         temperature=args.temperature, seed=args.seed,
                         device=device)
    trace = poisson_trace(args.n_requests, args.rate, args.mean_prompt,
                          args.max_new, cfg.vocab_size, args.seed,
                          n_codebooks=cfg.n_codebooks)
    wall = serve_trace(engine, trace)
    st = engine.stats()
    lat = latency_summary(engine.finished)
    new_tokens = sum(len(r.generated) for r in engine.finished)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"arch={cfg.name} on {where}: served {len(engine.finished)} "
          f"requests, {new_tokens} new tokens in {wall:.2f}s "
          f"({new_tokens / max(wall, 1e-9):.1f} tok/s)")
    print(f"latency: first-token p50={lat['first_token_p50_s']:.3f}s "
          f"p99={lat['first_token_p99_s']:.3f}s | total "
          f"p50={lat['total_p50_s']:.3f}s p99={lat['total_p99_s']:.3f}s")
    print(f"pages: peak={st['peak_pages']}/{args.pages} "
          f"(peak KV {st['peak_kv_bytes'] / 1e6:.2f} MB), "
          f"preemptions={st['preemptions']}")
    cc = st["compile_cache"]
    print(f"compile cache: {cc['entries']} executables, {cc['hits']} hits / "
          f"{cc['misses']} misses / {cc['evictions']} evictions")


if __name__ == "__main__":
    main()
