#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (``src/repro_torch``) on one NVIDIA
H100: builds the CUDA kernels from the checkout, holds each against its
plain PyTorch version, runs full-width qwen3-0.6b against the CPU, serves
a Poisson trace through the continuous-batching engine, and trains
full-width qwen3-0.6b (cut to 8 layers) with DmSGD on 4 nodes over the
one-peer exponential graph.

  python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero before the result lines:
  1. device   -- a CUDA device is required; prints nvidia-smi's name and
                 power limit
  2. build    -- nvcc builds every kernel of csrc/ in parallel
  3. kernels  -- each kernel vs its plain version at its path's shapes
                 (attention: bf16, tolerance 2e-2 as tests/test_kernels.py;
                 gossip_mix: f32 1e-5 and bf16 2e-2, degrees 1 and 3, on
                 (4, 2^27) and an odd tail), timed with CUDA events beside
                 its plain version, the one PyTorch call computing the same
                 function (where there is one), and its bound on the card
  4. model    -- full-width qwen3-0.6b (random weights from --seed):
                 prefill of 2 x 64 tokens and 4 paged decode steps on the
                 card against the same weights on the CPU
  5. serve    -- ServeEngine over 16 Poisson requests (mean prompt 256,
                 32 new tokens, greedy): the serving main path; the launch
                 counters are zeroed before and read after it
  6. train    -- launch.train.run: qwen3-0.6b at full width cut to 8
                 layers (the 28-layer 4-node state does not fit in 80 GB),
                 4 nodes, one_peer_exp, dmsgd beta 0.9, per-node batch
                 2 x 128 tokens, 6 steps, hetero 0.5: the training main
                 path, counters zeroed before and read after; then K1 at the
                 training payload, the Lemma-1 check, and the same 6 steps
                 with the plain combine, which must agree
Then one ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (dense, no sparsity) at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12       # outside the tensor cores
PEAK_BYTES = 3.35e12
KERNEL_TOL = 2e-2            # tests/test_kernels.py:15, bf16
GOSSIP_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:189
# the training phase run twice, kernel and plain combine: six steps of
# bf16 activations apart only by the combine's rounding (and any
# run-to-run order of the backward's atomics), relative to max-abs
TRAIN_TOL = 2e-4
LEMMA_TOL = 1e-5             # tests/test_gossip.py:67-76
GOSSIP_BIG = (4, 1 << 27)    # 2^29 elements: 2.1 GB in f32
GOSSIP_TAIL = (3, 1_000_003)  # not a multiple of the 16-byte vector
# bf16 through 28 layers on two devices (different sum orders and bf16
# roundings in every matmul): start from 2e-2 of the logits' max-abs
MODEL_TOL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls (inputs stay in L2 when they
    fit, as in the serving path where they were just produced)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float,
          peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def within(got, want, tol: float) -> bool:
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= tol + tol * w.abs()).all())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_phase(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref
    B, S, H, Kv, D = 4, 512, 16, 8, 128
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
               for s in ((B, S, H, D), (B, S, Kv, D), (B, S, Kv, D)))
    errs = []
    for window, cap in ((None, None), (128, 50.0)):
        got = ops.flash_attention(q, k, v, window=window, attn_cap=cap)
        torch.cuda.synchronize()
        want = ref.attention_ref(q, k, v, window=window, attn_cap=cap)
        errs.append(max_err(got, want))
        check(within(got, want, KERNEL_TOL),
              f"flash_attention window={window} cap={cap}: max abs err "
              f"{errs[-1]} beyond {KERNEL_TOL}")
        log(f"  flash_attention B={B} S=T={S} H={H} Kv={Kv} D={D} bf16 "
            f"window={window} cap={cap}: max abs err {errs[-1]:.3g}")
    ms = time_ms(lambda: ops.flash_attention(q, k, v))
    plain_ms = time_ms(lambda: ref.attention_ref(q, k, v), iters=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    pairs = S * (S + 1) // 2                     # visible (row, col) pairs
    flops = 4 * B * H * D * pairs
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * Kv * D)
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"  flash_attention: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": f"B={B} S=T={S} H={H} Kv={Kv} D={D} bf16 causal"}


def paged_phase(torch, dev):
    import numpy as np

    from repro_torch.kernels.paged_attention import ops, ref
    B, H, Kv, D, ps, pmax = 8, 16, 8, 128, 16, 64
    rng = np.random.default_rng(2)
    lengths = rng.integers(1, pmax * ps + 1, B)
    lengths[0] = pmax * ps                        # one full-length sequence
    lengths[-1] = 1                               # one trash-padded row
    per_seq = -(-lengths // ps)
    n_pages = 1 + int(per_seq.sum())
    table = np.zeros((B, pmax), np.int32)
    order = 1 + rng.permutation(n_pages - 1)
    at = 0
    for b in range(B - 1):
        table[b, :per_seq[b]] = order[at:at + per_seq[b]]
        at += per_seq[b]
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(B, H, D, generator=g, device=dev).to(torch.bfloat16)
    kp, vp = (torch.randn(Kv, n_pages, ps, D, generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    tab = torch.from_numpy(table).to(dev)
    lens = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    errs = []
    for window, cap in ((None, None), (256, 30.0)):
        got = ops.paged_attention(q, kp, vp, tab, lens, window=window,
                                  attn_cap=cap)
        torch.cuda.synchronize()
        want = ref.paged_attention_ref(q, kp, vp, tab, lens, window=window,
                                       attn_cap=cap)
        errs.append(max_err(got, want))
        check(bool(torch.isfinite(got).all()), "paged_attention: non-finite")
        check(within(got, want, KERNEL_TOL),
              f"paged_attention window={window} cap={cap}: max abs err "
              f"{errs[-1]} beyond {KERNEL_TOL}")
        log(f"  paged_attention B={B} H={H} Kv={Kv} D={D} page={ps} "
            f"Pmax={pmax} lengths={lengths.tolist()} bf16 window={window} "
            f"cap={cap}: max abs err {errs[-1]:.3g}")
    ms = time_ms(lambda: ops.paged_attention(q, kp, vp, tab, lens))
    plain_ms = time_ms(lambda: ref.paged_attention_ref(q, kp, vp, tab, lens),
                       iters=5)
    visible = int(lengths.sum())
    flops = 4 * H * D * visible
    nbytes = (2 * visible * Kv * D * 2            # the K and V it must read
              + 2 * 2 * B * H * D                  # q and out
              + 4 * (table.size + B))              # page table and lengths
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"  paged_attention: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}); no single PyTorch call "
        f"computes it")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:89",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": f"B={B} H={H} Kv={Kv} D={D} page={ps} Pmax={pmax} "
                     f"{visible} visible tokens bf16"}


def gossip_phase(torch, dev):
    from repro_torch.kernels.gossip_mix import ops, ref
    g = torch.Generator(device=dev).manual_seed(4)
    big = GOSSIP_BIG
    cases = [(big, dt, deg) for dt in (torch.float32, torch.bfloat16)
             for deg in (1, 3)]
    cases += [(GOSSIP_TAIL, torch.float32, 3),
              (GOSSIP_TAIL, torch.bfloat16, 1)]
    errs = []
    for shape, dtype, degree in cases:
        x, *recvs = (torch.randn(shape, generator=g, device=dev).to(dtype)
                     for _ in range(degree + 1))
        w_self = 1.0 / (degree + 1)
        ws = (w_self,) * degree
        got = ops.gossip_mix(x, recvs, w_self=w_self, ws=ws)
        torch.cuda.synchronize()
        want = ref.gossip_mix_ref(x, recvs, w_self, ws)
        tol = GOSSIP_TOL[str(dtype).removeprefix("torch.")]
        errs.append(max_err(got, want))
        check(got.dtype == dtype and got.shape == x.shape,
              f"gossip_mix {shape} {dtype}: got {got.dtype} {tuple(got.shape)}")
        check(within(got, want, tol),
              f"gossip_mix {shape} {dtype} degree {degree}: max abs err "
              f"{errs[-1]} beyond {tol}")
        log(f"  gossip_mix {shape} {str(dtype)[6:]} degree {degree}: max abs "
            f"err {errs[-1]:.3g} (tolerance {tol})")
        del x, recvs, got, want
    # the train path's case: f32, degree 1, weights 1/2
    x, r = (torch.randn(big, generator=g, device=dev) for _ in range(2))
    ms = time_ms(lambda: ops.gossip_mix(x, [r], w_self=0.5, ws=(0.5,)))
    plain_ms = time_ms(lambda: ref.gossip_mix_ref(x, [r], 0.5, (0.5,)),
                       iters=10)
    library_ms = time_ms(lambda: torch.lerp(x, r, 0.5))
    n = x.numel()
    bound_ms, bound_by = bound(3 * n, 3 * 4 * n, PEAK_F32_FLOPS)
    log(f"  gossip_mix {big} f32 degree 1: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, lerp {library_ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by})")
    return {"name": "gossip_mix", "route": "cuda",
            "source": "src/repro_torch/csrc/gossip_mix.cu",
            "replaces": "src/repro/kernels/gossip_mix/kernel.py:34",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": f"{big} f32 degree 1 (library: torch.lerp(x, r, 0.5))"}


# ---------------------------------------------------------------------------
# phase 4: full-width model, card against CPU
# ---------------------------------------------------------------------------

def _prefill_decode(torch, M, cfg, model, tokens, table, device, steps, ps,
                    fed=None):
    """forward_prefill of ``tokens``, its k/v scattered into a fresh page
    pool through ``table`` (as the engine does), then ``steps`` paged decode
    steps.  Feeds ``fed`` tokens, or the run's own greedy picks when None.
    Returns the last-position logits of every step (f32, on the CPU) and
    the tokens fed."""
    B, P = tokens.shape
    pool = {n: torch.zeros(cfg.n_layers, cfg.n_kv_heads,
                           1 + int(table.max()), ps, cfg.head_dim,
                           dtype=torch.bfloat16, device=device)
            for n in ("k", "v")}
    tab = table.to(device)
    pos = torch.arange(P, device=device)
    page_idx, slot_idx = tab[:, pos // ps].long(), (pos % ps).expand(B, P)
    logits, (k, v) = M.forward_prefill(model, cfg, tokens.to(device))
    pool["k"][:, :, page_idx, slot_idx] = k.permute(0, 3, 1, 2, 4)
    pool["v"][:, :, page_idx, slot_idx] = v.permute(0, 3, 1, 2, 4)
    out = [logits[:, -1].float().cpu()]
    fed = list(fed) if fed is not None else []
    for s in range(steps):
        if len(fed) <= s:
            fed.append(out[-1].argmax(-1)[:, None])
        positions = torch.full((B,), P + s, dtype=torch.int32, device=device)
        logits, pool = M.decode_step_paged(model, cfg, fed[s].to(device),
                                           pool, tab, positions, page_size=ps)
        out.append(logits[:, 0].float().cpu())
    return torch.stack(out), fed


def model_phase(torch, dev, cfg, params, seed):
    import numpy as np

    from repro_torch.models import model as M
    B, P, steps, ps = 2, 64, 4, 16
    n_per = -(-(P + steps) // ps)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int64))
    table = torch.from_numpy(
        (1 + rng.permutation(B * n_per)).reshape(B, n_per).astype(np.int32))
    with torch.no_grad():
        t0 = time.perf_counter()
        gpu, fed = _prefill_decode(torch, M, cfg, params, tokens, table, dev,
                                   steps, ps)
        t_gpu = time.perf_counter() - t0
        cpu_params = M.Model(cfg, device="cpu")
        cpu_params.load_state_dict({n: t.cpu() for n, t in
                                    params.state_dict().items()})
        t0 = time.perf_counter()
        cpu, _ = _prefill_decode(torch, M, cfg, cpu_params, tokens, table,
                                 "cpu", steps, ps, fed=fed)
        t_cpu = time.perf_counter() - t0
    check(bool(torch.isfinite(gpu).all()), "model: non-finite logits")
    check(tuple(gpu.shape) == (steps + 1, B, cfg.vocab_size),
          f"model: logits shape {tuple(gpu.shape)}")
    scale = float(cpu.abs().max())
    err = float((gpu - cpu).abs().max())
    per_step = [round(float((gpu[i] - cpu[i]).abs().max()), 5)
                for i in range(steps + 1)]
    agree = float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())
    log(f"  full-width {cfg.name}: prefill {B}x{P} + {steps} paged decode "
        f"steps; card {t_gpu:.2f} s (first use), CPU {t_cpu:.2f} s")
    log(f"  logits card vs CPU: max abs err {err:.5g} (per step {per_step}); "
        f"logits max-abs {scale:.5g}; tolerance {MODEL_TOL} x max-abs = "
        f"{MODEL_TOL * scale:.5g}; greedy agreement {agree:.3f}")
    check(err <= MODEL_TOL * scale,
          f"model: card vs CPU logits differ by {err} > {MODEL_TOL * scale}")


# ---------------------------------------------------------------------------
# phase 5: serve, the main path
# ---------------------------------------------------------------------------

def serve_phase(torch, dev, cfg, params, seed):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch import serve as S
    from repro_torch.serve import ServeEngine, pages_needed
    n_req, mean_prompt, max_new, ps, max_batch, max_seq = 16, 256, 32, 16, 8, 512
    # a burst (1000 requests/s): all 16 arrive within milliseconds, so the
    # engine runs at its max batch and tokens/s is its own throughput
    trace = S.poisson_trace(n_req, 1000.0, mean_prompt, max_new,
                            cfg.vocab_size, seed)
    longest = max(len(p) for _, p, _ in trace) + max_new
    check(longest <= max_seq, f"serve: a request needs {longest} > {max_seq}")
    n_pages = 1 + n_req * pages_needed(max_seq, ps)   # nothing is preempted
    engine = ServeEngine(cfg, params, n_pages=n_pages, page_size=ps,
                         max_seq=max_seq, max_batch=max_batch, seed=seed,
                         device=dev)
    torch.cuda.synchronize()
    fa_ops.flash_attention.launches = 0
    pa_ops.paged_attention.launches = 0
    wall = S.serve_trace(engine, trace)
    torch.cuda.synchronize()
    launches = {"flash_attention": fa_ops.flash_attention.launches,
                "paged_attention": pa_ops.paged_attention.launches}
    st = engine.stats()
    lat = S.latency_summary(engine.finished)
    new_tokens = sum(len(r.generated) for r in engine.finished)
    check(len(engine.finished) == n_req,
          f"serve: {len(engine.finished)} of {n_req} requests finished")
    check(all(len(r.generated) == max_new for r in engine.finished),
          "serve: a request stopped short of max_new")
    check(all(0 <= t < cfg.vocab_size for r in engine.finished
              for t in r.generated), "serve: token out of vocab")
    check(st["preemptions"] == 0, f"serve: {st['preemptions']} preemptions")
    want = {"flash_attention": cfg.n_layers * st["prefill_calls"],
            "paged_attention": cfg.n_layers * st["decode_calls"]}
    for name in want:
        check(launches[name] > 0, f"serve: {name} never launched")
        check(launches[name] == want[name],
              f"serve: {name} launched {launches[name]} times, expected "
              f"{want[name]} (n_layers x calls)")
    log(f"  served {len(engine.finished)} requests, {new_tokens} new tokens "
        f"in {wall:.3f} s: {new_tokens / wall:.1f} tokens/s; "
        f"{st['prefill_calls']} prefill calls, {st['decode_calls']} decode "
        f"steps, {st['steps']} engine steps")
    log(f"  latency: first-token p50 {lat['first_token_p50_s']:.4f} s "
        f"p99 {lat['first_token_p99_s']:.4f} s | total p50 "
        f"{lat['total_p50_s']:.4f} s p99 {lat['total_p99_s']:.4f} s")
    log(f"  pages: peak {st['peak_pages']}/{n_pages} (peak KV "
        f"{st['peak_kv_bytes'] / 1e6:.2f} MB); compile cache "
        f"{st['compile_cache']}")
    log(f"  launches on the main path: {launches} (= n_layers {cfg.n_layers}"
        f" x prefill calls / decode steps)")
    per_call = {"flash_attention": st["prefill_calls"],
                "paged_attention": st["decode_calls"]}
    return launches, per_call


# ---------------------------------------------------------------------------
# phase 6: train, the training main path
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["--full", "--layers", "8", "--nodes", "4",
              "--topology", "one_peer_exp", "--optimizer", "dmsgd",
              "--beta", "0.9", "--batch", "2", "--seq", "128", "--steps", "6",
              "--hetero", "0.5", "--log-every", "1", "--device", "cuda"]


def _max_abs(tree) -> float:
    return max(float(v.abs().max()) for v in tree.values())


def _max_diff(a, b) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def train_phase(torch, dev, seed):
    from repro_torch.core import flatbuf, gossip
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.gossip_mix import ops as gm_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch import train as T
    args = T.parse_args(TRAIN_ARGV + ["--seed", str(seed)])
    log(f"  {args.arch} at full width, depth cut to {args.layers} layers "
        f"(28 layers x 4 nodes of x, m, g and the gossip payload do not "
        f"fit in 80 GB); {args.nodes} nodes, {args.topology}, "
        f"{args.optimizer} beta {args.beta}, batch {args.batch} x "
        f"{args.seq} tokens per node, {args.steps} steps, hetero "
        f"{args.hetero}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.flash_attention.launches = 0
    pa_ops.paged_attention.launches = 0
    gm_ops.gossip_mix.launches = 0
    res = T.run(args)
    torch.cuda.synchronize()
    launches = {"gossip_mix": gm_ops.gossip_mix.launches,
                "flash_attention": fa_ops.flash_attention.launches,
                "paged_attention": pa_ops.paged_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plan, hist = res["plan"], res["history"]
    losses = [h["loss"] for h in hist]
    check(len(losses) == args.steps and all(
        l == l and abs(l) < float("inf") for l in losses),
        f"train: losses {losses}")
    check(launches["gossip_mix"] == args.steps,
          f"train: gossip_mix launched {launches['gossip_mix']} times, "
          f"expected {args.steps} (one f32 group, one shift per step)")
    check(launches["flash_attention"] == 0 and
          launches["paged_attention"] == 0,
          f"train: attention kernels launched {launches}")
    check(plan.num_compiled == 2,
          f"train: {plan.num_compiled} executables, expected 2")
    step_ms = 1e3 * sorted(res["step_s"][1:])[len(res["step_s"][1:]) // 2]
    tokens = args.nodes * args.batch * args.seq
    cfg = res["config"]
    log(f"  losses {[round(l, 5) for l in losses]}")
    cons = [f"{h['consensus']:.4g}" for h in hist]
    log(f"  consensus per step {cons}")
    log(f"  step ms {[round(1e3 * t, 3) for t in res['step_s']]}; median "
        f"of steps 2-{args.steps} {step_ms:.3f} ms = "
        f"{tokens / step_ms * 1e3:.1f} tokens/s; peak allocated "
        f"{peak_gb:.3f} GB; launches {launches}; "
        f"{plan.num_compiled} executables, cache {plan.cache_stats()}")

    # K1 at the training payload: (m_next, x_next) packed, one f32 group
    layout, bufs = flatbuf.pack((res["state"].momentum, res["params"]))
    check(len(bufs) == 1, f"train: {len(bufs)} payload groups")
    buf = bufs[0]
    recv = torch.roll(buf, plan.realization(args.steps).shifts[0][0], 0)
    pay_ms = time_ms(lambda: gm_ops.gossip_mix(buf, [recv], w_self=0.5,
                                               ws=(0.5,)), iters=5, warmup=1)
    pay_bound, _ = bound(3 * buf.numel(), 3 * 4 * buf.numel(),
                         PEAK_F32_FLOPS)
    log(f"  K1 at the training payload {tuple(buf.shape)} f32 "
        f"({buf.numel() / 2**31:.3f} x 2^31 elements): {pay_ms:.3f} ms, "
        f"bound {pay_bound:.3f} ms (bytes)")
    del layout, bufs, buf, recv

    # Lemma 1: tau = 2 one-peer rounds average the 4 nodes exactly
    mixed = res["params"]
    for k in range(2):
        mixed = plan.mix(k)(mixed)
    dev_max = 0.0
    for v in mixed.values():
        mean = v.mean(0, keepdim=True)
        dev_max = max(dev_max, float((v - mean).abs().max()))
        check(bool(((v - mean).abs() <= LEMMA_TOL + LEMMA_TOL * mean.abs())
                   .all()), "train: Lemma 1 check failed")
    log(f"  Lemma 1: after tau=2 rounds max deviation from the node mean "
        f"{dev_max:.3g} (tolerance rtol=atol={LEMMA_TOL})")
    del mixed

    # the same 6 steps with the plain combine
    x1, m1 = res["params"], res["state"].momentum
    del res
    gm_ops.gossip_mix.launches = 0
    gossip.set_kernel_mode("off")
    try:
        off = T.run(args)
    finally:
        gossip.set_kernel_mode("auto")
    check(gm_ops.gossip_mix.launches == 0, "train: the plain run launched K1")
    dx = _max_diff(x1, off["params"])
    dm = _max_diff(m1, off["state"].momentum)
    sx, sm = _max_abs(off["params"]), _max_abs(off["state"].momentum)
    log(f"  kernel vs plain combine after {args.steps} steps: params max "
        f"abs diff {dx:.3g} (max-abs {sx:.4g}), momentum {dm:.3g} (max-abs "
        f"{sm:.4g}); tolerance {TRAIN_TOL} x max-abs; plain-run losses "
        f"{[round(h['loss'], 5) for h in off['history']]}")
    check(dx <= TRAIN_TOL * sx and dm <= TRAIN_TOL * sm,
          f"train: kernel and plain runs differ (params {dx}, momentum {dm})")
    return {"launches": launches["gossip_mix"], "step_ms": step_ms,
            "tokens_per_s": tokens / step_ms * 1e3, "peak_gb": peak_gb,
            "train_payload_ms": pay_ms, "train_payload_bound_ms": pay_bound,
            "layers": cfg.n_layers}


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    log("phase 1: device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    log(f"  {smi_line}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.device_count()} device(s)")

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import model as M

    log("phase 2: build")
    t0 = time.perf_counter()
    secs = build.build()
    log(f"  built {list(secs)} in {time.perf_counter() - t0:.2f} s "
        f"(per kernel {dict((k, round(v, 2)) for k, v in secs.items())})")
    for name in build.KERNELS:
        log_path = build.library_path(name).with_suffix(".log")
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("phase 3: kernels against their plain versions")
    kernels = [flash_phase(torch, dev), paged_phase(torch, dev),
               gossip_phase(torch, dev)]
    torch.cuda.empty_cache()

    log("phase 4: full-width model, card against CPU")
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = configs.get_config("qwen3-0.6b")
    t0 = time.perf_counter()
    params = M.init(cfg, args.seed, device=dev)
    torch.cuda.synchronize()
    log(f"  init {cfg.name} ({M.param_count(params) / 1e6:.1f} M params, "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}) on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    model_phase(torch, dev, cfg, params, args.seed)

    log("phase 5: serve (the serving main path)")
    launches, per_call = serve_phase(torch, dev, cfg, params, args.seed)
    del params
    torch.cuda.empty_cache()

    log("phase 6: train (the training main path)")
    train = train_phase(torch, dev, args.seed)
    for k in kernels:
        if k["name"] == "gossip_mix":
            k["launches"] = train["launches"]
            k["launches_per_call"] = 1              # per train step
            k["train_payload_ms"] = train["train_payload_ms"]
            k["train_payload_bound_ms"] = train["train_payload_bound_ms"]
        else:
            k["launches"] = launches[k["name"]]
            k["launches_per_call"] = (k["launches"]
                                      // max(per_call[k["name"]], 1))

    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
