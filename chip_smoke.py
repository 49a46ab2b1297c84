#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (``src/repro_torch``) on one NVIDIA
H100: builds the CUDA kernels from the checkout, holds each against its
plain PyTorch version, runs full-width qwen3-0.6b against the CPU, serves
a Poisson trace through the continuous-batching engine, trains
full-width qwen3-0.6b (cut to 8 layers) with DmSGD on 4 nodes over the
one-peer exponential graph, runs full-width mamba2-1.3b (the ssm
family): its forward through the SSD-scan kernel, and generate, and runs
full-width zamba2-1.2b (the hybrid family): its forward through the
SSD-scan and flash-attention kernels, decode, and generate, and trains
the ssm and hybrid families with d_adamw and qg_dmsgd, over random
matchings and the uniform one-peer order, with a checkpoint round trip,
then trains full-width qwen3-0.6b with simulated stragglers through the
runtime-valued gossip (deadline gating, loss-aware weights), runs
data-dependent skips, prints the paper's figures from the card, and
trains full-width qwen3-0.6b with int8 gossip payloads and with the
overlapped (one-step-delayed) pipeline, its delayed round on a side
stream, and runs full-width granite-moe-3b-a800m (the moe family): its
prefill and paged decode through the flash- and paged-attention kernels,
serving, generate, and training with the capacity dispatch, then
full-width musicgen-large (the audio family, frames of 4 codes) through
the same kernels, serving, generate and training, and
llama-3.2-vision-90b (the vlm family) cut to one group at full width: its
forward, decode and generate over image embeddings, and training at the
reduced width, then the four configs no other phase runs (gemma2-27b,
granite-34b, deepseek-67b, dbrx-132b) at full width through the paged
serving path, and the serving benchmark (bench_serve --quick) with its
structural gates, then the kernel and communication benchmarks
(bench_kernels, bench_comm --quick with its wire-bytes gate) and the
paper's LM-scale experiment (train_lm at the 100m preset, one-peer and
static exponential graphs on 8 nodes), and the gossip across processes:
the shard-native engine on a mesh of ranks sharing the card, and phase
6's training with one rank a node, then the overlapped trainer,
parallel_msgd, a checkpoint and runtime rounds on such meshes, fsdp- and
model-sharded training and a replica's model-sharded prefill, and last
the dry run: every arch,
input shape and mesh counted per chip on the meta device, and the
counter held on the card against meta.

  python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero before the result lines:
  1. device   -- a CUDA device is required; prints nvidia-smi's name and
                 power limit
  2. build    -- nvcc builds every kernel of csrc/ in parallel; prints
                 each function's registers, spills and static shared
                 memory, the HGMMA / UTMALDG count of K2's bf16 kernel and
                 the HGMMA count of K4's tensor-core kernels (cuobjdump
                 -sass), which must be non-zero
  3. kernels  -- each kernel vs its plain version at its path's shapes
                 (attention: bf16, tolerance 2e-2 as tests/test_kernels.py,
                 flash at the serving prefill's (4, 512, 16, 8, 128) and the
                 operations-bound (1, 4096, 16, 8, 128), and its f32 branch
                 at 2e-4; paged: the ragged batch, the serve decode shape
                 and one 8,192-token sequence, timed from CUDA-graph
                 replays over >= 4 copies of the pool, cold in L2;
                 gossip_mix: f32 1e-5 and bf16 2e-2, degrees 1 and 3, on
                 (4, 2^27) and an odd tail; ssd_scan: f32, 1e-3 x max(1,
                 max-abs) and on its tensor-core branch 5e-5 x max(1,
                 max-abs), at mamba2-1.3b's (1, 2048, 64, 64, 1, 128) with
                 the test draw of A and the model's A range, and a ragged
                 s = 1000, g = 2; at zamba2's (2, 2048, 64, 64, 1, 64) with
                 the model's A; K2 also at zamba2's (2, 2048, 32, 32, 64)
                 and at granite-moe's prefill bucket (4, 512, 24, 8, 64),
                 G 3, and musicgen's (4, 512, 32, 32, 64), G 1, its
                 kernel / sdpa printed beside zamba2's; K3 also at
                 granite-moe's decode step, B 8 at 257-288 tokens, H 24,
                 Kv 8, D 64: G 3 in groups of 4 rows, and at musicgen's,
                 H 32, Kv 32, D 64: G 1, one row a group; both at
                 phase 15's shapes: K2 at the prefill buckets (4, 512, H,
                 Kv, 128) of gemma2-27b (32, 16) with its window 4096 and
                 soft-cap 50, granite-34b (48, 1), deepseek-67b (64, 8)
                 and dbrx-132b (48, 8), and gemma2's (1, 6144, 32, 16, 128)
                 where the window bites; K3 at their decode steps, B 8 at
                 257-288 tokens, and one 6,148-token gemma2 sequence with
                 the window and cap: G 2, 48, 8 and 6),
                 timed with CUDA events beside
                 its plain version, the one PyTorch call computing the same
                 function (where there is one), and its bound on the card,
                 with the achieved TFLOP/s or GB/s and the share of the
                 bound (K1 and lerp timed in turns, and their ratio; K2
                 and SDPA in turns, each replayed from a CUDA graph so
                 that the wrapper's host time does not hide the kernel's;
                 gemma2's capped and windowed rows against a compiled
                 flex_attention, the cap as its score_mod and the causal
                 window as its block mask, held to the plain version too)
  4. model    -- full-width qwen3-0.6b (random weights from --seed):
                 prefill of 2 x 64 tokens and 4 paged decode steps on the
                 card against the same weights on the CPU
  5. serve    -- ServeEngine over 16 Poisson requests (mean prompt 256,
                 32 new tokens, greedy): the serving main path; the launch
                 counters are zeroed before and read after it.  Then the
                 legacy ring-cache generate: the fast prefill (one
                 forward_prefill, 28 K2 launches) against prefill="loop"
                 (none) on 4 x 64 prompt tokens in f32 activations, logits
                 of the prefill and 4 decode steps within 2e-2 x max-abs;
                 one timed bf16 generate of 4 x 64 + 32 new, greedy
  6. train    -- launch.train.run: qwen3-0.6b at full width cut to 8
                 layers (the 28-layer 4-node state does not fit in 80 GB),
                 4 nodes, one_peer_exp, dmsgd beta 0.9, per-node batch
                 2 x 128 tokens, 6 steps, hetero 0.5: the training main
                 path, counters zeroed before and read after; then K1 at the
                 training payload (against its plain version at 1e-5,
                 timed beside torch.lerp, the plain version and its bound),
                 the Lemma-1 check, and the same 6 steps with the plain
                 combine, which must agree
  7. ssm      -- full-width mamba2-1.3b (48 layers, random weights from
                 --seed), counters zeroed before and read after: forward
                 of 2 x 2048 tokens with attention_impl="pallas" (48 K4
                 launches per call), timed in the config's bf16; the same
                 forward in f32 activations against the plain chunked
                 scan on the card; token-by-token decode against the K4
                 forward on 2 x 64 tokens (f32); generate of 4 prompts x
                 64 tokens, 32 new, greedy, bf16 (tokens/s, ms per decode
                 step, peak memory)
  8. hybrid   -- full-width zamba2-1.2b (38 mamba layers, the shared
                 attention + MLP block after each group of 6, nothing cut,
                 random weights from --seed), counters zeroed before and
                 read after: forward of 2 x 2048 tokens with
                 attention_impl="pallas" (38 K4 and 6 K2 launches per
                 call, no other kernel), timed in bf16; the same forward
                 in f32 activations against the plain chunked scan and
                 attention on the card (2e-2 x max-abs); token-by-token
                 decode against the K2/K4 forward on 2 x 64 tokens (f32);
                 generate of 4 x 64 + 32 new, greedy, bf16
  9. train    -- the ssm and hybrid families through launch.train.run,
   families      counters zeroed before and read after each run (K1 once
                 a step, no K2/K3/K4; one executable per distinct
                 realization drawn; losses and consensus finite): (a)
                 mamba2-1.3b at full width cut to 4 layers (8 do not fit
                 in 80 GB), 4 nodes, d_adamw over random_match, 2 x 128
                 tokens a node, 6 steps, then K1 at the d_adamw payload as
                 in phase 6; (b) zamba2-1.2b at full width cut to 6 layers
                 (one shared-block application), qg_dmsgd over
                 one_peer_exp, 4 steps; (c) reduced qwen3 over the uniform
                 one-peer order, 4 steps, kernel against plain combine
                 within 2e-4 x max-abs; (d) reduced mamba2 with --ckpt-dir
                 in a temporary directory, --ckpt-every 2, 5 steps, and
                 the restore of step 4 onto the live trees on the card, bit
                 for bit (a full-width checkpoint would write >= 10 GB to
                 disk on every run)
 10. runtime  -- runtime-valued gossip and the paper's figures: (a)
                 phase 6's run with --deadline-skip --straggler-prob 0.25
                 --loss-aware (the alive draws printed; no K1, every
                 round runtime-valued; one executable per distinct
                 realization); (a') phase 6's run again (K1) and with
                 --deadline-skip --straggler-prob 0 (all alive: the
                 runtime f32 combine, self weight 1/2), held within
                 2e-4 x max-abs, then one round of each at the 9 GB
                 training payload in turns; (b) dmsgd(when=...) over
                 one_peer_exp(8), 2^20 + 3 f32 elements a node, zero
                 gradients, 3 of 6 rounds communicating: every node at the
                 node mean within 1e-5, sched_pos 3, K1 on all 6 rounds;
                 (c) repro_torch.benchmarks.run's spectral_gap,
                 consensus, transient and hetero suites on the card at the
                 reference's sizes, and bench_hetero.run_quick: every CSV
                 line printed, every derived boolean True,
                 prop1_max_dev <= 1e-12, K1 launched in transient
 11. pipeline -- int8 wire compression and the overlapped pipeline, each
                 run with the counters zeroed before and read after: (a)
                 phase 6's cell with --overlap: step ms, peak memory, K1
                 launches = delayed rounds + logged flushes + the final
                 flush, executables = the reference plan's count (prime,
                 realizations in flight, flushes), the delayed round's
                 device ms and its share concurrent with the per-node
                 gradients (CUDA events on both streams), and the flushed
                 params and momentum bit-equal to the sequential delayed
                 recursion built from the synchronous pieces on the main
                 stream; (b) the cell with --compression int8: 0 K1
                 launches, one round at the 9 GB payload against the K1
                 round in turns, every element within sum_d w_d x
                 scale(sender, group) / 2 + 1e-6 x max|x| of the f32 mix;
                 (c) --overlap --compression int8, its peak reckoned from
                 (a) first (the depth halved if it would not fit), bit-equal
                 to its sequential recursion; (d) dsgd(overlap=True) over
                 one_peer_exp(8), 2^20 + 3 f32 a node, zero gradients: a
                 period and the flush reach the node mean within 1e-6
 12. moe      -- full-width granite-moe-3b-a800m (32 layers, 40 experts
                 top-8, f32 params, random weights from --seed), counters
                 zeroed before and read after each run: (a) forward_prefill
                 of 2 x 64 tokens and 4 paged decode steps in f32
                 activations (32 K2 and 4 x 32 K3 launches) against the
                 same with the plain attention on the card, and the decode
                 logits against a prefill over the prompt and the fed
                 tokens (dropless), each within 2e-2 x max-abs; (b) phase
                 5's serve on this model (K2 32 per prefill call, K3 32 per
                 decode step); (c) phase 5's dense generate checks on this
                 model (fast against loop prefill, f32; one timed bf16
                 generate); (d) launch.train.run at full width cut to 2
                 layers (the depth reckoned from phase 6's peak per
                 parameter, printed with the measured peak), 4 nodes,
                 dmsgd over one_peer_exp, 2 x 128 tokens a node, 6 steps,
                 the capacity dispatch: K1 once a step, no K2/K3; then K1
                 at that run's payload (4 x 352 M f32, (m, x) packed)
                 against its plain version at 1e-5, timed in turns with
                 torch.lerp; the phase's runtime
 13. audio    -- full-width musicgen-large (48 layers, MHA of 32 heads of
                 64, 4 codebooks, f32 params, random weights from --seed),
                 counters zeroed before and read after each run: (a)
                 phase 12's path check on 2 x 64 x 4 tokens (48 K2 and
                 4 x 48 K3 launches); (b) phase 5's serve with (P, 4)
                 prompts, frames/s (a frame of 4 codes counts as one
                 token; K2 48 per prefill call, K3 48 per decode step),
                 then 4 requests at temperature 0.8, whose frames must
                 not all repeat one code; (c) phase 5's generate checks
                 on (4, 64, 4) prompts; (d) launch.train.run at full width
                 cut to 4 layers (302 M a node, the peak reckoned first),
                 4 nodes, dmsgd over one_peer_exp, 2 x 128 frames a node, 6
                 steps: K1 once a step, no K2/K3; then K1 at that run's
                 payload (4 x 604 M f32) against its plain version; (e)
                 launch/profile_serve.py --arch musicgen-large
 14. vlm      -- llama-3.2-vision-90b at full width cut to one group (4
                 self layers and 1 cross layer, 6.38 B f32 params, random
                 weights from --seed, every gate 0.5), images (B, 1024,
                 8192) from a seeded generator: (a) forward of 2 x 64
                 tokens and the token-by-token decode against it, f32,
                 2e-2 x max-abs, and the same forward with the gates at 0
                 apart from it; (b) generate of 4 x 64 + 32 new with
                 images, greedy, bf16 (tokens/s, ms a step, peak memory);
                 no kernel runs in (a) or (b) (the reference's attention
                 there is plain); (c) launch.train.run on the reduced
                 config (6 layers, d 256, 16 image tokens drawn on the
                 card), 4 nodes, 4 steps, K1 once a step (full width
                 cannot train on one card: the embed and head alone are
                 2.1 B a node)
 15. configs  -- gemma2-27b (4 layers: 2 local with the 4,096 window, 2
                 global; soft-caps 50 and 30, tied 256k vocab), granite-34b
                 (4 layers, G 48 over one kv head), deepseek-67b (4 layers,
                 G 8) and dbrx-132b (2 layers, G 6, 16 experts top-4) at
                 full width, f32 params, random weights from --seed, one
                 model on the card at a time, each peak reckoned before its
                 run and printed beside the measured one, counters zeroed
                 before and read after each run: (a) phase 12's path check
                 (n_layers K2 and 4 x n_layers K3 launches); (b) phase 5's
                 serve (K2 n_layers per prefill call, K3 n_layers per
                 decode step, no preemption); (c) gemma2 only: one
                 6,144-token prompt and 4 paged decode steps, f32, through
                 K2/K3 against the plain attention within 2e-2 x max-abs,
                 and the same run with every layer global, which must
                 differ by far more (the window excludes ~2,000 keys from
                 every late query)
 16. bench    -- repro_torch.benchmarks.bench_serve --quick on the card
                 (reduced qwen3: the engine against fixed batches of the
                 loop-prefill generate on one Poisson trace) and
                 check_serve_regression.compare against the committed
                 BENCH_serve_h100.json: fails on a NaN or missing latency
                 or rate, a paged peak KV at or above the dense one, or the
                 two sides' token counts differing; the tokens/s and the
                 engine / baseline speedup are printed, not gated (the
                 quick trace is bound by its arrivals, on the card as on
                 a CPU, and the reduced model's steps by the host)
 17. benches  -- (a) repro_torch.benchmarks.bench_kernels on the card: K2
                 f32 at (1, 512, 4, 2, 64), K4 at (1, 512, 4, 64, 1, 64)
                 chunk 128, K1 at 2^20 f32, each allclose to its plain
                 version (2e-4, 2e-3, 1e-5) and launched exactly as often
                 as the suite called its wrapper; kernel us (CUDA-graph
                 replays, in turns with sdpa for K2 and torch.lerp for
                 K1) beside the bound, the library call's and the plain
                 version's us;
                 (b) bench_comm --quick into a temporary file:
                 check_comm_regression.compare against the committed
                 BENCH_comm_h100.json, the wire bytes equal to the
                 reference's BENCH_comm.json once its 8,192-element padding
                 is taken out (port x 1,007,616 == reference x 1,000,000;
                 runtime metadata bytes, collectives, rounds, kinds and
                 wire multipliers equal), every us_per_mix real, K1
                 launched by every Shifts and Matching row's timed mixes;
                 the overlap pair and its speedup printed, not gated (the
                 step is host-bound on one card); (c) launch.train_lm
                 train_one at the 100m preset (128,995,584 parameters a
                 node), 8 nodes, 10 steps over one_peer_exp and then
                 static_exp: every loss finite, the last below step 0's,
                 K1 once a step and no other kernel, 3 and 1 executables
                 (one per distinct realization), peak memory beside the
                 reckoned peak
 18. mesh     -- multi-process gossip (ROADMAP item 18) on the one card:
                 (a) 8 spawned ranks as a (node 4, fsdp 2) mesh, every
                 rank on cuda:0 over a gloo group whose buffers are
                 staged through pinned host memory ("gloo-host"): the
                 reference test's {w, b, h} tree and then DmSGD's (m, x)
                 payload of full-width qwen3-0.6b cut to 2 layers (specs
                 from sharding.gossip_payload_spec_fn) through one-peer
                 Shifts, a Matching with fixed points, int8, grid Dense,
                 full averaging (the small tree also the hypercube, static
                 exponential, int8 Matching, the runtime rounds, the
                 delayed halves and the gathered path): each rank's
                 block against its slice of the single-process global
                 path on the card with K1's plain version as its combine
                 (so each rank's K1 is held against the plain version on
                 the same inputs), bit for bit but Dense (1e-5 f32, 1e-2
                 bf16), the qwen3 blocks handed to this process through
                 CUDA IPC; the wire log against gossip_spec; K1 launched
                 per rank once per dtype group a static round; each
                 round's ms and its share staging through the host;
                 (b) 4 ranks as a (node 4) mesh train phase 6's cell, one
                 rank per node, every step's loss and the final params
                 and momentum held against phase 6's single-process run
                 repeated here with the plain combine (2e-4 of max-abs,
                 f32 params; bit for bit
                 reported), median step ms and peak memory per rank, K1
                 6 a rank; (d)-(g) on one more world of 4 ranks, one a
                 node, full-width qwen3-0.6b cut to 2 layers: the
                 synchronous dmsgd leg (its step ms), (d) --overlap
                 dmsgd, 4 steps, each delayed round's permute posted
                 before the rank's gradients and waited for after them
                 (wire ms and the share of it open under the gradients,
                 step ms against the synchronous leg, K1 3 delayed + 2
                 logged flushes + 1 final a rank), (e) parallel_msgd, 3
                 steps (one psum a step: ops, bytes, ms), both held
                 against the single-process run with the plain combine
                 (2e-4 of max-abs; bit for bit reported), (f) (d)'s
                 carry-buffer checkpoint at step 2, gathered at rank 0,
                 against the single-process run's array by array, (g)
                 runtime rounds with 2 nodes a rank (node 2 x fsdp 2: each
                 node line 2 ranks over 4 nodes) bit for bit the global
                 path's, and the legs' seconds; (h)-(i) on one world of
                 8 ranks, a (node 4, fsdp 2, model 1) mesh, the same
                 model in f32 activations, each rank holding its fsdp
                 shards, gathering its node's leaves for the gradients
                 and reduce-scattering their mean: (h) dmsgd, 2 steps,
                 and the every=2 pair (the Shifts step one permute more
                 than the Identity step, nothing else), (i) --overlap, 2
                 steps, its carry-buffer checkpoint at step 1 against the
                 single-process run's array by array, both held against
                 the single-process run with the plain combine (2e-4 of
                 max-abs; bit for bit reported), the fsdp ops a step
                 (one all_gather, one reduce_scatter, one psum), per rank
                 median step ms, peak memory beside (d)'s, the wire log
                 per kind and K1 (2 / 4 a rank); in the same world of 8,
                 model-sharded (tensor-parallel) training, each rank
                 holding its (fsdp, model) shard and running the pass on
                 its model shards (launch/tp.py): (j) dmsgd, 3 steps, on
                 (node 2, fsdp 2, model 2), (k) (i)'s --overlap run on
                 (node 4, fsdp 1, model 2), its carry-buffer checkpoint
                 against the same single-process one array by array,
                 both within 2e-4 of max-abs, per rank median step ms,
                 peak memory, the "model" scope's ops, bytes and ms a
                 step and K1 (3 / 4 a rank); (m) in the same world,
                 before (l), a replica's model-sharded prefill
                 (mesh_check.prefill_rank: steps.make_prefill_step(tp=,
                 fsdp=)): full-width qwen3-0.6b cut to 2 layers, f32
                 activations, attention_impl "pallas", 8 rows of 512 on
                 (node 2, fsdp 2, model 2), 2 rows a rank, the fsdp
                 shards gathered, K2 on each rank's 8 query and 4 kv
                 heads (2 launches a rank, counted from 0 around the
                 call), every rank's last logits gathered over model
                 within 2e-4 of max-abs of the single-process prefill
                 step with the plain attention (its reference released
                 once compared); per rank the median of 3 prefills, the
                 fsdp and model scopes' ops, bytes and ms, the peak on
                 the card and the host; (n) in the same world, after
                 (m), a replica's model-sharded decode
                 (mesh_check.decode_rank: steps.make_serve_step(tp=,
                 fsdp=)), each rank on its shards of the weights and of
                 the cache (sharding.cache_specs), cut from .npy files it
                 maps, 2 of 8 rows, f32: (n1) qwen3-0.6b at full width,
                 2 layers, a 256-slot ring filled by the single-process
                 prefill_cache, 4 steps that wrap it, the kv heads cut;
                 (n2) granite-34b at full width, 1 layer, 2 steps, its
                 one kv head on the head-dim cut; every step's logits
                 gathered over model and the final cache shard within
                 2e-4 of max-abs of the single-process decode, the wire
                 ops a step as reckoned, no kernel launched; per rank
                 the median ms of a step, the fsdp and model ops' count,
                 bytes and ms, the peak on the card; (l) in the same world,
                 the moe family's rows split over fsdp: full-width
                 granite-moe-3b-a800m cut to 2 layers on (node 2, fsdp
                 4, model 1), a batch of 4 a node, one row a rank, its
                 capacity routing and aux loss made global over the
                 node's 4 fsdp ranks (launch/moe_group.py), 2 steps,
                 within 2e-4 of max-abs, the "moe" scope's ops, bytes
                 and ms a step, K1 2 a rank, the leg's seconds; then K1
                 alone at a rank's (1, 187.0 M) f32 block of (h) and at
                 (l)'s from CUDA-graph replays in turns with torch.lerp,
                 beside its bytes bound; (c) on one card asking
                 for NCCL raises (two ranks on cuda:0); with >= 4 cards
                 (a)'s tree also runs over NCCL, one card a rank, else
                 one line says why not
 19. dryrun   -- the dry run and its counter (ROADMAP item 23): (a) the
                 whole matrix, 10 archs x 4 shapes x both meshes, counted
                 on the meta device in worker processes: every record ok,
                 the card's max_memory_allocated unmoved, make_experiments'
                 two tables printed, each prefill_32k and each of the
                 40 decode_32k / long_500k records rank 0's
                 model-sharded step (nothing uncounted) with its dominant
                 term and collectives printed; (b) phase 6's train step
                 counted by launch.cost.Cost on the card (K1 launched)
                 and on meta:
                 flops equal, bytes within 1 %, any op whose count differs
                 printed, the step's median ms against the bound its count
                 gives on one card; (c) the same for phase 7's forward
                 (mamba2-1.3b, 2 x 2048, bf16 activations, K4 recorded by
                 ssd_cost); under 120 s
Every phase's runtime is printed after it.
Then one ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (dense, no sparsity) at its 700 W limit,
# and the bound they give: repro_torch.benchmarks.common (torch only)
from repro_torch.benchmarks.bench_kernels import (  # noqa: E402
    flash_cost, ssd_cost)
from repro_torch.benchmarks.common import (  # noqa: E402
    PEAK_F32_FLOPS, PEAK_TF32_FLOPS, bound_us, time_graph_us, time_turns)
KERNEL_TOL = 2e-2            # tests/test_kernels.py:15, bf16
FLASH_F32_TOL = 2e-4         # tests/test_kernels.py:15, f32
FLASH_MAIN = (4, 512, 16, 8, 128)   # (B, S, H, Kv, D): the serving prefill
FLASH_LONG = (1, 4096, 16, 8, 128)  # bound by the bf16 tensor-core rate
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
SSD_TOL = 1e-3               # tests/test_kernels.py:117-118, x max(1, max-abs)
# K4's tensor-core branch, x max(1, max-abs): 3xTF32 errs by up to 1.5e-5
# and single TF32 by ~5e-4 (tests/test_torch_ssd_scan.py TOL_TC),
# so a kernel that dropped its lo terms fails
SSD_TOL_TC = 5e-5
SSD_MAIN = (1, 2048, 64, 64, 1, 128)    # (b, s, h, p, g, n) of mamba2-1.3b
SSD_RAGGED = (1, 1000, 64, 64, 2, 128)  # chunk 128 halves to 8
SSD_FORWARD = (2, 2048, 64, 64, 1, 128)  # one layer of phase 7's forward
SSD_HYBRID = (2, 2048, 64, 64, 1, 64)    # one layer of phase 8's forward
FLASH_HYBRID = (2, 2048, 32, 32, 64)     # phase 8's shared block: G 1, D 64
FLASH_MOE = (4, 512, 24, 8, 64)          # phase 12's prefill bucket: G 3, D 64
FLASH_AUDIO = (4, 512, 32, 32, 64)       # phase 13's prefill bucket: G 1, D 64
# phase 15's prefill buckets (B 4 x 512, D 128): gemma2-27b G 2 (its local
# layers' window 4096 and soft-cap 50), granite-34b G 48 over one kv head,
# deepseek-67b G 8, dbrx-132b G 6; and gemma2's 6,144-token prompt of
# phase 15 (c), where the window bites
FLASH_GEMMA2 = (4, 512, 32, 16, 128)
FLASH_GRANITE34B = (4, 512, 48, 1, 128)
FLASH_DEEPSEEK = (4, 512, 64, 8, 128)
FLASH_DBRX = (4, 512, 48, 8, 128)
FLASH_GEMMA2_LONG = (1, 6144, 32, 16, 128)
GEMMA2_MASK = (4096, 50.0)               # (window, soft-cap) of a local layer
GEMMA2_CASES = ((None, 50.0), GEMMA2_MASK)  # its global and local layers
# the kernels line's rows of phase 15's shapes, K2 and K3 alike
CONFIG_ROWS = ("gemma2", "granite34b", "deepseek", "dbrx", "gemma2_long")
# mamba2-1.3b at full width: the K4 forward against the plain chunked one,
# and decode against forward, relative to the logits' max-abs.  Both are
# held in f32 activations: with random weights the 48-layer bf16 forward
# amplifies single bf16 rounding flips to O(1) logit changes (the JAX
# reference's own "pallas" and "jnp" bf16 forwards part the same way
# while its f32 ones agree), so a bf16 comparison says nothing about the
# kernel
SSM_TOL = 2e-2
SSM_B, SSM_S = 2, 2048       # the forward
SSM_DECODE = (2, 64)         # decode against forward
SSM_GEN = (4, 64, 32)        # generate: prompts, prompt length, new tokens
# the dense ring-cache generate (phase 5) and zamba2-1.2b (phase 8): held
# as phase 7 holds mamba2, in f32 activations at 2e-2 of max-abs
DENSE_GEN = (4, 64, 32)      # prompts, prompt length, new tokens
DENSE_DECODE_STEPS = 4       # decode steps after the two prefills
HYB_B, HYB_S = 2, 2048       # the forward
HYB_DECODE = (2, 64)         # decode against forward
HYB_GEN = (4, 64, 32)        # generate


def _smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_PHASE = {"title": None, "t": 0.0}


def phase(title: str | None) -> None:
    """Log the runtime of the phase that ends here, then the next one's
    ``title`` (None after the last)."""
    now = time.perf_counter()
    if _PHASE["title"]:
        log(f"  ({_PHASE['title'].split(':')[0]} ran {now - _PHASE['t']:.1f}"
            f" s)")
    if title:
        log(title)
    _PHASE.update(title=title, t=now)


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


def _short(function: str) -> str:
    """A demangled kernel name without its namespace and arguments."""
    return function.replace("(anonymous namespace)::", "").split("(")[0]


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def within(got, want, tol: float) -> bool:
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= tol + tol * w.abs()).all())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _flash_inputs(torch, dev, shape, dtype, seed):
    B, S, H, Kv, D = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in ((B, S, H, D), (B, S, Kv, D), (B, S, Kv, D))]


def _flex_attention(torch, dev, shape, window: int | None, cap: float):
    """One compiled ``flex_attention`` call computing K2's causal GQA
    attention with ``window`` as its block mask and the tanh soft-cap
    ``cap`` as its score_mod, on (B, H, S, D) tensors: the library call
    for the capped rows, which SDPA cannot compute."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    S = shape[1]

    def mask_mod(b, h, qi, ki):
        visible = ki <= qi
        return visible if window is None else visible & (ki > qi - window)

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    block_mask = create_block_mask(mask_mod, None, None, S, S, device=dev)
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda q, k, v: flex(q, k, v, score_mod=score_mod,
                                block_mask=block_mask, enable_gqa=True)


def flash_phase(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref
    rows, errs = {}, []
    # (row, shape, seed, (window, cap) checked, plain iterations, and the
    # (window, cap) the row is timed at: the model's call)
    for name, shape, seed, cases, plain_iters, timed in (
            ("main", FLASH_MAIN, 1, ((None, None), (128, 50.0)), 5, None),
            ("long", FLASH_LONG, 11, ((None, None), (1000, 30.0)), 2, None),
            ("hybrid", FLASH_HYBRID, 13, ((None, None),), 2, None),
            ("moe", FLASH_MOE, 17, ((None, None), (100, 30.0)), 5, None),
            ("audio", FLASH_AUDIO, 19, ((None, None), (100, 30.0)), 5, None),
            ("gemma2", FLASH_GEMMA2, 23, GEMMA2_CASES, 3, GEMMA2_MASK),
            ("granite34b", FLASH_GRANITE34B, 29, ((None, None), (100, 30.0)),
             3, None),
            ("deepseek", FLASH_DEEPSEEK, 31, ((None, None), (100, 30.0)), 3,
             None),
            ("dbrx", FLASH_DBRX, 37, ((None, None), (100, 30.0)), 3, None),
            ("gemma2_long", FLASH_GEMMA2_LONG, 41, GEMMA2_CASES, 1,
             GEMMA2_MASK)):
        B, S, H, Kv, D = shape
        tw, tc = timed or (None, None)
        q, k, v = _flash_inputs(torch, dev, shape, torch.bfloat16, seed)
        for window, cap in cases:
            got = ops.flash_attention(q, k, v, window=window, attn_cap=cap)
            torch.cuda.synchronize()
            want = ref.attention_ref(q, k, v, window=window, attn_cap=cap)
            errs.append(max_err(got, want))
            check(bool(torch.isfinite(got).all()),
                  f"flash_attention {shape}: non-finite")
            check(within(got, want, KERNEL_TOL),
                  f"flash_attention {shape} window={window} cap={cap}: max "
                  f"abs err {errs[-1]} beyond {KERNEL_TOL}")
            log(f"  flash_attention B={B} S=T={S} H={H} Kv={Kv} D={D} bf16 "
                f"window={window} cap={cap}: max abs err {errs[-1]:.3g}")
            del got, want
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if timed is None:
            lib_name = "sdpa"
            library = partial(F.scaled_dot_product_attention, qt, kt, vt,
                              is_causal=True, enable_gqa=True)
        else:
            # SDPA has no soft-cap: flex_attention computes the same
            # function, held here to the plain version as the kernel is
            lib_name = "flex_attention"
            library = partial(_flex_attention(torch, dev, shape, tw, tc),
                              qt, kt, vt)
            got = library().transpose(1, 2)
            torch.cuda.synchronize()
            want = ref.attention_ref(q, k, v, window=tw, attn_cap=tc)
            lib_err = max_err(got, want)
            check(within(got, want, KERNEL_TOL),
                  f"flex_attention {shape} window={tw} cap={tc}: max abs "
                  f"err {lib_err} beyond {KERNEL_TOL}")
            log(f"  flex_attention {shape} bf16 window={tw} cap={tc} "
                f"(compiled, library call): max abs err {lib_err:.3g}")
            del got, want
        t = time_turns({
            "kernel": lambda: ops.flash_attention(q, k, v, window=tw,
                                                  attn_cap=tc),
            "library": library}, rounds=2,
            timer=lambda f: time_graph_us(f) / 1e3)
        eager_ms = time_ms(lambda: ops.flash_attention(q, k, v, window=tw,
                                                       attn_cap=tc))
        plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, window=tw,
                                                     attn_cap=tc),
                           iters=plain_iters, warmup=1)
        flops, nbytes = flash_cost(shape, 2, tw)
        bound_ms, bound_by = bound_us(flops, nbytes)
        bound_ms /= 1e3
        rows[name] = {"ms": t["kernel"], "plain_ms": plain_ms,
                      "library_ms": t["library"], "library": lib_name,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "tflops": flops / t["kernel"] / 1e9,
                      "bound_share": bound_ms / t["kernel"],
                      "eager_ms": eager_ms,
                      "shape": f"B={B} S=T={S} H={H} Kv={Kv} D={D} bf16 "
                               f"causal window={tw} cap={tc}"}
        lib = (f"{lib_name} {t['library']:.4f} ms (kernel / {lib_name} "
               f"{t['kernel'] / t['library']:.2f})")
        log(f"  flash_attention {shape} bf16 window={tw} cap={tc}: kernel "
            f"{t['kernel']:.4f} ms ({flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB: {rows[name]['tflops']:.1f} TFLOP/s, "
            f"{100 * rows[name]['bound_share']:.1f} % of the bound), {lib}, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"kernel and {lib_name} replayed from CUDA graphs, the kernel "
            f"through its wrapper back to back {eager_ms:.4f} ms")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    # the f32 branch: the first version's FMA kernel, not redesigned
    q, k, v = _flash_inputs(torch, dev, FLASH_MAIN, torch.float32, 1)
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v)
    f32_err = max_err(got, want)
    check(within(got, want, FLASH_F32_TOL),
          f"flash_attention f32: max abs err {f32_err} beyond "
          f"{FLASH_F32_TOL}")
    f32_ms = time_ms(lambda: ops.flash_attention(q, k, v))
    f32_bound, f32_by = bound_us(*flash_cost(FLASH_MAIN, 4), PEAK_F32_FLOPS)
    f32_bound /= 1e3
    log(f"  flash_attention {FLASH_MAIN} f32 (FMA branch): max abs err "
        f"{f32_err:.3g} (tolerance {FLASH_F32_TOL}); kernel {f32_ms:.4f} "
        f"ms, bound {f32_bound:.4f} ms ({f32_by}, f32 outside the tensor "
        f"cores)")
    ratios = {n: rows[n]["ms"] / rows[n]["library_ms"]
              for n in ("hybrid", "audio")}
    log(f"  flash_attention at D 64, G 1: kernel / sdpa {ratios['audio']:.2f}"
        f" at musicgen's {FLASH_AUDIO}, {ratios['hybrid']:.2f} at zamba2's "
        f"{FLASH_HYBRID}")
    main = rows.pop("main")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
            "max_abs_err": max(errs), **main,
            **{n: rows[n] for n in ("long", "hybrid", "moe", "audio")
               + CONFIG_ROWS},
            "f32": {"ms": f32_ms, "max_abs_err": f32_err,
                    "bound_ms": f32_bound, "bound_by": f32_by}}


def paged_phase(torch, dev):
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.launch import time_paged as TP
    errs, rows = [], {}
    for name, cases in (("ragged", ((None, None), (256, 30.0))),
                        ("serve", ((None, None), (100, 30.0))),
                        ("long", ((None, None), (3000, 30.0))),
                        ("moe", ((None, None), (100, 30.0))),
                        ("audio", ((None, None), (100, 30.0))),
                        ("gemma2", GEMMA2_CASES),
                        ("granite34b", ((None, None), (100, 30.0))),
                        ("deepseek", ((None, None), (100, 30.0))),
                        ("dbrx", ((None, None), (100, 30.0))),
                        ("gemma2_long", GEMMA2_CASES)):
        q, pools, tab, lens, ln = TP.inputs(dev, name)
        h, kv, d = TP.heads(name)
        kp, vp = pools[0]
        for window, cap in cases:
            got = ops.paged_attention(q, kp, vp, tab, lens, window=window,
                                      attn_cap=cap)
            torch.cuda.synchronize()
            want = ref.paged_attention_ref(q, kp, vp, tab, lens,
                                           window=window, attn_cap=cap)
            errs.append(max_err(got, want))
            check(bool(torch.isfinite(got).all()),
                  f"paged_attention {name}: non-finite")
            check(within(got, want, KERNEL_TOL),
                  f"paged_attention {name} window={window} cap={cap}: max "
                  f"abs err {errs[-1]} beyond {KERNEL_TOL}")
            log(f"  paged_attention {name}: B={len(ln)} H={h} Kv={kv} "
                f"D={d} page={TP.PAGE} Pmax={tab.shape[1]} lengths "
                f"{ln.tolist() if len(ln) <= 8 else len(ln)} bf16 "
                f"window={window} cap={cap}: max abs err {errs[-1]:.3g}")
        tw, tc = TP.mask(name)
        plain_ms = time_ms(lambda: ref.paged_attention_ref(
            q, kp, vp, tab, lens, window=tw, attn_cap=tc), iters=3)
        r = TP.time_shape(dev, name)
        r["plain_ms"] = plain_ms
        rows[name] = r
        log(f"  paged_attention {name} window={tw} cap={tc}: kernel "
            f"{r['ms']:.4f} ms from CUDA-"
            f"graph replays over {r['copies']} pool copies "
            f"({r['pool_mb']:.1f} MB, cold in L2; {r['gbps']:.1f} GB/s, "
            f"{100 * r['bound_share']:.1f} % of the bound), through the "
            f"wrapper back to back {r['eager_ms']:.4f} ms; plain "
            f"{plain_ms:.4f} ms; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {r['visible']} visible tokens); no single "
            f"PyTorch call computes it")
        del q, pools, kp, vp
    main = rows.pop("serve")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:89",
            "max_abs_err": max(errs), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "eager_ms": main["eager_ms"], "bound_share": main["bound_share"],
            "shape": f"serve decode: B={main['B']} H={TP.H} Kv={TP.KV} "
                     f"D={TP.D} page={TP.PAGE} Pmax={main['pmax']} "
                     f"{main['visible']} visible tokens bf16, cold pool",
            **{n: rows[n] for n in ("ragged", "long", "moe", "audio")
               + CONFIG_ROWS}}


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
    # the train path's case: f32, degree 1, weights 1/2; K1 and lerp in
    # turns
    x, r = (torch.randn(big, generator=g, device=dev) for _ in range(2))
    t = time_turns({
        "kernel": lambda: ops.gossip_mix(x, [r], w_self=0.5, ws=(0.5,)),
        "lerp": lambda: torch.lerp(x, r, 0.5)}, timer=time_ms)
    ms, library_ms = t["kernel"], t["lerp"]
    plain_ms = time_ms(lambda: ref.gossip_mix_ref(x, [r], 0.5, (0.5,)),
                       iters=10)
    n = x.numel()
    bound_ms, bound_by = bound_us(3 * n, 3 * 4 * n, PEAK_F32_FLOPS)
    bound_ms /= 1e3
    log(f"  gossip_mix {big} f32 degree 1: kernel {ms:.4f} ms "
        f"({3 * 4 * n / ms / 1e6:.1f} GB/s, {100 * bound_ms / ms:.1f} % of "
        f"the bound), lerp {library_ms:.4f} ms ({100 * bound_ms / library_ms:.1f}"
        f" %; kernel / lerp {ms / library_ms:.4f}), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "gossip_mix", "route": "cuda",
            "source": "src/repro_torch/csrc/gossip_mix.cu",
            "replaces": "src/repro/kernels/gossip_mix/kernel.py:34",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "gbps": 3 * 4 * n / ms / 1e6,
            "bound_share": bound_ms / ms, "lerp_ratio": ms / library_ms,
            "shape": f"{big} f32 degree 1 (library: torch.lerp(x, r, 0.5))"}


def _ssd_inputs(torch, dev, shape, seed, model_a):
    """As tests/test_kernels.py:108-113 draws them (A = -exp(0.3 N)), or
    with mamba2's own A = -exp(log(linspace(1, 16, h)))."""
    b, s, h, p, g, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*sh):
        return torch.randn(sh, generator=gen, device=dev)

    x, dt = rn(b, s, h, p), torch.nn.functional.softplus(rn(b, s, h))
    A = (-torch.exp(torch.log(torch.linspace(1.0, 16.0, h, device=dev)))
         if model_a else -torch.exp(0.3 * rn(h)))
    return x, dt, A, rn(b, s, g, n), rn(b, s, g, n)


def ssd_phase(torch, dev):
    from repro_torch.kernels.ssd_scan import kernel, ops, ref
    from repro_torch.models import mamba2 as m2
    errs = []
    for shape, model_a, seed in ((SSD_MAIN, False, 5), (SSD_MAIN, True, 6),
                                 (SSD_RAGGED, False, 7),
                                 (SSD_HYBRID, True, 8)):
        x, dt, A, B, C = _ssd_inputs(torch, dev, shape, seed, model_a)
        ck = ops.chunk_len(shape[1], 128)
        y, hT = ops.ssd_scan(x, dt, A, B, C, chunk=128)
        torch.cuda.synchronize()
        y_ref, h_ref = ref.ssd_ref(x, dt, A, B, C)
        for name, got, want in (("y", y, y_ref), ("h_final", hT, h_ref)):
            err, scale = max_err(got, want), float(want.abs().max())
            errs.append(err)
            check(bool(torch.isfinite(got).all()),
                  f"ssd_scan {shape}: non-finite {name}")
            tc = kernel.tensor_core_branch(ck, shape[5])
            tol = SSD_TOL_TC if tc else SSD_TOL
            check(err <= tol * max(1.0, scale),
                  f"ssd_scan {shape} model_a={model_a} {name}: max abs err "
                  f"{err} beyond {tol} x max(1, {scale})")
            log(f"  ssd_scan (b,s,h,p,g,n)={shape} chunk {ck} f32 "
                f"A={'model' if model_a else 'test'} {name} "
                f"({'3xTF32 tensor-core' if tc else 'FMA'} branch): max abs "
                f"err {err:.3g} = {err / max(1.0, scale):.3g} x max(1, "
                f"max-abs {scale:.4g}), tolerance {tol} x max(1, max-abs)")
    rows = {}
    for name, shape in (("main", SSD_MAIN), ("forward", SSD_FORWARD),
                        ("hybrid", SSD_HYBRID)):
        x, dt, A, B, C = _ssd_inputs(torch, dev, shape, 6, True)
        b, s, h, p, g, n = shape
        L = ops.chunk_len(s, 128)
        ms = time_graph_us(lambda: ops.ssd_scan(x, dt, A, B, C),
                           calls=10) / 1e3
        eager_ms = time_ms(lambda: ops.ssd_scan(x, dt, A, B, C))
        nc, pairs = s // L, L * (L + 1) // 2
        flops, nbytes = ssd_cost(shape, 128)
        # C B^T per head, as the reference computes it
        flops_per_head = flops + (h - g) * b * nc * 2 * pairs * n
        # 3xTF32: three TF32 products for every f32 one
        bound_ms, bound_by = bound_us(3 * flops, nbytes, PEAK_TF32_FLOPS)
        bound_ms /= 1e3
        per_head_ms = bound_us(3 * flops_per_head, nbytes,
                               PEAK_TF32_FLOPS)[0] / 1e3
        f32_ms = bound_us(flops, nbytes, PEAK_F32_FLOPS)[0] / 1e3
        tf32_ms = bound_us(flops, nbytes, PEAK_TF32_FLOPS)[0] / 1e3
        row = {"ms": ms, "eager_ms": eager_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bound_per_head_scores_ms": per_head_ms,
               "bound_f32_fma_ms": f32_ms,
               "bound_tf32_ms": tf32_ms, "bound_share": bound_ms / ms,
               "tflops_3xtf32": 3 * flops / ms / 1e9,
               "per_head_scores_share": per_head_ms / ms,
               "shape": f"(b,s,h,p,g,n)={shape} chunk {L} f32"}
        if name == "main":
            row["plain_ms"] = time_ms(lambda: ref.ssd_ref(x, dt, A, B, C),
                                      iters=2, warmup=1)
            row["chunked_ms"] = time_ms(
                lambda: m2.ssd_chunked(x, dt, A, B, C, chunk=L), iters=5,
                warmup=1)
        rows[name] = row
        log(f"  ssd_scan {shape} chunk {L} f32: kernel {ms:.4f} ms (CUDA-"
            f"graph replays; through the wrapper back to back {eager_ms:.4f}"
            f" ms), {row['tflops_3xtf32']:.1f} TFLOP/s of 3xTF32 work, "
            f"{100 * row['bound_share']:.1f} % of the bound "
            f"{bound_ms:.4f} ms ({bound_by}: 3 x {flops / 1e9:.3f} GFLOP "
            f"at TF32's 495 TFLOP/s, {nbytes / 1e6:.1f} MB at 3.35 TB/s); "
            f"beside it 3xTF32 with C B^T once a head "
            f"({3 * flops_per_head / 1e9:.3f} GFLOP) {per_head_ms:.4f} ms "
            f"({100 * per_head_ms / ms:.1f} %), the f32-FMA bound "
            f"{f32_ms:.4f} ms and single TF32's {tf32_ms:.4f} ms"
            + (f"; plain ssd_ref {row['plain_ms']:.4f} ms, plain "
               f"ssd_chunked {row['chunked_ms']:.4f} ms; library: none "
               f"exists (no single PyTorch call computes SSD)"
               if name == "main" else ""))
        del x, dt, A, B, C
    main = rows.pop("main")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:75",
            "max_abs_err": max(errs), **main, "library_ms": None,
            "forward_shape": rows["forward"], "hybrid_shape": rows["hybrid"]}


# ---------------------------------------------------------------------------
# phase 4: full-width model, card against CPU
# ---------------------------------------------------------------------------

def _prefill_decode(torch, M, cfg, model, tokens, table, device, steps, ps,
                    fed=None, pool_dtype=None):
    """forward_prefill of ``tokens``, its k/v scattered into a fresh page
    pool (bf16 unless ``pool_dtype``) through ``table`` (as the engine
    does), then ``steps`` paged decode steps.  Feeds ``fed`` tokens, or the
    run's own greedy picks when None.  Returns the last-position logits of
    every step (f32, on the CPU) and the tokens fed.  Audio tokens are
    (B, P, K) frames, and their logits (B, K, V) a step."""
    B, P = tokens.shape[:2]
    pool = {n: torch.zeros(cfg.n_layers, cfg.n_kv_heads,
                           1 + int(table.max()), ps, cfg.head_dim,
                           dtype=pool_dtype or torch.bfloat16, device=device)
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

def serve_phase(torch, dev, cfg, params, seed, out=None):
    """Phase 5's trace through the engine (audio: (P, K) prompts, and a
    frame of K codes counts as one token).  ``out``, a dict, gets the
    run's tokens/s, latencies, peak pages and peak allocated bytes."""
    import numpy as np

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch import serve as S
    from repro_torch.serve import ServeEngine, pages_needed
    n_req, mean_prompt, max_new, ps, max_batch, max_seq = 16, 256, 32, 16, 8, 512
    # a burst (1000 requests/s): all 16 arrive within milliseconds, so the
    # engine runs at its max batch and tokens/s is its own throughput
    trace = S.poisson_trace(n_req, 1000.0, mean_prompt, max_new,
                            cfg.vocab_size, seed,
                            n_codebooks=cfg.n_codebooks)
    longest = max(len(p) for _, p, _ in trace) + max_new
    check(longest <= max_seq, f"serve: a request needs {longest} > {max_seq}")
    n_pages = 1 + n_req * pages_needed(max_seq, ps)   # nothing is preempted
    engine = ServeEngine(cfg, params, n_pages=n_pages, page_size=ps,
                         max_seq=max_seq, max_batch=max_batch, seed=seed,
                         device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.flash_attention.launches = 0
    pa_ops.paged_attention.launches = 0
    wall = S.serve_trace(engine, trace)
    torch.cuda.synchronize()
    peak_bytes = torch.cuda.max_memory_allocated()
    launches = {"flash_attention": fa_ops.flash_attention.launches,
                "paged_attention": pa_ops.paged_attention.launches}
    st = engine.stats()
    lat = S.latency_summary(engine.finished)
    new_tokens = sum(len(r.generated) for r in engine.finished)
    check(len(engine.finished) == n_req,
          f"serve: {len(engine.finished)} of {n_req} requests finished")
    check(all(len(r.generated) == max_new for r in engine.finished),
          "serve: a request stopped short of max_new")
    check(all(0 <= int(np.min(r.generated)) and
              int(np.max(r.generated)) < cfg.vocab_size
              for r in engine.finished), "serve: token out of vocab")
    check(st["preemptions"] == 0, f"serve: {st['preemptions']} preemptions")
    want = {"flash_attention": cfg.n_layers * st["prefill_calls"],
            "paged_attention": cfg.n_layers * st["decode_calls"]}
    for name in want:
        check(launches[name] > 0, f"serve: {name} never launched")
        check(launches[name] == want[name],
              f"serve: {name} launched {launches[name]} times, expected "
              f"{want[name]} (n_layers x calls)")
    unit = "frames" if cfg.family == "audio" else "tokens"
    log(f"  served {len(engine.finished)} requests, {new_tokens} new {unit} "
        f"in {wall:.3f} s: {new_tokens / wall:.1f} {unit}/s; "
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
    if out is not None:
        out.update(tokens_per_s=new_tokens / wall, peak_pages=st[
            "peak_pages"], peak_bytes=peak_bytes, **lat)
    return launches, per_call


def dense_generate_phase(torch, dev, cfg, params, seed):
    """The legacy ring-cache generate of the dense family: the fast prefill
    (one forward_prefill, K2 once per layer, its k/v ring-filled) against
    the token-by-token loop (no kernel), in f32 activations; then one
    timed bf16 generate.  Audio prompts are (B, P, K) frames."""
    import dataclasses

    import numpy as np

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    Bg, Pg, new = DENSE_GEN
    f32_cfg = dataclasses.replace(cfg, activation_dtype=torch.float32)
    rng = np.random.default_rng(seed + 1)
    frame = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (Bg, Pg) + frame)).to(dev)
    cache_len = Pg + new
    out, launches = {}, {}
    with torch.no_grad():
        for mode in ("auto", "loop"):
            torch.cuda.synchronize()
            n0 = fa_ops.flash_attention.launches
            t0 = time.perf_counter()
            logits, cache = S.prefill_cache(f32_cfg, params, prompts,
                                            cache_len=cache_len, mode=mode)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches[mode] = fa_ops.flash_attention.launches - n0
            out[mode] = (logits, cache, secs)
        # the same decode steps from each ring, fed the fast path's picks
        steps = {m: [out[m][0][:, -1].float()] for m in out}
        cur = out["auto"][0][:, -1].argmax(-1)[:, None]
        for t in range(Pg, Pg + DENSE_DECODE_STEPS):
            for m in out:
                lg, _ = M.decode_step(params, f32_cfg, cur, out[m][1], t)
                steps[m].append(lg[:, -1].float())
            cur = steps["auto"][-1].argmax(-1)[:, None]
    fast, loop = (torch.stack(steps[m]) for m in ("auto", "loop"))
    check(bool(torch.isfinite(fast).all()), "generate: non-finite logits")
    err, scale = _rel_err(fast, loop)
    check(launches["auto"] == cfg.n_layers and launches["loop"] == 0,
          f"generate: flash_attention launched {launches} in the two "
          f"prefills, expected {cfg.n_layers} (fast) and 0 (loop)")
    log(f"  dense generate prefill {Bg} x {Pg} f32: fast (forward_prefill, "
        f"{launches['auto']} K2 launches) {1e3 * out['auto'][2]:.3f} ms, "
        f"loop ({Pg} decode steps, {launches['loop']} launches) "
        f"{1e3 * out['loop'][2]:.3f} ms; logits of the prefill and "
        f"{DENSE_DECODE_STEPS} decode steps fast vs loop: max abs err "
        f"{err:.5g}, max-abs {scale:.5g}; tolerance {SSM_TOL} x max-abs = "
        f"{SSM_TOL * scale:.5g}")
    check(err <= SSM_TOL * scale,
          f"generate: fast and loop prefill differ by {err} > "
          f"{SSM_TOL * scale}")
    del out, steps, fast, loop

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n0 = (fa_ops.flash_attention.launches, pa_ops.paged_attention.launches)
    t0 = time.perf_counter()
    with torch.no_grad():
        toks = S.generate(cfg, params, prompts, max_new=new, temperature=0.0,
                          seed=seed, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gen_launches = fa_ops.flash_attention.launches - n0[0]
    check(gen_launches == cfg.n_layers and
          pa_ops.paged_attention.launches == n0[1],
          f"generate: K2 launched {gen_launches} times (expected "
          f"{cfg.n_layers}), K3 {pa_ops.paged_attention.launches - n0[1]}")
    check(tuple(toks.shape) == (Bg, Pg + new) + frame and
          torch.equal(toks[:, :Pg], prompts) and
          bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"generate: bad output {tuple(toks.shape)}")
    unit = "frames" if frame else "tokens"
    log(f"  dense generate {Bg} prompts x {Pg} {unit} + {new} new, greedy, "
        f"bf16: {gen_s:.3f} s, {Bg * new / gen_s:.1f} new {unit}/s, "
        f"{1e3 * gen_s / (new + 1):.3f} ms per step (one prefill, {new} "
        f"decode steps), peak allocated {peak_gb:.3f} GB; K2 launches "
        f"{gen_launches} (one prefill)")
    return {"generate_launches": gen_launches,
            "generate_tokens_per_s": Bg * new / gen_s}


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


def _counters():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.gossip_mix import ops as gm_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return (gm_ops.gossip_mix, fa_ops.flash_attention,
            pa_ops.paged_attention, ssd_ops.ssd_scan)


def _distinct(plan, steps: int) -> int:
    """Distinct realizations the topology drew over ``steps`` steps."""
    return len({plan.topology.realization(k).structure_key()
                for k in range(steps)})


def _train_run(torch, T, args, what, k1_per_step=1):
    """One driver run with the counters zeroed before and read after: the
    losses and consensus finite, K1 ``k1_per_step`` times a step (0 when
    every round is runtime-valued) and no other kernel, one executable per
    distinct realization drawn.  Returns the run and its metrics."""
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    res = T.run(args)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plan, hist, cfg = res["plan"], res["history"], res["config"]
    losses = [h["loss"] for h in hist]
    cons = [h["consensus"] for h in hist]
    check(len(hist) == args.steps and all(
        abs(v) < float("inf") for v in losses + cons),
        f"{what}: losses {losses}, consensus {cons}")
    want = {"gossip_mix": k1_per_step * args.steps, "flash_attention": 0,
            "paged_attention": 0, "ssd_scan": 0}
    check(launches == want, f"{what}: launches {launches}, expected {want} "
          "(one f32 payload group a step; K2 and K4 are forward-only)")
    distinct = _distinct(plan, args.steps)
    check(plan.num_compiled == distinct,
          f"{what}: {plan.num_compiled} executables for {distinct} distinct "
          "realizations")
    step_ms = 1e3 * sorted(res["step_s"][1:])[len(res["step_s"][1:]) // 2]
    tokens = args.nodes * args.batch * args.seq
    log(f"  {what}: losses {[round(v, 5) for v in losses]}; consensus per "
        f"step {[f'{v:.4g}' for v in cons]}")
    log(f"  {what}: step ms {[round(1e3 * t, 3) for t in res['step_s']]}; "
        f"median of steps 2-{args.steps} {step_ms:.3f} ms = "
        f"{tokens / step_ms * 1e3:.1f} tokens/s; peak allocated "
        f"{peak_gb:.3f} GB; launches {launches}; {plan.num_compiled} "
        f"executables for {distinct} distinct realizations, cache "
        f"{plan.cache_stats()}")
    return res, {"launches": launches["gossip_mix"], "step_ms": step_ms,
                 "tokens_per_s": tokens / step_ms * 1e3, "peak_gb": peak_gb,
                 "layers": cfg.n_layers}


def _within_chunked(got, want, tol, cols: int = 1 << 26):
    """``within`` and ``max_err`` block of columns by block, so a
    payload-sized comparison holds no payload-sized temporaries."""
    ok, err = True, 0.0
    for j in range(0, got.shape[1], cols):
        g, w = got[:, j:j + cols], want[:, j:j + cols]
        ok = ok and within(g, w, tol)
        err = max(err, max_err(g, w))
    return ok, err


def _k1_at_payload(torch, buf, recv, what):
    """K1 on a training payload (one packed f32 group) and the buffer it
    receives: against its plain version at 1e-5, then the kernel and
    ``torch.lerp`` in turns, the plain version, and the bytes bound."""
    from repro_torch.kernels.gossip_mix import ops, ref
    got = ops.gossip_mix(buf, [recv], w_self=0.5, ws=(0.5,))
    want = ref.gossip_mix_ref(buf, [recv], 0.5, (0.5,))
    tol = GOSSIP_TOL["float32"]
    ok, err = _within_chunked(got, want, tol)
    check(ok, f"gossip_mix at {what}: max abs err {err} beyond {tol}")
    del got, want
    t = time_turns({
        "kernel": lambda: ops.gossip_mix(buf, [recv], w_self=0.5, ws=(0.5,)),
        "lerp": lambda: torch.lerp(buf, recv, 0.5)},
        timer=lambda f: time_ms(f, iters=5, warmup=1))
    plain_ms = time_ms(lambda: ref.gossip_mix_ref(buf, [recv], 0.5, (0.5,)),
                       iters=3, warmup=1)
    n = buf.numel()
    bound_ms, bound_by = bound_us(3 * n, 3 * 4 * n, PEAK_F32_FLOPS)
    bound_ms /= 1e3
    ms, lerp_ms = t["kernel"], t["lerp"]
    log(f"  K1 at {what} {tuple(buf.shape)} f32 ({n / 2**31:.3f} x 2^31 "
        f"elements): max abs err {err:.3g} (tolerance {tol}); kernel "
        f"{ms:.4f} ms ({12 * n / ms / 1e6:.1f} GB/s, "
        f"{100 * bound_ms / ms:.1f} % of the bound), lerp {lerp_ms:.4f} ms "
        f"(kernel / lerp {ms / lerp_ms:.4f}), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return {"shape": list(buf.shape), "ms": ms, "lerp_ms": lerp_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "max_abs_err": err}


def train_phase(torch, dev, seed):
    from repro_torch.core import flatbuf, gossip
    from repro_torch.kernels.gossip_mix import ops as gm_ops
    from repro_torch.launch import train as T
    args = T.parse_args(TRAIN_ARGV + ["--seed", str(seed)])
    log(f"  {args.arch} at full width, depth cut to {args.layers} layers "
        f"(28 layers x 4 nodes of x, m, g and the gossip payload do not "
        f"fit in 80 GB); {args.nodes} nodes, {args.topology}, "
        f"{args.optimizer} beta {args.beta}, batch {args.batch} x "
        f"{args.seq} tokens per node, {args.steps} steps, hetero "
        f"{args.hetero}")
    res, out = _train_run(torch, T, args, "train")
    plan = res["plan"]

    # K1 at the training payload: (m_next, x_next) packed, one f32 group
    _, bufs = flatbuf.pack((res["state"].momentum, res["params"]))
    check(len(bufs) == 1, f"train: {len(bufs)} payload groups")
    buf = bufs[0]
    del bufs
    recv = torch.roll(buf, plan.realization(args.steps).shifts[0][0], 0)
    pay = _k1_at_payload(torch, buf, recv, "the training payload")
    del buf, recv

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
    out.update({f"train_payload_{k}": v for k, v in pay.items()})
    return out


# ---------------------------------------------------------------------------
# phase 7: ssm, the mamba2-1.3b main path
# ---------------------------------------------------------------------------

def _rel_err(got, want) -> tuple[float, float]:
    return max_err(got, want), float(want.float().abs().max())


def ssm_phase(torch, dev, seed):
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.gossip_mix import ops as gm_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    cfg = dataclasses.replace(configs.get_config("mamba2-1.3b"),
                              attention_impl="pallas")
    f32_cfg = dataclasses.replace(cfg, activation_dtype=torch.float32)
    t0 = time.perf_counter()
    params = M.init(cfg, seed, device=dev)
    torch.cuda.synchronize()
    log(f"  init {cfg.name} ({M.param_count(params) / 1e6:.1f} M params, "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, d_state "
        f"{cfg.d_state}, {cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} "
        f"heads of {cfg.ssm_head_dim}) on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SSM_B, SSM_S))).to(dev)
    counters = (ssd_ops.ssd_scan, fa_ops.flash_attention,
                pa_ops.paged_attention, gm_ops.gossip_mix)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    with torch.no_grad():
        # forward through K4: one call to warm up, then timed calls
        secs = []
        for i in range(4):
            n0 = ssd_ops.ssd_scan.launches
            t0 = time.perf_counter()
            logits, _ = M.forward(params, cfg, tokens)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            check(ssd_ops.ssd_scan.launches - n0 == cfg.n_layers,
                  f"ssm: forward {i} launched ssd_scan "
                  f"{ssd_ops.ssd_scan.launches - n0} times, expected "
                  f"{cfg.n_layers}")
        check(bool(torch.isfinite(logits).all()), "ssm: non-finite logits")
        check(tuple(logits.shape) == (SSM_B, SSM_S, cfg.vocab_size),
              f"ssm: logits shape {tuple(logits.shape)}")
        fwd_ms = 1e3 * sorted(secs[1:])[len(secs[1:]) // 2]
        logits32, _ = M.forward(params, f32_cfg, tokens)
        n_fwd = len(secs) + 1

        # decode against forward
        Bd, Sd = SSM_DECODE
        short = tokens[:Bd, :Sd]
        full, _ = M.forward(params, f32_cfg, short)
        n_fwd += 1
        cache = M.init_cache(cfg, batch=Bd, cache_len=Sd,
                             dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        outs = []
        for t in range(Sd):
            lg, cache = M.decode_step(params, f32_cfg, short[:, t:t + 1],
                                      cache, t)
            outs.append(lg)
        dec = torch.cat(outs, dim=1)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        dec_err, dec_scale = _rel_err(dec, full)
        del full, dec, outs, cache

        # generate: the family's serving path
        Bg, Pg, new = SSM_GEN
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (Bg, Pg))).to(dev)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = S.generate(cfg, params, prompts, max_new=new, temperature=0.0,
                         seed=seed, device=dev)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    check(launches["ssd_scan"] == cfg.n_layers * n_fwd,
          f"ssm: ssd_scan launched {launches['ssd_scan']} times, expected "
          f"{cfg.n_layers} x {n_fwd} forward calls")
    check(all(v == 0 for k, v in launches.items() if k != "ssd_scan"),
          f"ssm: other kernels launched {launches}")
    check(tuple(out.shape) == (Bg, Pg + new), f"ssm: generate {out.shape}")
    check(torch.equal(out[:, :Pg], prompts), "ssm: generate lost the prompt")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "ssm: generated token out of vocab")
    log(f"  forward {SSM_B} x {SSM_S} tokens through K4: "
        f"{[round(1e3 * t, 3) for t in secs]} ms; median of calls 2-4 "
        f"{fwd_ms:.3f} ms = {SSM_B * SSM_S / fwd_ms * 1e3:.1f} tokens/s")
    log(f"  launches on the main path: {launches} ({cfg.n_layers} x "
        f"{n_fwd} forward calls; decode and generate run no kernel)")

    # the same forwards with the plain chunked scan, on the card
    with torch.no_grad():
        t0 = time.perf_counter()
        plain, _ = M.forward(params, dataclasses.replace(
            cfg, attention_impl="jnp"), tokens)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        plain32, _ = M.forward(params, dataclasses.replace(
            f32_cfg, attention_impl="jnp"), tokens)
    check(ssd_ops.ssd_scan.launches == launches["ssd_scan"],
          "ssm: the plain forward launched K4")
    err16, scale16 = _rel_err(logits, plain)
    agree16 = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    log(f"  bf16 (not checked, see SSM_TOL): K4 vs plain forward max abs "
        f"err {err16:.5g} of max-abs {scale16:.5g}, greedy agreement "
        f"{agree16:.4f}; plain forward {1e3 * plain_s:.3f} ms")
    del logits, plain
    err, scale = _rel_err(logits32, plain32)
    agree = float((logits32.argmax(-1) == plain32.argmax(-1)).float().mean())
    log(f"  f32: K4 forward vs plain ssd_chunked forward: max abs err "
        f"{err:.5g}, logits max-abs {scale:.5g}; tolerance {SSM_TOL} x "
        f"max-abs = {SSM_TOL * scale:.5g}; greedy agreement {agree:.4f}")
    check(err <= SSM_TOL * scale,
          f"ssm: K4 and plain forward differ by {err} > {SSM_TOL * scale}")
    log(f"  f32: decode {Bd} x {Sd} tokens vs K4 forward: max abs err "
        f"{dec_err:.5g}, logits max-abs {dec_scale:.5g}; tolerance "
        f"{SSM_TOL} x max-abs = {SSM_TOL * dec_scale:.5g}; "
        f"{1e3 * dec_s / Sd:.3f} ms per decode step")
    check(dec_err <= SSM_TOL * dec_scale,
          f"ssm: decode vs forward differ by {dec_err} > "
          f"{SSM_TOL * dec_scale}")
    steps = Pg + new
    log(f"  generate {Bg} prompts x {Pg} tokens + {new} new, greedy: "
        f"{gen_s:.3f} s, {Bg * new / gen_s:.1f} new tokens/s, "
        f"{1e3 * gen_s / steps:.3f} ms per decode step ({steps} steps), "
        f"peak allocated {peak_gb:.3f} GB")
    return {"launches": launches["ssd_scan"], "forward_calls": n_fwd,
            "forward_ms": fwd_ms,
            "forward_tokens_per_s": SSM_B * SSM_S / fwd_ms * 1e3,
            "generate_tokens_per_s": Bg * new / gen_s,
            "decode_step_ms": 1e3 * gen_s / steps, "peak_gb": peak_gb}


# ---------------------------------------------------------------------------
# phase 8: hybrid, the zamba2-1.2b main path
# ---------------------------------------------------------------------------

def hybrid_phase(torch, dev, seed):
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.gossip_mix import ops as gm_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    cfg = dataclasses.replace(configs.get_config("zamba2-1.2b"),
                              attention_impl="pallas")
    f32_cfg = dataclasses.replace(cfg, activation_dtype=torch.float32)
    n_groups = cfg.n_layers // cfg.shared_attn_every
    per_call = {"ssd_scan": cfg.n_layers, "flash_attention": n_groups,
                "paged_attention": 0, "gossip_mix": 0}
    t0 = time.perf_counter()
    params = M.init(cfg, seed, device=dev)
    torch.cuda.synchronize()
    log(f"  init {cfg.name} ({M.param_count(params) / 1e6:.1f} M params: "
        f"{cfg.n_layers} mamba layers, d_model {cfg.d_model}, d_state "
        f"{cfg.d_state}; the shared block ({cfg.n_heads} heads of "
        f"{cfg.head_dim}, kv {cfg.n_kv_heads}, d_ff {cfg.d_ff}) after each "
        f"group of {cfg.shared_attn_every}, {n_groups} times) on the card "
        f"in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (HYB_B, HYB_S))).to(dev)
    counters = (ssd_ops.ssd_scan, fa_ops.flash_attention,
                pa_ops.paged_attention, gm_ops.gossip_mix)

    def counts():
        return {c.__name__: c.launches for c in counters}

    def forward(c, toks):
        n0 = counts()
        logits, _ = M.forward(params, c, toks)
        n1 = counts()
        check({k: n1[k] - n0[k] for k in n1} == per_call,
              f"hybrid: a forward launched "
              f"{ {k: n1[k] - n0[k] for k in n1} }, expected {per_call}")
        return logits

    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    with torch.no_grad():
        secs = []
        for _ in range(4):
            t0 = time.perf_counter()
            logits = forward(cfg, tokens)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(logits).all()), "hybrid: non-finite logits")
        check(tuple(logits.shape) == (HYB_B, HYB_S, cfg.vocab_size),
              f"hybrid: logits shape {tuple(logits.shape)}")
        fwd_ms = 1e3 * sorted(secs[1:])[len(secs[1:]) // 2]
        logits32 = forward(f32_cfg, tokens)
        n_fwd = len(secs) + 1

        # decode against forward
        Bd, Sd = HYB_DECODE
        short = tokens[:Bd, :Sd]
        full = forward(f32_cfg, short)
        n_fwd += 1
        cache = M.init_cache(cfg, batch=Bd, cache_len=Sd,
                             dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        outs = []
        for t in range(Sd):
            lg, cache = M.decode_step(params, f32_cfg, short[:, t:t + 1],
                                      cache, t)
            outs.append(lg)
        dec = torch.cat(outs, dim=1)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        dec_err, dec_scale = _rel_err(dec, full)
        del full, dec, outs, cache

        # generate: the family's serving path
        Bg, Pg, new = HYB_GEN
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (Bg, Pg))).to(dev)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = S.generate(cfg, params, prompts, max_new=new, temperature=0.0,
                         seed=seed, device=dev)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    launches = counts()
    check(launches == {k: v * n_fwd for k, v in per_call.items()},
          f"hybrid: launches {launches}, expected {per_call} x {n_fwd} "
          f"forward calls")
    check(tuple(out.shape) == (Bg, Pg + new), f"hybrid: generate {out.shape}")
    check(torch.equal(out[:, :Pg], prompts),
          "hybrid: generate lost the prompt")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "hybrid: generated token out of vocab")
    log(f"  forward {HYB_B} x {HYB_S} tokens through K4 and K2: "
        f"{[round(1e3 * t, 3) for t in secs]} ms; median of calls 2-4 "
        f"{fwd_ms:.3f} ms = {HYB_B * HYB_S / fwd_ms * 1e3:.1f} tokens/s")
    log(f"  launches on the main path: {launches} ({per_call} per forward "
        f"call x {n_fwd}; decode and generate run no kernel)")

    # the same forwards with the plain chunked scan and attention
    with torch.no_grad():
        t0 = time.perf_counter()
        plain, _ = M.forward(params, dataclasses.replace(
            cfg, attention_impl="jnp"), tokens)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        plain32, _ = M.forward(params, dataclasses.replace(
            f32_cfg, attention_impl="jnp"), tokens)
    check(counts() == launches, "hybrid: the plain forward launched a kernel")
    err16, scale16 = _rel_err(logits, plain)
    agree16 = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    log(f"  bf16 (not checked, see SSM_TOL): K2/K4 vs plain forward max abs "
        f"err {err16:.5g} of max-abs {scale16:.5g}, greedy agreement "
        f"{agree16:.4f}; plain forward {1e3 * plain_s:.3f} ms")
    del logits, plain
    err, scale = _rel_err(logits32, plain32)
    agree = float((logits32.argmax(-1) == plain32.argmax(-1)).float().mean())
    log(f"  f32: K2/K4 forward vs plain forward (_sdpa, ssd_chunked): max "
        f"abs err {err:.5g}, logits max-abs {scale:.5g}; tolerance "
        f"{SSM_TOL} x max-abs = {SSM_TOL * scale:.5g}; greedy agreement "
        f"{agree:.4f}")
    check(err <= SSM_TOL * scale,
          f"hybrid: K2/K4 and plain forward differ by {err} > "
          f"{SSM_TOL * scale}")
    log(f"  f32: decode {Bd} x {Sd} tokens vs K2/K4 forward: max abs err "
        f"{dec_err:.5g}, logits max-abs {dec_scale:.5g}; tolerance "
        f"{SSM_TOL} x max-abs = {SSM_TOL * dec_scale:.5g}; "
        f"{1e3 * dec_s / Sd:.3f} ms per decode step")
    check(dec_err <= SSM_TOL * dec_scale,
          f"hybrid: decode vs forward differ by {dec_err} > "
          f"{SSM_TOL * dec_scale}")
    steps = Pg + new
    log(f"  generate {Bg} prompts x {Pg} tokens + {new} new, greedy: "
        f"{gen_s:.3f} s, {Bg * new / gen_s:.1f} new tokens/s, "
        f"{1e3 * gen_s / steps:.3f} ms per decode step ({steps} steps), "
        f"peak allocated {peak_gb:.3f} GB")
    return {"launches": launches, "per_call": per_call,
            "forward_calls": n_fwd, "forward_ms": fwd_ms,
            "forward_tokens_per_s": HYB_B * HYB_S / fwd_ms * 1e3,
            "generate_tokens_per_s": Bg * new / gen_s,
            "decode_step_ms": 1e3 * gen_s / steps, "peak_gb": peak_gb}


# ---------------------------------------------------------------------------
# phase 9: train ssm and hybrid, d_adamw / qg_dmsgd, aperiodic gossip
# ---------------------------------------------------------------------------

# (a) mamba2-1.3b at full width, depth cut to 4 layers (0.21 B params: the
# tied 50,280 x 2048 embedding and 25.9 M a layer): x, mu, nu, g, the
# three *_next trees, the bias-corrected moments, and the gossip's packed
# payload, received copy and output are ~19 f32 trees of 4 x 0.21 B
# (3.3 GB each), reckoned ~60 GB; 8 layers would not fit in 80 GB
SSM_TRAIN_ARGV = ["--arch", "mamba2-1.3b", "--full", "--layers", "4",
                  "--nodes", "4", "--topology", "random_match",
                  "--optimizer", "d_adamw", "--lr", "0.01", "--batch", "2",
                  "--seq", "128", "--steps", "6", "--hetero", "0.5",
                  "--log-every", "1", "--device", "cuda"]
# (b) zamba2-1.2b at full width, 6 layers: one shared-block application
HYB_TRAIN_ARGV = ["--arch", "zamba2-1.2b", "--full", "--layers", "6",
                  "--nodes", "4", "--topology", "one_peer_exp",
                  "--optimizer", "qg_dmsgd", "--batch", "2", "--seq", "128",
                  "--steps", "4", "--hetero", "0.5", "--log-every", "1",
                  "--device", "cuda"]
UNIFORM_STEPS = 4            # (c) reduced qwen3, uniform one-peer order
# (d) the checkpoint round trip, reduced mamba2 (a full-width checkpoint
# would write >= 10 GB to disk on every run)
CKPT_ARGV = ["--arch", "mamba2-1.3b", "--nodes", "4", "--optimizer",
             "d_adamw", "--topology", "random_match", "--batch", "2",
             "--seq", "64", "--steps", "5", "--ckpt-every", "2",
             "--log-every", "1", "--device", "cuda"]


def _adamw_payload(torch, res, steps):
    """K1 at the d_adamw payload: (mu, nu, x) packed as the gossip packs
    (mu_next, nu_next, x_next), one f32 group, gathered by the next step's
    matching.  Empties ``res`` so that the trees' memory goes back."""
    from repro_torch.core import flatbuf
    plan, mom = res["plan"], res["state"].momentum
    _, bufs = flatbuf.pack((mom["mu"], mom["nu"], res["params"]))
    check(len(bufs) == 1, f"d_adamw payload: {len(bufs)} dtype groups")
    buf = bufs[0]
    del bufs, mom
    res.clear()
    partner = plan.realization(steps).partner
    recv = buf.index_select(0, torch.as_tensor(partner, device=buf.device))
    return _k1_at_payload(torch, buf, recv, "the d_adamw payload")


def _uniform_run(torch, dev, seed, T):
    """``build_trainer`` over the uniform one-peer order on reduced qwen3:
    UNIFORM_STEPS steps with the kernel, counters zeroed before and read
    after, then the same steps with the plain combine."""
    from repro_torch import configs
    from repro_torch.core import gossip, schedule, topology
    from repro_torch.data import SyntheticLM
    from repro_torch.models import model as M
    cfg = configs.reduced_config(configs.get_config("qwen3-0.6b"))
    n = 4
    data = SyntheticLM(cfg.vocab_size, n, hetero=0.5, seed=seed)
    lr_fn = schedule.warmup_step_decay(0.05, 2, [100])
    batches = [{"tokens": torch.from_numpy(data.sample(k, 2, 64))}
               for k in range(UNIFORM_STEPS)]

    def train():
        top = topology.one_peer_exponential(n, schedule="uniform", seed=seed)
        opt, step_for = T.build_trainer(cfg, top, "dmsgd", 0.9)
        stacked = T.stack_nodes(M.init(cfg, seed, device=dev), n)
        state = opt.init(stacked)
        losses = []
        for k in range(UNIFORM_STEPS):
            stacked, state, loss = step_for(k)(stacked, state, batches[k],
                                               lr_fn(k))
            losses.append(float(loss))
        return stacked, state, losses, step_for.plan

    counters = _counters()
    for c in counters:
        c.launches = 0
    x1, s1, losses, plan = train()
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    want = {"gossip_mix": UNIFORM_STEPS, "flash_attention": 0,
            "paged_attention": 0, "ssd_scan": 0}
    check(launches == want, f"uniform: launches {launches}, expected {want}")
    check(all(abs(v) < float("inf") for v in losses),
          f"uniform: losses {losses}")
    draws = [plan.topology.realization(k).shifts[0][0]
             for k in range(UNIFORM_STEPS)]
    distinct = _distinct(plan, UNIFORM_STEPS)
    check(plan.num_compiled == distinct,
          f"uniform: {plan.num_compiled} executables for {distinct} draws")
    gossip.set_kernel_mode("off")
    try:
        x2, s2, losses2, _ = train()
    finally:
        gossip.set_kernel_mode("auto")
    dx, dm = _max_diff(x1, x2), _max_diff(s1.momentum, s2.momentum)
    sx, sm = _max_abs(x2), _max_abs(s2.momentum)
    log(f"  (c) reduced {cfg.name}, one_peer_exp_uniform (shifts drawn "
        f"{draws}), dmsgd, {n} nodes, {UNIFORM_STEPS} steps: losses "
        f"{[round(v, 5) for v in losses]}; launches {launches}; "
        f"{plan.num_compiled} executables for {distinct} distinct draws; "
        f"kernel vs plain combine: params {dx:.3g} (max-abs {sx:.4g}), "
        f"momentum {dm:.3g} (max-abs {sm:.4g}), tolerance {TRAIN_TOL} x "
        "max-abs")
    check(dx <= TRAIN_TOL * sx and dm <= TRAIN_TOL * sm,
          f"uniform: kernel and plain runs differ (params {dx}, "
          f"momentum {dm})")
    return launches["gossip_mix"]


def _checkpoint_run(torch, seed, T):
    """--ckpt-dir on the card, then ``restore`` onto the live trees: bit
    for bit, the same dtypes, on the card."""
    import tempfile

    from repro_torch import checkpoint
    from repro_torch.convert import train_state_to_jax
    gm = _counters()[0]
    with tempfile.TemporaryDirectory() as d:
        args = T.parse_args(CKPT_ARGV + ["--ckpt-dir", d, "--seed",
                                         str(seed)])
        gm.launches = 0
        res = T.run(args)
        torch.cuda.synchronize()
        launches = gm.launches
        saved = sorted(os.listdir(d))
        check(saved == ["step_2", "step_4"] and launches == args.steps,
              f"checkpoint: saved {saved}, {launches} K1 launches")
        live = train_state_to_jax(res["params"], res["state"].momentum,
                                  res["config"])
        got = checkpoint.restore(d, checkpoint.latest_step(d), live)
        nbytes = sum(f.stat().st_size for f in Path(d, "step_4").iterdir())
    leaves = []

    def walk(a, b):
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            else:
                leaves.append((a[k], b[k]))

    walk(got, live)
    for g, w in leaves:
        check(g.dtype == w.dtype and g.device == w.device
              and torch.equal(g, w),
              "checkpoint: a restored leaf differs from the live one")
    log(f"  (d) reduced mamba2-1.3b, d_adamw over random_match, "
        f"--ckpt-every {args.ckpt_every}, {args.steps} steps: saved "
        f"{saved} ({nbytes / 1e6:.2f} MB at step 4); restore of step 4 "
        f"onto the live trees on the card: {len(leaves)} leaves bit-equal, "
        f"same dtypes ({sorted({str(w.dtype) for _, w in leaves})}); "
        "full-width checkpoints left out (>= 10 GB to disk a run)")
    return launches


def train_families_phase(torch, dev, seed):
    from repro_torch.launch import train as T
    log("  (a) mamba2-1.3b at full width, depth cut to 4 layers (~19 f32 "
        "trees of 4 x 0.21 B parameters, reckoned ~60 GB; 8 layers do not "
        "fit in 80 GB), 4 nodes, d_adamw over random_match (aperiodic "
        "matchings)")
    args = T.parse_args(SSM_TRAIN_ARGV + ["--seed", str(seed)])
    res, ssm = _train_run(torch, T, args, "ssm d_adamw")
    payload = _adamw_payload(torch, res, args.steps)
    del res
    torch.cuda.empty_cache()
    log("  (b) zamba2-1.2b at full width, 6 layers (one shared-block "
        "application), 4 nodes, qg_dmsgd over one_peer_exp")
    res, hyb = _train_run(torch, T, T.parse_args(
        HYB_TRAIN_ARGV + ["--seed", str(seed)]), "hybrid qg_dmsgd")
    del res
    torch.cuda.empty_cache()
    uniform = _uniform_run(torch, dev, seed, T)
    ckpt = _checkpoint_run(torch, seed, T)
    return {"ssm": ssm, "hybrid": hyb, "payload": payload,
            "launches": {"ssm_d_adamw": ssm["launches"],
                         "hybrid_qg_dmsgd": hyb["launches"],
                         "uniform": uniform, "checkpoint": ckpt}}


# ---------------------------------------------------------------------------
# phase 10: runtime-valued gossip and the paper's figures
# ---------------------------------------------------------------------------

# (a) phase 6's run with simulated stragglers, per-node deadline gating
# and AL-DSGD weights: every round is runtime-valued (no K1)
STRAGGLER_ARGV = TRAIN_ARGV + ["--deadline-skip", "--straggler-prob",
                               "0.25", "--loss-aware"]
# (a') every node alive: the runtime combine derives self weight 1/2, the
# K1 run's static weight
ALL_ALIVE_ARGV = TRAIN_ARGV + ["--deadline-skip", "--straggler-prob", "0"]
SCHED_NODES, SCHED_ELEMS = 8, (1 << 20) + 3      # (b): f32 elements a node
SCHED_GATES = [True, False, False, True, False, True]
FIGURE_SUITES = ["spectral_gap", "consensus", "transient", "hetero"]
# the booleans the figures' derived columns must hold (and the
# finite-time zeros, base_k2_zero_at_5 and its kin)
FIGURE_CLAIMS = {"exp>grid>ring", "one_peer_zero_at_tau", "static_nonzero",
                 "perm_zero", "unif_not_periodic", "n48_not_periodic",
                 "exp<grid<ring", "ring_degrades_faster",
                 "skip_beats_wait_wallclock"}


def _stragglers(torch, T, seed):
    args = T.parse_args(STRAGGLER_ARGV + ["--seed", str(seed)])
    log(f"  (a) {args.arch} at full width, {args.layers} layers, "
        f"{args.nodes} nodes, {args.topology}, {args.optimizer}, "
        f"--deadline-skip --straggler-prob {args.straggler_prob} "
        "--loss-aware: every round runtime-valued (no K1)")
    res, out = _train_run(torch, T, args, "stragglers", k1_per_step=0)
    log(f"  (a) alive per step {res['alive']} (numpy draws "
        "default_rng(2**20 + step).random(n) >= p)")
    check(res["state"].sched_pos is None, "stragglers: a schedule position")
    return out


def _runtime_against_k1(torch, T, seed):
    """(a') phase 6's static run (K1) and the same run through the
    runtime combine with every node alive, held within TRAIN_TOL x
    max-abs; then one round of each at the training payload, in turns."""
    from repro_torch.core import gossip
    from repro_torch.core.topology import Gated
    res, static = _train_run(torch, T, T.parse_args(
        TRAIN_ARGV + ["--seed", str(seed)]), "static (K1)")
    x1, m1 = res["params"], res["state"].momentum
    del res
    res, runtime = _train_run(torch, T, T.parse_args(
        ALL_ALIVE_ARGV + ["--seed", str(seed)]), "all alive (runtime)",
        k1_per_step=0)
    check(all(all(a) for a in res["alive"]), "all alive: a node was dropped")
    x2, m2 = res["params"], res["state"].momentum
    dx, dm = _max_diff(x2, x1), _max_diff(m2, m1)
    sx, sm = _max_abs(x1), _max_abs(m1)
    log(f"  (a') runtime combine (all alive) vs K1 after 6 steps: params "
        f"max abs diff {dx:.3g} (max-abs {sx:.4g}), momentum {dm:.3g} "
        f"(max-abs {sm:.4g}); tolerance {TRAIN_TOL} x max-abs")
    check(dx <= TRAIN_TOL * sx and dm <= TRAIN_TOL * sm,
          f"runtime vs K1: params {dx}, momentum {dm}")
    del x1, m1
    torch.cuda.empty_cache()
    # one gossip round at the training payload: the static round (pack,
    # roll, K1, unpack) against the runtime round (pack, roll, f32
    # combine with an all-alive gate, unpack), in turns
    payload = (m2, x2)
    r = res["plan"].realization(6)
    alive = torch.ones(len(res["alive"][0]), dtype=torch.bool,
                       device=x2[next(iter(x2))].device)
    del res
    nbytes = sum(v.numel() * 4 for v in x2.values()) * 2
    t = time_turns({
        "k1_round": lambda: gossip.mix_realization(payload, r),
        "runtime_round": lambda: gossip.mix_realization(
            payload, Gated(r, alive))},
        timer=lambda f: time_ms(f, iters=3, warmup=1))
    log(f"  (a') one gossip round at the training payload ({nbytes / 1e9:.3f}"
        f" GB f32): K1 round {t['k1_round']:.3f} ms, runtime round "
        f"{t['runtime_round']:.3f} ms (runtime / K1 "
        f"{t['runtime_round'] / t['k1_round']:.3f})")
    return {"static": static, "runtime": runtime, "params_diff": dx,
            "momentum_diff": dm, "k1_round_ms": t["k1_round"],
            "runtime_round_ms": t["runtime_round"], "payload_gb": nbytes / 1e9}


def _scheduled_skips(torch, dev, seed):
    """(b) Lemma 1 with interleaved skips: dmsgd(when=...) over the
    one-peer exponential graph of 8 nodes, zero gradients (pure gossip),
    through a GossipPlan; after 3 communicating rounds every node holds
    the node mean, the position counts the communicating rounds, and K1
    ran every round, the skipped ones too (their result discarded)."""
    from repro_torch.core import optim, topology
    from repro_torch.core.plan import GossipPlan
    gm = _counters()[0]
    n = SCHED_NODES
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    params = {"a": torch.randn((n, 1 << 20), generator=g, device=dev),
              "b": torch.randn((n, 3), generator=g, device=dev)}
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    opt = optim.dmsgd(topology.one_peer_exponential(n), beta=0.9,
                      when=lambda ctx: ctx.aux["comm"])
    plan = GossipPlan.for_optimizer(
        opt, fn=lambda mix, p, s, gr, lr, aux: opt.update_with_mix(
            p, s, gr, lr, mix, aux=aux))
    state = opt.init(params)
    torch.cuda.synchronize()
    gm.launches = 0
    for k, c in enumerate(SCHED_GATES):
        params, state = plan.step_fn(k)(params, state, zeros, 0.05,
                                        {"comm": torch.tensor(c)})
    torch.cuda.synchronize()
    launches = gm.launches
    comms = sum(SCHED_GATES)
    dev_max = 0.0
    for v in params.values():
        mean = v.mean(0, keepdim=True)
        dev_max = max(dev_max, float((v - mean).abs().max()))
        check(bool(((v - mean).abs() <= LEMMA_TOL + LEMMA_TOL * mean.abs())
                   .all()), "scheduled skips: not averaged after 3 "
              "communicating rounds")
    log(f"  (b) dmsgd(when=...) over one_peer_exp({n}), {SCHED_ELEMS} f32 "
        f"elements a node, gates {SCHED_GATES}: sched_pos "
        f"{int(state.sched_pos)} (communicating rounds {comms}), max "
        f"deviation from the node mean {dev_max:.3g} (tolerance "
        f"rtol=atol={LEMMA_TOL}), K1 launches {launches} over "
        f"{len(SCHED_GATES)} rounds, {plan.num_compiled} executable")
    check(int(state.sched_pos) == comms, "scheduled skips: sched_pos")
    check(launches == len(SCHED_GATES),
          f"scheduled skips: {launches} K1 launches")
    check(plan.num_compiled == 1, "scheduled skips: executables")
    return launches


class _Tee:
    """A stdout that also keeps what is written (the suites print their
    CSV rows)."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def rows(self) -> list:
        """(name, us, derived) of every CSV row written."""
        return [tuple(ln.split(",", 2)) for ln in "".join(self.text)
                .splitlines() if ln.count(",") >= 2
                and not ln.startswith("name,")]


def _derived_claims(rows) -> dict:
    """``{"row:key": bool}`` for every boolean of the derived columns."""
    out = {}
    for name, _, derived in rows:
        for kv in derived.split(";"):
            key, _, val = kv.partition("=")
            if val in ("True", "False"):
                out[f"{name}:{key}"] = val == "True"
    return out


def _figures(torch, dev):
    """(c) every figure suite on the card at the reference's default
    sizes, then the straggler trade at run_quick's size; each CSV line
    printed, each derived boolean held True."""
    import contextlib

    from repro_torch.benchmarks import bench_hetero
    from repro_torch.benchmarks import run as bench_run
    gm = _counters()[0]
    log("name,us_per_call,derived")
    seconds, launches = {}, {}
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        for name in FIGURE_SUITES:
            gm.launches = 0
            secs, failed = bench_run.run_suites([name], dev)
            torch.cuda.synchronize()
            check(not failed, f"figures: suite {name} raised")
            seconds[name], launches[name] = secs[name], gm.launches
        t0 = time.perf_counter()
        bench_hetero.run_quick(device=dev)
        seconds["hetero_quick"] = time.perf_counter() - t0
    rows = tee.rows()
    claims = _derived_claims(rows)
    keys = {k.split(":", 1)[1] for k in claims}
    missing = FIGURE_CLAIMS - keys
    check(not missing, f"figures: derived booleans missing: {missing}")
    zeros = [k for k in keys
             if "_zero_at_" in k and k.rsplit("_", 1)[1].isdigit()]
    check(len(zeros) == 4, f"figures: finite-time zeros {zeros}")
    dev_prop1 = float(next(kv.split("=")[1] for name, _, d in rows
                           if name == "spectral_gap_fig3"
                           for kv in d.split(";")
                           if kv.startswith("prop1_max_dev=")))
    false = [k for k, v in claims.items() if not v]
    log(f"  (c) seconds per suite {dict((k, round(v, 2)) for k, v in seconds.items())}; "
        f"K1 launches per suite {launches}; prop1_max_dev {dev_prop1:.3g}; "
        f"{len(claims)} derived booleans, false: {false}")
    check(dev_prop1 <= 1e-12, f"figures: prop1_max_dev {dev_prop1}")
    check(not false, f"figures: derived booleans false: {false}")
    check(launches["transient"] > 0, "figures: transient launched no K1")
    return {"seconds": seconds, "launches": launches}


def runtime_phase(torch, dev, seed):
    from repro_torch.launch import train as T
    t0 = time.perf_counter()
    a = _stragglers(torch, T, seed)
    torch.cuda.empty_cache()
    vs = _runtime_against_k1(torch, T, seed)
    torch.cuda.empty_cache()
    sched = _scheduled_skips(torch, dev, seed)
    torch.cuda.empty_cache()
    figs = _figures(torch, dev)
    log(f"  phase 10 took {time.perf_counter() - t0:.1f} s")
    return {"stragglers": a, "against_k1": vs, "figures": figs,
            "launches": {"stragglers": a["launches"],
                         "static_rerun": vs["static"]["launches"],
                         "all_alive": vs["runtime"]["launches"],
                         "scheduled_skips": sched,
                         **{f"figures_{k}": v
                            for k, v in figs["launches"].items()}}}


# ---------------------------------------------------------------------------
# phase 11: int8 wire compression and the overlapped (delayed-mix) pipeline
# ---------------------------------------------------------------------------

OVERLAP_ARGV = TRAIN_ARGV + ["--overlap"]
INT8_ARGV = TRAIN_ARGV + ["--compression", "int8"]
LEMMA_OVERLAP = (8, (1 << 20) + 3)   # (d): nodes, f32 elements a node
OVERLAP_ATOL = 1e-6                  # tests/test_overlap.py:158-185


class _Sequential:
    """The synchronous optimizer driven as the one-step-delayed recursion
    (tests/test_overlap.py:45-75's construction), all on the main stream:
    the previous payload is mixed synchronously (``mix``: the sync plan's
    executor of step t-1, None at step 0) and lands on the params and
    slots, then the chain runs with an identity mix."""

    overlap = False
    has_runtime_gossip = False

    def __init__(self, opt):
        self.opt, self.payload = opt, None

    def update_with_mix(self, p, s, g, lr, mix, aux=None):
        opt = self.opt
        if mix is not None:
            p, slots = opt._land(mix(self.payload), p, opt._slots_of(s))
            s = opt._state_of(slots, s.count)
        p2, s2 = opt.update_with_mix(p, s, g, lr, lambda t: t)
        slots2 = opt._slots_of(s2)
        parts = tuple({k: v.float() for k, v in (
            p2 if w == "x_next" else slots2[w[:-5]]).items()}
            for w in opt._overlap_names())
        self.payload = parts[0] if len(parts) == 1 else parts
        return p2, s2


def _sequential_delayed(torch, T, args):
    """The run of ``args`` (``--overlap`` aside) as the sequential
    delayed recursion through the same train step; the flushed params and
    momentum."""
    from repro_torch.core import optim
    from repro_torch.core.plan import GossipPlan
    from repro_torch.launch import steps as steps_mod
    start = T.prepare(args)
    opt = optim.make_optimizer(args.optimizer, start["topology"],
                               beta=args.beta,
                               momentum_dtype=start["momentum_dtype"],
                               compression=args.compression)
    sync = GossipPlan.for_optimizer(opt)
    seq = _Sequential(opt)
    step = steps_mod.make_train_step(start["config"], seq)
    p, s = start["params"], opt.init(start["params"])
    batches, lr_fn = start["batches"], start["lr_fn"]
    del start
    for k in range(args.steps):
        p, s, _ = step(sync.mix(k - 1) if k else None, p, s, batches[k],
                       lr_fn(k))
    p, slots = opt._land(sync.mix(args.steps - 1)(seq.payload), p,
                         opt._slots_of(s))
    return p, opt._state_of(slots, s.count).momentum


def _bit_equal(torch, a, b) -> bool:
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def _overlap_executables(plan, steps: int, logged: list) -> int:
    """The reference plan's executable count for a pipelined run: the
    prime, one per realization in flight at steps 1..T-1, one flush per
    realization drained (each logged step's and the final)."""
    key = lambda k: plan.topology.realization(k).structure_key()  # noqa
    return (1 + len({key(k) for k in range(steps - 1)})
            + len({key(k) for k in logged + [steps - 1]}))


def _overlap_report(timeline, steps: int, what: str) -> tuple:
    """The delayed rounds' device ms and the ms of each that ran while the
    per-node gradients ran (CUDA events on both streams); the medians."""
    from repro_torch.launch import steps as steps_mod
    rounds = [steps_mod.overlap_ms(m) for m in timeline]
    check(len(rounds) == steps - 1,
          f"{what}: {len(rounds)} delayed rounds timed")
    ms = sorted(r[0] for r in rounds)[len(rounds) // 2]
    under = sorted(r[1] for r in rounds)[len(rounds) // 2]
    log(f"  {what}: delayed round on the side stream, device ms per step "
        f"{[round(r[0], 3) for r in rounds]}, of which under the per-node "
        f"gradients {[round(r[1], 3) for r in rounds]}; median {ms:.3f} ms, "
        f"{under:.3f} ms ({100 * under / ms:.1f} %) concurrent")
    return ms, under


def _pipelined(torch, T, args, what):
    """(a)/(c): one ``--overlap`` run, counters zeroed before and read
    after, against the sequential delayed recursion, bit for bit."""
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    timeline: list = []
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    res = T.run(args, timeline=timeline)
    torch.cuda.synchronize()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plan, hist = res["plan"], res["history"]
    losses = [h["loss"] for h in hist]
    cons = [h["consensus"] for h in hist]
    check(len(hist) == args.steps and all(
        abs(v) < float("inf") for v in losses + cons),
        f"{what}: losses {losses}, consensus {cons}")
    logged = [h["step"] for h in hist]
    # K1: a delayed round at steps 1..T-1, a flush at each logged step and
    # at the end; an int8 round never takes K1
    k1 = 0 if args.compression else (args.steps - 1) + len(logged) + 1
    want = {"gossip_mix": k1, "flash_attention": 0, "paged_attention": 0,
            "ssd_scan": 0}
    check(launches == want, f"{what}: launches {launches}, expected {want}")
    execs = _overlap_executables(plan, args.steps, logged)
    check(plan.num_compiled == execs,
          f"{what}: {plan.num_compiled} executables, reckoned {execs}")
    step_ms = 1e3 * sorted(res["step_s"][1:])[len(res["step_s"][1:]) // 2]
    tokens = args.nodes * args.batch * args.seq
    log(f"  {what}: losses {[round(v, 5) for v in losses]}; consensus "
        f"(flushed view) {[f'{v:.4g}' for v in cons]}")
    log(f"  {what}: step ms {[round(1e3 * t, 3) for t in res['step_s']]}; "
        f"median of steps 2-{args.steps} {step_ms:.3f} ms = "
        f"{tokens / step_ms * 1e3:.1f} tokens/s; peak allocated "
        f"{peak_gb:.3f} GB; launches {launches} (reckoned K1 {k1}: " + (
            "an int8 round takes no K1" if args.compression else
            f"{args.steps - 1} delayed rounds + {len(logged)} logged "
            "flushes + 1 final flush") + f"); {plan.num_compiled} "
        f"executables (reckoned "
        f"{execs}: prime, realizations in flight, flushes), cache "
        f"{plan.cache_stats()}; allocator retries {retries} (each frees the "
        "cache: a device synchronisation)")
    ms, under = _overlap_report(timeline, args.steps, what)
    x1, m1 = res["params"], res["state"].momentum
    del res
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() - sum(
        t.numel() * t.element_size() for t in (*x1.values(), *m1.values()))
    log(f"  {what}: allocated beyond the final params and momentum once the "
        f"run returned: {held / 1e9:.3f} GB")
    x2, m2 = _sequential_delayed(torch, T, args)
    same = _bit_equal(torch, x1, x2) and _bit_equal(torch, m1, m2)
    log(f"  {what}: flushed params and momentum against the sequential "
        f"delayed recursion (synchronous pieces, main stream): "
        f"{'bit-equal' if same else 'DIFFERENT'} (params max abs diff "
        f"{_max_diff(x1, x2):.3g}, momentum {_max_diff(m1, m2):.3g})")
    check(same, f"{what}: pipelined and sequential delayed runs differ")
    return {"launches": launches["gossip_mix"], "step_ms": step_ms,
            "tokens_per_s": tokens / step_ms * 1e3, "peak_gb": peak_gb,
            "executables": plan.num_compiled, "delayed_ms": ms,
            "concurrent_ms": under, "layers": args.layers,
            "alloc_retries": retries}


def _int8_round(torch, res, args):
    """(b): one round at the training payload, K1 against int8 in turns,
    and the int8 error held to its bound against the f32 mix."""
    from repro_torch.core import flatbuf, gossip
    payload = (res["state"].momentum, res["params"])
    r = res["plan"].realization(args.steps)
    nbytes = sum(v.numel() * 4 for v in res["params"].values()) * 2
    t = time_turns({
        "k1_round": lambda: gossip.mix_realization(payload, r),
        "int8_round": lambda: gossip.mix_realization(payload, r,
                                                     compression="int8")},
        timer=lambda f: time_ms(f, iters=3, warmup=1))
    log(f"  (b) one gossip round at the training payload ({nbytes / 1e9:.3f}"
        f" GB f32): K1 round {t['k1_round']:.3f} ms, int8 round "
        f"{t['int8_round']:.3f} ms (int8 / K1 "
        f"{t['int8_round'] / t['k1_round']:.3f})")
    layout = flatbuf.layout_of(payload)
    g = layout.groups[0]
    _, bufs = flatbuf.pack(payload, layout)
    sc = gossip._scale_columns(bufs[0], g)
    del bufs
    # each receiver's bound: sum over its senders of w * scale / 2
    half = sum(w * torch.roll(sc, s, 0) for s, w in r.shifts) / 2
    exact = flatbuf.tree_flatten(gossip.mix_realization(payload, r))[0]
    quant = flatbuf.tree_flatten(gossip.mix_realization(
        payload, r, compression="int8"))[0]
    leaves = flatbuf.tree_flatten(payload)[0]
    n, worst = leaves[0].shape[0], 0.0
    for sl in g.slots:
        x = leaves[sl.leaf_index]
        err = (quant[sl.leaf_index] - exact[sl.leaf_index]).reshape(
            n, -1).abs().amax(1)
        lim = half[:, sl.scale_group] + 1e-6 * float(x.abs().max())
        check(bool((err <= lim).all()),
              f"int8 round: slot {sl.leaf_index} err {err.tolist()} beyond "
              f"{lim.tolist()}")
        worst = max(worst, float((err / lim).max()))
    log(f"  (b) int8 against the f32 mix of the same payload: every element "
        f"within sum_d w_d scale_(sender, group) / 2 + 1e-6 max|x| "
        f"({len(g.slots)} slots in {len(g.scale_groups)} scale groups); "
        f"largest error / bound {worst:.4f}")
    return {"k1_round_ms": t["k1_round"], "int8_round_ms": t["int8_round"],
            "payload_gb": nbytes / 1e9, "worst_err_over_bound": worst,
            "slot_gb": max(b - a for a, b in g.scale_ranges) * n * 4 / 1e9}


def _lemma_overlap(torch, dev, seed):
    """(d): dsgd(overlap=True) over one_peer_exp(8), zero gradients: one
    period of delayed rounds (on the side stream) and the flush reach the
    exact average."""
    from repro_torch.core import optim, topology
    from repro_torch.core.plan import GossipPlan
    gm = _counters()[0]
    n, elems = LEMMA_OVERLAP
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    params = {"a": torch.randn((n, elems - 3), generator=gen, device=dev),
              "b": torch.randn((n, 3), generator=gen, device=dev)}
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    top = topology.one_peer_exponential(n)
    opt = optim.dsgd(top, overlap=True)
    plan = GossipPlan.for_optimizer(
        opt, fn=lambda io, p, s, g: opt.update_pipelined(
            p, s, g, 0.0, io, pending=opt.start_delayed(p, s, io)))
    p, s = params, opt.init(params)
    torch.cuda.synchronize()
    gm.launches = 0
    for k in range(top.period):
        p, s = plan.step_fn(k)(p, s, zeros)
    p, s = plan.flush_step_fn(top.period)(p, s)
    torch.cuda.synchronize()
    dev_max = max(float((v - params[k].mean(0, keepdim=True)).abs().max())
                  for k, v in p.items())
    log(f"  (d) dsgd(overlap=True) over one_peer_exp({n}), {elems} f32 a "
        f"node, zero gradients: {top.period} steps (a period) and the flush, "
        f"max deviation from the initial node mean {dev_max:.3g} (atol "
        f"{OVERLAP_ATOL}); K1 launches {gm.launches}")
    check(dev_max <= OVERLAP_ATOL, "overlap: not averaged after a period")
    check(s.buf is None and gm.launches == top.period,
          f"overlap Lemma 1: {gm.launches} K1 launches")
    return gm.launches


def pipeline_phase(torch, dev, seed):
    from repro_torch.launch import train as T
    t0 = time.perf_counter()
    args = T.parse_args(OVERLAP_ARGV + ["--seed", str(seed)])
    log(f"  (a) phase 6's cell with --overlap: {args.arch}, {args.layers} "
        f"layers, {args.nodes} nodes, {args.topology}, {args.optimizer} beta "
        f"{args.beta}, {args.batch} x {args.seq} a node, {args.steps} steps")
    a = _pipelined(torch, T, args, "overlap")
    torch.cuda.empty_cache()

    args = T.parse_args(INT8_ARGV + ["--seed", str(seed)])
    log(f"  (b) the same cell with --compression int8, synchronous")
    res, b = _train_run(torch, T, args, "int8", k1_per_step=0)
    b.update(_int8_round(torch, res, args))
    del res
    torch.cuda.empty_cache()

    # (c) reckoned from (a): the int8 round on the side stream holds the
    # int8 copy, its received copy, one scale group's f32 quotient and the
    # accumulator, where the f32 round held the received copy and K1's
    # output
    payload_gb, slot_gb = b["payload_gb"], b["slot_gb"]
    est = a["peak_gb"] - 2 * payload_gb + (payload_gb / 2 + slot_gb
                                           + payload_gb)
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    layers = args.layers if est < 0.9 * card_gb else args.layers // 2
    log(f"  (c) int8 + overlap reckoned at {args.layers} layers: peak of (a)"
        f" {a['peak_gb']:.3f} GB - f32 round {2 * payload_gb:.3f} + int8 "
        f"round {payload_gb / 2 + slot_gb + payload_gb:.3f} = {est:.3f} GB "
        f"of {card_gb:.1f}; " + ("no cut" if layers == args.layers else
                                 f"depth cut {args.layers} -> {layers}"))
    args = T.parse_args(OVERLAP_ARGV + ["--compression", "int8", "--layers",
                                        str(layers), "--seed", str(seed)])
    c = _pipelined(torch, T, args, "int8 + overlap")
    torch.cuda.empty_cache()

    d = _lemma_overlap(torch, dev, seed)
    log(f"  phase 11 took {time.perf_counter() - t0:.1f} s")
    return {"overlap": a, "int8": b, "int8_overlap": c,
            "launches": {"overlap": a["launches"], "int8": b["launches"],
                         "int8_overlap": c["launches"], "lemma_overlap": d}}


# ---------------------------------------------------------------------------
# phase 12: moe, the granite-moe-3b-a800m main path
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-3b-a800m"
MOE_PATH = (2, 64, 4)        # (a): prompts, prompt length, decode steps
# (d) the depth cut, reckoned from phase 6's peak before the run: 51.85 GB
# for 4 nodes x 281 M parameters (qwen3-0.6b at 8 layers) is ~46 bytes a
# node's parameter (x, m, g, the next x and m, the packed payload, its
# received copy and the mixed output, all f32)
TRAIN_BYTES_PER_PARAM = 51.85e9 / (4 * 281e6)
MOE_TRAIN_ARGV = ["--arch", MOE_ARCH, "--full", "--layers", "2",
                  "--nodes", "4", "--topology", "one_peer_exp",
                  "--optimizer", "dmsgd", "--beta", "0.9", "--batch", "2",
                  "--seq", "128", "--steps", "6", "--hetero", "0.5",
                  "--log-every", "1", "--device", "cuda"]


@contextlib.contextmanager
def _plain_attention():
    """The model's attention calls K2's and K3's plain versions on the card
    (``ref.attention_ref``, ``ref.paged_attention_ref``) in place of their
    wrappers, for the comparison runs only; no kernel launches."""
    import types

    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.paged_attention import ref as pa_ref
    from repro_torch.models import attention as A
    saved = A.flash_ops, A.paged_ops
    A.flash_ops = types.SimpleNamespace(flash_attention=fa_ref.attention_ref)
    A.paged_ops = types.SimpleNamespace(
        paged_attention=lambda q, kp, vp, *a, **kw: pa_ref.paged_attention_ref(
            q, kp.to(q.dtype), vp.to(q.dtype), *a, **kw))
    try:
        yield
    finally:
        A.flash_ops, A.paged_ops = saved


def _paged_path(torch, dev, cfg, params, seed, what):
    """(a) A forward_prefill of 2 x 64 tokens (audio: frames of K codes)
    and 4 paged decode steps in f32 activations through K2 and K3,
    against the same with the plain attention, and the decode logits
    against a prefill over the prompt and the fed tokens (the experts
    dropless both), each within 2e-2 x max-abs."""
    import dataclasses

    import numpy as np

    from repro_torch.models import model as M
    B, P, steps = MOE_PATH
    ps = 16
    f32_cfg = dataclasses.replace(cfg, activation_dtype=torch.float32)
    n_per = -(-(P + steps) // ps)
    rng = np.random.default_rng(seed + 2)
    frame = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (B, P) + frame))
    table = torch.from_numpy(
        (1 + rng.permutation(B * n_per)).reshape(B, n_per).astype(np.int32))
    counters = _counters()
    with torch.no_grad():
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        kern, fed = _prefill_decode(torch, M, f32_cfg, params, tokens, table,
                                    dev, steps, ps, pool_dtype=torch.float32)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        with _plain_attention():
            plain, _ = _prefill_decode(torch, M, f32_cfg, params, tokens,
                                       table, dev, steps, ps, fed=fed,
                                       pool_dtype=torch.float32)
        torch.cuda.synchronize()
        check({c.__name__: c.launches for c in counters} == launches,
              f"{what}: the plain attention launched a kernel")
        whole = torch.cat([tokens] + [f.cpu() for f in fed], 1).to(dev)
        full, _ = M.forward_prefill(params, f32_cfg, whole)
        full = full[:, P - 1:].float().cpu().transpose(0, 1)
    want = {"gossip_mix": 0, "flash_attention": cfg.n_layers,
            "paged_attention": cfg.n_layers * steps, "ssd_scan": 0}
    check(launches == want, f"{what}: the path launched {launches}, "
          f"expected {want}")
    check(bool(torch.isfinite(kern).all()) and tuple(kern.shape) == (
        steps + 1, B) + frame + (cfg.vocab_size,),
        f"{what}: logits {tuple(kern.shape)}")
    err, scale = _rel_err(kern, plain)
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    log(f"  (a) prefill {B} x {P} + {steps} paged decode steps, f32: "
        f"launches {launches}; K2/K3 vs plain attention max abs err "
        f"{err:.5g}, logits max-abs {scale:.5g}; tolerance {MODEL_TOL} x "
        f"max-abs = {MODEL_TOL * scale:.5g}; greedy agreement {agree:.3f}")
    check(err <= MODEL_TOL * scale,
          f"{what}: K2/K3 and plain attention differ by {err} > "
          f"{MODEL_TOL * scale}")
    d_err, d_scale = _rel_err(kern, full)
    log(f"  (a) decode logits vs a prefill over the prompt and the fed "
        f"tokens: max abs err {d_err:.5g}, max-abs {d_scale:.5g}; "
        f"tolerance {MODEL_TOL * d_scale:.5g}")
    check(d_err <= MODEL_TOL * d_scale,
          f"{what}: decode vs prefill differ by {d_err} > "
          f"{MODEL_TOL * d_scale}")
    return {"max_abs_err": err, "decode_err": d_err}


def _train_at_payload(torch, T, args, per_node, what, note):
    """(d) ``launch.train.run`` of ``args`` at full width with its depth
    cut, the peak memory reckoned first from phase 6's bytes a parameter
    and printed beside the measured one (K1 once a step and no other
    kernel: ``_train_run``); then K1 at the run's payload, (m_next,
    x_next) packed in one f32 group, against the partner's copy the next
    one-peer round receives (``_k1_at_payload``)."""
    from repro_torch.core import flatbuf
    reckoned = TRAIN_BYTES_PER_PARAM * args.nodes * per_node / 1e9
    log(f"  (d) train: {args.arch} at full width, depth cut to "
        f"{args.layers} layers: {per_node / 1e6:.1f} M params a node x "
        f"{args.nodes} nodes x {TRAIN_BYTES_PER_PARAM:.1f} bytes (phase 6's "
        f"peak per parameter) = {reckoned:.1f} GB reckoned; "
        f"{args.topology}, {args.optimizer} beta {args.beta}, batch "
        f"{args.batch} x {args.seq} tokens a node, {args.steps} steps, "
        f"{note}")
    res, train = _train_run(torch, T, args, f"(d) {what} train")
    log(f"  (d) peak allocated {train['peak_gb']:.3f} GB against "
        f"{reckoned:.1f} GB reckoned")
    _, bufs = flatbuf.pack((res["state"].momentum, res["params"]))
    check(len(bufs) == 1, f"(d) {what} train: {len(bufs)} payload groups")
    buf = bufs[0]
    shift = res["plan"].realization(args.steps).shifts[0][0]
    del bufs, res
    recv = torch.roll(buf, shift, 0)
    train["payload"] = _k1_at_payload(torch, buf, recv,
                                      f"the {what} payload")
    del buf, recv
    torch.cuda.empty_cache()
    return train


def moe_phase(torch, dev, seed):
    """Phase 12: full-width granite-moe-3b-a800m: (a) the path check, (b)
    serving phase 5's trace, (c) the ring-cache generate, (d) training."""
    from repro_torch import configs
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    cfg = configs.get_config(MOE_ARCH)
    params = M.init(cfg, seed, device=dev)
    torch.cuda.synchronize()
    n = M.param_count(params)
    log(f"  init {cfg.name} ({n / 1e6:.1f} M params, "
        f"{M.active_param_count(params, cfg) / 1e6:.1f} M active: "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"of {cfg.head_dim}, kv {cfg.n_kv_heads} (G "
        f"{cfg.n_heads // cfg.n_kv_heads}), {cfg.n_experts} experts of d_ff "
        f"{cfg.d_ff}, top-{cfg.top_k}; f32 params, "
        f"{4 * n / 1e9:.2f} GB) on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    path = _paged_path(torch, dev, cfg, params, seed, "moe")
    log("  (b) serve: phase 5's trace")
    launches, per_call = serve_phase(torch, dev, cfg, params, seed)
    log("  (c) generate")
    gen = dense_generate_phase(torch, dev, cfg, params, seed)
    args = T.parse_args(MOE_TRAIN_ARGV + ["--seed", str(seed)])
    per_layer = sum(p.numel() for p in params.layers[0].parameters())
    per_node = n - (cfg.n_layers - args.layers) * per_layer
    del params
    torch.cuda.empty_cache()

    train = _train_at_payload(torch, T, args, per_node, "moe",
                              "capacity dispatch")
    secs = time.perf_counter() - t0
    log(f"  phase 12 took {secs:.1f} s")
    return {"path": path, "launches": launches, "per_call": per_call,
            "generate_launches": gen["generate_launches"], "train": train,
            "seconds": secs}


# ---------------------------------------------------------------------------
# phase 13: audio, the musicgen-large main path
# ---------------------------------------------------------------------------

AUDIO_ARCH = "musicgen-large"
AUDIO_SAMPLED = 4            # (b) requests served at temperature 0.8
AUDIO_TRAIN_ARGV = ["--arch", AUDIO_ARCH, "--full", "--layers", "4",
                    "--nodes", "4", "--topology", "one_peer_exp",
                    "--optimizer", "dmsgd", "--beta", "0.9", "--batch", "2",
                    "--seq", "128", "--steps", "6", "--hetero", "0.5",
                    "--log-every", "1", "--device", "cuda"]


def _sampled_frames(torch, dev, cfg, params, seed):
    """(b) 4 requests at temperature 0.8 through the engine: each frame's
    K codes are K independent draws, so the codes of a frame are not all
    equal in every frame."""
    import numpy as np

    from repro_torch.launch import serve as S
    from repro_torch.serve import ServeEngine, pages_needed
    max_seq = 256
    trace = S.poisson_trace(AUDIO_SAMPLED, 1000.0, 64, 32, cfg.vocab_size,
                            seed + 3, n_codebooks=cfg.n_codebooks)
    engine = ServeEngine(cfg, params, n_pages=1 + AUDIO_SAMPLED *
                         pages_needed(max_seq, 16), page_size=16,
                         max_seq=max_seq, max_batch=8, temperature=0.8,
                         seed=seed, device=dev)
    S.serve_trace(engine, trace)
    check(len(engine.finished) == AUDIO_SAMPLED,
          f"audio: {len(engine.finished)} of {AUDIO_SAMPLED} sampled "
          "requests finished")
    frames = np.concatenate([np.stack(r.generated) for r in engine.finished])
    mixed = int((frames != frames[:, :1]).any(1).sum())
    check(frames.shape[1] == cfg.n_codebooks and mixed > 0,
          f"audio: {frames.shape} sampled frames, {mixed} with differing "
          "codes")
    log(f"  (b) sampled at temperature 0.8: {AUDIO_SAMPLED} requests, "
        f"{len(frames)} frames of {frames.shape[1]} codes, {mixed} with "
        f"codes that differ within the frame")
    return mixed / len(frames)


def audio_phase(torch, dev, seed):
    """Phase 13: full-width musicgen-large: (a) the path check, (b)
    serving phase 5's trace with (P, 4) prompts, then sampled frames, (c)
    the ring-cache generate, (d) training, (e) ``profile_serve``."""
    from repro_torch import configs
    from repro_torch.launch import profile_serve as PS
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    cfg = configs.get_config(AUDIO_ARCH)
    params = M.init(cfg, seed, device=dev)
    torch.cuda.synchronize()
    n = M.param_count(params)
    log(f"  init {cfg.name} ({n:,} params: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, kv "
        f"{cfg.n_kv_heads} (G {cfg.n_heads // cfg.n_kv_heads}), d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.n_codebooks} codebooks; "
        f"f32 params, {4 * n / 1e9:.2f} GB) on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    path = _paged_path(torch, dev, cfg, params, seed, "audio")
    log("  (b) serve: phase 5's trace, (P, 4) prompts, greedy")
    launches, per_call = serve_phase(torch, dev, cfg, params, seed)
    mixed = _sampled_frames(torch, dev, cfg, params, seed)
    log("  (c) generate")
    gen = dense_generate_phase(torch, dev, cfg, params, seed)
    args = T.parse_args(AUDIO_TRAIN_ARGV + ["--seed", str(seed)])
    per_layer = sum(p.numel() for p in params.layers[0].parameters())
    per_node = n - (cfg.n_layers - args.layers) * per_layer
    del params
    torch.cuda.empty_cache()
    train = _train_at_payload(torch, T, args, per_node, "audio",
                              f"{cfg.n_codebooks}-code frames")
    log("  (e) profile_serve --arch musicgen-large (the decode step's host "
        "and device time, idle share and launches)")
    PS.main(["--arch", AUDIO_ARCH, "--seed", str(seed)])
    torch.cuda.empty_cache()
    return {"path": path, "launches": launches, "per_call": per_call,
            "generate_launches": gen["generate_launches"], "train": train,
            "mixed_frames": mixed}


# ---------------------------------------------------------------------------
# phase 14: vlm, llama-3.2-vision-90b cut to one group at full width
# ---------------------------------------------------------------------------

VLM_ARCH = "llama-3.2-vision-90b"
VLM_LAYERS = 5               # one group: 4 self layers, then 1 cross layer
VLM_GATE = 0.5               # tanh(0.5): the cross-attention does work
# (a) the gates at 0 must move the f32 logits by more than this x max-abs:
# 100 times f32 rounding, far below what a working cross layer adds
GATE_EFFECT = 1e-4
VLM_FORWARD = (2, 64)        # (a): forward, and decode against it
VLM_GEN = (4, 64, 32)        # (b): prompts, prompt length, new tokens
VLM_TRAIN_ARGV = ["--arch", VLM_ARCH, "--nodes", "4",
                  "--topology", "one_peer_exp", "--optimizer", "dmsgd",
                  "--beta", "0.9", "--batch", "2", "--seq", "128",
                  "--steps", "4", "--hetero", "0.5", "--log-every", "1",
                  "--device", "cuda"]


def vlm_phase(torch, dev, seed):
    """Phase 14: (a) the forward and the token-by-token decode against it,
    f32; (b) generate with images, bf16; (c) training, reduced width."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.launch import serve as S
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get_config(VLM_ARCH),
                              n_layers=VLM_LAYERS)
    params = M.init(cfg, seed, device=dev)
    with torch.no_grad():
        for cross in params.cross_layers:
            cross.xattn.gate.fill_(VLM_GATE)
    torch.cuda.synchronize()
    n = M.param_count(params)
    img_shape = (cfg.n_image_tokens, cfg.d_model)
    log(f"  init {cfg.name} cut to one group ({n:,} params: "
        f"{len(params.layers)} self layers and {len(params.cross_layers)} "
        f"cross layer, d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.head_dim}, kv {cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}; f32 params, {4 * n / 1e9:.2f} GB; gates "
        f"{VLM_GATE}) on the card in {time.perf_counter() - t0:.2f} s; "
        f"images {img_shape} a row")
    counters = _counters()
    for c in counters:
        c.launches = 0

    B, P = VLM_FORWARD
    f32_cfg = dataclasses.replace(cfg, activation_dtype=torch.float32)
    rng = np.random.default_rng(seed + 4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P))).to(dev)
    img = T.image_embeds(seed, 0, (B,) + img_shape, dev)
    with torch.no_grad():
        t1 = time.perf_counter()
        full, _ = M.forward(params, f32_cfg, tokens, image_embeds=img)
        full = full.float()
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t1
        cache = M.init_cache(f32_cfg, B, P, dtype=torch.float32, device=dev)
        t1 = time.perf_counter()
        dec = torch.cat([M.decode_step(params, f32_cfg, tokens[:, t:t + 1],
                                       cache, t, image_embeds=img)[0]
                         for t in range(P)], 1).float()
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t1
        for cross in params.cross_layers:
            cross.xattn.gate.zero_()
        ungated, _ = M.forward(params, f32_cfg, tokens, image_embeds=img)
        for cross in params.cross_layers:
            cross.xattn.gate.fill_(VLM_GATE)
    check(bool(torch.isfinite(full).all()) and tuple(full.shape) == (
        B, P, cfg.vocab_size), f"vlm: logits {tuple(full.shape)}")
    err, scale = _rel_err(dec, full)
    gate_diff = max_err(ungated, full)
    log(f"  (a) forward {B} x {P} f32 {1e3 * fwd_s:.1f} ms; decode "
        f"{P} steps {1e3 * dec_s:.1f} ms; decode vs forward max abs err "
        f"{err:.5g}, logits max-abs {scale:.5g}; tolerance {MODEL_TOL} x "
        f"max-abs = {MODEL_TOL * scale:.5g}; the forward with the gates at "
        f"0 differs by {gate_diff:.5g}")
    check(err <= MODEL_TOL * scale,
          f"vlm: decode vs forward differ by {err} > {MODEL_TOL * scale}")
    check(gate_diff > GATE_EFFECT * scale,
          f"vlm: the cross layer changes the logits by only {gate_diff}")
    del full, dec, ungated, cache

    Bg, Pg, new = VLM_GEN
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (Bg, Pg))).to(dev)
    imgs = T.image_embeds(seed, 1, (Bg,) + img_shape, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    toks = S.generate(cfg, params, prompts, max_new=new, cache_len=Pg + new,
                      temperature=0.0, seed=seed, image_embeds=imgs,
                      device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t1
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {c.__name__: c.launches for c in counters}
    check(tuple(toks.shape) == (Bg, Pg + new) and
          torch.equal(toks[:, :Pg], prompts) and
          bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"vlm generate: bad output {tuple(toks.shape)}")
    check(not any(launches.values()),
          f"vlm: (a) and (b) launched {launches}; its attention is plain")
    log(f"  (b) generate {Bg} prompts x {Pg} tokens + {new} new with "
        f"images, greedy, bf16 (token-by-token prefill): {gen_s:.3f} s, "
        f"{Bg * new / gen_s:.2f} new tokens/s, {1e3 * gen_s / (Pg + new):.3f}"
        f" ms per decode step ({Pg + new} steps), peak allocated "
        f"{peak_gb:.3f} GB; launches {launches}")
    del params, prompts, imgs, toks
    torch.cuda.empty_cache()

    args = T.parse_args(VLM_TRAIN_ARGV + ["--seed", str(seed)])
    full_cfg = configs.get_config(VLM_ARCH)
    head = (1 + (not full_cfg.tie_embeddings)) * full_cfg.vocab_size * \
        full_cfg.d_model
    log(f"  (c) train: the reduced config (full width cannot train on one "
        f"card: the untied {full_cfg.vocab_size:,} x {full_cfg.d_model:,} "
        f"embed and head alone are {head / 1e9:.2f} B a node, "
        f"{TRAIN_BYTES_PER_PARAM * args.nodes * head / 1e9:.0f} GB for "
        f"{args.nodes} nodes at phase 6's {TRAIN_BYTES_PER_PARAM:.1f} bytes "
        f"a parameter)")
    batch = T.prepare(args)["batches"][0]["image_embeds"]
    check(batch.is_cuda and tuple(batch.shape) == (
        args.nodes, args.batch, 16, 256),
        f"vlm train: images {tuple(batch.shape)} on {batch.device}")
    del batch
    res, train = _train_run(torch, T, args, "(c) vlm train, reduced")
    rcfg = res["config"]
    every = rcfg.cross_attn_every
    log(f"  (c) {rcfg.n_layers} layers ({rcfg.n_layers // every} groups of "
        f"{every - 1} self + 1 cross), d_model "
        f"{rcfg.d_model}, {rcfg.n_image_tokens} image tokens drawn on the "
        f"card each step")
    del res
    torch.cuda.empty_cache()
    return {"generate_tokens_per_s": Bg * new / gen_s, "train": train,
            "decode_err": err}


# ---------------------------------------------------------------------------
# phase 15: the configs no other phase runs, at full width, cut in depth
# ---------------------------------------------------------------------------

# (arch, layers kept): gemma2-27b 2 local + 2 global layers, G 2; granite-34b
# G 48 over one kv head (MQA); deepseek-67b G 8; dbrx-132b G 6, 16 experts
# top-4 (dropless when serving), its 2 layers 31 GB of f32 weights
CONFIG_CUTS = (("gemma2-27b", 4), ("granite-34b", 4), ("deepseek-67b", 4),
               ("dbrx-132b", 2))
GEMMA2_PROMPT = 6144         # (c): the local layers' 4,096 window bites
GEMMA2_STEPS = 4
# the tokens of one engine prefill call in (b): the engine's 256-token
# prefill budget admits one ~256-token prompt a call, padded to 512
SERVE_PREFILL_TOKENS = 512


def _param_counts(cfg) -> tuple[int, int]:
    """(parameters of one [attn + ffn] layer, parameters outside the
    layers) of ``cfg``, from a one-layer ``Model`` left uninitialised on
    the host (``torch.empty``: its pages are never touched)."""
    import dataclasses

    from repro_torch.models import model as M
    one = M.Model(dataclasses.replace(cfg, n_layers=1), device="cpu")
    per_layer = sum(p.numel() for p in one.layers[0].parameters())
    return per_layer, M.param_count(one) - per_layer


def _reckon_serve(cfg, n_params: int, per_layer: int) -> float:
    """Bytes the serve run (b) holds at its peak, an upper bound: the f32
    weights, plus the transients summed though they do not all live at
    once -- the bf16 copy of one layer's and of the head's weights a step
    casts, and an engine prefill's logits (bf16, then the soft-cap's
    three f32 temporaries: 14 bytes a logit)."""
    head = cfg.vocab_size * cfg.d_model
    return (4 * n_params + 2 * per_layer + 2 * head
            + 14 * SERVE_PREFILL_TOKENS * cfg.vocab_size)


def _reckon_window(cfg, n_params: int) -> float:
    """Bytes (c) holds at its peak: the f32 weights and the larger of the
    6,144 x 256,000 f32 logits with the soft-cap's temporaries (4 of
    them) and one layer's plain-attention scores with theirs (H x P^2 f32,
    3 of them alive at a time)."""
    P = GEMMA2_PROMPT
    return 4 * n_params + max(16 * P * cfg.vocab_size,
                              12 * cfg.n_heads * P * P)


def _window_bites(torch, dev, cfg, params, seed):
    """(c) gemma2: one 6,144-token prompt and 4 paged decode steps, f32,
    through K2/K3 against the plain attention; and the same with every
    layer global, which must differ by far more than the kernels do."""
    import dataclasses

    import numpy as np

    from repro_torch.models import model as M
    P, steps, ps = GEMMA2_PROMPT, GEMMA2_STEPS, 16
    f32_cfg = dataclasses.replace(cfg, activation_dtype=torch.float32)
    n_per = -(-(P + steps) // ps)
    rng = np.random.default_rng(seed + 5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, P)))
    table = torch.from_numpy(
        (1 + rng.permutation(n_per)).reshape(1, n_per).astype(np.int32))
    reckoned = _reckon_window(cfg, M.param_count(params))
    counters = _counters()
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        kern, fed = _prefill_decode(torch, M, f32_cfg, params, tokens, table,
                                    dev, steps, ps, pool_dtype=torch.float32)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        with _plain_attention():
            plain, _ = _prefill_decode(torch, M, f32_cfg, params, tokens,
                                       table, dev, steps, ps, fed=fed,
                                       pool_dtype=torch.float32)
        every_global, _ = _prefill_decode(
            torch, M, dataclasses.replace(f32_cfg, sliding_window=None),
            params, tokens, table, dev, steps, ps, fed=fed,
            pool_dtype=torch.float32)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    want = {"gossip_mix": 0, "flash_attention": cfg.n_layers,
            "paged_attention": cfg.n_layers * steps, "ssd_scan": 0}
    check(launches == want, f"(c) gemma2 window: launched {launches}, "
          f"expected {want}")
    check(bool(torch.isfinite(kern).all()) and tuple(kern.shape) == (
        steps + 1, 1, cfg.vocab_size), f"(c) logits {tuple(kern.shape)}")
    err, scale = _rel_err(kern, plain)
    diff = max_err(every_global, kern)
    log(f"  (c) window {cfg.sliding_window} bites: prefill 1 x {P} + "
        f"{steps} paged decode "
        f"steps, f32, {secs:.2f} s; launches {launches}; K2/K3 vs plain "
        f"attention max abs err {err:.5g}, logits max-abs {scale:.5g}, "
        f"tolerance {MODEL_TOL} x max-abs = {MODEL_TOL * scale:.5g}; every "
        f"layer global instead differs by {diff:.5g} ("
        f"{diff / max(err, 1e-30):.3g} x the kernels' error); peak "
        f"allocated {peak / 1e9:.3f} GB "
        f"against {reckoned / 1e9:.1f} GB reckoned")
    check(err <= MODEL_TOL * scale,
          f"(c) gemma2 window: K2/K3 and plain differ by {err} > "
          f"{MODEL_TOL * scale}")
    check(diff > max(GATE_EFFECT * scale, 10 * err),
          f"(c) gemma2: the window changes the logits by only {diff}")
    return {"max_abs_err": err, "global_diff": diff, "peak_gb": peak / 1e9,
            "reckoned_gb": reckoned / 1e9}


def configs_phase(torch, dev, seed):
    """Phase 15: gemma2-27b, granite-34b, deepseek-67b and dbrx-132b at
    full width, cut in depth, one at a time on the card: (a) the paged
    path check, (b) phase 5's serve, (c) gemma2's biting window."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model as M
    out = {}
    for arch, layers in CONFIG_CUTS:
        t0 = time.perf_counter()
        full = configs.get_config(arch)
        per_layer, outside = _param_counts(full)
        n = outside + layers * per_layer
        reckoned = _reckon_serve(full, n, per_layer)
        cfg = dataclasses.replace(full, n_layers=layers)
        params = M.init(cfg, seed, device=dev)
        torch.cuda.synchronize()
        check(M.param_count(params) == n, f"{arch}: {M.param_count(params)}"
              f" params, reckoned from {n}")
        G = cfg.n_heads // cfg.n_kv_heads
        log(f"  {arch}: {layers} of {full.n_layers} layers at full width "
            f"({n:,} params, f32 {4 * n / 1e9:.2f} GB: d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, kv "
            f"{cfg.n_kv_heads} (G {G}), d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}"
            + (f", {cfg.n_experts} experts top-{cfg.top_k}"
               if cfg.n_experts else "")
            + (f", window {cfg.sliding_window} on the even layers, softcaps "
               f"{cfg.attn_softcap} / {cfg.final_softcap}, tied embeddings"
               if cfg.local_global else "")
            + f") on the card in {time.perf_counter() - t0:.2f} s")
        res = {"layers": layers, "params": n, "G": G}
        res["path"] = _paged_path(torch, dev, cfg, params, seed, arch)
        log(f"  (b) serve: phase 5's trace, bf16 activations; peak reckoned "
            f"{reckoned / 1e9:.1f} GB")
        serve = {}
        res["launches"], res["per_call"] = serve_phase(torch, dev, cfg,
                                                       params, seed, serve)
        log(f"  (b) peak allocated {serve['peak_bytes'] / 1e9:.3f} GB "
            f"against {reckoned / 1e9:.1f} GB reckoned")
        res["serve"] = serve
        res["reckoned_gb"] = reckoned / 1e9
        if cfg.local_global:
            res["window"] = _window_bites(torch, dev, cfg, params, seed)
        del params
        torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t0
        log(f"  {arch} took {res['seconds']:.1f} s")
        out[arch] = res
    return out


# ---------------------------------------------------------------------------
# phase 16: bench_serve --quick and its gate
# ---------------------------------------------------------------------------

BENCH_SERVE_BASELINE = ROOT / "BENCH_serve_h100.json"


def bench_serve_phase(torch, dev):
    """``repro_torch.benchmarks.bench_serve --quick`` on the card (reduced
    qwen3: the engine against fixed batches of the loop-prefill
    ``generate``, one Poisson trace), then ``check_serve_regression.compare``
    against the committed H100 record.  It fails on the structural gates
    only: a latency or rate that is NaN or missing, the paged peak KV at
    or above the dense one, or the two sides' token counts differing.  The
    tokens/s line and the engine / baseline speedup are printed and not
    gated here: reduced qwen3 is host-bound (a decode step is ~90 % idle
    on the card), so what a step costs is the host's, and two hosts have
    shown 82.8 and 110.3 tokens/s for one serving cell; and the quick
    trace (12 requests at 8 a second, 8 new tokens each) is bound by its
    arrivals, 96 tokens over the ~2.2 s they span, on the card as on the
    CPU.  The command-line gate keeps the reference's 20 % threshold."""
    import tempfile

    from repro_torch.benchmarks import bench_serve as BS
    from repro_torch.benchmarks import check_serve_regression as CSR
    check(BENCH_SERVE_BASELINE.exists(),
          f"bench_serve: no {BENCH_SERVE_BASELINE.name} in the checkout")
    with open(BENCH_SERVE_BASELINE) as f:
        baseline = json.load(f)
    counters = _counters()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "BENCH_serve.new.json")
        BS.main(["--quick", "--out", path])
        with open(path) as f:
            new = json.load(f)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    # a threshold of 1 cannot fail on tokens/s: the structural gates only
    structural = CSR.compare(baseline, new, threshold=1.0)
    eng, base = new["engine"], new["baseline"]
    tps0 = baseline["engine"]["tokens_per_s"]
    drop = (tps0 - eng["tokens_per_s"]) / tps0
    want = new["config"]["n_requests"] * new["config"]["max_new"]
    log(f"  tokens/s: engine {eng['tokens_per_s']:.1f} (committed "
        f"{baseline['engine']['tokens_per_s']:.1f}), baseline "
        f"{base['tokens_per_s']:.1f}; engine / baseline speedup "
        f"{new['speedup']:.3f}x (committed {baseline['speedup']:.3f}x); "
        f"not gated here (a drop of {100 * drop:.1f} % against the "
        f"command line's 20 % gate)")
    log(f"  launches {launches}")
    check(not structural, f"bench_serve: {structural}")
    check(eng["new_tokens"] == base["new_tokens"] == want,
          f"bench_serve: engine {eng['new_tokens']} and baseline "
          f"{base['new_tokens']} new tokens, expected {want}")
    check(launches["flash_attention"] > 0 and
          launches["paged_attention"] > 0,
          f"bench_serve: the engine ran no kernel: {launches}")
    return {"record": new, "launches": launches,
            "throughput_drop": drop > 0.2}


# ---------------------------------------------------------------------------
# phase 17: bench_kernels, bench_comm --quick and train_lm (100m)
# ---------------------------------------------------------------------------

BENCH_COMM_BASELINE = ROOT / "BENCH_comm_h100.json"
BENCH_COMM_REFERENCE = ROOT / "BENCH_comm.json"
# elements a node of bench_comm's 1M-f32 tree: the port pads its flat
# buffers to 8 elements, the reference to its TPU kernel's 8 x 1024 tile
COMM_PORT_ELEMS, COMM_REF_ELEMS = 1_000_000, 1_007_616
# the bench_kernels row -> the kernel wrapper it calls
BENCH_KERNELS = {"kernel_flash_attention": "flash_attention",
                 "kernel_ssd_scan": "ssd_scan",
                 "kernel_gossip_mix": "gossip_mix"}
# 10 steps a topology: the whole script must end within its limit on slow hosts
LM_PRESET, LM_NODES, LM_STEPS = "100m", 8, 10
LM_TOPS = {"one_peer_exp": 3, "static_exp": 1}   # executables expected
# train_lm's other arguments: the reference's CLI defaults
LM_KW = dict(batch=2, seq=128, lr0=0.3, hetero=0.3)


def _zeroed_counters(torch):
    counters = _counters()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    return counters


def _bench_kernels(torch):
    """(a): the suite with the counters zeroed before and read after."""
    from repro_torch.benchmarks import bench_kernels as BK
    counters = _zeroed_counters(torch)
    rows = BK.run("cuda")
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    want = {"paged_attention": 0}
    want.update({BENCH_KERNELS[r["name"]]: r["kernel_calls"] for r in rows})
    for r in rows:
        check(r["allclose"], f"bench_kernels {r['name']}: not allclose to "
              f"its plain version at {BK.TOL[r['name']]}")
        lib = ("no library call" if r["library_us"] is None else
               f"library {r['library_us']:.2f} us (kernel / library "
               f"{r['us'] / r['library_us']:.3f})")
        log(f"  {r['name']}: kernel {r['us']:.2f} us (CUDA-graph replays), "
            f"bound {r['bound_us']:.3f} us ({r['bound_by']}; "
            f"{100 * r['bound_share']:.1f} % of it), {lib}, plain "
            f"{r['plain_us']:.1f} us; {r['kernel_calls']} wrapper calls")
    log(f"  bench_kernels launches {launches}")
    check(launches == want, f"bench_kernels: launches {launches}, the "
          f"suite called the wrappers {want} times")
    return {r["name"]: r for r in rows}, launches


def _scaled(port, ref) -> bool:
    return port * COMM_REF_ELEMS == ref * COMM_PORT_ELEMS


def _comm_against_reference(new, ref) -> list:
    """The padding-adjusted equality of the wire accounting with the
    reference's record; returns the rows that differ."""
    bad = []
    for g, w in zip(new["rows"], ref["rows"], strict=True):
        same = all(g[k] == w[k] for k in ("topology", "kind", "rounds",
                                          "wire_multiplier",
                                          "collectives_per_step"))
        if not (same and _scaled(g["bytes_per_iter"], w["bytes_per_iter"])):
            bad.append(("rows", g["topology"]))
    for g, w in zip(new["two_axis"]["rows"], ref["two_axis"]["rows"],
                    strict=True):
        same = all(g[k] == w[k] for k in ("topology", "kind", "fsdp",
                                          "collectives_per_step"))
        if not (same and all(_scaled(g[k], w[k]) for k in (
                "bytes_per_iter_per_node", "bytes_per_iter_per_shard"))):
            bad.append(("two_axis", g["topology"]))
    for g, w in zip(new["runtime"]["rows"], ref["runtime"]["rows"],
                    strict=True):
        same = all(g[k] == w[k] for k in ("topology", "kind", "meta_cols",
                                          "collectives_per_step",
                                          "meta_bytes_per_iter"))
        if not (same and _scaled(g["bytes_per_iter"] - g[
                "meta_bytes_per_iter"], w["bytes_per_iter"]
                - w["meta_bytes_per_iter"])):
            bad.append(("runtime", g["topology"]))
    return bad


def _bench_comm(torch):
    """(b): bench_comm --quick into a temporary file, its K1 launches
    counted per table row by wrapping the module's ``mix_us``."""
    import tempfile

    from repro_torch.benchmarks import bench_comm as BC
    from repro_torch.benchmarks import check_comm_regression as CCR
    from repro_torch.kernels.gossip_mix import ops as gm_ops
    for path in (BENCH_COMM_BASELINE, BENCH_COMM_REFERENCE):
        check(path.exists(), f"bench_comm: no {path.name} in the checkout")
    with open(BENCH_COMM_BASELINE) as f:
        baseline = json.load(f)
    with open(BENCH_COMM_REFERENCE) as f:
        reference = json.load(f)
    per_row, mix_us = [], BC.mix_us

    def counted(top, tree):
        before = gm_ops.gossip_mix.launches
        us = mix_us(top, tree)
        per_row.append(gm_ops.gossip_mix.launches - before)
        return us

    counters = _zeroed_counters(torch)
    BC.mix_us = counted
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "BENCH_comm.new.json")
            BC.main(["--quick", "--out", path])
            with open(path) as f:
                new = json.load(f)
    finally:
        BC.mix_us = mix_us
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    fails = CCR.compare(baseline, new)
    # the timings must be real numbers; the speedup is not gated here
    fails += CCR.report_timings(baseline, new, min_overlap_speedup=0.0)
    check(not fails, f"bench_comm against {BENCH_COMM_BASELINE.name}: "
          f"{fails}")
    bad = _comm_against_reference(new, reference)
    check(not bad, f"bench_comm: wire accounting differs from "
          f"{BENCH_COMM_REFERENCE.name} beyond its padding: {bad}")
    mixes = BC.MIX_ITERS + BC.MIX_WARMUP
    want = [mixes if r["kind"] in ("ppermute", "matching") else 0
            for r in new["rows"]]
    log(f"  K1 launches per table row {dict(zip(BC.TABLE_TOPOLOGIES, per_row))}"
        f" ({mixes} mixes a row; dense rows combine by einsum)")
    check(per_row == want, f"bench_comm: K1 launches per row {per_row}, "
          f"expected {want}")
    for r in new["rows"]:
        log(f"  comm_{r['topology']}: {r['us_per_mix']:.1f} us a mix, "
            f"bytes_per_iter {r['bytes_per_iter']} (reference "
            f"{next(w['bytes_per_iter'] for w in reference['rows'] if w['topology'] == r['topology'])})")
    ov = new["overlap"]
    log(f"  overlap ({ov['nodes']} nodes, {ov['steps']} steps): sync "
        f"{ov['ms_per_step_sync']:.3f} ms, pipelined "
        f"{ov['ms_per_step_overlap']:.3f} ms a step, speedup "
        f"{ov['speedup']:.3f}x (committed "
        f"{baseline['overlap']['speedup']:.3f}x); informational on one "
        f"card, not gated: the step is host-bound")
    log(f"  bench_comm launches {launches}; wire bytes = the reference's x "
        f"{COMM_PORT_ELEMS:,} / {COMM_REF_ELEMS:,} in every row")
    check(launches["gossip_mix"] >= sum(want) and all(
        launches[k] == 0 for k in launches if k != "gossip_mix"),
          f"bench_comm: launches {launches}")
    return {"record": new, "launches": launches, "per_row": per_row}


def _reckon_lm(n_params: int, degree: int) -> float:
    """Peak GB of a train_lm step: phase 6's measured bytes a
    node-parameter (one received payload), and two payload copies (m, x)
    more for every further shift of the round."""
    node_params = LM_NODES * n_params
    return (TRAIN_BYTES_PER_PARAM * node_params
            + (degree - 1) * 2 * 4 * node_params) / 1e9


def _train_lm(torch, seed):
    """(c): train_one at the 100m preset over each of LM_TOPS."""
    from repro_torch.core import topology as topo_mod
    from repro_torch.launch import train_lm as TL
    cfg = TL.make_cfg(LM_PRESET)
    n_params = TL.param_count(cfg)
    out = {}
    for top, executables in LM_TOPS.items():
        degree = topo_mod.get_topology(top, LM_NODES).max_degree
        reckoned = _reckon_lm(n_params, degree)
        counters = _zeroed_counters(torch)
        t0 = time.perf_counter()
        r = TL.train_one(cfg, top, nodes=LM_NODES, steps=LM_STEPS,
                         seed=seed, device="cuda", **LM_KW)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        losses = r["losses"]
        peak = r["peak_bytes"] / 1e9
        step_ms = 1e3 * sorted(r["step_s"][1:])[len(r["step_s"][1:]) // 2]
        tokens = LM_NODES * LM_KW["batch"] * LM_KW["seq"]
        log(f"  train_lm {LM_PRESET} ({n_params:,} parameters a node) "
            f"{top}, {LM_NODES} nodes: losses "
            f"{[round(v, 4) for v in losses]}")
        log(f"  train_lm {top}: median step {step_ms:.1f} ms = "
            f"{tokens / step_ms * 1e3:.0f} tokens/s; peak allocated "
            f"{peak:.3f} GB (reckoned {reckoned:.1f}); {r['num_compiled']} "
            f"executables for {r['distinct']} distinct realizations; "
            f"launches {launches}; {secs:.1f} s")
        check(all(abs(v) < float("inf") for v in losses),
              f"train_lm {top}: losses {losses}")
        check(losses[-1] < losses[0], f"train_lm {top}: the loss did not "
              f"fall in {LM_STEPS} steps: {losses[0]} -> {losses[-1]}")
        want = {"gossip_mix": LM_STEPS, "flash_attention": 0,
                "paged_attention": 0, "ssd_scan": 0}
        check(launches == want, f"train_lm {top}: launches {launches}, "
              f"expected {want} (one f32 payload group a step)")
        check(r["num_compiled"] == r["distinct"] == executables,
              f"train_lm {top}: {r['num_compiled']} executables for "
              f"{r['distinct']} distinct realizations, expected "
              f"{executables}")
        out[top] = {"launches": launches["gossip_mix"], "step_ms": step_ms,
                    "peak_gb": peak, "reckoned_gb": reckoned,
                    "first_loss": losses[0], "last_loss": losses[-1]}
        del r
        torch.cuda.empty_cache()
    return out


def benches_phase(torch, dev, seed):
    log("  (a) bench_kernels")
    kern, kern_launches = _bench_kernels(torch)
    torch.cuda.empty_cache()
    log("  (b) bench_comm --quick and its gates")
    comm = _bench_comm(torch)
    torch.cuda.empty_cache()
    log(f"  (c) train_lm --preset {LM_PRESET} --nodes {LM_NODES}, "
        f"{LM_STEPS} steps")
    lm = _train_lm(torch, seed)
    return {"kernels": kern, "kernel_launches": kern_launches,
            "comm": comm, "lm": lm}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 18: multi-process gossip (ROADMAP item 18)
# ---------------------------------------------------------------------------

MESH_SHAPE = (4, 2)                      # (node, fsdp): 8 ranks
MESH_PAYLOAD = ("qwen3-0.6b", 2)         # full width, cut to 2 layers
MESH_DENSE_TOL = 1e-5                    # tests/test_shard_native.py:364


def _mesh_engine(res, seed, shape):
    """(a)'s small tree on a world of ranks: every block against the
    global path on the card, the wire logs, K1 a static round."""
    from repro_torch.launch import mesh_check as MC
    fails = MC.check(res, seed, "cuda", shape)
    wire = res[0]["wire"]
    check(not fails, f"mesh ({wire}): {len(fails)} blocks or logs off: "
          f"{fails[:4]}")
    check(all(r["wire"] == wire for r in res), "mesh: ranks on other wires")
    delayed = all(all(r["delayed"].values()) for r in res)
    check(delayed, "mesh: a delayed pair differs from its round")
    k1 = [sum(rec["k1"] for rec in r["rounds"].values()) for r in res]
    r0 = res[0]["rounds"]
    for name, rec in r0.items():
        log(f"  {wire} {name}: rank 0 {rec['ms']:.3f} ms, wire "
            f"{ {k: (v['ops'], v['bytes']) for k, v in rec['log'].items()} }"
            f", K1 {rec['k1']}")
    log(f"  {wire}: {len(res)} ranks {dict(zip(('node', 'fsdp'), shape))}: "
        f"every block equal to the plain-combine global path's slice "
        f"(dense within "
        f"{MESH_DENSE_TOL}), delayed halves bit for bit, wire logs equal "
        f"to gossip_spec; K1 per rank {k1}")
    return {"wire": wire, "k1_per_rank": k1,
            "round_ms": {n: rec["ms"] for n, rec in r0.items()}}


MESH_LEG_ARGV = ["--full", "--layers", str(MESH_PAYLOAD[1]), "--nodes", "4",
                 "--topology", "one_peer_exp", "--beta", "0.9", "--batch",
                 "2", "--seq", "128", "--hetero", "0.5", "--log-every",
                 "100", "--device", "cuda"]
MESH_OVERLAP_STEPS = 4       # (d), (f): 3 delayed rounds, a save at step 2
MESH_PMSGD_STEPS = 3         # (e)


def _median_ms(step_s) -> float:
    rest = sorted(step_s[1:])
    return 1e3 * rest[len(rest) // 2]


def _against_single(what, r, ref_losses, comp):
    """A rank's losses and final (m, x) against the single-process run's
    (TRAIN_TOL x max-abs); returns whether the state is bit for bit."""
    losses = [h["loss"] for h in r["history"]]
    check(len(losses) == len(ref_losses) and all(
        abs(a - b) <= TRAIN_TOL * abs(b) for a, b in zip(losses, ref_losses)),
        f"{what} rank {r['rank']}: losses {losses} vs {ref_losses}")
    equal, err, scale = comp
    check(err <= TRAIN_TOL * scale, f"{what} rank {r['rank']}: (m, x) max "
          f"abs diff {err} beyond {TRAIN_TOL} x {scale}")
    return equal


def _npz_leaf(z, i: int):
    """Leaf ``i`` of a checkpoint's ``arrays.npz`` (``z``, its open
    ``zipfile.ZipFile``) as numpy: the stored member's bytes read from the
    file straight into the array, past zipfile's reader (which copies the
    member through Python and checks its CRC: ~50 s for two 12 GB
    checkpoints on the card's host; ``np.load`` is slower still)."""
    import io
    import struct
    import zipfile

    import numpy as np
    from numpy.lib import format as npf
    info = z.getinfo(f"leaf_{i}.npy")
    check(info.compress_type == zipfile.ZIP_STORED,
          f"checkpoint leaf {i} is compressed")
    with open(z.filename, "rb") as fh:
        fh.seek(info.header_offset)
        local = fh.read(30)
        check(local[:4] == b"PK\x03\x04", f"checkpoint leaf {i}: no local "
              "file header at its offset")
        start = info.header_offset + 30 + sum(struct.unpack("<HH",
                                                            local[26:30]))
        fh.seek(start)
        head = io.BytesIO(fh.read(min(1 << 16, info.file_size)))
        major, _ = npf.read_magic(head)
        shape, fortran, dtype = getattr(
            npf, f"read_array_header_{major}_0")(head)
        x = np.empty(int(np.prod(shape)), dtype)
        check(head.tell() + x.nbytes == info.file_size, f"checkpoint leaf "
              f"{i}: {head.tell()} + {x.nbytes} bytes in a member of "
              f"{info.file_size}")
        fh.seek(start + head.tell())
        view, got = memoryview(x.view(np.uint8)), 0
        while got < x.nbytes:
            n = fh.readinto(view[got:])
            check(n > 0, f"checkpoint leaf {i}: the file ends early")
            got += n
    return x.reshape(shape, order="F" if fortran else "C")


def _ckpt_arrays(mesh_dirs: list, step: int, want: dict) -> list:
    """(f), (i), (k): the checkpoints of step ``step`` that mesh runs wrote
    under ``mesh_dirs`` against the arrays the single-process run saved
    at that step (``want``: leaf key path -> array, in the order
    ``checkpoint.save`` writes them): the same leaves, each of the same
    shape and dtype within TRAIN_TOL x its max-abs, compared on the card
    (each single-process leaf moved there once); per directory the
    bit-equal arrays and the largest difference."""
    import zipfile

    import torch
    out = []
    for d in mesh_dirs:
        man = json.loads((Path(d) / f"step_{step}" / "manifest.json")
                         .read_text())
        check(man["treedef"] == list(want), f"mesh checkpoint leaves "
              f"{man['treedef']} != single-process {list(want)}")
        out.append({"leaves": len(want), "bit_equal": 0,
                    "max_abs_diff": 0.0, "gb": 0.0,
                    "gossip_buf": any(p.startswith("gossip_buf")
                                      for p in want)})
    files = [zipfile.ZipFile(Path(d) / f"step_{step}" / "arrays.npz")
             for d in mesh_dirs]
    try:
        for i, (path, y) in enumerate(want.items()):
            yt = torch.from_numpy(y).cuda()
            scale = float(yt.abs().max())
            for z, rec in zip(files, out):
                x = _npz_leaf(z, i)
                check(x.shape == y.shape and x.dtype == y.dtype,
                      f"checkpoint {path}: {x.shape} {x.dtype} vs {y.shape} "
                      f"{y.dtype}")
                rec["gb"] += x.nbytes / 1e9
                xt = torch.from_numpy(x).cuda()
                del x
                if torch.equal(xt, yt):
                    rec["bit_equal"] += 1
                    continue
                err = float((xt.float() - yt.float()).abs().max())
                del xt
                check(err <= TRAIN_TOL * scale, f"checkpoint {path}: max "
                      f"abs diff {err} beyond {TRAIN_TOL} x {scale}")
                rec["max_abs_diff"] = max(rec["max_abs_diff"], err)
            del yt
    finally:
        for z in files:
            z.close()
        torch.cuda.empty_cache()
    return out


def _kept_checkpoints():
    """A stand-in for ``checkpoint.save`` that keeps what it is given as
    numpy, by leaf key path in the order ``save`` writes them, instead of
    writing it: ``(save, {step: {path: array}})``."""
    from repro_torch.checkpoint import ckpt
    kept = {}

    def save(ckpt_dir, step, tree):
        kept[step] = {path: leaf.detach().cpu().numpy()
                      for path, leaf in ckpt._flatten(tree)}

    return save, kept


def _mesh_legs(torch, seed):
    """(d)-(g) on one world of 4 ranks, one a node, every rank on the card
    over gloo-host: (d) --overlap dmsgd with (f) its carry-buffer
    checkpoint, the same leg synchronous, (e) parallel_msgd, each
    compared in this process with the single-process run (the plain
    combine: every rank's K1 meets its plain version; its checkpoint
    kept in memory by a stand-in ``checkpoint.save``), then (g) runtime
    rounds with 2 nodes a rank on a (node 2, fsdp 2) mesh of the same
    ranks."""
    import shutil
    import tempfile
    from unittest import mock

    from repro_torch.core import gossip
    from repro_torch.launch import mesh_check as MC
    from repro_torch.launch import train as T
    t_legs = time.perf_counter()
    base = MESH_LEG_ARGV + ["--seed", str(seed)]
    ovl = base + ["--steps", str(MESH_OVERLAP_STEPS), "--overlap",
                  "--ckpt-every", "2"]
    sync = base + ["--steps", str(MESH_OVERLAP_STEPS)]
    pm = base + ["--steps", str(MESH_PMSGD_STEPS), "--optimizer",
                 "parallel_msgd"]
    tmp = tempfile.mkdtemp(prefix="mesh_ckpt_")
    try:
        start = T.prepare(T.parse_args(ovl))
        tokens = [b["tokens"].numpy() for b in start["batches"]]
        refs = {}
        # the single-process run's checkpoint is kept in memory, not
        # written: (f) reads only the file the mesh's rank 0 writes
        save, kept = _kept_checkpoints()
        with gossip.kernel_mode("off"), \
                mock.patch.object(T.checkpoint, "save", save):
            for name, argv in (("overlap", ovl + ["--ckpt-dir",
                                                  f"{tmp}/single"]),
                               ("parallel_msgd", pm)):
                a = T.parse_args(argv)
                r = T.run(a, start=start if name == "overlap"
                          else T.prepare(a, tokens))
                refs[name] = ([h["loss"] for h in r["history"]],
                              (r["state"].momentum, r["params"]))
                del r
                start = None
                torch.cuda.empty_cache()
        t_refs = time.perf_counter() - t_legs
        # the synchronous leg first: a process's first steps carry its
        # one-time costs
        SYNC, OVL, PM = range(3)
        runs = [(sync, None),
                (ovl + ["--ckpt-dir", f"{tmp}/mesh"], refs["overlap"][1]),
                (pm, refs["parallel_msgd"][1])]
        res, comps = MC.train_world(runs, tokens, runtime=True)
        losses = {k: v[0] for k, v in refs.items()}
        del refs, runs
        torch.cuda.empty_cache()
        t_world = time.perf_counter() - t_legs - t_refs

        # (d) the overlapped trainer: its delayed rounds' wire, K1
        rounds = MESH_OVERLAP_STEPS - 1
        logged = 2                              # steps 0 and 3
        k1_want = rounds + logged + 1           # delayed, logged, final
        bits, wire_ms, share, k1 = [], [], [], []
        for r in res:
            o = r["runs"][OVL]
            bits.append(_against_single("mesh overlap", o,
                                        losses["overlap"],
                                        comps[OVL][o["rank"]]))
            perm = o["log"]["permute"]
            check(perm["ops"] == rounds, f"mesh overlap rank {o['rank']}: "
                  f"{perm['ops']} delayed permutes, expected {rounds} (one "
                  "a delayed round, one dtype group)")
            wire_ms.append(1e3 * perm["s"] / perm["ops"])
            share.append(perm["open_s"] / perm["s"])
            k1.append(o["k1"])
            check(o["k1"] == k1_want, f"mesh overlap rank {o['rank']}: K1 "
                  f"{o['k1']}, reckoned {k1_want}")
        ovl_ms = [_median_ms(r["runs"][OVL]["step_s"]) for r in res]
        sync_ms = [_median_ms(r["runs"][SYNC]["step_s"]) for r in res]
        o0 = res[0]["runs"][OVL]
        log(f"  (d) --overlap dmsgd, {MESH_OVERLAP_STEPS} steps on a (node "
            f"4) mesh ({o0['wire']}): losses "
            f"{[round(h['loss'], 5) for h in o0['history']]} (single "
            f"process {[round(v, 5) for v in losses['overlap']]}); final "
            f"(m, x) per rank max abs diff "
            f"{[comps[OVL][k][1] for k in sorted(comps[OVL])]} (tolerance "
            f"{TRAIN_TOL} x max-abs), bit for bit {bits}")
        log(f"  (d) delayed round's wire per rank "
            f"{[round(v, 1) for v in wire_ms]} ms (start to wait; one "
            f"permute a round of {o0['log']['permute']['bytes'] // rounds} "
            f"bytes), of which between start and wait (under the "
            f"gradients) {[f'{100 * v:.1f} %' for v in share]}; median step "
            f"ms per rank {[round(v, 1) for v in ovl_ms]} against the "
            f"synchronous leg's {[round(v, 1) for v in sync_ms]}; K1 per "
            f"rank {k1} (reckoned {rounds} delayed + {logged} logged "
            f"flushes + 1 final flush); logging and flushes apart: "
            f"{ {k: (v['ops'], round(v['s'], 3)) for k, v in o0['log'].items() if ':' in k} }"
            " (ops, s)")

        # (e) parallel_msgd: one psum a gradient dtype group a step
        pbits, psum_ms, psum_b = [], [], []
        for r in res:
            p = r["runs"][PM]
            pbits.append(_against_single("mesh parallel_msgd", p,
                                         losses["parallel_msgd"],
                                         comps[PM][p["rank"]]))
            ps = p["log"]["psum"]
            check(ps["ops"] == MESH_PMSGD_STEPS and "permute" not in
                  p["log"], f"mesh parallel_msgd rank {p['rank']}: wire "
                  f"{p['log']}, expected one psum a step")
            psum_ms.append(1e3 * ps["s"] / ps["ops"])
            psum_b.append(ps["bytes"] // ps["ops"])
            check(p["k1"] == 0, f"mesh parallel_msgd: K1 {p['k1']}")
        p0 = res[0]["runs"][PM]
        log(f"  (e) parallel_msgd, {MESH_PMSGD_STEPS} steps: losses "
            f"{[round(h['loss'], 5) for h in p0['history']]} (single "
            f"process {[round(v, 5) for v in losses['parallel_msgd']]}); "
            f"final (m, x) max abs diff "
            f"{[comps[PM][k][1] for k in sorted(comps[PM])]}, bit for bit "
            f"{pbits}; psum a step: {p0['log']['psum']['ops'] // MESH_PMSGD_STEPS}"
            f" op of {psum_b[0]} bytes, ms per rank "
            f"{[round(v, 1) for v in psum_ms]}; median step ms per rank "
            f"{[round(_median_ms(r['runs'][PM]['step_s']), 1) for r in res]}")

        # (f) the carry-buffer checkpoint of (d): rank 0 wrote the rows
        (ck,) = _ckpt_arrays([f"{tmp}/mesh"], 2, kept.pop(2))
        check(ck["gossip_buf"], "mesh checkpoint carries no gossip_buf")
        log(f"  (f) --overlap --ckpt-dir (carry-buffer), step 2: "
            f"{ck['leaves']} arrays ({ck['gb']:.2f} GB, gossip_buf among "
            f"them) against the single-process run's: {ck['bit_equal']} bit "
            f"for bit, largest difference {ck['max_abs_diff']}")

        # (g) runtime rounds, 2 nodes a rank
        fails = []
        for r in res:
            rt = r["runtime"]
            want = MC.gathered_runtime_expected(rt["coords"], device="cuda")
            for name, blocks in rt["rounds"].items():
                for k, v in blocks.items():
                    if not (v == want[name][k]).all():
                        fails.append(f"rank {r['runs'][OVL]['rank']} "
                                     f"{name}.{k}")
        check(not fails, f"(g) runtime blocks off the global path: {fails}")
        rt0 = res[0]["runtime"]
        log(f"  (g) runtime rounds {sorted(rt0['rounds'])} with 2 nodes a "
            f"rank (node 2 x fsdp 2; each node line 2 ranks over 4 nodes): "
            f"every block bit for bit the global path's; rank 0 wire "
            f"{ {k: (v['ops'], v['bytes']) for k, v in rt0['log'].items()} }")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = time.perf_counter() - t_legs
    log(f"  (d)-(g) {total:.1f} s (single-process references {t_refs:.1f} "
        f"s, the world {t_world:.1f} s)")
    return {"overlap_k1_per_rank": k1,
            "parallel_msgd_k1_per_rank": [r["runs"][PM]["k1"] for r in res],
            "overlap_wire_ms_per_rank": wire_ms,
            "overlap_open_share_per_rank": share,
            "overlap_step_ms_per_rank": ovl_ms, "sync_step_ms_per_rank": sync_ms,
            "psum_ms_per_rank": psum_ms, "psum_bytes": psum_b[0],
            "overlap_bit_equal": bits, "parallel_msgd_bit_equal": pbits,
            "overlap_peak_gb_per_rank": [r["runs"][OVL]["peak_gb"]
                                         for r in res],
            "sync_peak_gb_per_rank": [r["runs"][SYNC]["peak_gb"]
                                      for r in res],
            "ckpt": ck, "seconds": total}


FSDP_SHAPE = (4, 2, 1)     # (node, fsdp, model): the reference tests' mesh
# (h), (i), (k): 2 steps, a save at step 1 in (i) and (k) (3 steps and a
# save at step 2 took the script past 1,100 s on a slow host); (j): 3
FSDP_STEPS = 2
CKPT_STEP = 1
TP_J_STEPS = 3
TP_J_SHAPE = (2, 2, 2)     # (j): node 2, fsdp 2, model 2
TP_K_SHAPE = (4, 1, 2)     # (k): node 4, fsdp 1, model 2
MOE_L_SHAPE = (2, 4, 1)    # (l): node 2, fsdp 4, model 1
# (l): granite-moe at full width cut to 2 layers, a batch of 4 a node and
# no micro-batch: one row a rank, the routing group the node's 4 rows
# over its 4 fsdp ranks
MOE_L_ARGV = ["--arch", MOE_ARCH, "--full", "--layers", "2", "--nodes",
              str(MOE_L_SHAPE[0]), "--topology", "one_peer_exp", "--beta",
              "0.9", "--batch", "4", "--seq", "128", "--hetero", "0.5",
              "--log-every", "100", "--device", "cuda", "--steps",
              str(FSDP_STEPS)]


# (m): the model-sharded prefill, qwen3-0.6b at full width cut to 2
# layers, f32 activations, attention_impl "pallas", 8 rows of 512 over
# (node 2, fsdp 2, model 2): 2 rows a rank, each rank's 8 query heads and
# 4 kv heads (D 128) through K2 once a layer; 3 timed calls after it
PREFILL_M_ARGV = ["--arch", "qwen3-0.6b", "--full", "--layers", "2",
                  "--batch", "8", "--seq", "512", "--impl", "pallas",
                  "--f32", "--repeat", "3", "--device", "cuda"]
PREFILL_M_LAUNCHES = {"flash_attention": 2, "ssd_scan": 0}

# (n): the model-sharded decode, f32 activations, 8 rows on (node 2, fsdp
# 2, model 2), 2 rows a rank: (n1) qwen3-0.6b at full width cut to 2
# layers, a 256-slot ring filled by the single-process prefill_cache on a
# 254-token prompt, 4 steps at positions 254-257 (the ring wraps), its 8
# kv heads cut (4 a rank); (n2) granite-34b at full width, 1 layer, a
# 64-slot ring drawn from the seed, 2 steps at 63-64: its one kv head,
# the head dim cut (64 of 128 a rank).  (n1) times a step after them.
DECODE_N_ARGV = {
    "n1": ["--arch", "qwen3-0.6b", "--full", "--layers", "2", "--batch", "8",
           "--cache-len", "256", "--prompt", "254", "--steps", "4", "--f32",
           "--repeat", "1", "--device", "cuda"],
    "n2": ["--arch", "granite-34b", "--full", "--layers", "1", "--batch",
           "8", "--cache-len", "64", "--start", "63", "--steps", "2",
           "--f32", "--device", "cuda"]}
# the wire ops a step a rank, reckoned from the cuts: one fsdp all_gather
# of the rank's shards; (n1) psums for the vocab-parallel embedding and
# each layer's row-parallel wo (a 2-layer MLP stack divides model 2 and
# stays whole); (n2) psums for the embedding, wo, the partial logits and
# w_down (one layer: the MLP cut on ff), all_gathers of q, k, v and the
# output's head-dim block
DECODE_N_WIRE = {"n1": {"fsdp:all_gather": 1, "model:psum": 1 + 2},
                 "n2": {"fsdp:all_gather": 1, "model:psum": 4,
                        "model:all_gather": 4}}


def _wire_rows(log: dict) -> dict:
    """A wire log per kind: (ops, bytes, s, staging share of the s)."""
    return {k: (v["ops"], v["bytes"], round(v["s"], 3),
                round(v["stage_s"] / v["s"], 3) if v["s"] else 0.0)
            for k, v in log.items()}


def _k1_fsdp_block(torch, elems: int, seed: int) -> dict:
    """K1 alone at a rank's (1, elems) f32 (m, x) block, degree 1 with
    weights 1/2 (one-peer Shifts over 4 nodes), against its plain version
    (max abs err), then timed from CUDA-graph replays in turns with
    ``torch.lerp``, beside its bytes bound (x and the received block read
    once, the output written once)."""
    from repro_torch.kernels.gossip_mix import ops, ref
    g = torch.Generator(device="cuda").manual_seed(seed + 27)
    x, r = (torch.randn((1, elems), generator=g, device="cuda")
            for _ in range(2))
    got = ops.gossip_mix(x, [r], w_self=0.5, ws=(0.5,))
    err = max_err(got, ref.gossip_mix_ref(x, [r], 0.5, (0.5,)))
    del got
    check(err <= GOSSIP_TOL["float32"], f"K1 at the fsdp block (1, {elems})"
          f": max abs err {err} beyond {GOSSIP_TOL['float32']}")
    t = time_turns({
        "kernel": lambda: ops.gossip_mix(x, [r], w_self=0.5, ws=(0.5,)),
        "lerp": lambda: torch.lerp(x, r, 0.5)},
        timer=lambda f: time_graph_us(f) / 1e3)
    plain = time_ms(lambda: ref.gossip_mix_ref(x, [r], 0.5, (0.5,)),
                    iters=5)
    bound, by = bound_us(3 * elems, 3 * 4 * elems, PEAK_F32_FLOPS)
    del x, r
    torch.cuda.empty_cache()
    return {"elems": elems, "max_abs_err": err, "ms": t["kernel"],
            "lerp_ms": t["lerp"], "plain_ms": plain, "bound_ms": bound / 1e3,
            "bound_by": by}


FREE_EVERY_S = 0.25
HOST_MARK_BYTES = 8e9        # the host's high-water mark printed in steps


def _host_used() -> int | None:
    """Bytes of host memory in use: the cgroup's (``memory.current``) where
    the process has one, else the machine's (MemTotal - MemAvailable)."""
    try:
        with open("/sys/fs/cgroup/memory.current") as f:
            return int(f.read())
    except (OSError, ValueError):
        pass
    try:
        with open("/proc/meminfo") as f:
            info = {line.split(":")[0]: int(line.split()[1]) * 1024
                    for line in f}
        return info["MemTotal"] - info["MemAvailable"]
    except (OSError, KeyError, ValueError, IndexError):
        return None


@contextlib.contextmanager
def _least_free(torch):
    """Yields ``[least free bytes, total bytes, most host bytes in use]``
    of the card and the host (:func:`_host_used`; None where it cannot be
    read), filled by a thread that reads ``torch.cuda.mem_get_info`` and
    the host's every FREE_EVERY_S seconds until the block ends: the
    low-water mark of every process on the card, the high-water mark on
    the host."""
    import threading
    free = list(torch.cuda.mem_get_info()) + [_host_used()]
    done = threading.Event()

    t0 = time.perf_counter()
    mark = [0.0]

    def sample():
        while not done.wait(FREE_EVERY_S):
            free[0] = min(free[0], torch.cuda.mem_get_info()[0])
            used = _host_used()
            if used is not None:
                free[2] = max(free[2] or 0, used)
                if used >= mark[0] + HOST_MARK_BYTES:
                    # printed as it rises: a run the host's limit ends
                    # keeps its last mark in the log
                    mark[0] = used
                    log(f"  host memory in use {used / 1e9:.1f} GB at "
                        f"{time.perf_counter() - t0:.1f} s of the world")

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        yield free
    finally:
        done.set()
        th.join()


def _model_rows(log: dict, steps: int) -> dict:
    """The wire log's ``model`` scope (the tensor-parallel pass) a step:
    per kind (ops, bytes sent, ms)."""
    return {k: (v["ops"] / steps, v["bytes"] / steps,
                round(1e3 * v["s"] / steps, 3))
            for k, v in log.items() if k.startswith("model:")}


def _sharded_legs(torch, seed, d_peaks):
    """(h)-(l) on one world of 8 ranks sharing the card over gloo-host.
    (h), (i) on a (node 4, fsdp 2, model 1) mesh: each rank keeps its
    fsdp shard of its node's leaves, gathers the node's whole leaves for
    the gradient pass and reduce-scatters the gradients' mean; (j), (k)
    on (node 2, fsdp 2, model 2) and (node 4, fsdp 1, model 2): each
    rank keeps its (fsdp, model) shard and runs the tensor-parallel pass
    (``launch/tp.py``) on its model shards.  Activations in f32
    (``mesh_check.f32_start``), every run alike: the row split changes
    the products' shapes, which bf16 activations round apart by more
    than the 2e-4 held here.  (h) dmsgd synchronous,
    then the every=2 pair (a Shifts step against the same step's
    Identity: one permute more and nothing else); (i) --overlap with a
    carry-buffer checkpoint at step 1, written by the mesh's rank 0 and
    held array by array against the single-process run's (kept in
    memory by a stand-in ``checkpoint.save``, taken after the world);
    (j) dmsgd synchronous on 2 nodes; (k) (i)'s run on the model mesh,
    its checkpoint held against the same single-process one; (l) the moe
    family's rows split over fsdp, its routing made global over the
    node's 4 fsdp ranks (:func:`_moe_leg`).  All held in this process
    against the single-process run with the plain combine (every rank's
    K1 meets its plain version), shard by shard; then K1 alone at a
    rank's block of (h) and of (l).  ``d_peaks``: (d)'s peaks, (sync,
    overlap) per rank."""
    import shutil
    import tempfile
    from unittest import mock

    from repro_torch.core import gossip
    from repro_torch.launch import mesh_check as MC
    from repro_torch.launch import train as T
    t_legs = time.perf_counter()
    base = MESH_LEG_ARGV + ["--seed", str(seed), "--steps", str(FSDP_STEPS)]
    ovl = base + ["--overlap", "--ckpt-every", str(CKPT_STEP)]
    tmp = tempfile.mkdtemp(prefix="fsdp_ckpt_")
    try:
        start = MC.f32_start(T.parse_args(ovl))
        tokens = [b["tokens"].numpy() for b in start["batches"]]
        tp_j = base + ["--nodes", str(TP_J_SHAPE[0]), "--steps",
                       str(TP_J_STEPS)]
        start_j = MC.f32_start(T.parse_args(tp_j))
        tokens_j = [b["tokens"].numpy() for b in start_j["batches"]]
        moe_l = MOE_L_ARGV + ["--seed", str(seed)]
        t_ref_l = time.perf_counter()
        start_l = MC.f32_start(T.parse_args(moe_l))
        tokens_l = [b["tokens"].numpy() for b in start_l["batches"]]
        t_ref_l = time.perf_counter() - t_ref_l
        refs = {}
        with gossip.kernel_mode("off"):
            for name, argv in (("overlap", ovl), ("sync", base),
                               ("tp_j", tp_j), ("moe_l", moe_l)):
                t_ref = time.perf_counter()
                a = T.parse_args(argv)
                st = {"overlap": start, "tp_j": start_j,
                      "moe_l": start_l}.get(name)
                r = T.run(a, start=MC.f32_start(a, tokens) if st is None
                          else st)
                # on the host: 15 GB on the card here beside the world's
                # 8 ranks ran the card out of memory at (k)'s checkpoint
                refs[name] = ([h["loss"] for h in r["history"]],
                              tuple({k: v.cpu() for k, v in part.items()}
                                    for part in (r["state"].momentum,
                                                 r["params"])))
                del r, st
                if name == "overlap":
                    start = None
                torch.cuda.empty_cache()
        t_ref_l += time.perf_counter() - t_ref
        del start_j, start_l
        # (m)'s reference: the single-process prefill step, plain attention
        t_ref_m = time.perf_counter()
        prefill_m = PREFILL_M_ARGV + ["--seed", str(seed)]
        ref_m = MC.single_prefill(prefill_m)
        torch.cuda.empty_cache()
        t_ref_m = time.perf_counter() - t_ref_m
        # (n)'s references: each case's weights drawn on the card, its
        # single-process plain decode, then the weights and the start
        # cache written beside the world as .npy files, which each rank
        # maps, moving only its shards to the card
        t_ref_n = time.perf_counter()
        decode_n, refs_n = [], {}
        for name, argv in DECODE_N_ARGV.items():
            argv = argv + ["--seed", str(seed)]
            full = MC.prefill_weights(MC.decode_config(MC.decode_args(argv)),
                                      seed, "cuda")
            want = MC.single_decode(argv, weights=full)
            MC.save_leaves(f"{tmp}/{name}_w", full)
            MC.save_leaves(f"{tmp}/{name}_c", want.pop("start"))
            del full
            torch.cuda.empty_cache()
            decode_n.append((argv, None, f"{tmp}/{name}_w",
                             f"{tmp}/{name}_c"))
            refs_n[name] = (argv, want)
        t_ref_n = time.perf_counter() - t_ref_n
        t_refs = time.perf_counter() - t_legs
        # (l) last: train_world lets each reference go once compared, so
        # (l)'s ranks stage through the host without the others' 15 GB
        # (with them the host's 96 GiB ran out during (l))
        SYNC, OVL, TPJ, TPK, MOEL = range(5)
        losses = {k: v[0] for k, v in refs.items()}
        runs = [(base, refs["sync"][1]),
                (ovl + ["--ckpt-dir", f"{tmp}/mesh"], refs["overlap"][1]),
                (tp_j, refs["tp_j"][1], TP_J_SHAPE, tokens_j),
                (ovl + ["--ckpt-dir", f"{tmp}/mesh_k"], refs["overlap"][1],
                 TP_K_SHAPE),
                (moe_l, refs["moe_l"][1], MOE_L_SHAPE, tokens_l)]
        del refs
        with _least_free(torch) as free:
            res, comps = MC.train_world(runs, tokens, shape=FSDP_SHAPE,
                                        axes=MC.TRAIN_AXES, every2=base,
                                        f32=True, prefill=(prefill_m, MOEL,
                                                           TP_J_SHAPE),
                                        decode=(decode_n, MOEL, TP_J_SHAPE))
        log(f"  (h)-(l) the card's least free memory while the world ran: "
            f"{free[0] / 1e9:.2f} GB of {free[1] / 1e9:.2f}; the host's most "
            f"in use "
            f"{'not read' if free[2] is None else f'{free[2] / 1e9:.2f} GB'}"
            f" (sampled every {FREE_EVERY_S} s)")
        torch.cuda.empty_cache()
        t_world = time.perf_counter() - t_legs - t_refs
        fsdp_want = {"fsdp:all_gather": FSDP_STEPS,
                     "fsdp:reduce_scatter": FSDP_STEPS,
                     "fsdp:psum": FSDP_STEPS}
        out = {"least_free_gb": free[0] / 1e9,
               "host_most_used_gb": None if free[2] is None
               else free[2] / 1e9}
        for leg, idx, what, k1_want, perm_want in (
                ("h", SYNC, "fsdp sync", FSDP_STEPS, FSDP_STEPS),
                # a delayed round a step after the first, 2 logged
                # flushes (the first and last steps), 1 final flush; the
                # priming step permutes nothing
                ("i", OVL, "fsdp overlap", FSDP_STEPS + 2, FSDP_STEPS - 1)):
            bits, k1, peaks, ms = [], [], [], []
            for r in res:
                o = r["runs"][idx]
                bits.append(_against_single(what, o, losses[
                    "sync" if idx == SYNC else "overlap"],
                    comps[idx][o["rank"]]))
                fs = {k: v["ops"] for k, v in o["log"].items()
                      if k.startswith("fsdp:")}
                check(fs == fsdp_want, f"{what} rank {o['rank']}: fsdp ops "
                      f"{fs}, expected {fsdp_want}")
                perm = o["log"].get("permute", {}).get("ops", 0)
                check(perm == perm_want, f"{what} rank {o['rank']}: "
                      f"{perm} permutes in the steps, expected {perm_want}")
                check(o["k1"] == k1_want, f"{what} rank {o['rank']}: K1 "
                      f"{o['k1']}, reckoned {k1_want}")
                k1.append(o["k1"])
                peaks.append(o["peak_gb"])
                ms.append(_median_ms(o["step_s"]))
            o0 = res[0]["runs"][idx]
            log(f"  ({leg}) {what}, {FSDP_STEPS} steps on a (node 4, fsdp "
                f"2, model 1) mesh ({o0['wire']}), "
                f"{sum(o0['param_elems'].values()) / 1e6:.1f} M parameters "
                f"a rank: losses {[round(h['loss'], 5) for h in o0['history']]}"
                f" (single process {[round(v, 5) for v in losses['sync' if idx == SYNC else 'overlap']]}); "
                f"final (m, x) shards per rank max abs diff "
                f"{[comps[idx][k][1] for k in sorted(comps[idx])]} "
                f"(tolerance {TRAIN_TOL} x max-abs), bit for bit {bits}")
            log(f"  ({leg}) median step ms per rank "
                f"{[round(v, 1) for v in ms]}; peak GB per rank "
                f"{[round(v, 3) for v in peaks]} against (d)'s "
                f"{'synchronous' if idx == SYNC else '--overlap'} leg, one "
                f"rank a node, "
                f"{[round(v, 3) for v in d_peaks[idx != SYNC]]}; K1 per"
                f" rank {k1}; rank 0 wire (ops, bytes, s, staging share): "
                f"{_wire_rows(o0['log'])}")
            out[leg] = {"k1_per_rank": k1, "bit_equal": bits,
                        "peak_gb_per_rank": peaks, "step_ms_per_rank": ms,
                        "wire_rank0": _wire_rows(o0["log"])}
        # the every=2 pair: the gossip step adds one permute, nothing else
        for r in res:
            gossip_log, base_log = r["every2"]
            counts = {k: v["ops"] for k, v in gossip_log.items()}
            base_c = {k: v["ops"] for k, v in base_log.items()}
            diff = {k: counts.get(k, 0) - base_c.get(k, 0)
                    for k in set(counts) | set(base_c)}
            diff = {k: d for k, d in diff.items() if d}
            check(diff == {"permute": 1}, f"every=2 pair rank "
                  f"{r['runs'][0]['rank']}: the gossip step adds {diff} "
                  "over the Identity step, expected one permute")
        log(f"  (h) every=2 pair: the Shifts step's wire {counts} against "
            f"the Identity step's {base_c}: one permute more and nothing "
            "else, on every rank")
        out.update(_tp_legs(res, comps, losses, (TPJ, TPK)))
        out["m"] = _prefill_leg(res, ref_m, prefill_m)
        out["m"]["reference_s"] = t_ref_m
        del ref_m                     # released once compared
        out["n"] = _decode_leg(res, refs_n)
        out["n"]["reference_s"] = t_ref_n
        del refs_n
        log(f"  (n) card peak GB per rank: (n1) "
            f"{[round(v, 3) for v in out['n']['n1']['peak_gb_per_rank']]}, "
            f"(n2) "
            f"{[round(v, 3) for v in out['n']['n2']['peak_gb_per_rank']]}; "
            f"the host's most in use over the world "
            f"{'not read' if free[2] is None else f'{free[2] / 1e9:.2f} GB'};"
            f" its references {t_ref_n:.1f} s; {_smi_line()}")
        out["l"] = _moe_leg(res, comps, losses["moe_l"], MOEL, moe_l)
        # (i)'s and (k)'s carry-buffer checkpoints: rank 0 wrote the rows;
        # the single-process run's, kept in memory by a stand-in save, is
        # taken now that the world's ranks and their host buffers are gone
        t_single = time.perf_counter()
        save, kept = _kept_checkpoints()
        with gossip.kernel_mode("off"), \
                mock.patch.object(T.checkpoint, "save", save):
            a = T.parse_args(ovl + ["--ckpt-dir", f"{tmp}/single"])
            T.run(a, start=MC.f32_start(a, tokens))
        torch.cuda.empty_cache()
        t_ck = time.perf_counter()
        cks = _ckpt_arrays([f"{tmp}/mesh", f"{tmp}/mesh_k"], CKPT_STEP,
                           kept.pop(CKPT_STEP))
        log(f"  (i), (k) checkpoints compared on the card in "
            f"{time.perf_counter() - t_ck:.1f} s (the single-process run "
            f"that keeps its own {t_ck - t_single:.1f} s)")
        for (leg, where), ck in zip((("i", "over fsdp"),
                                     ("k", "over model")), cks):
            check(ck["gossip_buf"], f"({leg}) checkpoint carries no "
                  "gossip_buf")
            log(f"  ({leg}) --overlap --ckpt-dir (carry-buffer), step "
                f"{CKPT_STEP}: {ck['leaves']} arrays ({ck['gb']:.2f} GB, "
                f"gossip_buf "
                f"among them, each leaf gathered {where}) against the "
                f"single-process run's: {ck['bit_equal']} bit for bit, "
                f"largest difference {ck['max_abs_diff']}")
            out["ckpt" if leg == "i" else "ckpt_k"] = ck
        del kept
        elems = 2 * sum(res[0]["runs"][SYNC]["param_elems"].values())
        elems_l = 2 * sum(res[0]["runs"][MOEL]["param_elems"].values())
        del res
        torch.cuda.empty_cache()
        for leg, n in (("h", elems), ("l", elems_l)):
            t_k = time.perf_counter()
            k = _k1_fsdp_block(torch, n, seed)
            log(f"  ({leg}) K1 at a rank's (1, {n / 1e6:.1f} M) f32 (m, x) "
                f"block: {k['ms']:.4f} ms "
                f"({100 * k['bound_ms'] / k['ms']:.1f} % of its "
                f"{k['bound_ms']:.4f} ms {k['bound_by']} bound), torch.lerp "
                f"{k['lerp_ms']:.4f} ms (K1 / lerp "
                f"{k['ms'] / k['lerp_ms']:.4f}; graph replays in turns), "
                f"plain {k['plain_ms']:.4f} ms, max abs err "
                f"{k['max_abs_err']}")
            if leg == "h":
                out["k1_block"] = k
            else:
                out["l"]["k1_block"] = k
                out["l"]["seconds"] += time.perf_counter() - t_k
        out["l"]["seconds"] += t_ref_l
        log(f"  (l) {out['l']['seconds']:.1f} s: its single-process "
            f"reference {t_ref_l:.1f} s, its run in the world "
            f"{out['l']['world_s']:.1f} s (the slowest rank), K1 at its "
            f"block {out['l']['seconds'] - t_ref_l - out['l']['world_s']:.1f}"
            " s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = time.perf_counter() - t_legs
    log(f"  (h)-(l) {total:.1f} s (single-process references {t_refs:.1f} "
        f"s, the world {t_world:.1f} s)")
    out["seconds"] = total
    return out


def _prefill_leg(res, want, argv) -> dict:
    """(m) of :func:`_sharded_legs`' world, before (l): a replica's
    model-sharded prefill (``mesh_check.prefill_rank``; ``steps.
    make_prefill_step(tp=, fsdp=)``) of qwen3-0.6b at full width, 2
    layers, f32 activations, ``attention_impl="pallas"``, 8 rows of 512
    on (node 2, fsdp 2, model 2): each rank gathers its fsdp shards and
    runs the tensor-parallel forward on its 2 rows, K2 on its 8 query
    and 4 kv heads once a layer.  Every rank's last logits, gathered
    over model, are held within TRAIN_TOL x max-abs of ``want``, the
    single-process prefill step with the plain attention on the whole
    batch (so K2 meets its plain version at the rank's shape); its K2 /
    K4 launches (counts set to 0 just before the call) as
    PREFILL_M_LAUNCHES; its wire log one fsdp all_gather and the model
    psums, alike on every rank.  Per rank the median of 3 timed
    prefills, the fsdp and model scopes (ops, bytes, ms), peak memory on
    the card and the process's peak resident set (the host's memory in
    use is :func:`_least_free`'s line for the whole world)."""
    import numpy as np

    from repro_torch.launch import mesh_check as MC
    args = MC.prefill_args(argv)
    scale = float(np.abs(want).max())
    errs, ms, launches, scopes, peaks, hosts = [], [], [], [], [], []
    for r in res:
        o = r["prefill"]
        err = float(np.abs(o["logits"] - want[o["rows"]]).max())
        check(o["logits"].shape == (len(o["rows"]), want.shape[-1]),
              f"(m) rank {o['rank']}: logits {o['logits'].shape}")
        check(err <= TRAIN_TOL * scale, f"(m) rank {o['rank']}: logits "
              f"max abs diff {err} beyond {TRAIN_TOL} x {scale}")
        check(o["launches"] == PREFILL_M_LAUNCHES, f"(m) rank {o['rank']}: "
              f"launches {o['launches']}, expected {PREFILL_M_LAUNCHES}")
        ops = {k: v["ops"] for k, v in o["log"].items()}
        check(ops.get("fsdp:all_gather") == 1 and ops.get("model:psum"),
              f"(m) rank {o['rank']}: wire ops {ops}")
        errs.append(err)
        ms.append(1e3 * sorted(o["step_s"])[len(o["step_s"]) // 2])
        launches.append(o["launches"]["flash_attention"])
        scopes.append({k: (v["ops"], v["bytes"], round(1e3 * v["s"], 3))
                       for k, v in o["log"].items()})
        peaks.append(o["peak_gb"])
        hosts.append(o["host_peak_gb"])
    check(all({k: v[0] for k, v in sc.items()} ==
              {k: v[0] for k, v in scopes[0].items()} for sc in scopes),
          "(m): the wire ops differ between ranks")
    o0 = res[0]["prefill"]
    log(f"  (m) model-sharded prefill, qwen3-0.6b at full width, "
        f"{args.layers} layers, f32 activations, attention_impl "
        f"{args.impl}, {args.batch} x {args.seq} on (node 2, fsdp 2, model "
        f"2) ({o0['wire']}), {o0['param_elems'] / 1e6:.1f} M parameters a "
        f"rank, {len(o0['rows'])} rows a rank: last logits gathered over "
        f"model, max abs diff per rank {errs} against the single-process "
        f"plain prefill (tolerance {TRAIN_TOL} x {scale:.4g}); K2 launches "
        f"per rank {launches}")
    log(f"  (m) per rank: median of {args.repeat} prefills "
        f"{[round(v, 3) for v in ms]} ms (first call "
        f"{[round(1e3 * r['prefill']['first_s'], 1) for r in res]} ms); "
        f"peak GB on the card {[round(v, 3) for v in peaks]}; peak "
        f"resident set GB of each rank's process so far (pages shared "
        f"between ranks counted in each; the host's use is the world's "
        f"line) {[round(v, 3) for v in hosts]}")
    log(f"  (m) per rank the fsdp and model scopes (ops, bytes, ms): "
        f"{scopes}")
    return {"max_abs_err_per_rank": errs, "ms_per_rank": ms,
            "k2_per_rank": launches, "scopes_per_rank": scopes,
            "peak_gb_per_rank": peaks, "host_peak_gb_per_rank": hosts,
            "tolerance": TRAIN_TOL * scale}


def _decode_leg(res, refs: dict) -> dict:
    """(n) of :func:`_sharded_legs`' world, after (m): a replica's
    model-sharded decode (``mesh_check.decode_rank``; ``steps.
    make_serve_step(tp=, fsdp=)``) of DECODE_N_ARGV's two cases on (node
    2, fsdp 2, model 2), each rank on its shards of the weights and of
    the cache (``sharding.cache_specs``), 2 rows.  ``refs``: each case's
    (argv, single-process plain decode).  Every rank's logits at every
    step, gathered over model, and its final cache shard are held within
    TRAIN_TOL x max-abs of the single process's; its cache shard's shape
    is ``local_shard``'s (``mesh_check.decode_errors``); its wire ops as
    DECODE_N_WIRE a step; no kernel launched (the ring decode is plain
    PyTorch, as the reference's).  Per rank the median ms of a step, the
    fsdp and model ops a step (count, bytes, ms), the card's peak and
    the process's peak resident set."""
    import numpy as np

    from repro_torch.launch import mesh_check as MC
    out = {}
    for j, (name, (argv, want)) in enumerate(refs.items()):
        args = MC.decode_args(argv)
        rs = [r["decode"][j] for r in res]
        errs = MC.decode_errors(rs, want, argv, TP_J_SHAPE)
        lo = float(np.abs(want["logits"]).max())
        ca = max(float(np.abs(v).max()) for v in want["final"].values())
        wire = {k: v * args.steps for k, v in DECODE_N_WIRE[name].items()}
        ms, scopes, peaks, hosts = [], [], [], []
        for o, (e_lo, e_ca) in zip(rs, errs):
            check(e_lo <= TRAIN_TOL * lo, f"({name}) rank {o['rank']}: "
                  f"logits max abs diff {e_lo} beyond {TRAIN_TOL} x {lo}")
            check(e_ca <= TRAIN_TOL * ca, f"({name}) rank {o['rank']}: "
                  f"cache shard max abs diff {e_ca} beyond {TRAIN_TOL} x "
                  f"{ca}")
            ops = {k: v["ops"] for k, v in o["log"].items()}
            check(ops == wire, f"({name}) rank {o['rank']}: wire ops {ops},"
                  f" reckoned {wire}")
            check(not any(o["launches"].values()), f"({name}) rank "
                  f"{o['rank']}: kernel launches {o['launches']}")
            ms.append(1e3 * sorted(o["step_s"])[len(o["step_s"]) // 2])
            scopes.append({k: (v["ops"] / args.steps,
                               v["bytes"] / args.steps,
                               round(1e3 * v["s"] / args.steps, 3))
                           for k, v in o["log"].items()})
            peaks.append(o["peak_gb"])
            hosts.append(o["host_peak_gb"])
        o0 = rs[0]
        log(f"  ({name}) model-sharded decode, {args.arch} at full width, "
            f"layers {args.layers}, f32, {args.batch} rows on (node 2, "
            f"fsdp 2, model 2) ({o0['wire']}), "
            f"{o0['param_elems'] / 1e6:.1f} M parameters and a "
            f"{o0['cache_bytes'] / 1e6:.1f} MB cache shard "
            f"{ {k: v.shape for k, v in o0['cache'].items()} } a rank, "
            f"{args.steps} steps from position {MC.decode_start(args)} "
            f"over a {args.cache_len}-slot ring: max abs diff per rank, "
            f"logits {[e[0] for e in errs]} (tolerance {TRAIN_TOL} x "
            f"{lo:.4g}), cache shard {[e[1] for e in errs]} ({TRAIN_TOL} "
            f"x {ca:.4g}); wire ops a step as reckoned "
            f"{DECODE_N_WIRE[name]}; no kernel launched")
        log(f"  ({name}) {max(o['seconds'] for o in rs):.1f} s in the world"
            f" (the slowest rank: its shards, {len(o0['step_s'])} steps, the "
            f"logits' gather); per rank: median step "
            f"{[round(v, 1) for v in ms]} ms; peak "
            f"GB on the card {[round(v, 3) for v in peaks]}; peak resident "
            f"set GB of each rank's process {[round(v, 3) for v in hosts]}")
        log(f"  ({name}) per rank the fsdp and model scopes a step (ops, "
            f"bytes, ms): {scopes}")
        out[name] = {"max_abs_err_per_rank": errs, "ms_per_rank": ms,
                     "seconds": max(o["seconds"] for o in rs),
                     "scopes_per_rank": scopes, "peak_gb_per_rank": peaks,
                     "host_peak_gb_per_rank": hosts,
                     "tolerance": (TRAIN_TOL * lo, TRAIN_TOL * ca)}
    return out


def _moe_leg(res, comps, ref_losses, i, argv) -> dict:
    """(l) of :func:`_sharded_legs`' world: granite-moe at full width, 2
    layers, f32 activations, on (node 2, fsdp 4, model 1), a batch of 4
    a node and no micro-batch: each rank trains its one row of the
    node's batch, and the routing group (the node's 4 rows) spans the
    node's 4 fsdp ranks, its capacity routing and aux loss made global
    over them (``launch/moe_group.py``).  Every rank's losses and final
    (m, x) shards against the single-process run's (TRAIN_TOL x
    max-abs); its batch of one row; the fsdp ops a step as (h)'s plus
    the replicated router's psum; the ``"moe"`` scope's ops as
    ``mesh_check.moe_route_ops`` reckons them (remat on: the recompute
    issues the forward's again), alike on every rank; K1 one a step a
    rank.  Per rank the median step ms, peak memory, the run's seconds
    and the ``"moe"`` scope a step (ops, bytes sent, ms)."""
    from repro_torch.launch import mesh_check as MC
    from repro_torch.launch import train as T
    args = T.parse_args(argv)
    cfg = T.config_of(args)
    steps = args.steps
    what = f"moe l {dict(zip(('node', 'fsdp', 'model'), MOE_L_SHAPE))}"
    want_fsdp = {"fsdp:all_gather": steps, "fsdp:reduce_scatter": steps,
                 "fsdp:psum": 2 * steps}
    want_moe = MC.moe_route_ops(cfg, cfg.n_layers * steps)
    rows = args.batch // MOE_L_SHAPE[1]
    bits, k1, peaks, ms, secs, moe = [], [], [], [], [], []
    for r in res:
        o = r["runs"][i]
        bits.append(_against_single(what, o, ref_losses,
                                    comps[i][o["rank"]]))
        check(o["rows"] == rows, f"{what} rank {o['rank']}: a batch of "
              f"{o['rows']} rows, expected {rows}")
        fs = {k: v["ops"] for k, v in o["log"].items()
              if k.startswith("fsdp:")}
        check(fs == want_fsdp, f"{what} rank {o['rank']}: fsdp ops {fs}, "
              f"expected {want_fsdp}")
        ops = {k: v["ops"] for k, v in o["log"].items()
               if k.startswith("moe:")}
        check(ops == want_moe, f"{what} rank {o['rank']}: moe ops {ops}, "
              f"expected {want_moe}")
        check(o["k1"] == steps, f"{what} rank {o['rank']}: K1 {o['k1']}, "
              f"reckoned {steps}")
        k1.append(o["k1"])
        peaks.append(o["peak_gb"])
        ms.append(_median_ms(o["step_s"]))
        secs.append(o["seconds"])
        moe.append({k: (v["ops"] / steps, v["bytes"] / steps,
                        round(1e3 * v["s"] / steps, 3))
                    for k, v in o["log"].items() if k.startswith("moe:")})
    o0 = res[0]["runs"][i]
    log(f"  (l) {what}, granite-moe at full width, {cfg.n_layers} layers, "
        f"{steps} steps ({o0['wire']}), "
        f"{sum(o0['param_elems'].values()) / 1e6:.1f} M parameters a rank, "
        f"{rows} row a rank of the node's {args.batch} (one routing group "
        f"over {MOE_L_SHAPE[1]} ranks): losses "
        f"{[round(h['loss'], 5) for h in o0['history']]} (single process "
        f"{[round(v, 5) for v in ref_losses]}); final (m, x) shards per rank"
        f" max abs diff {[comps[i][k][1] for k in sorted(comps[i])]} "
        f"(tolerance {TRAIN_TOL} x max-abs), bit for bit {bits}")
    log(f"  (l) per rank: median step ms {[round(v, 1) for v in ms]}; peak "
        f"GB {[round(v, 3) for v in peaks]}; K1 {k1}; the run "
        f"{[round(v, 1) for v in secs]} s")
    log(f"  (l) the moe scope a step (ops, bytes, ms) per rank: {moe}")
    log(f"  (l) rank 0 wire (ops, bytes, s, staging share): "
        f"{_wire_rows(o0['log'])}")
    return {"k1_per_rank": k1, "bit_equal": bits, "peak_gb_per_rank": peaks,
            "step_ms_per_rank": ms, "run_s_per_rank": secs,
            "moe_per_rank": moe, "wire_rank0": _wire_rows(o0["log"]),
            "world_s": max(secs), "seconds": max(secs)}


def _tp_legs(res, comps, losses, idx) -> dict:
    """(j), (k) of :func:`_sharded_legs`' world: every rank's losses and
    final (m, x) shards against the single-process run's (TRAIN_TOL x
    max-abs), K1 a rank ((j) one a step; (k) under --overlap a delayed
    round a step after the first, 2 logged flushes, 1 final), the model
    ops alike on every rank, no fsdp op on fsdp 1; per rank the median
    step ms, peak memory, the ``model`` scope a step and K1."""
    out = {}
    for leg, i, shape, ref, steps, k1_want in (
            ("j", idx[0], TP_J_SHAPE, "tp_j", TP_J_STEPS, TP_J_STEPS),
            ("k", idx[1], TP_K_SHAPE, "overlap", FSDP_STEPS,
             FSDP_STEPS + 2)):
        what = f"tp {leg} {dict(zip(('node', 'fsdp', 'model'), shape))}"
        bits, k1, peaks, ms, model = [], [], [], [], []
        for r in res:
            o = r["runs"][i]
            bits.append(_against_single(what, o, losses[ref],
                                        comps[i][o["rank"]]))
            check(o["k1"] == k1_want, f"{what} rank {o['rank']}: K1 "
                  f"{o['k1']}, reckoned {k1_want}")
            rows = _model_rows(o["log"], steps)
            check(bool(rows), f"{what} rank {o['rank']}: no model op")
            fs = [k for k in o["log"] if k.startswith("fsdp:")]
            check(shape[1] > 1 or not fs, f"{what} rank {o['rank']}: fsdp "
                  f"ops {fs} on fsdp 1")
            k1.append(o["k1"])
            peaks.append(o["peak_gb"])
            ms.append(_median_ms(o["step_s"]))
            model.append(rows)
        check(all({k: v[0] for k, v in m.items()} ==
                  {k: v[0] for k, v in model[0].items()} for m in model),
              f"{what}: the model ops differ between ranks")
        o0 = res[0]["runs"][i]
        log(f"  ({leg}) {what}, {steps} steps ({o0['wire']}), "
            f"{sum(o0['param_elems'].values()) / 1e6:.1f} M parameters a "
            f"rank: losses {[round(h['loss'], 5) for h in o0['history']]} "
            f"(single process {[round(v, 5) for v in losses[ref]]}); "
            f"final (m, x) shards per rank max abs diff "
            f"{[comps[i][k][1] for k in sorted(comps[i])]} (tolerance "
            f"{TRAIN_TOL} x max-abs), bit for bit {bits}")
        log(f"  ({leg}) per rank: median step ms "
            f"{[round(v, 1) for v in ms]}; peak GB "
            f"{[round(v, 3) for v in peaks]}; K1 {k1}")
        log(f"  ({leg}) the model scope a step (ops, bytes, ms) per rank: "
            f"{model}")
        log(f"  ({leg}) rank 0 wire (ops, bytes, s, staging share): "
            f"{_wire_rows(o0['log'])}")
        out[leg] = {"k1_per_rank": k1, "bit_equal": bits,
                    "peak_gb_per_rank": peaks, "step_ms_per_rank": ms,
                    "model_per_rank": model,
                    "wire_rank0": _wire_rows(o0["log"])}
    return out


def mesh_phase(torch, dev, seed):
    from repro_torch.core import gossip
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import mesh_check as MC
    from repro_torch.launch import train as T
    out = {}
    cards = torch.cuda.device_count()

    # (a) the engine on one world: the small tree, then the qwen3 payload
    t0 = time.perf_counter()
    arch, layers = MESH_PAYLOAD
    res, comps = MC.payload_world(arch, layers, seed, MESH_SHAPE,
                                  engine=True)
    out["engine"] = _mesh_engine([r["engine"] for r in res], seed,
                                 MESH_SHAPE)
    world = len(res)
    for name, rows in comps.items():
        exact = name not in ("grid", "full")
        for rank, (equal, err, close) in rows.items():
            check(equal if exact else close,
                  f"mesh payload {name} rank {rank}: bit equal {equal}, "
                  f"max abs diff {err}")
        r0 = res[0]["rounds"][name]
        log(f"  {arch} x {layers} layers (m, x) {name}: rank 0 "
            f"{r0['ms']:.1f} ms, of which wire {r0['wire_ms']:.1f} ms, "
            f"staging through the host {r0['stage_ms']:.1f} ms "
            f"({100 * r0['stage_ms'] / r0['ms']:.1f} %); wire "
            f"{ {k: (v['ops'], v['bytes']) for k, v in r0['log'].items()} }"
            f"; K1 per rank {[r['rounds'][name]['k1'] for r in res]}; max "
            f"abs diff to the global path {max(e for _, e, _ in rows.values())}"
            + ("" if exact else f" (tolerance {MESH_DENSE_TOL})"))
        want_k1 = 1 if name in ("shifts", "matching") else 0
        check(all(r["rounds"][name]["k1"] == want_k1 for r in res),
              f"mesh payload {name}: K1 {[r['rounds'][name]['k1'] for r in res]}"
              f", expected {want_k1} a rank")
    log(f"  (a) {world} ranks, the payload {res[0]['local_elems'] / 1e6:.1f} "
        f"M f32 a rank; {time.perf_counter() - t0:.1f} s with the spawn")
    out["payload"] = {
        "k1_per_rank": [sum(rec["k1"] for rec in r["rounds"].values())
                        for r in res],
        "rounds": {n: {k: res[0]["rounds"][n][k] for k in
                       ("ms", "wire_ms", "stage_ms")} for n in comps}}

    # (b) training: phase 6's cell, single process, then one rank a node
    t0 = time.perf_counter()
    argv = TRAIN_ARGV + ["--seed", str(seed)]
    args = T.parse_args(argv)
    start = T.prepare(args)
    # the ranks train on the tokens sampled here (host work that grows
    # with the vocabulary), each its own node's
    tokens = [b["tokens"].numpy() for b in start["batches"]]
    # the combine's plain version: the ranks' K1 is held against it
    with gossip.kernel_mode("off"):
        ref = T.run(args, start=start)
    ref_losses = [h["loss"] for h in ref["history"]]
    reference = (ref["state"].momentum, ref["params"])
    del ref, start
    torch.cuda.empty_cache()
    res, comps = MC.train_world([(argv, reference)], tokens)
    res, comps = [r["runs"][0] for r in res], comps[0]
    del reference
    torch.cuda.empty_cache()
    for r in res:
        losses = [h["loss"] for h in r["history"]]
        check(len(losses) == len(ref_losses) and all(
            abs(a - b) <= TRAIN_TOL * abs(b) for a, b in
            zip(losses, ref_losses)),
            f"mesh train rank {r['rank']}: losses {losses} vs {ref_losses}")
        check(r["k1"] == args.steps, f"mesh train rank {r['rank']}: K1 "
              f"{r['k1']}, expected {args.steps}")
    bits = []
    for rank, (equal, err, scale) in sorted(comps.items()):
        check(err <= TRAIN_TOL * scale, f"mesh train rank {rank}: (m, x) "
              f"max abs diff {err} beyond {TRAIN_TOL} x {scale}")
        bits.append(equal)
    step_ms = [1e3 * sorted(r["step_s"][1:])[len(r["step_s"][1:]) // 2]
               for r in res]
    log(f"  (b) train on a (node {args.nodes}) mesh, {res[0]['wire']}: "
        f"losses {[round(h['loss'], 5) for h in res[0]['history']]} "
        f"(single process {[round(v, 5) for v in ref_losses]}); final "
        f"(m, x) per rank max abs diff "
        f"{[comps[k][1] for k in sorted(comps)]} (tolerance {TRAIN_TOL} x "
        f"max-abs), bit for bit {bits}; median step ms per rank "
        f"{[round(v, 3) for v in step_ms]}; peak GB per rank "
        f"{[round(r['peak_gb'], 3) for r in res]}; K1 per rank "
        f"{[r['k1'] for r in res]}; wire per rank 0 "
        f"{ {k: (v['ops'], round(v['s'], 3), round(v['stage_s'], 3)) for k, v in res[0]['log'].items()} }"
        f" (ops, s, staging s); {time.perf_counter() - t0:.1f} s")
    out["train"] = {"k1_per_rank": [r["k1"] for r in res],
                    "step_ms_per_rank": step_ms,
                    "peak_gb_per_rank": [r["peak_gb"] for r in res],
                    "bit_equal": bits}

    # (d)-(g): the overlapped trainer, parallel_msgd, a checkpoint and a
    # runtime round with 2 nodes a rank, on one world
    out["legs"] = _mesh_legs(torch, seed)

    # (h)-(k): fsdp-sharded training on a (node 4, fsdp 2, model 1) mesh,
    # model-sharded on (node 2, fsdp 2, model 2) and (node 4, fsdp 1,
    # model 2)
    out["fsdp"] = _sharded_legs(torch, seed, (
        out["legs"]["sync_peak_gb_per_rank"],
        out["legs"]["overlap_peak_gb_per_rank"]))

    # (c) NCCL: refused on one card; one card a rank where there are 4+
    msgs = mesh_mod.spawn(MC.nccl_refusal_rank, 2, (2,), timeout=120)
    check(all(m and "one card per rank" in m for m in msgs),
          f"mesh: NCCL with two ranks on cuda:0 did not raise: {msgs}")
    log(f"  (c) NCCL with 2 ranks on cuda:0 raises: {msgs[0][:90]}...")
    if cards >= 4:
        shape = (4, 2) if cards >= 8 else (4, 1)
        res = mesh_mod.spawn(MC.engine_rank, shape[0] * shape[1],
                             (shape, ("node", "fsdp"), "cuda", "nccl", seed),
                             timeout=300)
        out["nccl"] = _mesh_engine(res, seed, shape)
    else:
        log(f"  (c) the NCCL leg did not run: {cards} card(s) visible, it "
            "needs one card a rank (4 or more)")
        out["nccl"] = None
    return out


# ---------------------------------------------------------------------------
# phase 19: the dry run and the counter of a step's work
# ---------------------------------------------------------------------------

COUNT_BYTES_TOL = 0.01       # card against meta: bytes within 1 %


def _count_pair(torch, what, card_fn, meta_fn):
    """Count ``card_fn`` on the card and ``meta_fn`` on meta: flops equal,
    bytes within ``COUNT_BYTES_TOL``; prints any op whose count differs.
    Returns (card count, meta count)."""
    from repro_torch.launch.cost import Cost

    torch.cuda.synchronize()
    with Cost() as card:
        card_fn()
    torch.cuda.synchronize()
    with Cost() as meta:
        meta_fn()
    a, b = card.ops(), meta.ops()
    for op in sorted(set(a) | set(b)):
        if a.get(op) != b.get(op):
            log(f"  {what}: op {op} card (calls, flops, bytes) "
                f"{a.get(op)} meta {b.get(op)}")
    rel = abs(card.hbm_bytes - meta.hbm_bytes) / max(meta.hbm_bytes, 1.0)
    log(f"  {what}: card flops {card.flops:.6e} bytes {card.hbm_bytes:.6e} "
        f"peak {card.peak_bytes / 1e9:.3f} GB; meta flops {meta.flops:.6e} "
        f"bytes {meta.hbm_bytes:.6e} peak {meta.peak_bytes / 1e9:.3f} GB; "
        f"bytes apart by {100 * rel:.4f} % (tolerance "
        f"{100 * COUNT_BYTES_TOL:.0f} %)")
    check(card.flops == meta.flops,
          f"{what}: flops on the card {card.flops} != on meta {meta.flops}")
    check(rel <= COUNT_BYTES_TOL, f"{what}: bytes apart by {rel:.4%}")
    return card, meta


def _against_bound(what, count, ms, smi_line):
    """The bound one card gives a count (its flops at the bf16 peak, its
    bytes at the memory rate, the larger) against the measured ms."""
    from repro_torch.launch.mesh import HW

    c_ms = 1e3 * count.flops / HW["peak_flops_bf16"]
    m_ms = 1e3 * count.hbm_bytes / HW["hbm_bw"]
    bound = max(c_ms, m_ms)
    log(f"  {what}: median {ms:.3f} ms against the count's bound "
        f"{bound:.3f} ms (compute {c_ms:.3f}, memory {m_ms:.3f}): "
        f"{100 * bound / ms:.1f} % of the bound ({smi_line})")
    return {"ms": ms, "bound_ms": bound, "compute_ms": c_ms,
            "memory_ms": m_ms, "share": bound / ms,
            "flops": count.flops, "bytes": count.hbm_bytes,
            "peak_bytes": count.peak_bytes}


def dryrun_phase(torch, dev, seed, smi_line):
    import dataclasses
    import tempfile

    import numpy as np

    from repro_torch import configs
    from repro_torch.benchmarks import make_experiments as MX
    from repro_torch.kernels.gossip_mix import ops as gm_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    out = {}

    # (a) the matrix on meta: nothing allocated on the card
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    before = (torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated())
    jobs = min(8, os.cpu_count() or 1)
    with tempfile.TemporaryDirectory() as tmp:
        failures = D.run_matrix(D.ARCH_IDS, D.SHAPE_IDS, [False, True],
                                jobs=jobs, out_dir=tmp, verbose=False)
        check(not failures, f"dryrun: {len(failures)} failures: {failures}")
        os.environ["DRYRUN_DIR"] = tmp
        recs = MX.load()
        check(len(recs) == 80 and all(r["ok"] for r in recs.values()),
              f"dryrun: {len(recs)} records")
        log(MX.dryrun_section(recs))
        log(MX.roofline_section(recs))
        # the prefill records count rank 0's model-sharded step
        pre = [r for r in recs.values() if r["shape"] == "prefill_32k"]
        check(len(pre) == 20 and all(
            "uncounted" not in r and "partition" not in r
            and r["roofline"]["dominant"] for r in pre),
            "dryrun: a prefill_32k record is not rank 0's counted step")
        log("  (a) prefill_32k (rank 0's model-sharded step: dominant "
            "term, collectives): " + "; ".join(
                f"{r['arch']} {'2pod' if r['multi_pod'] else '1pod'} "
                f"{r['roofline']['dominant']} "
                f"{dict(r['cost']['collective_counts'])}"
                for r in sorted(pre, key=lambda r: (r["arch"],
                                                    r["multi_pod"]))))
        # the decode records count rank 0's model-sharded decode
        dec = [r for r in recs.values() if r["kind"] == "decode"]
        check(len(dec) == 40 and all(
            "uncounted" not in r and "partition" not in r
            and r["roofline"]["dominant"] and "wire" in r
            and r["rank_rows"] >= 1 for r in dec),
            "dryrun: a decode record is not rank 0's counted step")
        log("  (a) decode_32k / long_500k (rank 0's model-sharded decode: "
            "dominant term, collectives): " + "; ".join(
                f"{r['arch']} {r['shape']} "
                f"{'2pod' if r['multi_pod'] else '1pod'} "
                f"{r['roofline']['dominant']} "
                f"{dict(r['cost']['collective_counts'])}"
                for r in sorted(dec, key=lambda r: (r["arch"], r["shape"],
                                                    r["multi_pod"]))))
        del os.environ["DRYRUN_DIR"]
    torch.cuda.synchronize()
    after = (torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated())
    check(after == before, f"dryrun: the matrix moved the card's memory "
          f"(max, now) {before} -> {after}")
    log(f"  (a) ALL DRY-RUNS OK: 80 records in "
        f"{time.perf_counter() - t0:.1f} s on {jobs} worker processes; the "
        f"card's (max_memory_allocated, memory_allocated) {after} before "
        "and after")
    out["matrix_s"] = time.perf_counter() - t0

    # (b) phase 6's train step counted on the card and on meta
    t0 = time.perf_counter()
    args = T.parse_args(TRAIN_ARGV + ["--seed", str(seed)])
    start = T.prepare(args)
    cfg = start["config"]
    opt, step_for = T.build_trainer(cfg, start["topology"], args.optimizer,
                                    args.beta, args.micro_batch,
                                    momentum_dtype=start["momentum_dtype"])
    params, state = start["params"], opt.init(start["params"])
    lr, batches = start["lr_fn"], start["batches"]
    params, state, _ = step_for(0)(params, state, batches[0], lr(0))
    torch.cuda.synchronize()
    metas = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in params.items()}
    meta_state = opt.init(metas)
    gm_ops.gossip_mix.launches = 0
    card, _ = _count_pair(
        torch, "(b) train step",
        lambda: step_for(1)(params, state, batches[1], lr(1)),
        lambda: step_for(1)(metas, meta_state, batches[1], lr(1)))
    check(gm_ops.gossip_mix.launches == 1, f"dryrun (b): K1 launched "
          f"{gm_ops.gossip_mix.launches} times in the counted step")
    out["train_k1_launches"] = gm_ops.gossip_mix.launches
    secs = []
    for k in range(1, args.steps):
        t = time.perf_counter()
        params, state, _ = step_for(k)(params, state, batches[k], lr(k))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    step_ms = 1e3 * sorted(secs)[len(secs) // 2]
    out["train"] = _against_bound(
        f"(b) {cfg.name} x {cfg.n_layers} layers, {args.nodes} nodes, "
        f"{args.batch} x {args.seq} tokens a node, step", card, step_ms,
        smi_line)
    del params, state, start, metas, meta_state
    torch.cuda.empty_cache()
    log(f"  (b) {time.perf_counter() - t0:.1f} s")

    # (c) phase 7's forward: mamba2-1.3b through K4
    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get_config("mamba2-1.3b"),
                              attention_impl="pallas")
    params = M.init(cfg, seed, device=dev)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SSM_B, SSM_S))).to(dev)
    meta_params = M.init(cfg, device="meta")
    meta_tokens = torch.empty(tokens.shape, dtype=tokens.dtype,
                              device="meta")
    with torch.no_grad():
        M.forward(params, cfg, tokens)
        ssd_ops.ssd_scan.launches = 0
        card, _ = _count_pair(
            torch, "(c) ssm forward",
            lambda: M.forward(params, cfg, tokens),
            lambda: M.forward(meta_params, cfg, meta_tokens))
        check(ssd_ops.ssd_scan.launches == cfg.n_layers,
              f"dryrun (c): K4 launched {ssd_ops.ssd_scan.launches} times, "
              f"expected {cfg.n_layers}")
        out["ssm_k4_launches"] = ssd_ops.ssd_scan.launches
        secs = []
        for _ in range(3):
            t = time.perf_counter()
            M.forward(params, cfg, tokens)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
    out["ssm"] = _against_bound(
        f"(c) {cfg.name} forward {SSM_B} x {SSM_S}, bf16 activations",
        card, 1e3 * sorted(secs)[1], smi_line)
    del params, tokens
    torch.cuda.empty_cache()
    log(f"  (c) {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    phase("phase 1: device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on the card")
    smi_line = _smi_line()
    dev = torch.device("cuda", 0)
    log(f"  {smi_line}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.device_count()} device(s)")

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import model as M

    phase("phase 2: build")
    t0 = time.perf_counter()
    secs = build.build()
    log(f"  built {list(secs)} in {time.perf_counter() - t0:.2f} s "
        f"(per kernel {dict((k, round(v, 2)) for k, v in secs.items())})")
    for name in build.KERNELS:
        for r in build.ptxas_report(name):
            log(f"  {name}: {_short(r['function'])}: {r['registers']} "
                f"registers, spill stores/loads {r['spill_stores']}/"
                f"{r['spill_loads']} bytes, static shared memory "
                f"{r['smem_bytes']} bytes")
        for line in build.library_path(name).with_suffix(".log") \
                .read_text().splitlines():
            if "warning" in line.lower():
                log(f"  {name}: {line.strip()}")
    sass = {_short(f): c for f, c in build.sass_counts("flash_attention")
            .items()}
    for fn, counts in sass.items():
        log(f"  flash_attention SASS {fn}: {counts}")
    wgmma = [c for fn, c in sass.items() if "flash_fwd_wgmma" in fn]
    check(len(wgmma) == 2 and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0
                                  for c in wgmma),
          f"flash_attention: the bf16 kernels hold no HGMMA / UTMALDG: {sass}")
    ssd_sass = {_short(f): c for f, c in build.sass_counts(
        "ssd_scan", ("HGMMA",)).items()}
    for fn, counts in ssd_sass.items():
        log(f"  ssd_scan SASS {fn}: {counts}")
    tc = [c for fn, c in ssd_sass.items()
          if fn.split("<")[0].endswith(("_tc", "_pair"))]
    check(len(tc) >= 2 and all(c["HGMMA"] > 0 for c in tc),
          f"ssd_scan: the tensor-core kernels hold no HGMMA: {ssd_sass}")

    phase("phase 3: kernels against their plain versions")
    kernels = [flash_phase(torch, dev), paged_phase(torch, dev),
               gossip_phase(torch, dev), ssd_phase(torch, dev)]
    torch.cuda.empty_cache()

    phase("phase 4: full-width model, card against CPU")
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = configs.get_config("qwen3-0.6b")
    t0 = time.perf_counter()
    params = M.init(cfg, args.seed, device=dev)
    torch.cuda.synchronize()
    log(f"  init {cfg.name} ({M.param_count(params) / 1e6:.1f} M params, "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}) on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    model_phase(torch, dev, cfg, params, args.seed)

    phase("phase 5: serve (the serving main path)")
    launches, per_call = serve_phase(torch, dev, cfg, params, args.seed)
    dense_gen = dense_generate_phase(torch, dev, cfg, params, args.seed)
    del params
    torch.cuda.empty_cache()

    phase("phase 6: train (the training main path)")
    train = train_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()

    phase("phase 7: ssm (the mamba2-1.3b main path)")
    ssm = ssm_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()

    phase("phase 8: hybrid (the zamba2-1.2b main path)")
    hybrid = hybrid_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()

    phase("phase 9: train: ssm and hybrid, d_adamw / qg_dmsgd, aperiodic "
        "gossip")
    fam = train_families_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()

    phase("phase 10: runtime-valued gossip (stragglers, scheduled skips) and "
        "the paper's figures")
    rt = runtime_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()

    phase("phase 11: int8 wire compression and the overlapped (delayed-mix) "
        "pipeline")
    pipe = pipeline_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()

    phase("phase 12: moe (the granite-moe-3b-a800m main path)")
    moe = moe_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()

    phase("phase 13: audio (the musicgen-large main path)")
    audio = audio_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()

    phase("phase 14: vlm (llama-3.2-vision-90b, one group at full width)")
    vlm = vlm_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()

    phase("phase 15: configs (gemma2-27b, granite-34b, deepseek-67b, "
          "dbrx-132b at full width, cut in depth)")
    cfgs = configs_phase(torch, dev, args.seed)

    phase("phase 16: bench_serve --quick and its gate")
    bench = bench_serve_phase(torch, dev)
    torch.cuda.empty_cache()

    phase("phase 17: bench_kernels, bench_comm --quick and train_lm (100m)")
    benches = benches_phase(torch, dev, args.seed)
    for k in kernels:
        if k["name"] in ("ssd_scan", "flash_attention"):
            k["hybrid_launches"] = hybrid["launches"][k["name"]]
            k["hybrid_launches_per_call"] = hybrid["per_call"][k["name"]]
        if k["name"] == "flash_attention":
            k["generate_launches"] = dense_gen["generate_launches"]
        if k["name"] in ("flash_attention", "paged_attention"):
            # phase 12's serve, K2 once a layer per prefill call and K3
            # once a layer per decode step
            k["moe_launches"] = moe["launches"][k["name"]]
            k["moe_calls"] = moe["per_call"][k["name"]]
        if k["name"] == "flash_attention":
            k["moe_generate_launches"] = moe["generate_launches"]
            k["audio_generate_launches"] = audio["generate_launches"]
        if k["name"] in ("flash_attention", "paged_attention"):
            # phase 13's serve: K2 48 a prefill call, K3 48 a decode step
            k["audio_launches"] = audio["launches"][k["name"]]
            k["audio_calls"] = audio["per_call"][k["name"]]
            # phase 15's serves: n_layers a prefill call / decode step
            k["configs_launches"] = {a: r["launches"][k["name"]]
                                     for a, r in cfgs.items()}
            k["configs_calls"] = {a: r["per_call"][k["name"]]
                                  for a, r in cfgs.items()}
            k["bench_serve_launches"] = bench["launches"][k["name"]]
        if k["name"] == "gossip_mix":
            k["moe_train_launches"] = moe["train"]["launches"]
            k.update({f"moe_payload_{key}": v
                      for key, v in moe["train"]["payload"].items()})
            k["audio_train_launches"] = audio["train"]["launches"]
            k.update({f"audio_payload_{key}": v
                      for key, v in audio["train"]["payload"].items()})
            k["vlm_train_launches"] = vlm["train"]["launches"]
        if k["name"] in BENCH_KERNELS.values():
            # phase 17 (a): the suite's calls of the wrapper
            row = next(r for n, r in benches["kernels"].items()
                       if BENCH_KERNELS[n] == k["name"])
            k["bench_kernels_launches"] = benches["kernel_launches"][
                k["name"]]
            k["bench_kernels"] = {key: row[key] for key in (
                "us", "plain_us", "bound_us", "bound_by", "bound_share",
                "library_us")}
        if k["name"] == "gossip_mix":
            k["bench_comm_launches"] = benches["comm"]["launches"][
                "gossip_mix"]
            k["train_lm_launches"] = {t: r["launches"]
                                      for t, r in benches["lm"].items()}
        if k["name"] == "ssd_scan":
            k["launches"] = ssm["launches"]
            k["launches_per_call"] = k["launches"] // ssm["forward_calls"]
            k["forward_ms"] = ssm["forward_ms"]
        elif k["name"] == "gossip_mix":
            k["launches"] = train["launches"]
            k["launches_per_call"] = 1              # per train step
            k.update({key: v for key, v in train.items()
                      if key.startswith("train_payload_")})
            k.update({f"adamw_payload_{key}": v
                      for key, v in fam["payload"].items()})
            k["max_abs_err"] = max(k["max_abs_err"],
                                   train["train_payload_max_abs_err"],
                                   fam["payload"]["max_abs_err"],
                                   moe["train"]["payload"]["max_abs_err"],
                                   audio["train"]["payload"]["max_abs_err"])
            k["train_families_launches"] = fam["launches"]
            k["runtime_phase_launches"] = rt["launches"]
            # the delayed round of the overlap pipeline combines through K1
            # (phase 11); the int8 rounds combine in plain f32 torch
            k["pipeline_phase_launches"] = pipe["launches"]
            k["consumers"] = [
                "train step (phases 6, 9, 10)", "figure suites (phase 10)",
                "delayed round of the overlap pipeline and its flush "
                "(phase 11)"]
        else:
            k["launches"] = launches[k["name"]]
            k["launches_per_call"] = (k["launches"]
                                      // max(per_call[k["name"]], 1))

    torch.cuda.empty_cache()
    phase("phase 18: multi-process gossip (a mesh of ranks on the card)")
    mesh = mesh_phase(torch, dev, args.seed)
    for k in kernels:
        if k["name"] == "gossip_mix":
            k["mesh_k1_launches"] = {
                "engine_per_rank": mesh["engine"]["k1_per_rank"],
                "payload_per_rank": mesh["payload"]["k1_per_rank"],
                "train_per_rank": mesh["train"]["k1_per_rank"],
                "overlap_per_rank": mesh["legs"]["overlap_k1_per_rank"],
                "parallel_msgd_per_rank": mesh["legs"][
                    "parallel_msgd_k1_per_rank"],
                "fsdp_sync_per_rank": mesh["fsdp"]["h"]["k1_per_rank"],
                "fsdp_overlap_per_rank": mesh["fsdp"]["i"]["k1_per_rank"],
                "tp_j_per_rank": mesh["fsdp"]["j"]["k1_per_rank"],
                "tp_k_per_rank": mesh["fsdp"]["k"]["k1_per_rank"],
                "fsdp_moe_per_rank": mesh["fsdp"]["l"]["k1_per_rank"],
                "nccl_per_rank": (mesh["nccl"]["k1_per_rank"]
                                  if mesh["nccl"] else None)}
            k["fsdp_block"] = mesh["fsdp"]["k1_block"]
            k["fsdp_moe_block"] = mesh["fsdp"]["l"]["k1_block"]
        if k["name"] == "flash_attention":
            # phase 18 (m): K2 on each rank's heads in the model-sharded
            # prefill, 2 a rank (counted from 0 around the main path)
            m = mesh["fsdp"]["m"]
            k["mesh_prefill_launches_per_rank"] = m["k2_per_rank"]
            k["mesh_prefill"] = {key: m[key] for key in (
                "max_abs_err_per_rank", "tolerance", "ms_per_rank")}

    torch.cuda.empty_cache()
    phase("phase 19: the dry run (meta) and the counter, card against meta")
    dry = dryrun_phase(torch, dev, args.seed, smi_line)
    for k in kernels:
        if k["name"] == "gossip_mix":
            k["dryrun_count_launches"] = dry["train_k1_launches"]
        if k["name"] == "ssd_scan":
            k["dryrun_count_launches"] = dry["ssm_k4_launches"]

    phase(None)
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
