"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

The JAX package (``src/repro``) is the reference; this package mirrors its
layout module for module and never imports it, nor JAX.  Entry points run
on the card (``device="cuda"``) unless the caller passes ``device="cpu"``;
on a CPU tensor every kernel wrapper takes its plain PyTorch version.

Ported: every model family of the reference (dense, moe, ssm, hybrid,
vlm, audio), the paged KV pool, the continuous-batching scheduler and
engine, the serving and training drivers, the decentralized optimizers
and gossip, checkpoints both packages read, and the four kernels
(flash attention, paged attention, the gossip combine and the SSD scan)
as CUDA C++ for ``sm_90a`` under ``csrc/``.
"""
