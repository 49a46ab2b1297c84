"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

The JAX package (``src/repro``) is the reference; this package mirrors its
layout module for module and never imports it, nor JAX.  Entry points run
on the card (``device="cuda"``) unless the caller passes ``device="cpu"``;
on a CPU tensor every kernel wrapper takes its plain PyTorch version.

Ported so far (the serving slice): the dense model family, the paged KV
pool, the continuous-batching scheduler and engine, the serving driver,
and the flash-attention (prefill) and paged-attention (decode) kernels as
CUDA C++ for ``sm_90a`` under ``csrc/``.
"""
