"""SSD-scan entry point: dispatch on the device of the tensors.

Same signature and semantics as the JAX package's
``kernels/ssd_scan/ops.py: ssd_scan``.  A CPU tensor takes the plain
PyTorch version (``ref.ssd_ref``); a CUDA tensor launches the hand-written
kernel (``kernel.py``) or raises -- there is no fallback and no switch.
The kernel is forward-only, as the JAX package's is (its Pallas kernel has
no gradient), so on a CUDA tensor it refuses to run where autograd would
need its gradient: the train path takes the plain chunked algorithm
(``models.mamba2.ssd_chunked``, ``attention_impl="jnp"``) instead.
``ssd_scan.launches`` counts calls that launched the kernel (one call is
three CUDA launches: chunk states, the state pass, chunk outputs), so a run
can show that its path went through it.  A meta tensor (the dry run) gets
empty outputs of the kernel's shapes and dtypes; nothing runs.  On a CUDA
or meta tensor under an active :class:`repro_torch.launch.cost.Cost` the
call records the kernel's work by ``benchmarks/bench_kernels.py:
ssd_cost``.
"""
from __future__ import annotations

import torch

from ...launch import cost as cost_mod
from . import kernel as K
from .ref import ssd_ref

__all__ = ["ssd_scan", "chunk_len"]


def chunk_len(s: int, chunk: int) -> int:
    """The chunk the scan runs with: ``min(chunk, s)``, halved until it
    divides s (as the JAX wrapper: s = 1000 gives 8)."""
    ck = min(chunk, s)
    while s % ck:
        ck //= 2
    return ck


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128):
    """x (b,s,h,p); dt (b,s,h); A (h,); B,C (b,s,g,n) ->
    (y (b,s,h,p) in x's dtype, h_final (b,h,p,n) float32)."""
    if x.device.type == "cpu":
        y, h_final = ssd_ref(x, dt, A, B, C)
        return y.to(x.dtype), h_final
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan runs on cpu, cuda or meta, not "
                         f"{x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, B, C)):
        raise RuntimeError(
            "ssd_scan: the CUDA kernel is forward-only (the JAX package's "
            "kernel has no gradient either); the train path uses the plain "
            "chunked scan (models.mamba2.ssd_chunked, attention_impl='jnp')")
    counted = cost_mod.active()
    b, s, h, p = x.shape
    with cost_mod.hidden():
        if x.device.type == "meta":
            y = torch.empty_like(x)
            h_final = x.new_empty((b, h, p, B.shape[3]), dtype=torch.float32)
        else:
            y, h_final = K.ssd_scan_cuda(x, dt, A, B, C,
                                         chunk=chunk_len(s, chunk))
            ssd_scan.launches += 1
    if counted:
        from ...benchmarks.bench_kernels import ssd_cost
        cost_mod.kernel("ssd_scan", *ssd_cost((b, s, h, p) + tuple(
            B.shape[2:]), chunk), (y, h_final))
    return y, h_final


ssd_scan.launches = 0
