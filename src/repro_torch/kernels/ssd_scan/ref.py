"""Plain PyTorch version of the SSD-scan kernel: the naive per-timestep
recurrence (exact semantics).

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T ;  y_t = C_t h_t

A straight port of the JAX package's ``kernels/ssd_scan/ref.py``, with the
``scan`` as a Python loop over the steps.  It is independent of the chunked
algorithm (``models.mamba2.ssd_chunked``) and of the kernel, so it checks
both.  The wrapper in ``ops.py`` takes it for CPU tensors; ``chip_smoke.py``
holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch


def ssd_ref(x, dt, A, B, C, h0=None):
    """x: (b,s,h,p); dt: (b,s,h); A: (h,); B,C: (b,s,g,n).
    Returns (y (b,s,h,p), h_final (b,h,p,n)), both float32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    x, dt, A = x.float(), dt.float(), A.float()
    Bh = B.float().repeat_interleave(rep, dim=2)
    Ch = C.float().repeat_interleave(rep, dim=2)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    ys = []
    for t in range(s):
        dtt = dt[:, t]                                   # (b,h)
        decay = torch.exp(dtt * A[None])
        state = (state * decay[:, :, None, None]
                 + torch.einsum("bhn,bhp,bh->bhpn", Bh[:, t], x[:, t], dtt))
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], state))
    return torch.stack(ys, dim=1), state
