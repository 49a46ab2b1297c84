"""Device selection for the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of every
    entry point) raises when there is no card: the port never falls back
    to the CPU unless the caller asks for it with ``device="cpu"``.
    ``"meta"`` (shapes and dtypes, no values, nothing allocated) is taken
    when a caller names it: the dry run (``launch/dryrun.py``) and its
    tests count a step's work that way."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
