"""Tree checkpointing (npz payload + json manifest), in the JAX package's
on-disk format, so that each package restores the other's checkpoints.

Path layout: ``<dir>/step_<N>/{manifest.json, arrays.npz}``, written to
``step_<N>.tmp`` and renamed.  A tree is nested dicts, tuples (an
``OptState`` among them) and tensors; its leaves are written as
``leaf_<i>`` in JAX's flatten order (dict keys sorted at every level,
tuple fields in order, ``None`` holding no leaf), which is the order the
JAX ``restore`` reads them by position: an optimizer state from
:func:`repro_torch.convert.opt_state_to_jax` writes its momentum, its
int32 ``count`` and, for a ``gossip(when=...)`` chain, its int32
``sched_pos``, as the reference's ``OptState`` flattens.  A train state goes through
:func:`repro_torch.convert.train_state_to_jax` first, so its leaves also
have JAX's shapes (layer leaves stacked on the layer axis).

bf16 leaves are stored as the JAX package stores them: a ``uint8`` byte
view (last dimension doubled) with ``"bfloat16"`` in the manifest's
``dtypes``.  The manifest's ``treedef`` is the JAX treedef's ``repr``
there; here it is the list of the leaves' key paths (``"a/b/c"``), in
order.  Neither ``restore`` reads it.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

__all__ = ["save", "latest_step", "restore", "map_leaves"]


def _children(tree):
    """(key, child) pairs of a dict (keys sorted) or a tuple/list (in
    order), as JAX flattens them."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), v) for i, v in enumerate(tree)]


def _flatten(tree, prefix: str = ""):
    """(key path, leaf) pairs in JAX's flatten order (``None`` holds no
    leaf)."""
    for key, val in _children(tree):
        if val is None:
            continue
        if isinstance(val, (dict, tuple, list)):
            yield from _flatten(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


def _unflatten_like(like, leaves):
    """``like``'s structure, dict keys in ``like``'s order, the leaves
    taken from ``leaves`` in JAX's flatten order (keys sorted): a packed
    gossip buffer's layout follows the tree's key order, so a restored
    tree keeps it."""
    if like is None:
        return None
    if not isinstance(like, (dict, tuple, list)):
        return next(leaves)
    if isinstance(like, dict):
        vals = {k: _unflatten_like(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    vals = [_unflatten_like(v, leaves) for v in like]
    if hasattr(like, "_fields"):                 # a NamedTuple
        return type(like)(*vals)
    return type(like)(vals)


def map_leaves(fn, tree):
    """``tree`` with each leaf replaced by ``fn(leaf)``, the leaves visited
    one at a time in the order :func:`save` writes them (every rank of a
    mesh gathers them in the same order)."""
    return _unflatten_like(tree, (fn(leaf) for _, leaf in _flatten(tree)))


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """npz-safe array: bf16 (which numpy lacks) as a uint8 byte view."""
    t = t.detach().cpu().contiguous()
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint8).numpy(), dtype
    return t.numpy(), dtype


def save(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree`` as step ``step`` of ``ckpt_dir``; returns its path."""
    paths, arrays, dtypes = [], {}, []
    for i, (path, leaf) in enumerate(_flatten(tree)):
        arr, dt = _to_numpy(leaf)
        arrays[f"leaf_{i}"] = arr
        dtypes.append(dt)
        paths.append(path)
    path = os.path.join(ckpt_dir, f"step_{step}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(paths),
                   "treedef": paths, "dtypes": dtypes}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like_tree):
    """Restore into the structure of ``like_tree``: each leaf takes the
    like leaf's dtype, shape and device (a byte-view leaf is
    reinterpreted as the like leaf's dtype first)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(data.files))]
    like = [leaf for _, leaf in _flatten(like_tree)]
    if len(arrays) != len(like):
        raise ValueError(f"{path} holds {len(arrays)} leaves, the tree "
                         f"{len(like)}")
    out = []
    for a, r in zip(arrays, like):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.dtype == torch.uint8 and r.dtype != torch.uint8:
            t = t.view(r.dtype)
        out.append(t.to(r.dtype).reshape(r.shape).to(r.device))
    return _unflatten_like(like_tree, iter(out))
