"""Mixture-of-Experts FFN with top-k routing: dropless and capacity dispatch.

Mirrors the JAX package's ``models/moe.py``; its two dispatch modes:

* ``dropless=True`` (serving, and every decode): each token goes through
  ALL of its top-k experts, ``y_t = sum_k gate_tk * FFN_{e_tk}(x_t)``.  A
  token's output depends on that token alone, so the path is
  batch-invariant and causal: decode reproduces prefill.  Where the
  reference scans over the stacked experts (one device loop), the port
  runs every expert's swiglu as one batched product over the expert axis
  -- ``(T, d) @ (E, d, f) -> (E, T, f)`` -- and then sums the gated
  outputs in f32 over the expert axis, as one more batched product
  ``(T, E) x (E, T, d) -> (T, d)``: a few dozen launches a layer where a
  Python loop over 40 experts would take ~500.  Its transient is
  (E, T, f) and (E, T, d).

* ``dropless=False`` (the train loss): the GShard/Switch sort-based
  dispatch with a fixed per-expert ``capacity``; overflow tokens are
  dropped.  Which tokens overflow depends on every other token of the
  batch, so it never serves decode.

The router is always f32 (``MoE``'s ``router``), whatever the expert
weights' dtype; the expert products run in the activation dtype, as the
reference's ``.astype(dt)``, and silu is :func:`layers.silu` (op by op, as
``jax.nn.silu`` rounds in bf16).  Neither path reads a value back to the
host, so both stay asynchronous on the card, and both are deterministic
(remat's recomputation in backward gives the forward's numbers).
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import silu

__all__ = ["MoE", "moe_apply"]


class MoE(nn.Module):
    """Router (d_model, E) in f32; w_gate, w_up (E, d_model, d_ff) and
    w_down (E, d_ff, d_model) in ``dtype``: the reference's ``moe_init``
    leaves."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 dtype=torch.float32, device=None):
        super().__init__()

        def p(shape, dt):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.router = p((d_model, n_experts), torch.float32)
        self.w_gate = p((n_experts, d_model, d_ff), dtype)
        self.w_up = p((n_experts, d_model, d_ff), dtype)
        self.w_down = p((n_experts, d_ff, d_model), dtype)


def _route(p: MoE, xf: torch.Tensor, n_experts: int, top_k: int):
    """Per-token top-k gates (renormalised) and expert indices, and the
    Switch load-balance loss ``E * sum_e density_e / k * mean_prob_e``.
    xf: (T, d).  Returns (gates (T, k) f32, indices (T, k) int64, aux)."""
    logits = xf.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)    # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    # mean over tokens of the one-hot rows (the k indices of a row are
    # distinct, so a row holds k ones)
    density = torch.zeros_like(probs).scatter_(1, expert_idx, 1.0).mean(0)
    aux = n_experts * torch.sum(density / top_k * probs.mean(0))
    return gate_vals, expert_idx, aux


def _swiglu(p: MoE, xe: torch.Tensor, dt) -> torch.Tensor:
    """Every expert's swiglu on its rows: xe (T, d) (every expert sees all
    rows) or (E, C, d) (its own rows) -> (E, rows, d) in ``dt``."""
    g = torch.matmul(xe, p.w_gate.to(dt))
    u = torch.matmul(xe, p.w_up.to(dt))
    return torch.matmul(silu(g) * u, p.w_down.to(dt))


def _moe_dropless(p: MoE, xf: torch.Tensor, dt, *, n_experts: int,
                  top_k: int):
    """The exact per-token mixture: (T, d) -> (T, d) f32, and the aux loss."""
    T = xf.shape[0]
    gate_vals, expert_idx, aux = _route(p, xf, n_experts, top_k)
    # (T, E) combine weights: each expert's gate mass for each token
    combine = torch.zeros((T, n_experts), dtype=torch.float32,
                          device=xf.device).scatter_add(1, expert_idx,
                                                        gate_vals)
    ye = _swiglu(p, xf, dt)                                  # (E, T, d)
    # the gated sum over experts in f32, with no (E, T, d) product tensor
    y = torch.einsum("te,etd->td", combine, ye.float())
    return y, aux


def _dispatch(expert_idx: torch.Tensor, n_experts: int,
              capacity_factor: float):
    """The capacity dispatch's bookkeeping, as the reference builds it.
    expert_idx: (T, k).  Assignments a = t * k + j are grouped by expert
    (a stable sort, so token order within an expert), and the first
    ``capacity`` of each expert are kept.  Returns (capacity, order (A,),
    slot (A,) in [0, E * capacity), keep (A,) bool), all in sorted order."""
    T, top_k = expert_idx.shape
    A = T * top_k
    capacity = int(max(1, -(-A * capacity_factor // n_experts)))  # ceil
    flat_expert = expert_idx.reshape(A)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    pos_in_group = torch.arange(A, device=expert_idx.device) - \
        torch.searchsorted(sorted_expert, sorted_expert, right=False)
    keep = pos_in_group < capacity
    slot = sorted_expert * capacity + pos_in_group.clamp(max=capacity - 1)
    return capacity, order, slot, keep


def _moe_capacity(p: MoE, xf: torch.Tensor, dt, *, n_experts: int,
                  top_k: int, capacity_factor: float):
    """Capacity-bounded grouped dispatch: (T, d) -> (T, d) f32, and the aux
    loss.  Dropped assignments are routed to a spare row past the E x
    capacity slots (never written out of bounds) and contribute zero."""
    T, d = xf.shape
    gate_vals, expert_idx, aux = _route(p, xf, n_experts, top_k)
    capacity, order, slot, keep = _dispatch(expert_idx, n_experts,
                                            capacity_factor)
    n_slots = n_experts * capacity
    sorted_token = torch.div(order, top_k, rounding_mode="floor")
    sorted_gate = gate_vals.reshape(-1)[order]
    src = torch.where(keep, slot, n_slots)            # n_slots: dropped
    # kept slots are distinct, so each holds exactly its token's row
    gathered = xf.new_zeros((n_slots + 1, d)).index_add(
        0, src, xf[sorted_token])
    ye = _swiglu(p, gathered[:n_slots].reshape(n_experts, capacity, d), dt)
    vals = torch.where(keep[:, None],
                       ye.reshape(n_slots, d)[slot].float()
                       * sorted_gate[:, None], 0.0)
    # back to (token, j) order and summed over the k choices in f32: the
    # reference's scatter-add of the same k values, in a fixed order
    unsorted = torch.empty_like(vals).index_copy(0, order, vals)
    return unsorted.reshape(T, top_k, d).sum(1), aux


def _moe_capacity_tp(tp, p: MoE, xf: torch.Tensor, dt, *, n_experts: int,
                     top_k: int, capacity_factor: float):
    """:func:`_moe_capacity` on the rank's model shards of the experts
    (``tp``: a bound :class:`~repro_torch.launch.tp.TP`).  The router and
    the dispatch run replicated on the replicated activations.  Experts
    cut over model (expert-parallel) compute the kept rows of the rank's
    own experts; experts cut on the ff dim compute every expert on the
    rank's ff slice (partial outputs).  The slots and the gates enter the
    rank's products and its combine through ``copy_to`` (each rank's
    gradient of them is partial: without it the router's would be), and
    the combine leaves through ``reduce_from``.  The aux loss stays
    replicated."""
    T, d = xf.shape
    gate_vals, expert_idx, aux = _route(p, xf, n_experts, top_k)
    capacity, order, slot, keep = _dispatch(expert_idx, n_experts,
                                            capacity_factor)
    n_slots = n_experts * capacity
    sorted_token = torch.div(order, top_k, rounding_mode="floor")
    src = torch.where(keep, slot, n_slots)
    gathered = xf.new_zeros((n_slots + 1, d)).index_add(
        0, src, xf[sorted_token])
    slots = tp.copy_to(gathered[:n_slots].reshape(n_experts, capacity, d))
    sorted_gate = tp.copy_to(gate_vals).reshape(-1)[order]
    if tp.dim(p.w_gate) == 0:            # expert-parallel
        El = p.w_gate.shape[0]
        e0 = tp.rank * El
        ye = _swiglu(p, slots[e0:e0 + El], dt).reshape(El * capacity, d)
        expert = torch.div(slot, capacity, rounding_mode="floor")
        mine = keep & (expert >= e0) & (expert < e0 + El)
        at = (slot - e0 * capacity).clamp(0, El * capacity - 1)
    else:                                # every expert on the ff slice
        ye = _swiglu(p, slots, dt).reshape(n_slots, d)
        mine, at = keep, slot
    vals = torch.where(mine[:, None], ye[at].float() * sorted_gate[:, None],
                       0.0)
    unsorted = torch.empty_like(vals).index_copy(0, order, vals)
    return tp.reduce_from(unsorted.reshape(T, top_k, d).sum(1)), aux


def moe_apply(p: MoE, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, dropless: bool = True,
              tp=None):
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux loss (f32 scalar)).
    ``dropless=True`` is the batch-invariant serving path,
    ``dropless=False`` the capacity-bounded training path; ``tp`` (the
    rank's model shards, :func:`_moe_capacity_tp`) takes the training
    path only."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    if tp is not None and tp.dim(p.w_gate) is None:
        tp = None                        # experts whole on every rank
    if tp is not None:
        if dropless:
            raise ValueError("the tensor-parallel experts train with the "
                             "capacity dispatch (dropless=False)")
        y, aux = _moe_capacity_tp(tp, p, xf, x.dtype, n_experts=n_experts,
                                  top_k=top_k,
                                  capacity_factor=capacity_factor)
    elif dropless:
        y, aux = _moe_dropless(p, xf, x.dtype, n_experts=n_experts,
                               top_k=top_k)
    else:
        y, aux = _moe_capacity(p, xf, x.dtype, n_experts=n_experts,
                               top_k=top_k, capacity_factor=capacity_factor)
    return y.reshape(B, S, d).to(x.dtype), aux
