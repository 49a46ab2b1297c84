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
  (E, T, f) and (E, T, d).  On model shards (``tp=``, the model-sharded
  prefill) it takes :func:`_moe_capacity`'s two routes
  (:func:`_moe_dropless`).

* ``dropless=False`` (the train loss): the GShard/Switch sort-based
  dispatch with a fixed per-expert ``capacity``; overflow tokens are
  dropped.  Which tokens overflow depends on every other token of the
  batch, so it never serves decode.  On a mesh whose fsdp ranks split a
  node's rows, a routing group (a micro-batch) may span several ranks;
  ``route=`` (``launch/moe_group.py``) then makes the capacity, the kept
  set and the aux loss the whole group's, and splits the expert compute
  over the group's ranks (:func:`_moe_capacity`).

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


def _gates(p: MoE, xf: torch.Tensor, top_k: int):
    """The f32 router on xf (T, d): (gates (T, k) f32, renormalised,
    indices (T, k) int64, probabilities (T, E) f32)."""
    logits = xf.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)    # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    return gate_vals, expert_idx, probs


def _aux(density, mean_probs, n_experts: int, top_k: int):
    """The Switch load-balance loss ``E * sum_e density_e / k *
    mean_prob_e`` of the (E,) token means."""
    return n_experts * torch.sum(density / top_k * mean_probs)


def _route(p: MoE, xf: torch.Tensor, n_experts: int, top_k: int):
    """Per-token top-k gates (renormalised) and expert indices, and the
    Switch load-balance loss over xf's tokens.  xf: (T, d).  Returns
    (gates (T, k) f32, indices (T, k) int64, aux)."""
    gate_vals, expert_idx, probs = _gates(p, xf, top_k)
    # mean over tokens of the one-hot rows (the k indices of a row are
    # distinct, so a row holds k ones)
    density = torch.zeros_like(probs).scatter_(1, expert_idx, 1.0).mean(0)
    return gate_vals, expert_idx, _aux(density, probs.mean(0), n_experts,
                                       top_k)


def _swiglu(p: MoE, xe: torch.Tensor, dt) -> torch.Tensor:
    """Every expert's swiglu on its rows: xe (T, d) (every expert sees all
    rows) or (E, C, d) (its own rows) -> (E, rows, d) in ``dt``."""
    g = torch.matmul(xe, p.w_gate.to(dt))
    u = torch.matmul(xe, p.w_up.to(dt))
    return torch.matmul(silu(g) * u, p.w_down.to(dt))


def _moe_dropless(p: MoE, xf: torch.Tensor, dt, *, n_experts: int,
                  top_k: int, tp=None):
    """The exact per-token mixture: (T, d) -> (T, d) f32, and the aux loss.

    ``tp`` (a bound :class:`~repro_torch.launch.tp.TP`): the rank's model
    shards of the experts, by the route their layout takes.  Experts cut
    over model (expert-parallel: E divides the model extent, dbrx's 16
    at model 16) run the rank's El experts' swiglu on every token and
    combine with its El columns of the (T, E) combine weights; experts
    cut on the ff dim (E does not divide it: granite-moe's 40 at model
    16), ``w_gate`` / ``w_up`` column-parallel and ``w_down``
    row-parallel, run every expert on the rank's ff slice, and the gated
    sum runs over the partial outputs.  Either way the router runs
    replicated on the replicated activations, x and the combine weights
    enter through ``copy_to`` (each rank's gradient of them is partial),
    and the f32 partial sums meet in one ``reduce_from``."""
    T = xf.shape[0]
    gate_vals, expert_idx, aux = _route(p, xf, n_experts, top_k)
    # (T, E) combine weights: each expert's gate mass for each token
    combine = torch.zeros((T, n_experts), dtype=torch.float32,
                          device=xf.device).scatter_add(1, expert_idx,
                                                        gate_vals)
    if tp is not None:
        xf, combine = tp.copy_to(xf), tp.copy_to(combine)
        if tp.dim(p.w_gate) == 0:                     # expert-parallel
            El = p.w_gate.shape[0]
            combine = combine[:, tp.rank * El:(tp.rank + 1) * El]
    ye = _swiglu(p, xf, dt)                                  # (E, T, d)
    # the gated sum over experts in f32, with no (E, T, d) product tensor
    y = torch.einsum("te,etd->td", combine, ye.float())
    return (y if tp is None else tp.reduce_from(y)), aux


def _capacity(A: int, capacity_factor: float, n_experts: int) -> int:
    """Each expert's capacity for ``A`` assignments (the reference's)."""
    return int(max(1, -(-A * capacity_factor // n_experts)))  # ceil


def _counts(expert_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(E,) int64: the assignments to each expert."""
    flat = expert_idx.reshape(-1)
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=flat.device).index_add_(
        0, flat, torch.ones_like(flat))


def _positions(expert_idx: torch.Tensor, capacity: int, width: int,
               offset=None):
    """Assignments a = t * k + j grouped by expert (a stable sort, so token
    order within an expert); an assignment's position is its rank among
    its expert's, plus ``offset[e]`` (the assignments to e that come before
    these: a routing group's lower ranks), and the first ``capacity`` of
    each expert are kept.  Returns (order (A,), slot (A,) =
    ``e * width + position`` in [0, E * width), keep (A,) bool), in sorted
    order."""
    A = expert_idx.numel()
    flat_expert = expert_idx.reshape(A)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    pos_in_group = torch.arange(A, device=expert_idx.device) - \
        torch.searchsorted(sorted_expert, sorted_expert, right=False)
    if offset is not None:
        pos_in_group = pos_in_group + offset[sorted_expert]
    keep = pos_in_group < capacity
    slot = sorted_expert * width + pos_in_group.clamp(max=capacity - 1)
    return order, slot, keep


def _dispatch(expert_idx: torch.Tensor, n_experts: int,
              capacity_factor: float):
    """The capacity dispatch's bookkeeping, as the reference builds it.
    expert_idx: (T, k).  Returns (capacity, order (A,), slot (A,) in
    [0, E * capacity), keep (A,) bool), all in sorted order
    (:func:`_positions`)."""
    T, top_k = expert_idx.shape
    capacity = _capacity(T * top_k, capacity_factor, n_experts)
    return (capacity,) + _positions(expert_idx, capacity, capacity)


def _group_dispatch(expert_idx: torch.Tensor, n_experts: int,
                    capacity_factor: float, group: int, offset):
    """:func:`_dispatch` of a rank's share of a routing group of ``group``
    equal shares (expert_idx (T, k), the rank's tokens, which follow the
    group's lower ranks' in its token order): the capacity is the
    group's, for ``group * T * k`` assignments, and ``offset`` (E,)
    counts each expert's assignments on the lower ranks, so that the
    kept set is the one :func:`_dispatch` keeps on the whole group.  Its
    slots are laid out at a ``width`` of the capacity rounded up to a
    multiple of ``group`` (the padding slots are never kept).  Returns
    (capacity, width, order, slot, keep)."""
    T, top_k = expert_idx.shape
    capacity = _capacity(group * T * top_k, capacity_factor, n_experts)
    width = -(-capacity // group) * group
    return (capacity, width) + _positions(expert_idx, capacity, width,
                                          offset)


def _moe_capacity(p: MoE, xf: torch.Tensor, dt, *, n_experts: int,
                  top_k: int, capacity_factor: float, tp=None, route=None):
    """Capacity-bounded grouped dispatch: (T, d) -> (T, d) f32, and the aux
    loss.  Dropped assignments are routed to a spare row past the E x
    capacity slots (never written out of bounds) and contribute zero.

    ``tp`` (a bound :class:`~repro_torch.launch.tp.TP`): the rank's model
    shards of the experts.  The router and the dispatch run replicated on
    the replicated activations.  Experts cut over model (expert-parallel)
    compute the kept rows of the rank's own experts; experts cut on the
    ff dim compute every expert on the rank's ff slice (partial outputs).
    The slots and the gates enter the rank's products and its combine
    through ``copy_to`` (each rank's gradient of them is partial: without
    it the router's would be), and the combine leaves through
    ``reduce_from``.  The aux loss stays replicated over model.

    ``route`` (a :class:`~repro_torch.launch.moe_group.MoeGroup`): xf is
    the rank's share of a routing group spread over ``route.size``
    consecutive fsdp ranks, and the routing is the group's
    (:func:`_group_dispatch`): each expert's offset and the group's
    counts from ``route.counts``, the aux loss's means over the group's
    tokens (``route.sum`` of the probabilities, whose backward sums the
    ranks' gradients), and the expert compute split over the group:
    ``route.scatter`` hands each rank its ``width / G`` slots of every
    expert, summed from the ranks' buffers (each holds its own kept rows
    at their group slots, zeros elsewhere), and ``route.gather`` brings
    the outputs back for each rank to combine its own tokens."""
    T, d = xf.shape
    if route is None:
        gate_vals, expert_idx, aux = _route(p, xf, n_experts, top_k)
        capacity, order, slot, keep = _dispatch(expert_idx, n_experts,
                                                capacity_factor)
        width = capacity
    else:
        gate_vals, expert_idx, probs = _gates(p, xf, top_k)
        n = route.size * T                 # the group's tokens
        offset, total = route.counts(_counts(expert_idx, n_experts))
        aux = _aux(total.float() / n, route.sum(probs.sum(0)) / n,
                   n_experts, top_k)
        capacity, width, order, slot, keep = _group_dispatch(
            expert_idx, n_experts, capacity_factor, route.size, offset)
    n_slots = n_experts * width
    sorted_token = torch.div(order, top_k, rounding_mode="floor")
    src = torch.where(keep, slot, n_slots)            # n_slots: dropped
    # kept slots are distinct, so each holds exactly its token's row
    slots = xf.new_zeros((n_slots + 1, d)).index_add(
        0, src, xf[sorted_token])[:n_slots].reshape(n_experts, width, d)
    if tp is not None:
        slots, gate_vals = tp.copy_to(slots), tp.copy_to(gate_vals)
    sorted_gate = gate_vals.reshape(-1)[order]
    ep = tp is not None and tp.dim(p.w_gate) == 0     # expert-parallel
    if ep:
        El = p.w_gate.shape[0]
        e0 = tp.rank * El
        slots = slots[e0:e0 + El]
    if route is not None:
        slots = route.scatter(slots)
    ye = _swiglu(p, slots, dt)
    if route is not None:
        ye = route.gather(ye)
    if ep:
        ye = ye.reshape(El * width, d)
        expert = torch.div(slot, width, rounding_mode="floor")
        mine = keep & (expert >= e0) & (expert < e0 + El)
        at = (slot - e0 * width).clamp(0, El * width - 1)
    else:
        ye = ye.reshape(n_slots, d)
        mine, at = keep, slot
    vals = torch.where(mine[:, None], ye[at].float() * sorted_gate[:, None],
                       0.0)
    # back to (token, j) order and summed over the k choices in f32: the
    # reference's scatter-add of the same k values, in a fixed order
    unsorted = torch.empty_like(vals).index_copy(0, order, vals)
    y = unsorted.reshape(T, top_k, d).sum(1)
    return (y if tp is None else tp.reduce_from(y)), aux


def moe_apply(p: MoE, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, dropless: bool = True,
              tp=None, route=None):
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux loss (f32 scalar)).
    ``dropless=True`` is the batch-invariant serving path,
    ``dropless=False`` the capacity-bounded training path; ``tp`` (the
    rank's model shards) takes either (:func:`_moe_dropless`,
    :func:`_moe_capacity`), ``route`` (the rank's routing group over
    fsdp) the training path only: a serving batch has no routing
    group."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    if tp is not None and tp.dim(p.w_gate) is None:
        tp = None                        # experts whole on every rank
    if dropless:
        if route is not None:
            raise ValueError("the experts route over a routing group with "
                             "the capacity dispatch (dropless=False)")
        y, aux = _moe_dropless(p, xf, x.dtype, n_experts=n_experts,
                               top_k=top_k, tp=tp)
    else:
        y, aux = _moe_capacity(p, xf, x.dtype, n_experts=n_experts,
                               top_k=top_k, capacity_factor=capacity_factor,
                               tp=tp, route=route)
    return y.reshape(B, S, d).to(x.dtype), aux
