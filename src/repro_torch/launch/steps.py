"""Train step builder: per-node gradients, then the decentralized update.

The port of the JAX package's ``launch/steps.py`` (``train_loss_fn`` and
``make_train_step``; the dry-run's shape helpers are ROADMAP slice G).
Parameters, momentum and gradients are ``dict[str, Tensor]`` trees named
as :class:`repro_torch.models.model.Model`'s parameters, with a leading
node axis of size ``n``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core import optim as optim_mod
from ..models import model as M

Tree = Any

__all__ = ["train_loss_fn", "make_train_step", "overlap_ms"]

AUX_WEIGHT = 0.01     # the MoE aux loss's weight (zero aux for dense)


def train_loss_fn(params, cfg: M.ModelConfig, tokens, image_embeds=None):
    """Next-token CE in f32 against ``roll(tokens, -1)`` -- the last
    position's label wraps to the first token, as in the reference -- plus
    ``AUX_WEIGHT`` times the moe load-balance loss (zero for the other
    families).  Audio tokens (B, S, K) give (B, S, K, V) logits, and the
    mean runs over B S K.  The vlm family's ``image_embeds`` (B, T, d) go
    to the forward.  The experts train with the capacity dispatch: as in the
    reference, ``moe_dropless`` is turned off for the loss (the dropless
    mixture is the serving and eval path).  ``params`` is a ``Model`` or
    a :func:`~repro_torch.models.model.params_view`."""
    if cfg.n_experts and cfg.moe_dropless:
        cfg = dataclasses.replace(cfg, moe_dropless=False)
    logits, aux = M.forward(params, cfg, tokens, image_embeds=image_embeds)
    labels = torch.roll(tokens, -1, 1).long()
    lo = logits.float()
    mx = lo.amax(-1, keepdim=True).detach()
    lse = mx.squeeze(-1) + torch.log(torch.exp(lo - mx).sum(-1))
    label_logit = lo.gather(-1, labels[..., None]).squeeze(-1)
    ce = (lse - label_logit).mean()
    return ce + AUX_WEIGHT * aux


def make_train_step(cfg: M.ModelConfig,
                    opt: optim_mod.DecentralizedOptimizer,
                    *, micro_batch: int | None = None, timeline=None):
    """Returns ``train_step(mix, params, opt_state, batch, lr)``.

    ``mix`` is the realization-bound gossip executor that
    :class:`repro_torch.core.plan.GossipPlan` binds per realization.
    Gradients are computed per node in a loop over the node axis -- one
    node's activations alive at a time, where the reference vmaps -- each
    node's slice of the stacked parameters bound by name with
    :func:`~repro_torch.models.model.params_view`, with optional micro-batch
    accumulation in f32; then ``opt.update_with_mix`` partially averages.
    ``batch["tokens"]`` (n, B, S) (audio: (n, B, S, K)) may lie on the CPU;
    it is moved to the parameters' device, as is the vlm family's
    ``batch["image_embeds"]`` (n, B, T, d), split per node and, with
    ``micro_batch``, per micro-batch as the tokens are.  On a mesh (a
    plan built with ``mesh=``, one rank a node) the step takes the rank's
    block -- a node axis of 1 -- so the loop runs once and the gossip
    executor moves the payload over the mesh.  When the optimizer
    has runtime gossip hooks, ``aux`` carries the per-node losses and the
    batch's ``"alive"`` / ``"comm"`` flags (AL-DSGD weights, deadline gates,
    ``when=`` predicates).  Returns the new params, the new state, and the
    node-mean loss (a device scalar).

    An overlapped optimizer (``opt.overlap``) takes the pipelined step:
    ``mix`` is the step's :class:`~repro_torch.core.plan.OverlapIO`, and
    BEFORE the per-node forward and backward the delayed round of
    ``opt_state.buf`` starts (on the card on a side stream, so it runs
    under the backward); ``opt.update_pipelined`` waits for it, then runs
    the local transforms on the mixed iterates with the gradients taken
    at the pre-mix params.  ``timeline``, a list, gets one ``(start,
    delayed begin, delayed done, grads begin, grads end)`` tuple of CUDA
    events a pipelined step with a round in flight on the card
    (:func:`overlap_ms` reads them).
    """

    def loss_and_grads(p: dict, tokens, img):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = train_loss_fn(M.params_view(leaves), cfg, tokens, img)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def per_node_grads(p: dict, tokens, img):
        if micro_batch is None or micro_batch >= tokens.shape[0]:
            return loss_and_grads(p, tokens, img)
        nm = tokens.shape[0] // micro_batch

        def split(t):
            return (None if t is None
                    else t.reshape((nm, micro_batch) + t.shape[1:]))

        toks, imgs = split(tokens), split(img)
        acc_loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        acc_g = {k: torch.zeros(v.shape, dtype=torch.float32,
                                device=v.device) for k, v in p.items()}
        for m, tok in enumerate(toks):
            loss, g = loss_and_grads(p, tok,
                                     None if imgs is None else imgs[m])
            acc_g = {k: acc_g[k] + g[k].float() / nm for k in acc_g}
            acc_loss = acc_loss + loss / nm
        return acc_loss, acc_g

    def train_step(mix, params: Tree, opt_state, batch: dict, lr):
        first = next(iter(params.values()))
        tokens = batch["tokens"].to(first.device)
        images = batch.get("image_embeds")
        if images is not None:
            images = images.to(first.device)
        n = first.shape[0]
        marks = (timeline is not None and opt.overlap
                 and opt_state.buf is not None and first.is_cuda)
        if marks:
            t0, g_begin, g_end = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(3))
            t0.record()
        pending = (opt.start_delayed(params, opt_state, mix)
                   if opt.overlap else None)
        if marks:
            g_begin.record()
        losses, grads = [], None
        for i in range(n):
            loss, g = per_node_grads({k: v[i] for k, v in params.items()},
                                     tokens[i],
                                     None if images is None else images[i])
            if grads is None:        # written node by node, never stacked
                grads = {k: v.new_empty((n,) + tuple(v.shape))
                         for k, v in g.items()}
            for k, v in g.items():
                grads[k][i].copy_(v)
            losses.append(loss)
        losses = torch.stack(losses)
        if marks:
            g_end.record()
            timeline.append((t0, pending.begin, pending.done, g_begin,
                             g_end))
        if opt.overlap:
            new_params, new_state = opt.update_pipelined(
                params, opt_state, grads, lr, mix, pending=pending)
            return new_params, new_state, losses.mean()
        aux = None
        if opt.has_runtime_gossip:
            aux = {"loss": losses}
            for key in ("alive", "comm"):
                if key in batch:
                    aux[key] = batch[key]
        new_params, new_state = opt.update_with_mix(
            params, opt_state, grads, lr, mix, aux=aux)
        return new_params, new_state, losses.mean()

    return train_step


def overlap_ms(marks) -> tuple[float, float]:
    """(delayed round ms, ms of it that ran while the gradients ran) of
    one ``timeline`` entry of :func:`make_train_step`, from its events
    (synchronise first).  Times are taken from the ``start`` event, which
    precedes both streams' work."""
    t0, begin, done, g_begin, g_end = marks
    b, d = t0.elapsed_time(begin), t0.elapsed_time(done)
    gb, ge = t0.elapsed_time(g_begin), t0.elapsed_time(g_end)
    return d - b, max(0.0, min(d, ge) - max(b, gb))
