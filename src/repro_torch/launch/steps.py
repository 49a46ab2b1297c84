"""Train, prefill and serve step builders, and the dry run's input specs.

The port of the JAX package's ``launch/steps.py``: ``train_loss_fn`` and
``make_train_step``, and the dry run's shape helpers (``SHAPES``,
``shape_cfg``, ``input_specs``, ``cache_len_for``, ``cache_struct``,
``make_prefill_step``, ``make_serve_step``).  Parameters, momentum and
gradients are ``dict[str, Tensor]`` trees named as
:class:`repro_torch.models.model.Model`'s parameters, with a leading node
axis of size ``n``.

Input shapes (the reference's):
  train_4k     seq=4096    global_batch=256   -> train_step (DmSGD gossip)
  prefill_32k  seq=32768   global_batch=32    -> prefill_step
  decode_32k   seq=32768   global_batch=128   -> serve_step (1 new token)
  long_500k    seq=524288  global_batch=1     -> serve_step, sub-quadratic
               (ssm and hybrid natively; the attention families take the
               ``LONG_WINDOW`` sliding-window override)

``make_prefill_step(tp=, fsdp=)`` and ``make_serve_step(tp=, fsdp=)``
are also a replica's model-sharded prefill and decode (a rank's serving
shards and rows, and its shard of the cache), which the dry run's
``prefill_32k`` and decode records count.

Where the reference's ``input_specs`` returns ``ShapeDtypeStruct``
stand-ins, the port's returns tensors on the ``meta`` device (shapes and
dtypes, nothing allocated), which the step functions run on directly.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core import optim as optim_mod
from ..models import model as M
from . import sharding

Tree = Any

__all__ = ["SHAPES", "LONG_WINDOW", "shape_cfg", "input_specs",
           "cache_len_for", "cache_struct", "train_loss_fn",
           "loss_and_grads", "accumulate_grads", "make_train_step",
           "make_prefill_step", "make_serve_step", "overlap_ms"]

AUX_WEIGHT = 0.01     # the MoE aux loss's weight (zero aux for dense)

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq=524288, global_batch=1),
}

LONG_WINDOW = 8192  # sliding-window override for full attention at long_500k


def shape_cfg(cfg: M.ModelConfig, shape_name: str) -> M.ModelConfig:
    """Per-shape config overrides: at ``long_500k`` every family but ssm
    and hybrid attends over a ``LONG_WINDOW`` sliding window."""
    if shape_name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return dataclasses.replace(cfg, attention_override_window=LONG_WINDOW)
    return cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_spec(cfg: M.ModelConfig, lead: tuple, seq: int) -> torch.Tensor:
    shp = lead + (seq,)
    if cfg.family == "audio":
        shp = shp + (cfg.n_codebooks,)
    return _meta(shp, torch.int32)


def input_specs(cfg: M.ModelConfig, shape_name: str, *,
                nodes: int = 1) -> dict:
    """Meta-tensor stand-ins for every input of the shape's step: train
    ``tokens`` (nodes, global_batch / nodes, seq) (audio ``+ (K,)``),
    prefill ``tokens`` (global_batch, seq), decode ``token``
    (global_batch, 1); the vlm family adds ``image_embeds`` (..., T, d)
    in the activation dtype.  The decode ``idx`` departs from the
    reference's 0-d int32 struct: the port's ``decode_step`` takes the
    position as a Python int, so ``idx`` is the position of the shape's
    last token (``seq - 1``); the ring decode's work does not depend on
    it."""
    info = SHAPES[shape_name]
    seq, gb = info["seq"], info["global_batch"]
    adt = cfg.activation_dtype

    def images(lead):
        return _meta(lead + (cfg.n_image_tokens, cfg.d_model), adt)

    if info["kind"] == "train":
        pnb = gb // nodes
        if pnb < 1:
            raise ValueError(
                f"global_batch {gb} < nodes {nodes}: the decentralized "
                "layout needs at least one sequence per node")
        out = {"tokens": _token_spec(cfg, (nodes, pnb), seq)}
        if cfg.family == "vlm":
            out["image_embeds"] = images((nodes, pnb))
        return out
    if info["kind"] == "prefill":
        out = {"tokens": _token_spec(cfg, (gb,), seq)}
        if cfg.family == "vlm":
            out["image_embeds"] = images((gb,))
        return out
    out = {"token": _token_spec(cfg, (gb,), 1), "idx": seq - 1}
    if cfg.family == "vlm":
        out["image_embeds"] = images((gb,))
    return out


def cache_len_for(cfg: M.ModelConfig, shape_name: str) -> int:
    seq = SHAPES[shape_name]["seq"]
    if cfg.attention_override_window is not None:
        return min(seq, cfg.attention_override_window)
    return seq


def cache_struct(cfg: M.ModelConfig, shape_name: str) -> dict:
    """The decode cache on the meta device (``init_cache``'s tree, nothing
    allocated) for the shape's global batch."""
    return M.init_cache(cfg, SHAPES[shape_name]["global_batch"],
                        cache_len_for(cfg, shape_name), device="meta")


def train_loss_fn(params, cfg: M.ModelConfig, tokens, image_embeds=None,
                  tp=None, route=None):
    """Next-token CE in f32 against ``roll(tokens, -1)`` -- the last
    position's label wraps to the first token, as in the reference -- plus
    ``AUX_WEIGHT`` times the moe load-balance loss (zero for the other
    families).  Audio tokens (B, S, K) give (B, S, K, V) logits, and the
    mean runs over B S K.  The vlm family's ``image_embeds`` (B, T, d) go
    to the forward.  The experts train with the capacity dispatch: as in the
    reference, ``moe_dropless`` is turned off for the loss (the dropless
    mixture is the serving and eval path).  ``params`` is a ``Model`` or
    a :func:`~repro_torch.models.model.params_view`.  ``tp`` (a bound
    :class:`~repro_torch.launch.tp.TP`): ``params`` are the rank's model
    shards; where the head cuts the vocabulary the CE is the
    vocab-parallel one (``TP.vocab_ce``), the logits never gathered.  The
    loss is then the same on every rank of the model line.  ``route`` (a
    :class:`~repro_torch.launch.moe_group.MoeGroup`): ``tokens`` are the
    rank's share of a moe routing group, whose capacity dispatch and aux
    loss are the group's; the CE stays the mean over the rank's rows."""
    if cfg.n_experts and cfg.moe_dropless:
        cfg = dataclasses.replace(cfg, moe_dropless=False)
    logits, aux = M.forward(params, cfg, tokens, image_embeds=image_embeds,
                            tp=tp, route=route)
    labels = torch.roll(tokens, -1, 1).long()
    if M.logits_cut(params, cfg, tp):
        return tp.vocab_ce(logits, labels) + AUX_WEIGHT * aux
    lo = logits.float()
    mx = lo.amax(-1, keepdim=True).detach()
    lse = mx.squeeze(-1) + torch.log(torch.exp(lo - mx).sum(-1))
    label_logit = lo.gather(-1, labels[..., None]).squeeze(-1)
    ce = (lse - label_logit).mean()
    return ce + AUX_WEIGHT * aux


def loss_and_grads(cfg: M.ModelConfig, p: dict, tokens, img=None, tp=None,
                   route=None):
    """One node's (loss, gradients) on one (micro-)batch: ``p`` is the
    node's ``{name: tensor}`` slice, ``tokens`` (B, S) (audio: (B, S, K)),
    ``img`` the vlm family's (B, T, d) or None.  ``tp`` (a
    :class:`~repro_torch.launch.tp.TP`): ``p`` holds the rank's model
    shards, bound to the pass (``TP.bind``); the gradients are the
    shards'.  ``route``: :func:`train_loss_fn`'s."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    view = leaves
    if tp is not None:
        tp, view = tp.bind(leaves)
    loss = train_loss_fn(M.params_view(view), cfg, tokens, img, tp, route)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def accumulate_grads(acc_loss, acc_g: dict, loss, g: dict, nm: int):
    """One micro-batch of ``nm`` added into the f32 accumulators."""
    acc_g = {k: acc_g[k] + g[k].float() / nm for k in acc_g}
    return acc_loss + loss / nm, acc_g


def make_train_step(cfg: M.ModelConfig,
                    opt: optim_mod.DecentralizedOptimizer,
                    *, micro_batch: int | None = None, timeline=None,
                    fsdp=None, tp=None, route=None):
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
    events a pipelined step with a round in flight on the card's side
    stream (:func:`overlap_ms` reads them).  On a mesh the round's wire
    is posted before the gradients and completed after them; the mesh's
    wire log times it.

    ``fsdp``, a ``(mesh, specs)`` pair (a mesh whose fsdp extent is above
    1 and :func:`~repro_torch.launch.sharding.node_param_specs`), takes a
    rank's fsdp shards of its node's params and the rank's rows of the
    node's batch, and does what GSPMD inserts around the reference's
    step: the node's whole leaves gathered once a step
    (``sharding.fsdp_gather``, before the node loop and outside the
    micro-batches), the gradients taken on them, turned into the rank's
    shard of their mean over the fsdp line
    (``sharding.fsdp_reduce_scatter_mean``) before the update, and the
    node's loss the fsdp ``psum`` of the ranks' over F -- what the
    runtime gossip reads and the step returns, alike on every rank of a
    node.  The delayed round of an overlapped step is posted before the
    gather and waited for after the scatter.  These ops are recorded in
    the wire log's scope ``"fsdp"``.

    ``tp`` (a :class:`~repro_torch.launch.tp.TP` over a mesh whose model
    extent is above 1) runs each (micro-)batch's pass on the rank's
    model shards of the node's leaves -- after the fsdp gather when both
    are given -- with the batch replicated over the model line, as the
    reference's ``batch_spec`` says: a tensor-parallel forward and
    backward whose collectives are recorded in the scope ``"model"``,
    and gradients that are the rank's model shards.

    ``route`` (a :class:`~repro_torch.launch.moe_group.MoeGroup`, with
    ``fsdp``): the rank's rows are its share of one moe routing group
    spread over ``route.size`` fsdp ranks (a micro-batch, or the node's
    batch, larger than the rank's rows), so the pass routes them with the
    group (``models/moe.py``).  No loss is rescaled: the rank's pass is
    its share of the group's, each rank's loss holds the group's aux
    term, and the fsdp mean of the ranks' gradients is then the
    gradient of the mean over the node's micro-batches.
    """

    def per_node_grads(p: dict, tokens, img):
        if micro_batch is None or micro_batch >= tokens.shape[0]:
            return loss_and_grads(cfg, p, tokens, img, tp, route)
        nm = tokens.shape[0] // micro_batch

        def split(t):
            return (None if t is None
                    else t.reshape((nm, micro_batch) + t.shape[1:]))

        toks, imgs = split(tokens), split(img)
        acc_loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        acc_g = {k: torch.zeros(v.shape, dtype=torch.float32,
                                device=v.device) for k, v in p.items()}
        for m, tok in enumerate(toks):
            loss, g = loss_and_grads(cfg, p, tok,
                                     None if imgs is None else imgs[m], tp,
                                     route)
            acc_loss, acc_g = accumulate_grads(acc_loss, acc_g, loss, g, nm)
        return acc_loss, acc_g

    def node_loss(losses):
        if fsdp is None:
            return losses
        mesh = fsdp[0]
        with mesh.log.scope("fsdp"):
            return mesh.psum(losses.float(), "fsdp") / mesh.axis_size("fsdp")

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
        whole = params
        if fsdp is not None:
            with fsdp[0].log.scope("fsdp"):
                whole = sharding.fsdp_gather(params, fsdp[1], fsdp[0])
        losses, grads = [], None
        for i in range(n):
            loss, g = per_node_grads({k: v[i] for k, v in whole.items()},
                                     tokens[i],
                                     None if images is None else images[i])
            losses.append(loss)
            if n == 1:               # a rank's node: no copy
                grads = {k: v.unsqueeze(0) for k, v in g.items()}
                break
            if grads is None:        # written node by node, never stacked
                grads = {k: v.new_empty((n,) + tuple(v.shape))
                         for k, v in g.items()}
            for k, v in g.items():
                grads[k][i].copy_(v)
        del whole, g
        if fsdp is not None:
            with fsdp[0].log.scope("fsdp"):
                grads = sharding.fsdp_reduce_scatter_mean(grads, fsdp[1],
                                                          fsdp[0])
        losses = node_loss(torch.stack(losses))
        if marks and pending.begin is not None:   # a mesh's has none
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


def make_prefill_step(cfg: M.ModelConfig, *, tp=None, fsdp=None):
    """``prefill_step(params, batch)`` -> the last position's logits (B, V)
    (audio: (B, K, V)): the forward, without a gradient, over
    ``batch["tokens"]`` (and the vlm family's ``batch["image_embeds"]``),
    as the reference's serving prefill; its [attn + ffn] layers attend
    through the flash-attention kernel where ``cfg.attention_impl`` is
    ``"pallas"`` (the reference's forward reads it), through the plain
    attention otherwise.  ``params`` is a ``Model``, a
    :func:`~repro_torch.models.model.params_view`, or (with ``tp`` or
    ``fsdp``) a ``{name: tensor}`` dict.

    A replica's model-sharded prefill: a rank of a replica's ``fsdp x
    model`` ranks passes its ``(fsdp, model)`` shards of the params
    (``sharding.local_shard`` by ``param_specs(node_axis=False)`` at the
    global shapes) and its rows of the batch
    (``sharding.batch_block(node_axis=False)``).  ``fsdp``, a ``(mesh,
    specs)`` pair (a mesh whose fsdp extent is above 1 and those specs),
    gathers the shards over the fsdp line first -- one ``all_gather`` a
    dtype group (``sharding.fsdp_gather``), recorded in the wire log's
    scope ``"fsdp"``; ``tp`` (:meth:`TP.serving
    <repro_torch.launch.tp.TP.serving>` of the same specs, over a mesh
    whose model extent is above 1) binds the model shards and runs the
    tensor-parallel forward (collectives in the scope ``"model"``).  The
    logits are then the rank's block of the vocabulary where the head
    cuts it (``models.model.logits_cut``), else whole."""
    kernel = cfg.attention_impl == "pallas"

    def prefill_step(params, batch):
        with torch.no_grad():
            params, bound = _serving_view(params, tp, fsdp)
            logits, _ = M.forward(params, cfg, batch["tokens"],
                                  image_embeds=batch.get("image_embeds"),
                                  tp=bound, attn_kernel=kernel)
        return logits[:, -1]
    return prefill_step


def _serving_view(params, tp, fsdp, keep: tuple = ()):
    """(the params a serving step's model reads, the bound TP or None):
    ``fsdp``'s gather of a rank's serving shards, then ``tp.bind``
    (``keep``: leaves the pass cuts by hand beside ``tp.HANDLED``)."""
    if fsdp is not None:
        # a replica's leaves as a node row (a leading axis of 1, which the
        # packed gather reads), then back
        mesh, specs = fsdp
        with mesh.log.scope("fsdp"):
            row = sharding.fsdp_gather(
                {k: v[None] for k, v in params.items()},
                {k: (None,) + tuple(s) for k, s in specs.items()}, mesh)
        params = {k: v[0] for k, v in row.items()}
    bound = None
    if tp is not None:
        bound, params = tp.bind(params, keep)
    if isinstance(params, dict):
        params = M.params_view(params)
    return params, bound


def make_serve_step(cfg: M.ModelConfig, *, tp=None, fsdp=None):
    """``serve_step(params, cache, batch)`` -> (logits, cache): one
    ``decode_step`` of ``batch["token"]`` at position ``batch["idx"]`` (a
    Python int), without a gradient; the cache is updated in place and
    returned.  ``params`` as :func:`make_prefill_step`'s.

    A replica's model-sharded decode: a rank passes its ``(fsdp, model)``
    shards of the serving params, its rows of the batch
    (``sharding.batch_block(node_axis=False)``) and its block of the
    cache, ``sharding.local_shard(cache, sharding.cache_specs(cache, mesh,
    B), mesh)`` of the global cache of B rows.  ``fsdp`` gathers the
    shards over the fsdp line on every call, as :func:`make_prefill_step`
    does; ``tp`` binds the model shards (mamba2's ``conv_w`` and
    ``conv_b`` kept cut, the conv's channel block) and runs
    ``decode_step(tp=)``, the collectives in the scope ``"model"``.  The
    cache shard is never gathered; the logits are the rank's block of the
    vocabulary where the head cuts it."""
    def serve_step(params, cache, batch):
        with torch.no_grad():
            params, bound = _serving_view(params, tp, fsdp,
                                          ("conv_w", "conv_b"))
            return M.decode_step(params, cfg, batch["token"], cache,
                                 batch["idx"],
                                 image_embeds=batch.get("image_embeds"),
                                 tp=bound)
    return serve_step
