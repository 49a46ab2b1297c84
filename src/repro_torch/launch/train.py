"""End-to-end decentralized training driver.

The port of the JAX package's ``launch/train.py``: DmSGD (or a variant:
dsgd, vanilla_dmsgd, qg_dmsgd, parallel_msgd, d_adamw) over any topology
(aperiodic ones too: random_match), for every family of the reference
(dense, moe, ssm, hybrid, vlm, audio), with the n nodes stacked on the
leading axis of every tensor on one device.  Runs on the card by default
(``--device cuda`` raises without one); ``--device cpu`` runs the plain
PyTorch path.  As in the reference, the CLI trains the REDUCED config
unless ``--full``; ``--layers N`` cuts the depth (full width, N layers).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --nodes 8 --steps 12
  PYTHONPATH=src python -m repro_torch.launch.train --full --layers 8 \\
      --nodes 4 --batch 2 --seq 128 --steps 6 --hetero 0.5
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch mamba2-1.3b --optimizer d_adamw --topology random_match \\
      --nodes 4 --steps 6 --ckpt-dir /tmp/ck --ckpt-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --nodes 8 --steps 12 --loss-aware --deadline-skip \\
      --straggler-prob 0.25
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --nodes 4 --steps 6 --overlap --compression int8 \\
      --ckpt-dir /tmp/ck --ckpt-every 2 [--ckpt-flush]

Every step's batch is sampled before the loop (``SyntheticLM.sample`` is
host work that grows with the vocabulary), and each step is timed on the
host clock up to a device synchronisation.  The audio family's batch
holds ``n_codebooks`` token streams (n, B, S, K), as the reference's; the
vlm family's also holds ``image_embeds`` (n, B, n_image_tokens, d_model),
standard normal f32 drawn on ``--device`` from a ``torch.Generator``
seeded from (``--seed``, step) -- the reference draws them from
``jax.random.key(step)``, a stream torch cannot reproduce, so parity
tests put the same images in both batches.  ``--ckpt-dir`` saves
``{"params", "momentum"}`` every ``--ckpt-every`` steps after step 0, in
the JAX driver's format and layout (:mod:`repro_torch.checkpoint`).
``--loss-aware`` binds AL-DSGD weights and ``--deadline-skip`` per-node
straggler gating; ``--straggler-prob p`` simulates the stragglers: node i
misses step k's deadline when ``np.random.default_rng(2**20 +
k).random(n)[i] < p``.  The reference draws the same flags from
``jax.random.uniform(jax.random.key(2**20 + k), (n,))``, a stream torch
cannot reproduce, so the two drivers drop different nodes; parity tests
put the same ``alive`` in both batches.

``run(args, mesh=mesh)`` trains on a live
:class:`~repro_torch.launch.mesh.Mesh` whose ``"node"`` axis has one
coordinate per node -- ``("node",)``, ``("node", "fsdp")`` or ``("node",
"fsdp", "model")``; every rank calls ``run`` with
the same ``args``: each rank trains its own node -- its row of the
params and batches, which ``prepare(args, node=i)`` builds without
keeping any other node's, so the step's node loop runs once -- and the
gossip runs shard-natively over the mesh's wire.  With an fsdp extent F
above 1 a rank keeps only its fsdp shard of each of its node's leaves
(``prepare(args, node=i, fsdp=f, mesh=mesh)``, cut by
``sharding.node_param_specs``) and its rows of the node's batch (split
over fsdp where F divides the batch, as ``sharding.batch_spec`` says).
The moe family's capacity dispatch and aux loss couple every token of a
routing group -- a micro-batch, or the node's batch without
micro-batches -- which the reference's GSPMD keeps global; its rows are
split where a rank's micro-batches are whole groups (G = 1: the rank
routes them alone) or a group spans G consecutive ranks whole (G > 1:
the routing is made global over them, ``launch.moe_group``), and stay
whole on every rank otherwise (:func:`routing_group`).  Each step
gathers the node's whole leaves, takes the gradients on the rank's rows
and reduce-scatters their mean over the node's F ranks
(``steps.make_train_step(fsdp=)``), and the gossip moves each rank's
shard.  With a model extent M above 1 a rank keeps its
(fsdp, model) shard of each leaf, as the reference's rules cut it
(``prepare(args, node=i, mesh=mesh)``), takes the node's batch rows
replicated over its model line, and runs a tensor-parallel forward and
backward on its model shards (``steps.make_train_step(tp=)``,
:mod:`repro_torch.launch.tp`) after the fsdp gather; a mesh with fsdp 1
runs no fsdp op.
The logged loss and consensus are reduced across the ranks, so rank 0
(the only one that prints) prints what the single-process run prints;
the mesh's wire log records that logging (and the flush it reads under
``--overlap``) in the scope ``"log"``, the final flush in ``"flush"``
and checkpoints in ``"ckpt"``, apart from the steps' own ops, and each
history entry carries the logging's seconds (``log_s``) apart from the
step's.  Every flag runs on such a mesh: ``--overlap`` posts each delayed
round's wire before the rank's gradients and completes it after them
(``gossip.delayed_post``), ``parallel_msgd`` averages the gradients with
one ``psum`` per dtype group, and ``--ckpt-dir`` gathers the node rows at
rank 0, which writes the whole run's checkpoint (the single-process
run's arrays) while the others wait; on an fsdp or model mesh each
leaf is first gathered over fsdp, then over model (under ``--overlap``
the in-flight buffer too, unpacked, gathered and converted node by
node), and only the line at (fsdp 0, model 0) writes.

``--overlap`` trains the one-step-delayed pipeline (each step mixes the
previous step's payload, on the card on a side stream under the
backward); the logged consensus reads the flushed view, and the run ends
with a flush.  Its checkpoints carry the in-flight buffer as
``gossip_buf`` (in the reference's packing: ``convert.gossip_buf_to_jax``),
so a resume is bit-identical, or with ``--ckpt-flush`` hold the flushed
iterates and no buffer.  ``--compression int8`` sends the gossip payload
as int8 (a flag the JAX driver lacks; its optimizers take it).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from .. import checkpoint, configs
from ..convert import gossip_buf_to_jax, train_state_to_jax
from ..core import flatbuf
from ..core import optim as optim_mod
from ..core import schedule
from ..core import topology as topo_mod
from ..core import transforms
from ..core.plan import GossipPlan
from ..data import SyntheticLM
from ..device import resolve_device
from ..models import model as M
from . import sharding
from . import steps as steps_mod
from .moe_group import MoeGroup
from .tp import TP

__all__ = ["build_trainer", "consensus_distance", "stack_nodes",
           "image_embeds", "prepare", "run", "parse_args", "main",
           "check_mesh", "config_of", "fsdp_extent", "model_extent",
           "is_sharded", "rows_over_fsdp", "routing_group"]


def check_mesh(mesh, n: int) -> None:
    """Refuse a mesh training cannot run on: it must have a ``node`` axis
    of ``n`` ranks, and no axis but ``node``, ``fsdp`` and ``model``
    above 1."""
    if "node" not in mesh.axis_names or mesh.axis_size("node") != n:
        raise ValueError(f"training {n} nodes needs a mesh with a 'node' "
                         f"axis of {n}; got {mesh.shape}")
    other = {a: s for a, s in mesh.shape.items()
             if a not in ("node", "fsdp", "model") and s > 1}
    if other:
        raise ValueError(f"training on a mesh with {other}: the axes are "
                         "node, fsdp and model")


def fsdp_extent(mesh) -> int:
    """The mesh's fsdp extent (1 without a mesh or an fsdp axis)."""
    return 1 if mesh is None else mesh.shape.get("fsdp", 1)


def model_extent(mesh) -> int:
    """The mesh's model extent (1 without a mesh or a model axis)."""
    return 1 if mesh is None else mesh.shape.get("model", 1)


def is_sharded(mesh) -> bool:
    """Whether a rank of ``mesh`` holds shards of its node's leaves (an
    fsdp or model extent above 1)."""
    return fsdp_extent(mesh) > 1 or model_extent(mesh) > 1


def routing_group(mesh, batch: int, micro_batch: int | None = None):
    """How many fsdp ranks share one moe routing group when a node's
    ``batch`` rows are split over the mesh's fsdp extent F: a group is a
    micro-batch of ``mb`` rows (the node's batch where ``micro_batch`` is
    None or not below it), a rank's rows the contiguous block R = batch /
    F.  1 where mb divides R (the rank's micro-batches are whole groups
    of the node's, in the node's order), mb / R where R divides mb (a
    group spans that many consecutive ranks), None where neither."""
    rows = batch // fsdp_extent(mesh)
    mb = batch if micro_batch is None or micro_batch >= batch \
        else micro_batch
    if rows % mb == 0:
        return 1
    if mb % rows == 0:
        return mb // rows
    return None


def rows_over_fsdp(cfg, mesh, batch: int,
                   micro_batch: int | None = None) -> bool:
    """Whether a node's batch rows are split over fsdp: where
    ``sharding.batch_spec`` splits them, except, for the moe family, where
    a routing group neither holds a rank's rows whole nor lies whole
    within them (:func:`routing_group` None: a group would then take
    part of a rank's rows, and the rows stay whole on every rank, with
    the same numbers)."""
    spec = sharding.batch_spec(mesh, node_axis=True, batch_dim_size=batch)
    return spec[1] == "fsdp" and (
        not cfg.n_experts
        or routing_group(mesh, batch, micro_batch) is not None)


def build_trainer(cfg, topology, optimizer_name: str, beta: float,
                  micro_batch=None, momentum_dtype=None, warmup_steps=0,
                  overlap=False, loss_aware=False, deadline=False,
                  compression=None, timeline=None, mesh=None, batch=None):
    """Returns (opt, step_for) where ``step_for(step, prime=False)`` is the
    train-step executable for that step's gossip realization (the plan
    rides along as ``step_for.plan``).  All schedule handling lives in
    :class:`repro_torch.core.plan.GossipPlan`; this is optimizer + step
    function + plan wiring.  ``warmup_steps`` wraps the optimizer in
    ``transforms.allreduce_warmup`` before the plan is built, as the
    reference does, so the warm-up phase is its own plan key.
    ``loss_aware`` / ``deadline`` bind the
    runtime gossip hooks (the step then reads ``batch["alive"]``);
    ``overlap`` builds the pipelined trainer (``timeline``: see
    :func:`~repro_torch.launch.steps.make_train_step`),
    ``compression="int8"`` the int8 wire.  ``mesh`` (one node
    coordinate a node, :func:`check_mesh`) runs every gossip round
    shard-natively, the step taking each rank's block; with an fsdp
    extent above 1 the step gathers and reduce-scatters by
    ``sharding.node_param_specs(cfg, topology.n, mesh)``, and with a
    model extent above 1 it runs the tensor-parallel pass by them
    (``launch.tp.TP``).  ``batch``, a node's rows (needed for the moe
    family on an fsdp mesh): where they split over fsdp and a routing
    group spans G > 1 ranks (:func:`routing_group`), the step routes
    the experts over the group (``launch.moe_group.MoeGroup``).  They
    ride along as ``step_for.fsdp`` (``(mesh, specs)``, else None),
    ``step_for.tp`` (the ``TP``, else None), ``step_for.route`` (the
    ``MoeGroup``, else None) and ``step_for.specs`` (the specs on either
    mesh, else None)."""
    fsdp = tp = specs = route = None
    if mesh is not None:
        check_mesh(mesh, topology.n)
        if is_sharded(mesh):
            specs = sharding.node_param_specs(cfg, topology.n, mesh)
        if fsdp_extent(mesh) > 1:
            fsdp = (mesh, specs)
            if cfg.n_experts:
                if batch is None:
                    raise ValueError("the moe family on an fsdp mesh: give "
                                     "batch= (a node's rows), which sets "
                                     "its routing group")
                if rows_over_fsdp(cfg, mesh, batch, micro_batch):
                    size = routing_group(mesh, batch, micro_batch)
                    if size > 1:
                        route = MoeGroup(mesh, size)
        if model_extent(mesh) > 1:
            tp = TP(mesh, specs)
    opt = optim_mod.make_optimizer(optimizer_name, topology, beta=beta,
                                   momentum_dtype=momentum_dtype,
                                   compression=compression, overlap=overlap,
                                   loss_aware=loss_aware, deadline=deadline)
    if warmup_steps:
        opt = transforms.allreduce_warmup(warmup_steps)(opt)
    step_fn = steps_mod.make_train_step(cfg, opt, micro_batch=micro_batch,
                                        timeline=timeline, fsdp=fsdp, tp=tp,
                                        route=route)
    plan = GossipPlan.for_optimizer(opt, fn=step_fn, mesh=mesh)

    def step_for(step, **kw):
        return plan.step_fn(step, **kw)

    step_for.plan = plan
    step_for.fsdp = fsdp
    step_for.tp = tp
    step_for.route = route
    step_for.specs = specs
    return opt, step_for


def _sq_dist(params, mesh):
    """sum ||x_i - x_bar||^2 of this process's rows (a device scalar)."""
    _, bufs = flatbuf.pack(params)
    total = torch.zeros((), dtype=torch.float32, device=bufs[0].device)
    for buf in bufs:
        b32 = buf.float()
        if mesh is None:
            mean = b32.mean(0, keepdim=True)
        else:
            mean = mesh.psum(b32, "node") / mesh.axis_size("node")
        total += torch.sum(torch.square(b32 - mean))
    return total


def consensus_distance(params, mesh=None, specs=None) -> float:
    """||x_i - x_bar|| aggregated over the tree (the paper's consensus
    metric): one reduction over the packed flat buffers and a single host
    sync (padding columns are zeros on every node, so they add 0).  On a
    mesh each rank holds its node's block: the mean is a ``psum`` over
    the node axis, and so is the sum of squares.  With ``specs``
    (``build_trainer``'s, on an fsdp or model mesh) each element counts
    once: the sums are added over the fsdp and model lines too, and a
    leaf replicated over one of them is counted at its coordinate 0
    only."""
    if mesh is None or specs is None:
        total = _sq_dist(params, mesh)
    else:
        inner = [a for a in ("fsdp", "model") if mesh.shape.get(a, 1) > 1]
        mine = {k: v for k, v in params.items() if all(
            sharding.axis_dim(specs[k], a) is not None
            or mesh.axis_index(a) == 0 for a in inner)}
        total = (_sq_dist(mine, mesh) if mine else
                 torch.zeros((), dtype=torch.float32,
                             device=next(iter(params.values())).device))
        for a in inner:
            total = mesh.psum(total.reshape(1), a)[0]
    if mesh is not None:
        total = mesh.psum(total.reshape(1), "node")[0]
    return float(torch.sqrt(total))


def stack_nodes(params: M.Model, n: int) -> dict:
    """The node-stacked params tree: every parameter broadcast to a leading
    node axis of size ``n``, as views (no copy; the optimizer never writes
    in place, and its first step allocates the nodes' own tensors)."""
    return {k: p.detach().expand((n,) + tuple(p.shape))
            for k, p in params.named_parameters()}


def image_embeds(seed: int, step: int, shape, device) -> torch.Tensor:
    """Step ``step``'s stand-in image embeddings: standard normal f32 of
    ``shape`` from a ``torch.Generator`` on ``device`` seeded from
    (``seed``, ``step``)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1)[0]
    gen = torch.Generator(device=device).manual_seed(int(state))
    return torch.randn(shape, generator=gen, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _scope(mesh, name: str):
    """The mesh's wire log scope ``name`` (nothing without a mesh)."""
    return contextlib.nullcontext() if mesh is None else mesh.log.scope(name)


def _save(ckpt_dir: str, step: int, payload: dict, mesh) -> None:
    """``checkpoint.save`` of the train state ``payload`` (the reference's
    layout).  On a mesh each rank holds its node's rows (whole leaves,
    :func:`_whole_state`): every leaf is gathered at the line's node-0
    rank (on the host over gloo), which writes the whole run's
    checkpoint, and the line waits for it."""
    if mesh is None:
        checkpoint.save(ckpt_dir, step, payload)
        return
    host = mesh.backend == "gloo"
    full = checkpoint.map_leaves(
        lambda x: mesh.gather(x.cpu() if host else x, "node"), payload)
    if mesh.axis_index("node") == 0:
        checkpoint.save(ckpt_dir, step, full)
    del full
    mesh.barrier("node")


def _specs_like(tree, specs):
    """``specs`` (a params tree's) repeated over ``tree``'s structure: a
    params-shaped dict, a dict of them (d_adamw's ``{"mu", "nu"}``) or a
    tuple of them (a gossip payload)."""
    if isinstance(tree, dict):
        if all(isinstance(v, torch.Tensor) for v in tree.values()):
            return {k: specs[k] for k in tree}
        return {k: _specs_like(v, specs) for k, v in tree.items()}
    return type(tree)(_specs_like(v, specs) for v in tree)


def _whole_state(params, state, opt, cfg, mesh, specs) -> dict | None:
    """The train state ``checkpoint.save`` takes, in the reference's
    layout, of the rank's node (its whole leaves, gathered over the fsdp
    line, then the model line, by ``specs`` where they are given):
    params, momentum and, under ``--overlap``, the in-flight buffer as the
    reference packs it.  On a mesh the rank's own block is packed at its
    own layout (``pad_multiple=1``); the reference's packing of the whole
    payload is the blocks' rows stacked.  On an fsdp or model mesh the
    leaves are gathered at (fsdp 0, model 0) alone, whose line writes:
    None at the others."""
    momentum = state.momentum
    template = (None if state.buf is None
                else opt.payload_template(params, state))
    buf = None if state.buf is None else list(state.buf)
    pad = flatbuf.PAD_MULTIPLE if mesh is None else 1
    if specs is not None:
        if buf is not None:
            template = flatbuf.unpack(flatbuf.layout_of(template, pad), buf)

        def gather(tree, axis):
            return sharding.gather_axis(tree, _specs_like(tree, specs), mesh,
                                        axis, dst=0)

        for axis in ("fsdp", "model"):
            if mesh.shape.get(axis, 1) == 1:
                continue
            params, momentum = gather(params, axis), gather(momentum, axis)
            if template is not None:
                template = gather(template, axis)
            if mesh.axis_index(axis) != 0:
                return None      # the model gather runs at fsdp 0 alone
        if buf is not None:
            buf = flatbuf.pack(template, flatbuf.layout_of(template, pad))[1]
    payload = train_state_to_jax(params, momentum, cfg)
    if buf is not None:
        payload["gossip_buf"] = gossip_buf_to_jax(buf, template, cfg,
                                                  pad_multiple=pad)
    return payload


def config_of(args):
    """The model config ``args`` trains: ``--arch``, reduced unless
    ``--full``, its depth cut to ``--layers``."""
    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = configs.reduced_config(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def prepare(args, tokens=None, node: int | None = None,
            fsdp: int | None = None, mesh=None, model: int | None = None,
            config=None) -> dict:
    """What a run of ``args`` starts from, built as :func:`run` builds it:
    the config, the topology, the momentum dtype, the node-stacked
    initial params, every step's batch and the learning-rate schedule.
    References held against a run (the sequential delayed recursion of
    ``--overlap``) start from the same.  ``tokens`` is every step's token
    array as an earlier ``prepare(args)`` sampled them (the host sampling
    grows with the vocabulary: a world of ranks samples once).  ``node``
    keeps only that node's row of the params and of every per-node batch
    entry (a node axis of 1, the values the whole run gives it): a rank
    of a mesh then holds its own node and no other's.  ``fsdp`` and
    ``model``, the rank's coordinates on ``mesh`` (a mesh, live or
    abstract, whose fsdp or model extent is above 1; they default to a
    live mesh's own), keep only the rank's (fsdp, model) shard of each
    leaf, cloned (cut by ``sharding.node_param_specs``, read at the
    global shapes), and its rows of every batch entry but ``alive``
    where they split over fsdp (the module docstring); the rows are
    replicated over model.  ``--desync``'s noise is drawn on the whole
    stacked leaf, leaf by leaf, and cut at once: the values are the
    single-process run's, and no more than one whole stacked leaf is
    held at a time.  ``config``: the config to train in place of
    ``config_of(args)`` (the same widths, say, with fewer experts); the
    shards are cut by its specs."""
    if args.straggler_prob and not args.deadline_skip:
        raise ValueError("--straggler-prob simulates missed deadlines; "
                         "pair it with --deadline-skip")
    device = resolve_device(args.device)
    cfg = config_of(args) if config is None else config
    n = args.nodes
    # momentum dtype comes from the arch's layout config (an explicit
    # argument, not a process-global knob)
    layout = configs.get_layout(args.arch)
    mom_dtype = {"bfloat16": torch.bfloat16,
                 "float32": torch.float32}.get(layout.get("momentum_dtype"))

    shards = is_sharded(mesh)
    if shards:
        if node is None:
            raise ValueError("fsdp and model shards are a rank's: give its "
                             "node too")
        at = {a: 0 for a in mesh.axis_names}
        for axis, given in (("fsdp", fsdp), ("model", model)):
            if mesh.shape.get(axis, 1) > 1:
                at[axis] = mesh.axis_index(axis) if given is None else given
        fsdp = at["fsdp"] if fsdp_extent(mesh) > 1 else None
        model = at["model"] if model_extent(mesh) > 1 else None
        cut = sharding.inner_only(sharding.node_param_specs(cfg, n, mesh))
    else:
        fsdp = model = None

    def own(k, v):
        """The rank's part of a stacked leaf: its node row, its shard."""
        if node is None:
            return v
        v = v[node:node + 1]
        if shards:
            v = sharding.local_shard({k: v}, {k: cut[k]}, mesh, at)[k]
        return v.clone()

    params = M.init(cfg, args.seed, device=device)
    stacked = stack_nodes(params, n)
    if args.optimizer != "parallel_msgd" and args.desync:
        # start nodes desynchronized to exercise consensus (a torch
        # Generator: not the reference's jax.random noise); leaf by leaf,
        # so a node's row is cut before the next leaf's noise is drawn
        gen = torch.Generator(device=device).manual_seed(1)
        noisy = {}
        for k, p in stacked.items():
            v = p + (0.01 * torch.randn(p.shape, generator=gen,
                                        device=device)).to(p.dtype)
            noisy[k] = own(k, v)
            del v
        stacked = noisy
    elif node is not None:
        stacked = {k: own(k, p) for k, p in stacked.items()}
    del params

    lr_fn = schedule.warmup_step_decay(
        args.lr, args.warmup, [int(args.steps * 0.6), int(args.steps * 0.85)])
    if tokens is None:
        data = SyntheticLM(cfg.vocab_size, n, hetero=args.hetero,
                           seed=args.seed)
        n_codebooks = cfg.n_codebooks if cfg.family == "audio" else 0
        tokens = [data.sample(step, args.batch, args.seq, n_codebooks)
                  for step in range(args.steps)]
    batches = [{"tokens": torch.as_tensor(t)} for t in tokens]
    if cfg.family == "vlm":
        for step, batch in enumerate(batches):
            batch["image_embeds"] = image_embeds(
                args.seed, step, (n, args.batch, cfg.n_image_tokens,
                                  cfg.d_model), device)
    if args.deadline_skip:
        # simulated stragglers: each node misses the round's deadline with
        # probability p; the gossip drops it per node (both directions)
        for step, batch in enumerate(batches):
            batch["alive"] = torch.from_numpy(
                np.random.default_rng(2**20 + step).random(n)
                >= args.straggler_prob)
    if node is not None:
        split = fsdp is not None and rows_over_fsdp(cfg, mesh, args.batch,
                                                    args.micro_batch)
        per = args.batch // mesh.axis_size("fsdp") if split else None

        def mine(k, v):
            v = v[node:node + 1]
            if split and k != "alive":
                v = v[:, fsdp * per:(fsdp + 1) * per]
            return v.clone()

        batches = [{k: mine(k, v) for k, v in b.items()} for b in batches]
    return {"device": device, "config": cfg,
            "topology": topo_mod.get_topology(args.topology, n),
            "momentum_dtype": mom_dtype, "params": stacked,
            "batches": batches, "lr_fn": lr_fn, "node": node,
            "fsdp": fsdp, "model": model}


def run(args, timeline=None, mesh=None, start=None) -> dict:
    """Train per ``args`` (the CLI's namespace).  Returns the history (one
    entry per logged step: step, loss, consensus, lr, step_s, and log_s,
    the seconds of the logging after the step), every
    step's seconds, the final params and state (flushed under
    ``--overlap``), the config, the plan and the per-step ``alive`` flags
    (None without ``--deadline-skip``).  ``timeline`` (a list) collects
    the pipelined steps' CUDA events (``steps.make_train_step``).  On a
    ``mesh`` (module docstring) the params and state are this rank's
    node's, and the history's loss and consensus the whole run's.
    ``start`` is what :func:`prepare` returns, for a caller that changes
    it first (another activation dtype, say); by default ``prepare(args)``
    (on a mesh ``prepare(args, node=i, mesh=mesh)``, the rank's node
    ``i`` and, on an fsdp or model mesh, its shard)."""
    at = {"node": None, "fsdp": None, "model": None}
    loud = True
    if mesh is not None:
        check_mesh(mesh, args.nodes)
        loud = mesh.rank == 0
        for axis in at:
            if axis == "node" or mesh.shape.get(axis, 1) > 1:
                at[axis] = mesh.axis_index(axis)
    start = (prepare(args, node=at["node"], mesh=mesh) if start is None
             else start)
    got = {axis: start.get(axis) for axis in at}
    if got != at:
        raise ValueError(
            "a start prepared for " + ", ".join(f"{a} {v}" for a, v in
                                                 got.items())
            + " on a rank that trains " + ", ".join(f"{a} {v}" for a, v in
                                                     at.items()))
    device, cfg = start["device"], start["config"]
    stacked, batches, lr_fn = (start["params"], start["batches"],
                               start["lr_fn"])
    opt, step_for = build_trainer(cfg, start["topology"], args.optimizer,
                                  args.beta, args.micro_batch,
                                  momentum_dtype=start["momentum_dtype"],
                                  overlap=args.overlap,
                                  loss_aware=args.loss_aware,
                                  deadline=args.deadline_skip,
                                  compression=args.compression,
                                  timeline=timeline, mesh=mesh,
                                  batch=args.batch)
    plan = step_for.plan
    specs = step_for.specs
    state = opt.init(stacked)

    history, step_s = [], []
    t0 = time.perf_counter()
    for step in range(args.steps):
        lr = lr_fn(step)
        t = time.perf_counter()
        stacked, state, loss = step_for(step)(stacked, state,
                                              batches[step], lr)
        _sync(device)
        step_s.append(time.perf_counter() - t)
        if step % args.log_every == 0 or step == args.steps - 1:
            t = time.perf_counter()
            with _scope(mesh, "log"):
                # the flushed view (pure; dropped at once: under --overlap
                # it is a payload-sized buffer of its own, and on a mesh
                # one more payload-sized permute)
                cd = consensus_distance(
                    plan.flush_step_fn(step + 1)(stacked, state)[0], mesh,
                    specs)
                if mesh is not None:   # the node mean of the nodes' losses
                    loss = mesh.psum(loss.reshape(1).float(), "node")[0] \
                        / args.nodes
                loss = float(loss)
            history.append(dict(step=step, loss=loss, consensus=cd,
                                lr=lr, step_s=step_s[-1],
                                log_s=time.perf_counter() - t))
            if loud:
                print(f"step {step:5d}  loss {loss:.4f}  "
                      f"consensus {cd:.3e}  lr {lr:.2e}  "
                      f"step {1e3 * step_s[-1]:.1f} ms  "
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)
        if args.ckpt_dir and step and step % args.ckpt_every == 0:
            with _scope(mesh, "ckpt"):
                if args.overlap and args.ckpt_flush:
                    # flush-on-save: the mixed iterates, no buffer; a
                    # resume re-primes (step_for(k, prime=True))
                    fp, fs = plan.flush_step_fn(step + 1)(stacked, state)
                    payload = _whole_state(fp, fs._replace(buf=None), opt,
                                           cfg, mesh, specs)
                    del fp, fs
                else:
                    # carry-buffer: the in-flight payload is saved with the
                    # state, so a resume is bit-identical to never stopping
                    payload = _whole_state(stacked, state, opt, cfg, mesh,
                                           specs)
                if payload is not None:
                    _save(args.ckpt_dir, step, payload, mesh)
                del payload
    if args.overlap:
        with _scope(mesh, "flush"):
            stacked, state = plan.flush_step_fn(args.steps)(stacked, state)
    alive = ([b["alive"].tolist() for b in batches] if args.deadline_skip
             else None)
    return {"history": history, "step_s": step_s, "params": stacked,
            "state": state, "config": cfg, "plan": plan, "alive": alive}


def parse_args(argv=None) -> argparse.Namespace:
    """The CLI's flags (the JAX driver's, plus ``--layers``,
    ``--compression`` and ``--device``) parsed into the namespace
    :func:`run` takes."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (widths unchanged)")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--topology", default="one_peer_exp",
                    choices=sorted(topo_mod.TOPOLOGIES),
                    help="gossip graph; base_k/ceca are the finite-time "
                         "families (Takezawa 23 / cf. Ding 23)")
    ap.add_argument("--optimizer", default="dmsgd")
    ap.add_argument("--overlap", action="store_true",
                    help="one-step-delayed (overlapped) gossip: step t's "
                         "payload is mixed at step t+1, on the card on a "
                         "side stream under that step's backward")
    ap.add_argument("--ckpt-flush", action="store_true",
                    help="with --overlap: save the flushed iterates and no "
                         "in-flight buffer (a resume re-primes) instead of "
                         "carrying the buffer (a bit-identical resume)")
    ap.add_argument("--compression", default=None, choices=["int8"],
                    help="int8 gossip payloads on the wire (one f32 scale "
                         "per node and JAX leaf)")
    ap.add_argument("--loss-aware", action="store_true",
                    help="AL-DSGD adjacent-leader weights: pull harder from "
                         "better-loss neighbours; the per-node losses ride "
                         "the gossip's gather")
    ap.add_argument("--deadline-skip", action="store_true",
                    help="per-node straggler tolerance: nodes whose alive "
                         "flag is False drop out of the round (dropped "
                         "edges' mass returns to the self weight)")
    ap.add_argument("--straggler-prob", type=float, default=0.0,
                    help="per-step probability each node misses the gossip "
                         "deadline (simulated; needs --deadline-skip)")
    ap.add_argument("--beta", type=float, default=0.9)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4, help="per-node batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--hetero", type=float, default=0.0)
    ap.add_argument("--micro-batch", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--desync", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    out = run(args)
    where = (torch.cuda.get_device_name(0) if torch.device(args.device).type
             == "cuda" else "cpu")
    print(f"arch={out['config'].name} ({out['config'].n_layers} layers) on "
          f"{where}: {args.nodes} nodes, {args.topology}, {args.optimizer}; "
          f"{out['plan'].num_compiled} executables for " + (
              f"{period} gossip realizations" if (
                  period := out["plan"].topology.period)
              else "an aperiodic gossip schedule"))


if __name__ == "__main__":
    main()
