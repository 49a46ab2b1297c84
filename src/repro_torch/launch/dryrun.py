"""Multi-pod dry run: count the step of every (arch x input shape x mesh)
combination at production shardings, per chip, and write the roofline
terms to JSON.  The port of the JAX package's ``launch/dryrun.py``.

The reference lowers and compiles each step for 256 or 512 host devices
and reads ``memory_analysis()`` and the partitioned HLO.  The port
compiles nothing: every parameter, optimizer state, cache and batch is a
tensor on the ``meta`` device (shapes and dtypes, nothing allocated on
any device), the step runs on them under
:class:`repro_torch.launch.cost.Cost`, and each record is the view of
rank 0 of the logical mesh (``to_logical_mesh(make_production_mesh())``,
``("node", "fsdp", "model")``), with every spec from
:mod:`repro_torch.launch.sharding`:

* ``memory_analysis``: ``argument_bytes`` exactly, the bytes of rank 0's
  block of each argument under its spec (``sharding.local_shard``):
  params, momentum (the layout's ``momentum_dtype``) and batch for
  training; params, cache and token for decode.  ``output_bytes`` and
  ``alias_bytes`` follow the reference's donation (params and state for
  training, the cache for decode).  ``temp_bytes`` is the counted step's
  ``peak_bytes`` (a serving step's gathered leaves among them); ``fits``
  compares argument plus temp bytes with ``HW["hbm_bytes"]``.
* **training** (``train_4k``): rank 0's real step, on meta, over the
  dry mesh (``dry_mesh(...)``: the real collectives on a wire that moves
  nothing, each logged with the bytes rank 0 would send): the fsdp
  gather of its block (``sharding.fsdp_gather``), the tensor-parallel
  gradient pass on its model shards (``steps.loss_and_grads(tp=)``,
  :mod:`repro_torch.launch.tp`) over its rows of the node's ``global_batch
  / nodes`` sequences (split over fsdp as ``launch.train`` splits them,
  the moe family's too where ``launch.train.rows_over_fsdp`` lets it: a
  routing group that spans G > 1 ranks -- a ``--knob micro=`` above a
  rank's rows -- routes over the dry mesh, its collectives counted in
  the pass, :mod:`repro_torch.launch.moe_group`) in micro-batches of the
  layout's ``micro`` -- one micro-batch counted, its ops and collectives
  taken once per micro-batch, as the reference multiplies a scan body by
  its trip count -- the gradients' reduce-scatter
  (``sharding.fsdp_reduce_scatter_mean``), then the
  update and the gossip: ``opt.update_with_mix`` on rank 0's block
  through ``GossipPlan(mesh=dry_mesh(...))``, the real shard-native
  engine, K1 recorded by its formula.  Every term is counted per chip,
  the collectives inside a replica among them.  The record keeps the
  reference's ``gossip_ir`` and adds ``wire_bytes_per_rank`` from the
  dry mesh's log.
* **prefill** (``prefill_32k``): rank 0's real step over the dry mesh,
  as the reference's GSPMD partitions the serving step on one replica
  (the ``fsdp x model`` chips of a node): the fsdp gather of its block
  of the serving params (``param_specs(node_axis=False)``), then the
  tensor-parallel forward on its model shards
  (``steps.make_prefill_step(tp=, fsdp=)``, the experts dropless) over
  its rows of the batch (``sharding.batch_block``: over ``(node,
  fsdp)`` where that divides it), the collectives inside the replica
  counted (``"wire"``: rank 0's ops and bytes by scope).
  ``temp_bytes`` is the gathered leaves plus the pass's peak,
  ``output_bytes`` the rank's block of the last logits, ``rank_rows``
  its rows.
* **decode** (``decode_32k``, ``long_500k``): rank 0's real step over
  the dry mesh, as the prefill's: the fsdp gather of its block of the
  serving params, then the tensor-parallel one-token decode
  (``steps.make_serve_step(tp=, fsdp=)``) over its rows on its shard of
  the cache as ``sharding.cache_specs`` cuts it (batch over ``(node,
  fsdp)``, then the kv heads or the SSM state's heads over ``model``,
  the head dim or the conv's packed channels where those do not
  divide), written in place -- the head-dim cut's psum of the partial
  logits, the gathers of mamba2's conv output and y among the
  collectives counted (``"wire"``, ``rank_rows``).  The arguments are
  the parameter block, the cache shard and the rows' inputs; the
  output the logits block and the cache shard, which it aliases.

``roofline_terms`` uses the H100's constants (``launch.mesh.HW``):
compute at the bf16 peak, memory at the HBM rate, collectives at the
400 Gb/s network port of each card (``net_bw``); every record names its
``dominant`` term.  The record's ``cost``
key takes the place of the reference's ``hlo_cost``, ``count_s`` of its
``lower_s`` and ``compile_s``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k --mesh 1pod --knob model=1 --knob fsdp=1 \\
      --out /tmp/dr

``--arch all --shape all --mesh both`` is the 80-record matrix; ``--jobs
N`` counts it in N processes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
from torch.utils._pytree import tree_leaves, tree_map

from .. import configs
from ..core import gossip as gossip_mod
from ..core import optim as optim_mod
from ..core import plan as plan_mod
from ..core import topology as topo_mod
from ..models import model as M
from . import sharding, steps
from .cost import Cost
from .mesh import HW, dry_mesh, make_production_mesh, to_logical_mesh
from .moe_group import MoeGroup
from .tp import TP
from .train import routing_group, rows_over_fsdp

__all__ = ["ARCH_IDS", "SHAPE_IDS", "build", "roofline_terms", "run_one",
           "main"]

ARCH_IDS = [
    "mamba2-1.3b", "granite-34b", "musicgen-large", "gemma2-27b",
    "llama-3.2-vision-90b", "zamba2-1.2b", "qwen3-0.6b",
    "granite-moe-3b-a800m", "deepseek-67b", "dbrx-132b",
]
SHAPE_IDS = list(steps.SHAPES)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, None: None}

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _rank0(mesh) -> dict:
    return {a: 0 for a in mesh.axis_names}


def _batch_bytes(batch: dict, mesh, *, node_axis: bool) -> int:
    return _nbytes(sharding.batch_block(batch, mesh, node_axis=node_axis,
                                        coords=_rank0(mesh)))


def _setup(arch: str, shape_name: str, multi_pod: bool, knobs: dict):
    """(cfg, layout, logical mesh, nodes, fsdp, model extent), as the
    reference's ``build_lowered`` makes them."""
    layout = configs.get_layout(arch)
    layout.update({k: v for k, v in knobs.items() if k in layout})
    cfg = steps.shape_cfg(configs.get_config(arch), shape_name)
    if layout.get("param_dtype"):
        cfg = dataclasses.replace(cfg,
                                  param_dtype=_DTYPES[layout["param_dtype"]])
    if knobs.get("remat") is not None:
        cfg = dataclasses.replace(cfg, remat=bool(knobs["remat"]))
    if knobs.get("broadcast_positions"):
        cfg = dataclasses.replace(cfg, broadcast_positions=True)
    if knobs.get("attention_impl"):
        cfg = dataclasses.replace(cfg, attention_impl=knobs["attention_impl"])
    if knobs.get("gqa_layout"):
        cfg = dataclasses.replace(cfg, gqa_layout=knobs["gqa_layout"])
    prod = make_production_mesh(multi_pod=multi_pod)
    nodes = layout["nodes"] * (2 if multi_pod else 1)
    fsdp = layout["fsdp"]
    model_axis = layout.get("model", 16)
    if nodes * fsdp * model_axis != prod.size:
        # layout overrides may re-factorize part of the mesh: nodes absorb
        # the remainder, as in the reference
        nodes = prod.size // (fsdp * model_axis)
    mesh = to_logical_mesh(prod, nodes, fsdp, model_axis)
    return cfg, layout, mesh, nodes, fsdp, model_axis


_PASSES: dict = {}


def _loss_and_grads(cfg, params: dict, tokens, images, dry, specs,
                    group: int = 1) -> tuple:
    """The count of ``steps.loss_and_grads`` on these shapes -- on rank 0's
    model shards over ``dry`` (the tensor-parallel pass, its collectives
    in the count) where the mesh's model extent is above 1, and with the
    moe routing made global over ``group`` fsdp ranks (its collectives
    too) where it is above 1 -- and the gradients' dtypes; the same
    config, shapes, cut and group (a 1pod and a 2pod record) are counted
    once per process."""
    tp = TP(dry, specs) if dry.shape["model"] > 1 else None
    route = MoeGroup(dry, group) if group > 1 else None
    key = (cfg, tuple(tokens.shape),
           None if images is None else tuple(images.shape),
           tuple((k, tuple(v.shape)) for k, v in params.items()),
           tuple(sorted(tp.dims.items())) if tp else None, group)
    if key not in _PASSES:
        dry.log.reset()
        with Cost() as c:
            _, g = steps.loss_and_grads(cfg, params, tokens, images, tp,
                                        route)
        c.add_wire(dry.log)
        dry.log.reset()
        _PASSES[key] = (c, {k: v.dtype for k, v in g.items()})
    return _PASSES[key]


def _grad_pass(cfg, params: dict, tokens, images, micro, dry,
               specs, group: int = 1) -> tuple:
    """The count of a rank's gradient pass over ``tokens`` (B, S, ...) as
    ``make_train_step`` runs it, and the gradients' dtype per leaf: with
    ``nm`` micro-batches, one micro-batch's pass (its collectives too)
    counted once and taken ``nm`` times, plus the f32 accumulators and
    ``nm`` accumulations.  ``group``: the fsdp ranks a moe routing group
    spans (:func:`_loss_and_grads`)."""
    pnb = tokens.shape[0]
    if micro is None or micro >= pnb:
        return _loss_and_grads(cfg, params, tokens, images, dry, specs,
                               group)
    nm = pnb // micro
    one, g_dtypes = _loss_and_grads(
        cfg, params, tokens[:micro], None if images is None
        else images[:micro], dry, specs)
    total = Cost()
    with total:
        acc_loss = torch.zeros((), dtype=torch.float32, device="meta")
        acc_g = {k: torch.zeros(v.shape, dtype=torch.float32, device="meta")
                 for k, v in params.items()}
        g = {k: _meta(v.shape, g_dtypes[k]) for k, v in params.items()}
        with Cost() as acc:
            steps.accumulate_grads(acc_loss, acc_g, _meta((), torch.float32),
                                   g, nm)
    total.add(acc, k=nm - 1)
    total.add(one, k=nm)
    # a pass runs beside the accumulators
    total.peak_bytes = max(total.peak_bytes, one.peak_bytes + _nbytes(acc_g))
    return total, {k: torch.float32 for k in params}


def build(arch: str, shape_name: str, *, multi_pod: bool,
          topology: str = "one_peer_exp", optimizer: str = "dmsgd",
          gossip_phase: int = 0, knobs: dict | None = None):
    """Count one (arch, shape, mesh) step as rank 0 sees it.  Returns
    ``(cost, meta)``: the per-chip :class:`Cost` and the record's fields."""
    knobs = dict(knobs or {})
    cfg, layout, mesh, nodes, fsdp, model_axis = _setup(
        arch, shape_name, multi_pod, knobs)
    info = steps.SHAPES[shape_name]
    kind = info["kind"]
    inner = fsdp * model_axis
    params = dict(M.init(cfg, device="meta").named_parameters())
    params = {k: v.detach() for k, v in params.items()}
    n_params = sum(v.numel() for v in params.values())
    meta = dict(arch=arch, shape=shape_name, kind=kind, multi_pod=multi_pod,
                nodes=nodes, fsdp=fsdp,
                model_axis=sharding.axis_size(mesh, "model"),
                topology=topology, optimizer=optimizer, knobs=knobs,
                n_params=int(n_params))
    coords = _rank0(mesh)

    if kind == "train":
        mom_dtype = _DTYPES[layout.get("momentum_dtype")]
        top = topo_mod.get_topology(topology, nodes)
        opt = optim_mod.make_optimizer(optimizer, top, beta=0.9,
                                       momentum_dtype=mom_dtype,
                                       compression=knobs.get("compression"))
        stacked = {k: _meta((nodes,) + tuple(v.shape), v.dtype)
                   for k, v in params.items()}
        p_specs = sharding.param_specs(
            stacked, mesh, cfg=cfg, node_axis=True,
            fsdp_params=knobs.get("fsdp_params", True))
        blk = {k: _meta(v.shape, v.dtype) for k, v in sharding.local_shard(
            stacked, p_specs, mesh, coords).items()}
        mom = {k: _meta(v.shape, mom_dtype or v.dtype)
               for k, v in blk.items()}
        batch = steps.input_specs(cfg, shape_name, nodes=nodes)
        arg_bytes = (_nbytes(blk) + _nbytes(mom)
                     + _batch_bytes(batch, mesh, node_axis=True))
        dry = dry_mesh(mesh, rank=0)
        # the fsdp gather of rank 0's block: its node's leaves, whole over
        # fsdp, its model shards
        whole = blk
        gather = Cost()
        if fsdp > 1:
            with gather:
                whole = sharding.fsdp_gather(blk, p_specs, dry)
            gather.add_wire(dry.log)
            dry.log.reset()
        # the rank's gradient pass: its rows of the node's batch, the moe
        # routing made global over the ranks a routing group spans
        images = batch.get("image_embeds")
        tokens = batch["tokens"][0]
        micro = layout.get("micro")
        group = 1
        if rows_over_fsdp(cfg, mesh, tokens.shape[0], micro):
            if cfg.n_experts and fsdp > 1:
                group = routing_group(mesh, tokens.shape[0], micro)
            rows = tokens.shape[0] // fsdp
            tokens = tokens[:rows]
            images = None if images is None else images[:, :rows]
        grads_cost, g_dtypes = _grad_pass(
            cfg, {k: v[0] for k, v in whole.items()}, tokens,
            None if images is None else images[0], micro, dry, p_specs,
            group)
        # the reduce-scatter of the gradients' mean over fsdp
        grads = {k: _meta(v.shape, g_dtypes[k]) for k, v in whole.items()}
        scatter = Cost()
        if fsdp > 1:
            with scatter:
                sharding.fsdp_reduce_scatter_mean(grads, p_specs, dry)
                dry.psum(_meta((1,), torch.float32), "fsdp")   # node loss
            scatter.add_wire(dry.log)
            dry.log.reset()
        del grads
        # the update and the gossip on rank 0's block

        def step_fn(mix, p, s, g, lr):
            return opt.update_with_mix(p, s, g, lr, mix)

        plan = plan_mod.GossipPlan.for_optimizer(opt, fn=step_fn, mesh=dry)
        state = opt.init(blk)
        grads = {k: _meta(v.shape, g_dtypes[k]) for k, v in blk.items()}
        with Cost() as update:
            plan.step_fn(gossip_phase)(blk, state, grads, 0.01)
        update.add_wire(dry.log)
        cost = Cost()
        for part in (gather, grads_cost, scatter, update):
            cost.add(part)
        # the pass runs beside the gathered leaves; the update after it
        gathered = _nbytes(whole) - _nbytes(blk) if fsdp > 1 else 0
        cost.peak_bytes = int(gathered + grads_cost.peak_bytes
                              + update.peak_bytes)
        ir = gossip_mod.gossip_spec(top, gossip_phase,
                                    compression=opt.compression)
        bytes_per_elem = 1 if opt.compression == "int8" else 4
        ir["payload_bytes_per_node"] = int(
            bytes_per_elem * n_params * max(len(opt.gossip_where), 1)
            * ir["wire_multiplier"])
        ir["inner_shards"] = inner
        ir["payload_bytes_per_shard"] = ir["payload_bytes_per_node"] // inner
        ir["wire_bytes_per_rank"] = sum(dry.log.bytes().values())
        meta["gossip_ir"] = ir
        meta["compile_cache"] = plan.cache_stats()
        state_bytes = _nbytes(mom)
        meta["memory_analysis"] = dict(
            argument_bytes=arg_bytes,
            output_bytes=_nbytes(blk) + state_bytes + 4,
            alias_bytes=_nbytes(blk) + state_bytes)
        return cost, meta

    p_specs = sharding.param_specs(params, mesh, cfg=cfg, node_axis=False)
    blk = {k: _meta(v.shape, v.dtype) for k, v in sharding.local_shard(
        params, p_specs, mesh, coords).items()}
    p_bytes = _nbytes(blk)
    batch = steps.input_specs(cfg, shape_name, nodes=1)
    in_bytes = _batch_bytes(batch, mesh, node_axis=False)
    if kind == "prefill":
        # rank 0's real step over the dry mesh: the fsdp gather of its
        # block, the tensor-parallel forward on its model shards over its
        # rows of the batch; the pass runs beside the gathered leaves
        dry = dry_mesh(mesh, rank=0)
        rows = sharding.batch_block(batch, mesh, node_axis=False,
                                    coords=coords)
        step = steps.make_prefill_step(
            cfg, tp=TP.serving(dry, p_specs) if model_axis > 1 else None,
            fsdp=(dry, p_specs) if fsdp > 1 else None)
        with Cost() as cost:
            out = step(blk, rows)
        cost.add_wire(dry.log)
        # rank 0's wire by scope: ops and bytes sent per "scope:kind"
        meta["wire"] = {k: {"ops": v["ops"], "bytes": v["bytes"]}
                        for k, v in dry.log.kinds.items()}
        meta["memory_analysis"] = dict(
            argument_bytes=p_bytes + in_bytes,
            output_bytes=out.numel() * out.element_size(), alias_bytes=0)
        meta["rank_rows"] = rows["tokens"].shape[0]
        return cost, meta

    # decode: rank 0's real step over the dry mesh, as the prefill, on its
    # shard of the cache (cache_specs), updated in place
    dry = dry_mesh(mesh, rank=0)
    rows = sharding.batch_block(batch, mesh, node_axis=False, coords=coords)
    full_cache = steps.cache_struct(cfg, shape_name)
    c_specs = sharding.cache_specs(full_cache, mesh, info["global_batch"])
    cache = tree_map(lambda t: _meta(t.shape, t.dtype), sharding.local_shard(
        full_cache, c_specs, mesh, coords))
    cache_bytes = _nbytes(cache)
    step = steps.make_serve_step(
        cfg, tp=TP.serving(dry, p_specs) if model_axis > 1 else None,
        fsdp=(dry, p_specs) if fsdp > 1 else None)
    with Cost() as cost:
        logits, _ = step(blk, cache, rows)
    cost.add_wire(dry.log)
    meta["wire"] = {k: {"ops": v["ops"], "bytes": v["bytes"]}
                    for k, v in dry.log.kinds.items()}
    meta["memory_analysis"] = dict(
        argument_bytes=p_bytes + cache_bytes + in_bytes,
        output_bytes=logits.numel() * logits.element_size() + cache_bytes,
        alias_bytes=cache_bytes)
    meta["rank_rows"] = rows["token"].shape[0]
    return cost, meta


def roofline_terms(cost: Cost, n_chips: int) -> dict:
    """Three roofline terms in seconds, per chip, on the H100's constants:
    the count is per chip already (rank 0's view), so nothing is divided
    by the chip count.  ``dominant`` names the largest term."""
    t_compute = cost.flops / HW["peak_flops_bf16"]
    t_memory = cost.hbm_bytes / HW["hbm_bw"]
    t_coll = cost.total_collective_bytes / HW["net_bw"]
    return {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
        "dominant": max((t_compute, "compute"), (t_memory, "memory"),
                        (t_coll, "collective"))[1],
        "n_chips": n_chips,
    }


def _path(out_dir: str, arch: str, shape_name: str, multi_pod: bool,
          kw: dict) -> str:
    tag = "2pod" if multi_pod else "1pod"
    extra = ""
    if kw.get("topology", "one_peer_exp") != "one_peer_exp":
        extra += f"_{kw['topology']}"
    if kw.get("optimizer", "dmsgd") != "dmsgd":
        extra += f"_{kw['optimizer']}"
    if kw.get("knobs"):
        extra += "_" + "-".join(f"{k}{v}" for k, v in
                                sorted(kw["knobs"].items()))
    return os.path.join(out_dir, f"dryrun_{arch}_{shape_name}_{tag}{extra}.json")


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            out_dir: str | None = None, verbose: bool = True,
            **kw) -> dict:
    """Count one combination, print its summary (``verbose``) and write
    ``dryrun_{arch}_{shape}_{1pod|2pod}{extra}.json`` under ``out_dir``."""
    t0 = time.perf_counter()
    cost, meta = build(arch, shape_name, multi_pod=multi_pod, **kw)
    count_s = time.perf_counter() - t0
    mem = meta.pop("memory_analysis")
    mem["temp_bytes"] = int(cost.peak_bytes)
    mem["fits"] = bool(mem["argument_bytes"] + mem["temp_bytes"]
                       <= HW["hbm_bytes"])
    n_chips = 512 if multi_pod else 256
    rec = dict(meta, ok=True, count_s=round(count_s, 2),
               memory_analysis=mem, cost=cost.to_dict(),
               roofline=roofline_terms(cost, n_chips))
    if verbose:
        print(f"== {arch} x {shape_name} x "
              f"{'2-pod(512)' if multi_pod else '1-pod(256)'} ==")
        print("  memory_analysis:", mem)
        print("  cost: flops=%.3e hbm=%.3e coll=%.3e  %s" %
              (cost.flops, cost.hbm_bytes, cost.total_collective_bytes,
               dict(cost.collective_counts)))
        r = rec["roofline"]
        print("  roofline: compute=%.3fms memory=%.3fms collective=%.3fms"
              " dominant=%s" % (1e3 * r["compute_s"], 1e3 * r["memory_s"],
                                1e3 * r["collective_s"], r["dominant"]))
        print("  count=%.1fs" % count_s)
        if "compile_cache" in meta:
            print("  compile_cache:", meta["compile_cache"])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(_path(out_dir, arch, shape_name, multi_pod, kw), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _job(job: tuple) -> list:
    """One arch and shape on its meshes, in a worker process: per mesh
    (ok, printed lines or the error)."""
    import contextlib
    import io

    arch, shp, meshes, kw = job
    torch.set_num_threads(1)
    out = []
    for mp in meshes:
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                run_one(arch, shp, multi_pod=mp, **kw)
            out.append((True, buf.getvalue()))
        except Exception as e:  # noqa: BLE001
            out.append((False, repr(e)))
    return out


def run_matrix(archs, shapes, meshes, *, jobs: int = 1, **kw) -> list:
    """Count every combination (in ``jobs`` processes when above 1, one
    arch and shape a task), printing each summary, and ``!! FAILED ...``
    for each failure, in order.  Returns the failures."""
    todo = [(a, s, tuple(meshes), kw) for a in archs for s in shapes]
    if jobs > 1:
        import concurrent.futures as cf
        import multiprocessing as mp_mod

        with cf.ProcessPoolExecutor(
                jobs, mp_context=mp_mod.get_context("spawn")) as ex:
            results = list(ex.map(_job, todo))
    else:
        results = []
        for arch, shp, _, _ in todo:
            res = []
            for mp in meshes:
                try:
                    run_one(arch, shp, multi_pod=mp, **kw)
                    res.append((True, ""))
                except Exception as e:  # noqa: BLE001
                    res.append((False, repr(e)))
            results.append(res)
    failures = []
    for (arch, shp, _, _), res in zip(todo, results):
        for mp, (ok, text) in zip(meshes, res):
            if ok:
                print(text, end="")
                continue
            failures.append((arch, shp, mp, text))
            print(f"!! FAILED {arch} x {shp} x mp={mp}: {text}")
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape id or 'all'")
    ap.add_argument("--mesh", default="1pod", choices=["1pod", "2pod", "both"])
    ap.add_argument("--topology", default="one_peer_exp")
    ap.add_argument("--optimizer", default="dmsgd")
    ap.add_argument("--gossip-phase", type=int, default=0)
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--knob", action="append", default=[],
                    help="k=v hillclimb knobs (micro, fsdp_params, remat...)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the matrix")
    args = ap.parse_args(argv)

    knobs = {}
    for kv in args.knob:
        k, v = kv.split("=", 1)
        try:
            knobs[k] = json.loads(v)
        except json.JSONDecodeError:
            knobs[k] = v

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = SHAPE_IDS if args.shape == "all" else [args.shape]
    meshes = {"1pod": [False], "2pod": [True], "both": [False, True]}[args.mesh]
    failures = run_matrix(archs, shapes, meshes, jobs=args.jobs,
                          out_dir=args.out, topology=args.topology,
                          optimizer=args.optimizer,
                          gossip_phase=args.gossip_phase, knobs=knobs)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
    print("ALL DRY-RUNS OK")


if __name__ == "__main__":
    main()
