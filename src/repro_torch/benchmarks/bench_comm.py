"""Paper Table 1 / 7 / 8: per-iteration communication by topology.

The port of the JAX package's ``benchmarks/bench_comm.py`` on one card
(``--device``, the card by default).  Structural: reads gossip rounds,
collectives and bytes per node per iteration straight off the realization
IR (:func:`repro_torch.core.gossip.gossip_spec`) for a fixed model size,
plus the theoretical transient-iteration complexity from the spectral gap
(eq. 4).  Matchings (random_match, one_peer_hypercube, base_k) report
1-permute bytes; dense rounds report the O(n) all-gather a multi-node
mesh would pay.

The wire bytes are the port's packed layout's: each dtype group is padded
to 8 elements (:data:`repro_torch.core.flatbuf.PAD_MULTIPLE`), the
reference's to its TPU kernel's 8 x 1024 tile.  So on the 1M-f32-per-node
tree every ``bytes_per_iter`` here is the reference's x 1,000,000 /
1,007,616 (its payload of 1,007,616 elements a node, this one of
exactly 1,000,000); the runtime rows' piggybacked metadata bytes are not
padded and equal the reference's.

``us_per_mix`` is one ``GossipPlan(top).mix(0)`` of that tree on the
device (pack, ``torch.roll`` or ``index_select``, the ``gossip_mix``
kernel on Shifts and Matching rounds, unpack; an ``einsum`` on Dense).
:func:`engine_compare_spmd` times one round of the flat engine against
:func:`~repro_torch.core.gossip.mix_shifts_per_leaf`, the historical
one-roll-per-leaf path, on a 97-leaf transformer-shaped tree at 8 nodes;
on one card every roll is a device copy, not a collective, so
``permutes_per_step`` counts rolls (or gathers) launched.
:func:`engine_compare_two_axis` is the reference's shard-native against
global engine on a ``node x fsdp`` mesh, here a world of 8 spawned ranks
(:func:`repro_torch.launch.mesh.spawn`; on the card all of them on it,
over gloo staged through host memory): each rank's block of the 97-leaf
tree, every leaf sharded ``("node", "fsdp")``, mixed shard-natively (one
permute per dtype group) or by the global path (the payload gathered
over the mesh, mixed, the block kept: what GSPMD's reshard does for the
reference).  Where the reference prints HLO collective counts, its rows
carry the mesh's wire log: ops and bytes a rank sends per kind.

:func:`overlap_rows` times the overlapped (one-step-delayed) DmSGD
pipeline against synchronous gossip on one card, with the reference's
emulated backward (12 batched ``tanh(c @ d)`` at D 96 per node): the
delayed round runs on a side CUDA stream under it.  There is no fsdp axis
on one card (``fsdp: 1``).

``--quick`` writes the reference's JSON schema (``rows``, ``two_axis``,
``runtime``, ``overlap``) to ``--out`` (``BENCH_comm.new.json`` unless
told: ``BENCH_comm.json`` is the reference's committed record);
``repro_torch.benchmarks.check_comm_regression`` (or the reference's
checker) diffs it against a committed record:

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_comm --quick \\
      --out BENCH_comm.new.json
  PYTHONPATH=src python -m repro_torch.benchmarks.check_comm_regression \\
      --baseline BENCH_comm_h100.json --new BENCH_comm.new.json
  PYTHONPATH=src python -m repro_torch.benchmarks.bench_comm \\
      [--quick | --two-axis] [--out PATH] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from ..core import flatbuf, gossip, optim, spectral, topology
from ..core.plan import GossipPlan
from ..device import resolve_device
from .common import emit, time_fn

__all__ = ["TABLE_TOPOLOGIES", "comm_table", "two_axis_rows",
           "runtime_rows", "mix_us", "engine_compare_spmd",
           "engine_compare_two_axis", "overlap_rows", "run", "run_quick",
           "run_two_axis", "main"]

TABLE_TOPOLOGIES = ["ring", "grid", "static_exp", "one_peer_exp",
                    "one_peer_hypercube", "random_match", "base_k", "ceca",
                    "full"]
# how us_per_mix is timed: time_fn(iters=5) after its 2 warm-up calls
MIX_ITERS, MIX_WARMUP = 5, 2
# where --quick / --two-axis write unless told (check_comm_regression's
# default --new)
NEW_RECORD = "BENCH_comm.new.json"


def _wire_tree(n: int, device="meta") -> dict:
    """The 1M-f32-per-node tree of the table (on the meta device unless a
    mix is timed: the accounting reads only shapes and dtypes)."""
    return {"w": torch.zeros((n, 250_000, 4), dtype=torch.float32,
                             device=device)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mix_us(top, tree) -> float:
    """Microseconds of one ``GossipPlan(top).mix(0)`` of ``tree`` (the
    mixing executor the train path resolves step 0's realization to)."""
    mix0 = GossipPlan(top).mix(0)
    return time_fn(lambda: mix0(tree), iters=MIX_ITERS, warmup=MIX_WARMUP)


def comm_table(n: int = 16, *, time_mix: bool = True,
               device="cuda") -> list[dict]:
    """One row per topology: IR wire accounting + spectral/transient
    info; ``us_per_mix`` timed on ``device`` when ``time_mix``."""
    tree = (_wire_tree(n, resolve_device(device)) if time_mix
            else _wire_tree(n))
    layout = flatbuf.layout_of(tree)
    rows = []
    for name in TABLE_TOPOLOGIES:
        top = topology.get_topology(name, n)
        spec = gossip.gossip_spec(top, 0, layout=layout)
        # same packed-layout accounting for both kinds; x2 = x + momentum
        bytes_per_iter = spec["bytes_per_node_per_step"] * 2
        us = mix_us(top, tree) if time_mix else float("nan")
        W = top.weights(0)
        gap = (spectral.spectral_gap(W) if not top.time_varying
               else float("nan"))
        if name == "one_peer_exp":
            # eq. (11): same transient complexity as static exp
            trans = n ** 3 * math.log2(n) ** 2
        elif top.time_varying:
            trans = float("nan")
        else:
            trans = spectral.transient_iterations(n, gap)
        rows.append(dict(
            topology=name, n=n, degree=top.max_degree, kind=spec["kind"],
            rounds=spec["rounds"], wire_multiplier=spec["wire_multiplier"],
            collectives_per_step=spec["collectives_per_step"],
            bytes_per_iter=bytes_per_iter, us_per_mix=us, gap=gap,
            transient=trans,
            finite_time_period=(top.period if top.period is not None
                                and name in ("one_peer_exp",
                                             "one_peer_hypercube",
                                             "base_k", "ceca") else None)))
    return rows


def two_axis_rows(n: int = 16, fsdp: int = 8) -> list[dict]:
    """Structural per-shard wire accounting for a 2-axis ``node x fsdp``
    mesh: the shard-native engine permutes each node's LOCAL shard, so one
    chip's wire bytes are the per-node payload / fsdp.  Arithmetic on the
    IR: it needs no mesh."""
    layout = flatbuf.layout_of(_wire_tree(n))
    rows = []
    for name in ["one_peer_exp", "static_exp", "one_peer_hypercube",
                 "base_k"]:
        top = topology.get_topology(name, n)
        spec = gossip.gossip_spec(top, 0, layout=layout)
        bytes_iter = spec["bytes_per_node_per_step"] * 2  # x + momentum
        rows.append(dict(
            topology=name, n=n, fsdp=fsdp, kind=spec["kind"],
            collectives_per_step=spec["collectives_per_step"],
            bytes_per_iter_per_node=bytes_iter,
            bytes_per_iter_per_shard=bytes_iter // fsdp))
    return rows


def runtime_rows(n: int = 16) -> list[dict]:
    """Wire accounting for RUNTIME-VALUED rounds: the piggybacked metadata
    columns (loss / grad-norm / deadline flag) ride the f32 group's
    existing permute -- zero extra collectives; ``bytes_per_iter`` is
    payload x2 (x + momentum share one buffer) + the meta columns ONCE."""
    layout = flatbuf.layout_of(_wire_tree(n))
    rows = []
    for name, cols, tag in [("one_peer_exp", 1, "loss_aware"),
                            ("one_peer_exp", 2, "loss_aware+deadline"),
                            ("one_peer_hypercube", 2,
                             "loss_aware+deadline")]:
        top = topology.get_topology(name, n)
        spec = gossip.gossip_spec(top, 0, layout=layout, meta_cols=cols)
        payload = (spec["bytes_per_node_per_step"]
                   - spec["meta_bytes_per_node_per_step"])
        rows.append(dict(
            topology=f"{name}@{tag}", n=n, kind=spec["kind"],
            meta_cols=cols,
            collectives_per_step=spec["collectives_per_step"],
            meta_bytes_per_iter=spec["meta_bytes_per_node_per_step"],
            bytes_per_iter=(payload * 2
                            + spec["meta_bytes_per_node_per_step"])))
    return rows


def _transformer_like_tree(n: int, device, n_blocks: int = 24) -> dict:
    """~1M params a node split over 4 * n_blocks + 1 leaves
    (transformer-shaped)."""
    per_block = 1_000_000 // (n_blocks + 1)
    q = per_block // 4
    leaves = {}
    for i in range(n_blocks):
        leaves[f"blk{i:02d}"] = {
            key: torch.zeros((n, size), device=device)
            for key, size in (("attn", q), ("mlp_in", q), ("mlp_out", q),
                              ("ln", per_block - 3 * q))}
    leaves["embed"] = torch.zeros((n, per_block), device=device)
    return leaves


def engine_compare_spmd(nn: int = 8, device="cuda") -> list[dict]:
    """Time one gossip round, flat vs per-leaf, at ``nn`` nodes on one
    device: the flat engine (:meth:`GossipPlan.mix`: pack, one
    ``torch.roll`` per shift, the ``gossip_mix`` kernel, unpack) against
    :func:`gossip.mix_shifts_per_leaf` (a roll per leaf per shift and a
    plain f32 combine per leaf), in turns (ABBA), and the matching wire path
    (pack, one ``index_select``, the kernel).  ``permutes_per_step``
    counts the rolls or gathers a round launches on the card -- the
    collectives a node-sharded mesh would issue.  Emits one CSV row each
    and returns them."""
    dev = resolve_device(device)
    mtree = _transformer_like_tree(nn, dev)
    n_leaves = len(flatbuf.tree_flatten(mtree)[0])
    layout_m = flatbuf.layout_of(mtree)
    rows = []
    for name in ["one_peer_exp", "static_exp"]:
        top = topology.get_topology(name, nn)
        real = top.realization(0)
        self_w, shifts = real.self_w, list(real.shifts)
        mix0 = GossipPlan(top).mix(0)

        def flat_fn(t=mtree, m=mix0):
            return m(t)

        def leaf_fn(t=mtree, sw=self_w, sh=shifts):
            return gossip.mix_shifts_per_leaf(t, sw, sh)

        # ABBA order: a drift of the card's clock hits both engines
        us_flat = time_fn(flat_fn, iters=10)
        us_leaf = min(time_fn(leaf_fn, iters=10), time_fn(leaf_fn, iters=10))
        us_flat = min(us_flat, time_fn(flat_fn, iters=10))
        rolls_flat = len(shifts) * len(layout_m.groups)
        rolls_leaf = len(shifts) * n_leaves
        rows.append(dict(name=f"comm_engine_{name}_flat", us=us_flat,
                         derived=f"n={nn};leaves={n_leaves};"
                                 f"permutes_per_step={rolls_flat}"))
        rows.append(dict(name=f"comm_engine_{name}_perleaf", us=us_leaf,
                         derived=f"n={nn};leaves={n_leaves};"
                                 f"permutes_per_step={rolls_leaf};"
                                 f"flat_speedup="
                                 f"{us_leaf / max(us_flat, 1e-9):.2f}x"))

    # the matching wire path: one gather per dtype group
    top = topology.get_topology("one_peer_hypercube", nn)
    mix0 = GossipPlan(top).mix(0)
    us_match = time_fn(lambda: mix0(mtree), iters=10)
    rows.append(dict(name="comm_engine_one_peer_hypercube_matching",
                     us=us_match,
                     derived=f"n={nn};leaves={n_leaves};"
                             f"permutes_per_step={len(layout_m.groups)}"))
    for r in rows:
        emit(r["name"], r["us"], r["derived"])
    return rows


def _two_axis_rank(rank: int, nodes: int, fsdp: int, device: str,
                   iters: int) -> list[dict]:
    """One rank of :func:`engine_compare_two_axis`: both engines on its
    block, timed (each rank its own calls; the collectives keep them in
    step), one call of each logged; rank 0's rows are the result."""
    from ..launch import mesh as mesh_mod
    from ..launch import sharding
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    mesh = mesh_mod.make_mesh((nodes, fsdp), ("node", "fsdp"),
                              backend="gloo", device=dev)
    full = _transformer_like_tree(nodes, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for blk in full.values():
        for t in (blk.values() if isinstance(blk, dict) else [blk]):
            t.normal_(generator=gen)
    specs = {k: ({kk: ("node", "fsdp") for kk in v} if isinstance(v, dict)
                 else ("node", "fsdp")) for k, v in full.items()}
    local = sharding.map_specs(lambda x, _: x.contiguous(),
                               sharding.local_shard(full, specs, mesh), specs)
    del full
    n_leaves = len(flatbuf.tree_flatten(local)[0])
    top = topology.get_topology("one_peer_exp", nodes)
    r0 = top.realization(0)
    native = GossipPlan(top, mesh=mesh).mix(0)

    def global_fn(t):
        whole = sharding.gather(t, specs, mesh)
        mixed = gossip.mix_shifts(whole, r0.self_w, list(r0.shifts))
        return sharding.local_shard(mixed, specs, mesh)

    outs, rows = {}, []
    for tag, fn in (("shardnative", native), ("global", global_fn)):
        us = time_fn(lambda f=fn: f(local), iters=iters)
        mesh.log.reset()
        outs[tag] = fn(local)
        counts, sent = mesh.log.counts(), mesh.log.bytes()
        wire_s, stage_s = mesh.log.seconds()
        rows.append(dict(
            name=f"comm_engine2ax_one_peer_exp_{tag}", us=us,
            derived=f"nodes={nodes};fsdp={fsdp};leaves={n_leaves};"
                    f"wire={mesh.wire};collectives={counts};"
                    f"coll_bytes_per_rank={sum(sent.values())};"
                    f"wire_ms={1e3 * wire_s:.3f};"
                    f"stage_ms={1e3 * stage_s:.3f}"))
    a, b = (flatbuf.tree_flatten(outs[t])[0] for t in ("shardnative",
                                                        "global"))
    equal = all(torch.equal(x, y) for x, y in zip(a, b))
    rows[0]["derived"] += f";equal_to_global={equal}"
    return rows


def engine_compare_two_axis(nodes: int = 4, fsdp: int = 2, device="cuda",
                            iters: int = 5) -> list[dict]:
    """Shard-native vs global packed engine on a (node x fsdp) world of
    ``nodes * fsdp`` spawned ranks, every leaf of the 97-leaf tree sharded
    ``("node", "fsdp")``: the global path gathers the payload around the
    round, the shard-native one moves each rank's block once.  Emits rank
    0's rows (µs a round, the wire log's collectives and bytes, whether
    the two engines agree bit for bit) and returns them."""
    from ..launch import mesh as mesh_mod
    resolve_device(device)
    rows = mesh_mod.spawn(_two_axis_rank, nodes * fsdp,
                          (nodes, fsdp, str(device), iters),
                          threads=1 if str(device) == "cpu" else None)[0]
    for r in rows:
        emit(r["name"], r["us"], r["derived"])
    return rows


def overlap_rows(nodes: int = 4, param_elems: int = 6_000_000,
                 steps: int = 16, device="cuda") -> dict:
    """Overlapped (delayed-mix) vs synchronous DmSGD wall time on one
    device, over ``one_peer_exp(nodes)``.

    Both variants run the same flat engine and an identical emulated
    backward (a per-node chain of 12 ``tanh(c @ d)`` at D 96 that the
    gradients depend on).  The only difference is the dependency
    structure: the sync step mixes this step's update outputs after the
    backward; the pipelined step starts the delayed round of the
    in-flight buffer (ready at step start) on the card's side stream
    before the backward, so the two can overlap.  The record's ``fsdp``
    is 1: one card has no fsdp axis."""
    dev = resolve_device(device)
    half = param_elems // 2
    params = {"w1": torch.full((nodes, half), 0.01, device=dev),
              "w2": torch.full((nodes, half), 0.01, device=dev)}
    D = 96
    data = torch.full((nodes, D, D), 0.01, device=dev)
    top = topology.get_topology("one_peer_exp", nodes)

    def make_step(opt):
        def step(mix, p, s, d, lr):
            # the delayed round first, so it runs under the backward
            pending = opt.start_delayed(p, s, mix) if opt.overlap else None
            c = d
            for _ in range(12):
                c = torch.tanh(c @ d)
            scal = 1e-3 * c.sum(dim=(1, 2))
            g = {k: 0.01 * x + scal[:, None] for k, x in p.items()}
            if opt.overlap:
                return opt.update_pipelined(p, s, g, lr, mix,
                                            pending=pending)
            return opt.update_with_mix(p, s, g, lr, mix)
        return step

    out = {"nodes": nodes, "fsdp": 1,
           "param_bytes_per_node": 8 * param_elems,  # params + momentum
           "steps": steps}
    for tag, overlap in (("sync", False), ("overlap", True)):
        opt = optim.dmsgd(top, beta=0.9, overlap=overlap)
        plan = GossipPlan.for_optimizer(opt, fn=make_step(opt))
        p, s = params, opt.init(params)
        # warm pass: binds every realization's executable (the overlap
        # prime at k=0 too) and loads the kernel before the timed steps
        warm = top.period + 2
        for k in range(warm):
            p, s = plan.step_fn(k)(p, s, data, 0.01)
        _sync(dev)
        t0 = time.perf_counter()
        for k in range(warm, warm + steps):
            p, s = plan.step_fn(k)(p, s, data, 0.01)
        _sync(dev)
        out[f"ms_per_step_{tag}"] = 1e3 * (time.perf_counter() - t0) / steps
    out["speedup"] = out["ms_per_step_sync"] / out["ms_per_step_overlap"]
    return out


def run(n: int = 16, device="cuda") -> None:
    """The table's CSV rows, then the flat vs per-leaf engine comparison
    at 8 nodes and the two-axis (node 4 x fsdp 2) one."""
    for r in comm_table(n, device=device):
        emit(f"comm_{r['topology']}", r["us_per_mix"],
             f"degree={r['degree']};kind={r['kind']};rounds={r['rounds']};"
             f"bytes_per_iter={r['bytes_per_iter']};gap={r['gap']:.4f};"
             f"transient~{r['transient']:.3g}")
    engine_compare_spmd(device=device)
    engine_compare_two_axis(device=device)


def run_quick(out_path: str = NEW_RECORD, n: int = 16, *,
              device="cuda", **overlap_kw) -> dict:
    """The quick tier: structural IR accounting plus per-mix wall times
    and the overlap-vs-sync step-time pair (``overlap_kw`` passed to
    :func:`overlap_rows`), dumped as the reference's JSON record.
    ``check_comm_regression`` GATES only the deterministic wire-bytes
    fields; the timing fields are reported (they drift with the host)."""
    rows = comm_table(n, time_mix=True, device=device)
    rec = {"n": n, "rows": rows,
           "two_axis": {"fsdp": 8, "rows": two_axis_rows(n, fsdp=8)},
           "runtime": {"rows": runtime_rows(n)},
           "overlap": overlap_rows(device=device, **overlap_kw)}
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    for r in rows:
        emit(f"comm_{r['topology']}", r["us_per_mix"],
             f"kind={r['kind']};wire_multiplier={r['wire_multiplier']};"
             f"bytes_per_iter={r['bytes_per_iter']}")
    for r in rec["two_axis"]["rows"]:
        emit(f"comm_2ax_{r['topology']}", 0.0,
             f"fsdp={r['fsdp']};"
             f"bytes_per_iter_per_shard={r['bytes_per_iter_per_shard']}")
    for r in rec["runtime"]["rows"]:
        emit(f"comm_rt_{r['topology']}", 0.0,
             f"meta_cols={r['meta_cols']};"
             f"collectives={r['collectives_per_step']};"
             f"meta_bytes={r['meta_bytes_per_iter']};"
             f"bytes_per_iter={r['bytes_per_iter']}")
    ov = rec["overlap"]
    emit("comm_overlap_pipelined", 1e3 * ov["ms_per_step_overlap"],
         f"sync_ms={ov['ms_per_step_sync']:.2f};"
         f"speedup={ov['speedup']:.2f}x")
    print(f"wrote {out_path}", flush=True)
    return rec


def run_two_axis(out_path: str = NEW_RECORD, device="cuda") -> dict:
    """The ``--two-axis`` mode: overlap vs sync wall time (on one card
    :func:`overlap_rows`, no fsdp axis) and the two-axis engine
    comparison's rows (``engine_two_axis``), merged into ``out_path`` so
    the record carries them."""
    eng = engine_compare_two_axis(device=device)
    ov = overlap_rows(device=device)
    emit("comm_overlap_sync", 1e3 * ov["ms_per_step_sync"],
         f"nodes={ov['nodes']};fsdp={ov['fsdp']};"
         f"payload_bytes={ov['param_bytes_per_node']}")
    emit("comm_overlap_pipelined", 1e3 * ov["ms_per_step_overlap"],
         f"nodes={ov['nodes']};fsdp={ov['fsdp']};"
         f"speedup={ov['speedup']:.2f}x")
    rec = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            rec = json.load(f)
    rec["overlap"] = ov
    rec["engine_two_axis"] = eng
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"overlap {ov['speedup']:.2f}x over sync "
          f"({ov['ms_per_step_sync']:.1f} -> "
          f"{ov['ms_per_step_overlap']:.1f} ms/step); wrote {out_path}",
          flush=True)
    return ov


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="write the JSON record (structural rows, timings, "
                         "the overlap pair) to --out")
    ap.add_argument("--two-axis", action="store_true",
                    help="time overlap vs sync and the two-axis engine "
                         "comparison, and merge them into --out")
    ap.add_argument("--out", default=NEW_RECORD,
                    help="the record to write (the reference's default, "
                         "BENCH_comm.json, is its own committed record)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.two_axis:
        run_two_axis(args.out, device=args.device)
    elif args.quick:
        run_quick(args.out, device=args.device)
    else:
        run(device=args.device)


if __name__ == "__main__":
    main()
