"""The shard-native gossip engine on a world of ranks, held against the
single-process global path.

A (node 4, fsdp 2) world of 8 spawned ranks (:func:`repro_torch.launch.
mesh.spawn`) mixes the reference test's ``{w, b, h}`` tree (``w`` and
``h`` sharded over fsdp, ``b`` replicated; ``h`` in bf16) through every
realization kind -- one-peer Shifts, the one-peer hypercube Matching, a
Matching with fixed points, static exponential Shifts, int8 Shifts and
Matching, grid Dense, full averaging -- plus the delayed halves
(``pack_payload`` then ``delayed_mix``, and ``delayed_post``'s split
wire), the runtime rounds (a per-node
``Gated`` round, ``meta=`` with loss-aware edge weights, ``node_gate=``,
a Matching with fixed points under all three) and the gathered global
path of a mesh with two nodes per rank.  Each
rank returns its block of every output, its wire log and its K1
launches; :func:`check` holds each block against its slice of the global
path (:mod:`repro_torch.core.gossip` without a mesh, its combine the
plain version, so that on the card each rank's K1 output is held against
the plain version on the same inputs) and each wire log against
``gossip_spec``'s accounting.

:func:`payload_world` does the same for a large payload on the card --
DmSGD's ``(m, x)`` of a model config, its specs from
``sharding.gossip_payload_spec_fn`` -- where the ranks' blocks are too
large to return: the parent holds the whole payload and its global
result, each rank hands its output to the parent through CUDA IPC, and
the two are compared there, one round at a time.

Training on a node mesh, one rank a node: :func:`train_world` runs
``launch.train.run(args, mesh=)`` runs in turn on one world and compares
each rank's final state with a single-process run's in the parent;
:func:`train_cases_rank` is a CPU world's rank through every flag of the
driver (:func:`train_cases`, :func:`warmup_run`) and the runtime rounds
with two nodes a rank (:func:`gathered_runtime_rank`, held against
:func:`gathered_runtime_expected`).

  PYTHONPATH=src python -m repro_torch.launch.mesh_check --device cpu
  PYTHONPATH=src python -m repro_torch.launch.mesh_check --device cpu \
      --train --nodes 4 --steps 6 --overlap --compression int8
  PYTHONPATH=src python -m repro_torch.launch.mesh_check --device cpu \
      --fsdp 2 --train --nodes 4 --steps 6 --overlap --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.mesh_check --device cpu \
      --fsdp 2 --model 2 --train --nodes 2 --steps 6 --overlap

fsdp-sharded training (a node's leaves over its fsdp ranks, each rank
holding its shards): :func:`fsdp_cases` on a CPU world of 8
(:func:`fsdp_cases_rank`), and :func:`every2_logs`, the reference's
differential wire check (a gossip step against the same step with
``every=2``'s ``Identity``).

Model-sharded (tensor-parallel) training, a node's leaves over its
(fsdp, model) ranks: :func:`tp_cases` on a CPU world of 8
(:func:`tp_cases_rank`: every case, :func:`tp_regions_rank` -- the
region ops and the vocab-parallel CE -- :func:`tp_grads_rank` and each
rank's share of the cases' :func:`single_run`).

Model-sharded prefill, a replica's rows over its (fsdp, model) ranks:
:func:`prefill_rank` cuts the serving params to the rank's shards
(``sharding.local_shard``), takes its rows of the batch and runs
``steps.make_prefill_step(tp=, fsdp=)``; :func:`prefill_cases` (every
family, the moe family on both expert routes, one kv head, qwen3 under
``"pallas"``) on a CPU world of 4 (:func:`prefill_cases_rank`), held
against :func:`single_prefill`.

  PYTHONPATH=src python -m repro_torch.launch.mesh_check --device cpu \
      --fsdp 2 --model 2 --prefill --arch granite-moe-3b-a800m --f32

Model-sharded decode, a replica's rows and its cache over its (fsdp,
model) ranks: :func:`decode_rank` cuts the serving params and the cache
(``sharding.cache_specs``) to the rank's shards, a leaf at a time on the
host, takes its rows and runs ``steps.make_serve_step(tp=, fsdp=)`` for
a few steps that wrap the ring; :func:`decode_cases` (every family, the
kv heads and the head dim cut, the moe family on both routes, gemma2's
window and soft-cap on the head-dim cut) on a CPU world of 4
(:func:`decode_cases_rank`), held against :func:`single_decode` by
:func:`decode_errors`.

  PYTHONPATH=src python -m repro_torch.launch.mesh_check --device cpu \
      --fsdp 2 --model 2 --decode --arch granite-34b --f32
"""
from __future__ import annotations

import argparse
import contextlib
import os
import resource
import threading
import time

import numpy as np
import torch

from ..core import flatbuf, gossip, topology as T
from ..kernels.gossip_mix import ops as gm_ops
from . import mesh as mesh_mod
from . import sharding

__all__ = ["NODES", "FSDP", "WBH_SPECS", "wbh_tree", "static_rounds",
           "engine_rank", "check", "payload_tree", "payload_world",
           "train_rank", "train_world", "train_cases", "warmup_run",
           "gathered_runtime_rank", "gathered_runtime_expected",
           "train_cases_rank", "train_mesh", "every2_logs", "fsdp_cases",
           "fsdp_cases_rank", "reduce_scatter_rank", "family_cases",
           "FAMILY_ARCHS", "case_config", "f32_start", "whole_leaves",
           "TP_MESHES", "TP_FAMILIES", "tp_cases", "tp_regions_rank",
           "tp_grads_rank", "single_run", "tp_cases_rank", "PREFILL_MESH",
           "PREFILL_FAMILIES", "prefill_args", "prefill_config",
           "prefill_batch", "prefill_weights", "prefill_cases",
           "prefill_rank", "prefill_cases_rank", "single_prefill",
           "DECODE_MESH", "DECODE_FAMILIES", "decode_args", "decode_config",
           "decode_batch", "decode_start", "decode_cache", "cache_arrays",
           "cache_tree", "save_leaves", "decode_cases", "decode_rank",
           "decode_cases_rank", "single_decode", "decode_errors", "main"]

NODES, FSDP = 4, 2
WBH_SPECS = {"w": ("node", "fsdp"), "b": ("node",), "h": ("node", "fsdp")}
# the reference test's tolerances for the dense rounds (another
# summation order), by dtype
DENSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DELAYED = ("shifts", "matching", "identity", "grid", "full", "shifts_int8",
           "matching_int8")


def wbh_tree(nodes: int = NODES, seed: int = 0) -> dict:
    """The reference test's tree as numpy f32 (``h`` is cast to bf16 by
    :func:`torch_tree`): w (n, 16, 8), b (n, 6), h (n, 8, 4)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((nodes, 16, 8)).astype(np.float32),
            "b": rng.standard_normal((nodes, 6)).astype(np.float32),
            "h": rng.standard_normal((nodes, 8, 4)).astype(np.float32)}


def torch_tree(tree: dict, device="cpu") -> dict:
    out = {k: torch.from_numpy(v).to(device) for k, v in tree.items()}
    out["h"] = out["h"].to(torch.bfloat16)
    return out


def fixed_matching(n: int) -> T.Matching:
    """Nodes 0 and 1 paired, every other node a fixed point."""
    return T.Matching((1, 0) + tuple(range(2, n)))


def static_rounds(n: int) -> list:
    """(name, realization, compression) of every static round the world
    runs at ``n`` nodes."""
    one_peer = T.one_peer_exponential(n).realization(0)
    m = fixed_matching(n)
    return [("shifts", one_peer, None),
            ("hypercube", T.one_peer_hypercube(n).realization(0), None),
            ("matching", m, None),
            ("static_exp", T.static_exponential(n).realization(0), None),
            ("shifts_int8", one_peer, "int8"),
            ("matching_int8", m, "int8"),
            ("grid", T.grid_2d(n).realization(0), None),
            ("full", T.full_averaging(n).realization(0), None)]


def runtime_inputs(n: int, seed: int = 1) -> dict:
    """The runtime rounds' per-node values: alive flags, a loss column."""
    rng = np.random.default_rng(seed)
    alive = np.ones(n, bool)
    alive[1] = False
    return {"alive": alive,
            "loss": rng.uniform(1.0, 3.0, n).astype(np.float32)}


def edge_weight_torch(own, recv, w):
    """Loss-aware weights: a neighbour with the lower loss pulls harder."""
    return torch.as_tensor(w, dtype=torch.float32) * torch.where(
        recv[:, 0] < own[:, 0], 1.5, 0.5)


def runtime_rounds(n: int, inputs: dict, rows: slice, device) -> list:
    """(name, callable(tree, **mesh_kw)) of the runtime rounds; per-node
    values are the ``rows`` given (a rank's own)."""
    alive = torch.from_numpy(inputs["alive"][rows]).to(device)
    loss = torch.from_numpy(inputs["loss"][rows]).to(device)
    one_peer = T.one_peer_exponential(n).realization(0)
    m = T.one_peer_hypercube(n).realization(0)
    # nodes 0 and 2 paired, every other node a fixed point (the dead
    # node 1 among them)
    fixed = T.Matching((2, 1, 0) + tuple(range(3, n)))
    return [
        ("gated", lambda t, **kw: gossip.mix_realization(
            t, T.Gated(one_peer, alive), **kw)),
        ("meta", lambda t, **kw: gossip.mix_shifts(
            t, 0.5, list(one_peer.shifts), meta=loss,
            edge_weight=edge_weight_torch, **kw)),
        ("node_gate", lambda t, **kw: gossip.mix_matching(
            t, m.partner, 0.5, node_gate=alive, **kw)),
        ("fixed_meta", lambda t, **kw: gossip.mix_matching(
            t, fixed.partner, 0.5, meta=loss, edge_weight=edge_weight_torch,
            node_gate=alive, **kw)),
    ]


@contextlib.contextmanager
def one_rank_mesh(store_dir, axes: tuple = ("node",)):
    """A live mesh of one rank in this process (a world of 1 through a
    ``file://`` store in ``store_dir``), torn down on exit: every axis of
    extent 1, so a tree of ``n`` nodes takes the gathered global path."""
    import torch.distributed as dist
    mesh_mod.init_world(0, 1, "file://" + os.path.join(
        str(store_dir), f"one-rank-{os.getpid()}-{time.time_ns()}"))
    try:
        yield mesh_mod.make_mesh((1,) * len(axes), axes, device="cpu")
    finally:
        dist.destroy_process_group()


def _np(tree) -> dict:
    return {k: v.detach().float().cpu().numpy() for k, v in tree.items()}


def _bit_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def engine_rank(rank: int, shape: tuple, axes: tuple, device: str,
                backend: str | None, seed: int = 0) -> dict:
    """One rank's share of the world: its blocks of every round's output
    (numpy f32), its wire log and K1 launches a round, and whether each
    delayed pair was bit for bit the synchronous round."""
    if torch.device(device).type == "cuda":
        # gloo: every rank on the one card; nccl: one card a rank
        card = rank % torch.cuda.device_count() if backend == "nccl" else 0
        torch.cuda.set_device(card)
        device = f"cuda:{card}"
    mesh = mesh_mod.make_mesh(shape, axes, backend=backend, device=device)
    n = mesh.axis_size("node")
    full = torch_tree(wbh_tree(n, seed), device)
    local = sharding.local_shard(full, WBH_SPECS, mesh)
    local = {k: v.contiguous() for k, v in local.items()}
    out: dict = {"rank": rank, "coords": dict(mesh.coords),
                 "wire": mesh.wire, "rounds": {}, "delayed": {}}

    def record(name, fn):
        mesh.log.reset()
        k1 = gm_ops.gossip_mix.launches
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        if cuda:
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        out["rounds"][name] = {"out": _np(got), "log": mesh.log.snapshot(),
                               "k1": gm_ops.gossip_mix.launches - k1,
                               "ms": ms}
        return got

    realizations = {}
    for name, r, comp in static_rounds(n):
        realizations[name] = (r, comp)
        record(name, lambda r=r, comp=comp: gossip.mix_realization(
            local, r, compression=comp, mesh=mesh))
    realizations["identity"] = (T.Identity(), None)
    for name in DELAYED:
        r, comp = realizations[name]
        sync = gossip.mix_realization(local, r, compression=comp, mesh=mesh)
        mesh.log.reset()
        bufs = gossip.pack_payload(local, mesh=mesh)
        got = gossip.delayed_mix(local, bufs, r, compression=comp, mesh=mesh)
        # the split halves: the whole wire posted, then waited for
        posted = gossip.delayed_post(local, bufs, r, compression=comp,
                                     mesh=mesh).wait()
        out["delayed"][name] = (_bit_equal(got, sync)
                                and _bit_equal(posted, sync))
    i = mesh.axis_index("node")
    for name, fn in runtime_rounds(n, runtime_inputs(n), slice(i, i + 1),
                                   device):
        record(name, lambda fn=fn: fn(local, mesh=mesh))

    # the gathered global path: two nodes a rank, 2n nodes
    n2 = 2 * n
    full2 = torch_tree(wbh_tree(n2, seed + 1), device)
    block = {k: v[2 * i:2 * i + 2] for k, v in full2.items()}
    local2 = sharding.local_shard(block, {k: (None,) + s[1:] for k, s in
                                          WBH_SPECS.items()}, mesh)
    one_peer8 = T.one_peer_exponential(n2).realization(0)
    for name, r, comp in (("gathered_shifts", one_peer8, None),
                          ("gathered_int8", one_peer8, "int8"),
                          ("gathered_grid", T.grid_2d(n2).realization(0),
                           None)):
        record(name, lambda r=r, comp=comp: gossip.mix_realization(
            local2, r, compression=comp, mesh=mesh))
    return out


def nccl_refusal_rank(rank: int, world: int) -> str | None:
    """Ask for an NCCL mesh with every rank on ``cuda:0``: the message of
    the ValueError ``make_mesh`` raises (None if it does not)."""
    torch.cuda.set_device(0)
    try:
        mesh_mod.make_mesh((world,), ("node",), backend="nccl",
                           device="cuda:0")
    except ValueError as e:
        return str(e)
    return None


def _global(full: dict, name: str, n: int, device) -> dict:
    """The global path's output of round ``name`` on the whole tree, its
    combine the plain version: on the card each rank's K1 is held against
    it on the same inputs."""
    with gossip.kernel_mode("off"):
        return _global_round(full, name, n, device)


def _global_round(full: dict, name: str, n: int, device) -> dict:
    rounds = {nm: (r, c) for nm, r, c in static_rounds(n)}
    if name in rounds:
        r, comp = rounds[name]
        return gossip.mix_realization(full, r, compression=comp)
    if name.startswith("gathered_"):
        n2 = n
        one_peer = T.one_peer_exponential(n2).realization(0)
        r, comp = {"gathered_shifts": (one_peer, None),
                   "gathered_int8": (one_peer, "int8"),
                   "gathered_grid": (T.grid_2d(n2).realization(0), None)}[
                       name]
        return gossip.mix_realization(full, r, compression=comp)
    fn = dict(runtime_rounds(n, runtime_inputs(n), slice(None), device))[name]
    return fn(full)


def _dense(name: str) -> bool:
    return name in ("grid", "full", "gathered_grid")


def expected_blocks(name: str, n: int, seed: int, coords: dict,
                    device="cpu", fsdp: int = FSDP) -> dict:
    """Rank ``coords``' block of the global path's output of ``name``."""
    gathered = name.startswith("gathered_")
    nn = 2 * n if gathered else n
    full = torch_tree(wbh_tree(nn, seed + (1 if gathered else 0)), device)
    got = _global(full, name, nn, device)
    if gathered:
        i = coords["node"]
        got = {k: v[2 * i:2 * i + 2] for k, v in got.items()}
        specs = {k: (None,) + s[1:] for k, s in WBH_SPECS.items()}
    else:
        specs = WBH_SPECS
    mesh = mesh_mod.abstract_mesh((n, fsdp), ("node", "fsdp"))
    return _np(sharding.local_shard(got, specs, mesh, coords))


def wire_expectation(name: str, n: int, fsdp: int = FSDP) -> dict:
    """What one rank's wire log must hold for a static round on the
    (node n, fsdp) world: ``gossip_spec``'s accounting on the local
    layout (``pad_multiple=1``): permutes and bytes, psums for exact
    averaging, never an all-gather."""
    rounds = {nm: (r, c) for nm, r, c in static_rounds(n)}
    r, comp = rounds[name]
    local = {k: torch.zeros((1,) + tuple(v.shape[1:]))
             for k, v in torch_tree(wbh_tree(1)).items()}
    local["w"] = torch.zeros(1, 16 // fsdp, 8)
    local["h"] = torch.zeros(1, 8 // fsdp, 4, dtype=torch.bfloat16)
    layout = flatbuf.layout_of(local, pad_multiple=1)
    top = T.Topology(name, n, realizations=(r,))
    spec = gossip.gossip_spec(top, 0, layout=layout, compression=comp)
    groups = len(layout.groups)
    if isinstance(r, T.Dense):
        W = np.asarray(r.W)
        if np.allclose(W, W[0:1]):
            return {"counts": {"psum": groups}, "bytes": None}
        classes = sum(1 for s in range(1, n) if any(
            W[j, (j - s) % n] for j in range(n)))
        return {"counts": {"permute": classes * groups}, "bytes": None}
    counts = {"permute": spec["collectives_per_step"]}
    if comp == "int8" and fsdp > 1:
        counts["pmax"] = groups
    return {"counts": counts, "bytes": spec["bytes_per_node_per_step"]}


def check(results: list, seed: int = 0, device="cpu",
          shape: tuple = (NODES, FSDP)) -> list:
    """Every rank's blocks against the global path (bit for bit, dense
    rounds within ``DENSE_TOL``), the delayed halves, the K1 launches (one
    per dtype group a static round) and the static rounds' wire logs.
    Returns the failures (empty when all hold)."""
    fails = []
    n, fsdp = shape
    for res in results:
        coords = res["coords"]
        for name, rec in res["rounds"].items():
            want = expected_blocks(name, n, seed, coords, device, fsdp)
            for k, w in want.items():
                g = rec["out"][k]
                if _dense(name):
                    tol = DENSE_TOL[torch.bfloat16 if k == "h"
                                    else torch.float32]
                    if not np.allclose(g, w, rtol=tol, atol=tol * 1e-1):
                        fails.append(f"rank {res['rank']} {name}.{k}: max "
                                     f"diff {np.abs(g - w).max()}")
                elif not np.array_equal(g, w):
                    fails.append(f"rank {res['rank']} {name}.{k} not bit "
                                 f"equal (max diff {np.abs(g - w).max()})")
            if name in dict((nm, 0) for nm, _, _ in static_rounds(n)):
                exp = wire_expectation(name, n, fsdp)
                counts = {k: v["ops"] for k, v in rec["log"].items()}
                if counts != exp["counts"]:
                    fails.append(f"rank {res['rank']} {name}: wire {counts}"
                                 f", expected {exp['counts']}")
                sent = rec["log"].get("permute", {}).get("bytes", 0)
                paired = coords["node"] in (0, 1) or \
                    not name.startswith("matching")
                if exp["bytes"] is not None and paired and \
                        sent != exp["bytes"]:
                    fails.append(f"rank {res['rank']} {name}: sent {sent} "
                                 f"bytes, expected {exp['bytes']}")
                k1 = 0 if (name.endswith("int8") or _dense(name)
                           or device == "cpu") else 2
                if rec["k1"] != k1:
                    fails.append(f"rank {res['rank']} {name}: {rec['k1']} "
                                 f"K1 launches, expected {k1}")
        for name, ok in res["delayed"].items():
            if not ok:
                fails.append(f"rank {res['rank']} delayed {name} differs "
                             "from the synchronous round")
    return fails


# ---------------------------------------------------------------------------
# A large payload on the card, compared in the parent through CUDA IPC
# ---------------------------------------------------------------------------

PAYLOAD_ROUNDS = ("shifts", "matching", "shifts_int8", "grid", "full")


def payload_tree(cfg, n: int, seed: int, device) -> tuple:
    """DmSGD's ``(m, x)`` payload of ``cfg`` over ``n`` nodes in f32, one
    seeded normal draw a leaf on ``device`` (momentum scaled by 1e-2)."""
    shapes = {k: tuple(v.shape[1:])
              for k, v in payload_tree_shapes(cfg, 1)[0].items()}
    parts = []
    for half, scale in enumerate((1e-2, 1.0)):
        part = {}
        for j, (k, shp) in enumerate(shapes.items()):
            gen = torch.Generator(device=device).manual_seed(
                seed * 100_003 + half * 10_007 + j)
            part[k] = torch.randn((n,) + shp, generator=gen,
                                  device=device).mul_(scale)
        parts.append(part)
    return tuple(parts)


def _payload_realizations(n: int) -> dict:
    one_peer = T.one_peer_exponential(n).realization(0)
    return {"shifts": (one_peer, None),
            "matching": (fixed_matching(n), None),
            "shifts_int8": (one_peer, "int8"),
            "grid": (T.grid_2d(n).realization(0), None),
            "full": (T.full_averaging(n).realization(0), None)}


def _packed(tree) -> torch.Tensor:
    bufs = flatbuf.pack(tree, flatbuf.layout_of(tree, pad_multiple=1))[1]
    assert len(bufs) == 1
    return bufs[0]


def payload_rank(rank: int, shape: tuple, axes: tuple, seed: int, outq,
                 goq, device: str = "cuda", engine: bool = False) -> dict:
    """A rank of :func:`payload_world`: with ``engine``, first
    :func:`engine_rank`'s rounds (one spawn serves both); then its block
    of the payload (views of the parent's whole payload, through
    ``goq``, copied), each round on the mesh, the output handed to the
    parent (CUDA IPC) and held until the parent is done with it."""
    small = (engine_rank(rank, shape, axes, device, "gloo", seed)
             if engine else None)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    mesh = mesh_mod.make_mesh(shape, axes, backend="gloo", device=device)
    n = mesh.axis_size("node")
    views = goq.get()
    local = tuple({k: v.clone(memory_format=torch.contiguous_format)
                   for k, v in part.items()} for part in views)
    del views
    if cuda:
        torch.cuda.synchronize()
    rows = {}
    for name, (r, comp) in _payload_realizations(n).items():
        mesh.log.reset()
        k1 = gm_ops.gossip_mix.launches
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = gossip.mix_realization(local, r, compression=comp, mesh=mesh)
        if cuda:
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        packed = _packed(got)
        del got
        if cuda:                 # the round's buffers, before the handoff
            torch.cuda.empty_cache()
        wire_s, stage_s = mesh.log.seconds()
        rows[name] = {"ms": ms, "wire_ms": 1e3 * wire_s,
                      "stage_ms": 1e3 * stage_s,
                      "k1": gm_ops.gossip_mix.launches - k1,
                      "log": mesh.log.snapshot()}
        outq.put((rank, name, packed))
        if goq.get() == "stop":
            raise RuntimeError("the parent stopped comparing")
        del packed
        if cuda:
            torch.cuda.empty_cache()
    return {"rank": rank, "coords": dict(mesh.coords), "wire": mesh.wire,
            "rounds": rows, "engine": small,
            "local_elems": sum(v.numel() for p in local for v in p.values())}


def payload_specs(cfg, n: int, mesh) -> tuple:
    shapes = payload_tree_shapes(cfg, n)
    return sharding.gossip_payload_spec_fn(mesh, cfg=cfg)(shapes)


def payload_tree_shapes(cfg, n: int) -> tuple:
    """``(m, x)`` of meta tensors at the payload's global shapes (the
    model's parameters, never touched on the CPU, give the names)."""
    from ..models import model as M
    part = {k: torch.empty((n,) + tuple(p.shape), device="meta")
            for k, p in M.Model(cfg, device="cpu").named_parameters()}
    return (part, dict(part))


def _payload_config(arch: str, layers: int):
    import dataclasses

    from .. import configs
    cfg = configs.get_config(arch)
    if layers is None:                       # the reduced config
        return configs.reduced_config(cfg)
    return dataclasses.replace(cfg, n_layers=layers)


def payload_world(arch: str, layers: int | None, seed: int = 0,
                  shape: tuple = (NODES, FSDP),
                  axes: tuple = ("node", "fsdp"), timeout: float = 600.0,
                  device: str = "cuda", engine: bool = False,
                  store_dir: str | None = None):
    """The ``(m, x)`` payload of ``arch`` cut to ``layers`` on a world of
    ``prod(shape)`` ranks sharing the card (gloo, staged through host
    memory), each round's blocks compared in this process with the
    global path's: bit for bit for Shifts, Matching and int8, within
    1e-5 for Dense (f32).  ``layers=None`` takes the reduced config, and
    ``device="cpu"`` runs the same exchange on the CPU (shared memory in
    place of CUDA IPC); ``engine`` runs :func:`engine_rank` first on the
    same ranks (its results under ``"engine"``); ``store_dir`` is the
    world's store's directory (:func:`~repro_torch.launch.mesh.spawn`).
    Returns (rank results, comparisons)."""
    import torch.multiprocessing as mp

    cfg = _payload_config(arch, layers)
    cuda = torch.device(device).type == "cuda"
    n = shape[0]
    world = int(np.prod(shape))
    abstract = mesh_mod.abstract_mesh(shape, axes)
    specs = payload_specs(cfg, n, abstract)
    full = payload_tree(cfg, n, seed, device)
    ctx = mp.get_context("spawn")
    outq = ctx.Queue()
    goqs = [ctx.Queue() for _ in range(world)]
    coords = [dict(zip(axes, map(int, np.argwhere(abstract.devices == r)[0])))
              for r in range(world)]
    for r, q in enumerate(goqs):      # each rank's block, as views
        q.put(sharding.local_shard(full, specs, abstract, coords[r]))
    comps: dict = {}
    errors: list = []

    def compare():
        # the ranks' round first, then the global path: their peaks and
        # this process's do not meet on the card
        try:
            for name, (r, comp) in _payload_realizations(n).items():
                got = {}
                for _ in range(world):
                    rank, got_name, out = outq.get(timeout=timeout)
                    assert got_name == name, (got_name, name)
                    got[rank] = out
                # the plain combine: each rank's K1 against its plain
                # version on the same inputs
                with gossip.kernel_mode("off"):
                    want = gossip.mix_realization(full, r, compression=comp)
                rows = {}
                for rank in range(world):
                    exp = _packed(sharding.local_shard(want, specs, abstract,
                                                       coords[rank]))
                    g = got.pop(rank)
                    rows[rank] = (torch.equal(g, exp),
                                  float((g - exp).abs().max()),
                                  torch.allclose(g, exp, rtol=1e-5,
                                                 atol=1e-6))
                    del g, exp
                comps[name] = rows
                del want
                if cuda:
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                for q in goqs:
                    q.put(name)
        except BaseException as e:          # re-raised by the caller
            errors.append(e)
            for q in goqs:
                q.put("stop")

    th = threading.Thread(target=compare, daemon=True)
    th.start()
    try:
        res = mesh_mod.spawn(_payload_entry, world,
                             (shape, axes, seed, outq, goqs,
                              device, engine), timeout=timeout,
                             threads=None if cuda else 1,
                             store_dir=store_dir)
    finally:
        th.join(timeout=60)
    if errors:
        raise errors[0]
    return res, comps


def _payload_entry(rank, shape, axes, seed, outq, goqs,
                   device, engine):
    return payload_rank(rank, shape, axes, seed, outq,
                        goqs[rank], device, engine)


# ---------------------------------------------------------------------------
# Training on a node mesh: one rank per node
# ---------------------------------------------------------------------------

def case_config(args, replace: dict | None = None):
    """``launch.train.config_of(args)``, with ``replace``'s fields
    replaced (a config the driver's flags cannot name: fewer experts)."""
    import dataclasses

    from . import train as train_mod
    cfg = train_mod.config_of(args)
    return dataclasses.replace(cfg, **replace) if replace else cfg


def f32_start(args, tokens=None, node=None, mesh=None,
              replace: dict | None = None, f32_state: bool = False):
    """``launch.train.prepare(args, tokens, node, mesh=mesh)`` with f32
    activations (and :func:`case_config`'s ``replace``); ``f32_state``:
    the momentum in the params' dtype too, not the layout's (bf16 for
    some archs, whose rounding a reordered f32 sum can flip by an ulp)."""
    import dataclasses

    from . import train as train_mod
    start = train_mod.prepare(args, tokens, node, mesh=mesh,
                              config=case_config(args, replace))
    if f32_state:
        start["momentum_dtype"] = None
    start["config"] = dataclasses.replace(start["config"],
                                          activation_dtype=torch.float32)
    return start


TRAIN_AXES = ("node", "fsdp", "model")


def train_mesh(args, shape=None, axes=("node",)):
    """The live mesh a training rank runs on: ``shape`` (default
    ``(--nodes,)``) on ``axes``, gloo; on the card every rank on
    ``cuda:0``, staged through host memory."""
    return mesh_mod.make_mesh(shape or (args.nodes,), axes, backend="gloo",
                              device=args.device)


def _shard_specs(args, mesh, replace: dict | None = None):
    """``node_param_specs`` of the run's config on ``mesh``, or None on a
    mesh without fsdp or model shards."""
    from . import train as train_mod
    if not train_mod.is_sharded(mesh):
        return None
    return sharding.node_param_specs(case_config(args, replace), args.nodes,
                                     mesh)


def whole_leaves(tree: dict, specs: dict, mesh) -> dict:
    """A rank's shards of its node's leaves gathered whole over fsdp, then
    model, on every rank."""
    for axis in ("fsdp", "model"):
        if mesh.shape.get(axis, 1) > 1:
            tree = sharding.gather_axis(tree, specs, mesh, axis)
    return tree


def _release_host() -> None:
    """Free the pinned host blocks an earlier run's gloo-host staging left
    cached (the host allocator keeps each, rounded up to a power of two,
    until asked): 8 ranks' of them filled the host's memory."""
    release = getattr(torch._C, "_host_emptyCache", None)
    if release is not None:
        release()


def train_rank(rank: int, argv: list, outq=None, goq=None,
               f32: bool = False, tokens=None, keep: bool = True,
               tag=None, shape=None, axes=("node",),
               replace: dict | None = None, f32_state: bool = False) -> dict:
    """A rank of a training world: ``launch.train.run(args, mesh=...)`` on
    :func:`train_mesh` ``(args, shape, axes)`` -- by default a
    ``("node",)`` mesh of ``--nodes`` ranks.  Returns the history, the
    step seconds, the run's seconds from its start (``seconds``), the
    peak memory, the K1 launches, the wire log, the elements of the
    rank's params (``param_elems``) and the rows of its batches
    (``rows``); the final params and
    momentum come back as numpy (``outq`` None; dropped unless ``keep``;
    on an fsdp or model mesh the node's whole leaves, gathered) or,
    packed on the card, the rank's own block of ``(momentum, params)``
    through ``outq`` (CUDA IPC) as ``(rank, tag, packed)``, held until
    ``goq`` says the parent is done with them.  ``f32``: f32 activations
    (:func:`f32_start`); ``tokens``: the batches' tokens, as the parent
    sampled them (``launch.train.prepare``); ``replace``, ``f32_state``:
    :func:`f32_start`'s (f32 runs only)."""
    from . import train as train_mod
    args = train_mod.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        torch.cuda.set_device(0)
        torch.cuda.empty_cache()
        _release_host()
        torch.cuda.reset_peak_memory_stats()
    mesh = train_mesh(args, shape, axes)
    k1 = gm_ops.gossip_mix.launches
    t0 = time.perf_counter()
    node = mesh.axis_index("node")
    start = (f32_start(args, tokens, node, mesh, replace, f32_state) if f32
             else train_mod.prepare(args, tokens, node, mesh=mesh))
    rows = int(start["batches"][0]["tokens"].shape[1])
    res = train_mod.run(args, mesh=mesh, start=start)
    del start
    x, m = res["params"], res["state"].momentum
    out = {"rank": rank, "coords": dict(mesh.coords), "wire": mesh.wire,
           "rows": rows, "seconds": time.perf_counter() - t0,
           "history": res["history"], "step_s": res["step_s"],
           "k1": gm_ops.gossip_mix.launches - k1,
           "num_compiled": res["plan"].num_compiled,
           "log": mesh.log.snapshot(),
           "param_elems": {k: v.numel() for k, v in x.items()}}
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if outq is None:
        if keep:
            specs = _shard_specs(args, mesh, replace)
            if specs is not None:
                x, m = whole_leaves(x, specs, mesh), whole_leaves(m, specs,
                                                                  mesh)
            out["params"], out["momentum"] = _np(x), _np(m)
        return out
    del res
    packed = _packed((m, x))
    del x, m
    if torch.device(args.device).type == "cuda":
        torch.cuda.empty_cache()
    outq.put((rank, tag, packed))
    if goq.get() == "stop":
        raise RuntimeError("the parent stopped comparing")
    del packed
    return out


def every2_logs(argv: list, shape=None, axes=("node",), f32: bool = True,
                tokens=None) -> list:
    """The reference's differential wire check on a training mesh: two
    steps of ``argv``'s trainer through its plan with ``every=2``
    (``dataclasses.replace(plan, every=2)``), so step 0 realizes the
    topology's round and step 1 ``Identity`` -- the same step with no
    gossip.  Returns each step's wire log (``Mesh.log.snapshot()``)."""
    import dataclasses

    from . import train as train_mod
    args = train_mod.parse_args(argv)
    mesh = train_mesh(args, shape, axes)
    node = mesh.axis_index("node")
    start = (f32_start(args, tokens, node, mesh) if f32 else
             train_mod.prepare(args, tokens, node, mesh=mesh))
    opt, step_for = train_mod.build_trainer(
        start["config"], start["topology"], args.optimizer, args.beta,
        args.micro_batch, momentum_dtype=start["momentum_dtype"],
        compression=args.compression, mesh=mesh, batch=args.batch)
    plan = dataclasses.replace(step_for.plan, every=2)
    p = start["params"]
    s = opt.init(p)
    logs = []
    for k in range(2):
        mesh.log.reset()
        p, s, _ = plan.step_fn(k)(p, s, start["batches"][k],
                                  start["lr_fn"](k))
        logs.append(mesh.log.snapshot())
    return logs


# ---------------------------------------------------------------------------
# Every flag of launch.train on a node mesh; runtime rounds with several
# nodes a rank
# ---------------------------------------------------------------------------

def train_cases(argv: list, ckpt_dir: str | None = None) -> dict:
    """``{name: argv}`` of the node-mesh training cases beyond plain dmsgd:
    the overlapped trainer (its carry-buffer checkpoints under
    ``ckpt_dir/overlap``), the overlapped trainer under int8 (its
    flush-on-save checkpoints under ``ckpt_dir/overlap_int8``) and
    ``parallel_msgd``; a checkpoint at every second step."""
    def ck(name, *flags):
        if ckpt_dir is None:
            return []
        return ["--ckpt-dir", os.path.join(ckpt_dir, name), "--ckpt-every",
                "2", *flags]

    return {"overlap": argv + ["--overlap"] + ck("overlap"),
            "overlap_int8": argv + ["--overlap", "--compression", "int8"]
            + ck("overlap_int8", "--ckpt-flush"),
            "parallel_msgd": argv + ["--optimizer", "parallel_msgd"]}


def warmup_run(args, warmup_steps: int, mesh=None, start=None) -> dict:
    """``args``' steps through ``launch.train.build_trainer(warmup_steps=)``
    (the driver has no warm-up flag; nor has the reference's), in f32
    (:func:`f32_start`) unless ``start`` is given: every step's node-mean
    loss and plan key, the final params and momentum (on a mesh the
    rank's node)."""
    from . import train as train_mod
    node = None if mesh is None else mesh.axis_index("node")
    start = f32_start(args, node=node, mesh=mesh) if start is None else start
    opt, step_for = train_mod.build_trainer(
        start["config"], start["topology"], args.optimizer, args.beta,
        momentum_dtype=start["momentum_dtype"], warmup_steps=warmup_steps,
        mesh=mesh, batch=args.batch)
    p = start["params"]
    s = opt.init(p)
    losses = []
    for k in range(args.steps):
        p, s, loss = step_for(k)(p, s, start["batches"][k],
                                 start["lr_fn"](k))
        if mesh is not None:
            loss = mesh.psum(loss.reshape(1).float(), "node")[0] / args.nodes
        losses.append(float(loss))
    return {"losses": losses, "params": p, "momentum": s.momentum,
            "keys": [step_for.plan.realization_key(k)
                     for k in range(args.steps)]}


def gathered_runtime_rank(rank: int, shape: tuple = (2, 2), nodes: int = 4,
                          device: str = "cpu", seed: int = 0) -> dict:
    """Runtime rounds with ``nodes // shape[0]`` nodes a rank: on a (node,
    fsdp) mesh each rank holds the rows of its node coordinate of a
    ``nodes``-node {w, b, h} tree (w and h cut over fsdp) and mixes them
    through every :func:`runtime_rounds` round, its per-node values its
    own rows.  Returns its blocks (numpy f32) and its wire log."""
    mesh = mesh_mod.make_mesh(shape, ("node", "fsdp"), backend="gloo",
                              device=device)
    L = nodes // shape[0]
    i = mesh.axis_index("node")
    rows = slice(L * i, (i + 1) * L)
    block = {k: v[rows] for k, v in torch_tree(wbh_tree(nodes, seed),
                                               device).items()}
    local = {k: v.contiguous() for k, v in
             sharding.local_shard(block, _ROW_SPECS, mesh).items()}
    out = {name: _np(fn(local, mesh=mesh)) for name, fn in runtime_rounds(
        nodes, runtime_inputs(nodes), rows, device)}
    return {"coords": dict(mesh.coords), "rounds": out,
            "log": mesh.log.snapshot()}


_ROW_SPECS = {k: (None,) + s[1:] for k, s in WBH_SPECS.items()}


def gathered_runtime_expected(coords: dict, shape: tuple = (2, 2),
                              nodes: int = 4, device: str = "cpu",
                              seed: int = 0) -> dict:
    """Rank ``coords``' blocks of :func:`gathered_runtime_rank`'s rounds
    on the single-process global path."""
    L = nodes // shape[0]
    i = coords["node"]
    mesh = mesh_mod.abstract_mesh(shape, ("node", "fsdp"))
    full = torch_tree(wbh_tree(nodes, seed), device)
    out = {}
    for name, fn in runtime_rounds(nodes, runtime_inputs(nodes),
                                   slice(None), device):
        got = {k: v[L * i:(i + 1) * L] for k, v in fn(full).items()}
        out[name] = _np(sharding.local_shard(got, _ROW_SPECS, mesh, coords))
    return out


def train_cases_rank(rank: int, argv: list, ckpt_dir: str) -> dict:
    """A rank of a 4-rank CPU world: every :func:`train_cases` case
    through :func:`train_rank` in f32 on a (node 4) mesh, then
    :func:`warmup_run` with one warm-up step on such a mesh, then
    :func:`gathered_runtime_rank` on a (node 2, fsdp 2) mesh."""
    from . import train as train_mod
    out = {name: train_rank(rank, a, f32=True)
           for name, a in train_cases(argv, ckpt_dir).items()}
    args = train_mod.parse_args(argv)
    mesh = mesh_mod.make_mesh((args.nodes,), ("node",), device=args.device)
    w = warmup_run(args, 1, mesh)
    out["warmup"] = dict(w, params=_np(w["params"]),
                         momentum=_np(w["momentum"]),
                         log=mesh.log.snapshot())
    out["runtime"] = gathered_runtime_rank(rank, device=args.device)
    return out


# ---------------------------------------------------------------------------
# fsdp-sharded training: a node's leaves over its fsdp ranks
# ---------------------------------------------------------------------------

FSDP_MESH = ((NODES, FSDP, 1), TRAIN_AXES)      # the reference tests' mesh
FSDP_MESH_2AX = ((NODES, FSDP), ("node", "fsdp"))  # embed replicated
FSDP4_MESH = ((2, 4, 1), TRAIN_AXES)             # node 2, fsdp 4
MOE_ARCH = "granite-moe-3b-a800m"


def fsdp_cases(argv: list, ckpt_dir: str | None = None) -> dict:
    """``{name: (argv, mesh shape, axes)}`` of the fsdp training cases, on
    the (node 4, fsdp 2, model 1) mesh unless named: ``dmsgd`` (with
    ``--micro-batch 1`` over a batch of 4), ``overlap_int8`` (its
    carry-buffer checkpoints under ``ckpt_dir/overlap_int8``, a save at
    every second step), ``parallel_msgd``, ``runtime`` (``--loss-aware
    --deadline-skip --straggler-prob 0.25`` on the (node 4, fsdp 2) mesh,
    where ``embed`` is replicated over fsdp), and the moe family (its
    router replicated, its rows split over fsdp; 2 steps): ``moe`` (a
    batch of 2, one row a rank: the routing group, the node's batch,
    spans both ranks, G = 2 = F), ``moe_g1`` (micro-batches of 2 over a
    batch of 4: each rank's two rows are one whole group, G = 1) and
    ``moe_g2f4`` (the same batch on (node 2, fsdp 4, model 1): a group
    spans 2 of the 4 ranks, two groups side by side)."""
    def ck(name):
        if ckpt_dir is None:
            return []
        return ["--ckpt-dir", os.path.join(ckpt_dir, name), "--ckpt-every",
                "2"]

    return {
        "dmsgd": (argv + ["--batch", "4", "--micro-batch", "1"],
                  *FSDP_MESH),
        "overlap_int8": (argv + ["--overlap", "--compression", "int8"]
                         + ck("overlap_int8"), *FSDP_MESH),
        "parallel_msgd": (argv + ["--optimizer", "parallel_msgd"],
                          *FSDP_MESH),
        "runtime": (argv + ["--loss-aware", "--deadline-skip",
                            "--straggler-prob", "0.25"], *FSDP_MESH_2AX),
        "moe": (argv + ["--arch", MOE_ARCH, "--steps", "2"], *FSDP_MESH),
        "moe_g1": (argv + ["--arch", MOE_ARCH, "--steps", "2", "--batch",
                           "4", "--micro-batch", "2"], *FSDP_MESH),
        "moe_g2f4": (argv + ["--arch", MOE_ARCH, "--steps", "2", "--nodes",
                             "2", "--batch", "4", "--micro-batch", "2"],
                     *FSDP4_MESH),
    }


def moe_route_ops(cfg, passes: int) -> dict:
    """The wire log's ``"moe"`` scope (``launch.moe_group``) after
    ``passes`` moe layer passes routed over a group spread over fsdp
    ranks (layers x micro-steps): each forward's all_gather of the counts,
    psum of the probability sums, reduce_scatter of the slots and
    all_gather of the outputs -- twice under ``cfg.remat``, whose
    recompute issues them again -- and each backward's psum, all_gather
    (the reduce-scatter's) and reduce_scatter (the all-gather's)."""
    fwd = 2 if cfg.remat else 1
    return {"moe:all_gather": (2 * fwd + 1) * passes,
            "moe:psum": (fwd + 1) * passes,
            "moe:reduce_scatter": (fwd + 1) * passes}


# the families fsdp_cases leaves out: ssm, hybrid, audio, vlm
FAMILY_ARCHS = ("mamba2-1.3b", "zamba2-1.2b", "musicgen-large",
                "llama-3.2-vision-90b")


def family_cases(argv: list) -> dict:
    """``{arch: (argv, mesh shape, axes)}``: dmsgd, 2 steps, of each of
    :data:`FAMILY_ARCHS` on the (node 4, fsdp 2, model 1) mesh."""
    return {a: (argv + ["--arch", a, "--steps", "2"], *FSDP_MESH)
            for a in FAMILY_ARCHS}


def reduce_scatter_rank(mesh, seed: int = 5) -> tuple:
    """``Mesh.reduce_scatter`` over fsdp of a seeded (2F, 3) f32 tensor on
    dim 0 and of its transpose on dim 1: (the two blocks as numpy, the
    wire log)."""
    fs = mesh.axis_size("fsdp")
    x = torch.from_numpy(np.random.default_rng(
        seed + mesh.rank).standard_normal((2 * fs, 3)).astype(np.float32))
    mesh.log.reset()
    a = mesh.reduce_scatter(x, "fsdp")
    b = mesh.reduce_scatter(x.t().contiguous(), "fsdp", dim=1)
    return a.numpy(), b.numpy(), mesh.log.snapshot()


def fsdp_cases_rank(rank: int, argv: list, ckpt_dir: str) -> dict:
    """A rank of a CPU world of 8: every :func:`fsdp_cases` and
    :func:`family_cases` case through :func:`train_rank` in f32, then :func:`every2_logs` of ``argv``'s
    dmsgd on the 3-axis mesh (``"every2"``) and
    :func:`reduce_scatter_rank` on it (``"reduce_scatter"``)."""
    cases = dict(fsdp_cases(argv, ckpt_dir), **family_cases(argv))
    out = {name: train_rank(rank, a, f32=True, shape=shape, axes=axes)
           for name, (a, shape, axes) in cases.items()}
    out["every2"] = every2_logs(argv, *FSDP_MESH)
    mesh = mesh_mod.make_mesh(*FSDP_MESH, device="cpu")
    out["reduce_scatter"] = reduce_scatter_rank(mesh)
    return out


# ---------------------------------------------------------------------------
# model-sharded (tensor-parallel) training: a node's leaves over its
# (fsdp, model) ranks
# ---------------------------------------------------------------------------

TP_MESHES = {"j": ((2, 2, 2), TRAIN_AXES),       # node 2, fsdp 2, model 2
             "k": ((4, 1, 2), TRAIN_AXES)}       # node 4, fsdp 1, model 2
# (case, arch, config fields replaced, meshes): every family beyond dense
# on both meshes -- moe expert-parallel (E 4 over model 2) on both, on
# the ff dim (E 3 does not split over model 2, remat on) on j, whose rows
# split over fsdp 2 (the routing group spans both ranks) -- and one kv
# head
TP_FAMILIES = (("moe", MOE_ARCH, None, "jk"),
               ("moe_e3", MOE_ARCH, {"n_experts": 3, "remat": True}, "j"),
               ("kv1", "granite-34b", None, "k"),
               ("ssm", "mamba2-1.3b", None, "jk"),
               ("hybrid", "zamba2-1.2b", None, "jk"),
               ("audio", "musicgen-large", None, "jk"),
               ("vlm", "llama-3.2-vision-90b", None, "jk"))


def tp_cases(argv: list, ckpt_dir: str | None = None) -> dict:
    """``{name: (argv, mesh shape, axes, replace)}`` of the model-sharded
    training cases (qwen3 unless named): ``dmsgd_j`` on (node 2, fsdp 2,
    model 2) with micro-batches of 1 over a batch of 4 and remat on;
    ``dmsgd_k`` on (node 4, fsdp 1, model 2) at 3 layers (the dense MLP
    cut on its ff dim: 3 layers do not split over model 2);
    ``overlap_int8`` on k, 3 steps, its carry-buffer checkpoints under
    ``ckpt_dir/overlap_int8``; ``parallel_msgd`` and ``runtime``
    (``--loss-aware --deadline-skip --straggler-prob 0.25``) on j; then
    each of :data:`TP_FAMILIES` on its meshes (``{case}_{j|k}``)."""
    def nodes(shape):
        return ["--nodes", str(shape[0])]

    ck = ([] if ckpt_dir is None else
          ["--ckpt-dir", os.path.join(ckpt_dir, "overlap_int8"),
           "--ckpt-every", "2"])
    J, K = TP_MESHES["j"], TP_MESHES["k"]
    cases = {
        "dmsgd_j": (argv + nodes(J[0]) + ["--batch", "4", "--micro-batch",
                                          "1"], *J, {"remat": True}),
        "dmsgd_k": (argv + nodes(K[0]) + ["--layers", "3"], *K, None),
        "overlap_int8": (argv + nodes(K[0]) + [
            "--overlap", "--compression", "int8", "--steps", "3"] + ck, *K,
            None),
        "parallel_msgd": (argv + nodes(J[0]) + ["--optimizer",
                                                "parallel_msgd"], *J, None),
        "runtime": (argv + nodes(J[0]) + [
            "--loss-aware", "--deadline-skip", "--straggler-prob", "0.25"],
            *J, None),
    }
    for name, arch, rep, tags in TP_FAMILIES:
        for tag in tags:
            mesh = TP_MESHES[tag]
            cases[f"{name}_{tag}"] = (argv + nodes(mesh[0])
                                      + ["--arch", arch], *mesh, rep)
    return cases


def tp_regions_rank(mesh, seed: int = 7) -> dict:
    """The four region ops and the vocab-parallel CE of ``launch.tp`` on
    the rank's model line, forward and backward, on seeded inputs: a
    tensor alike on every rank (``x``, numpy seed ``seed``) or the
    rank's own (seed ``seed + 1 + m`` at model coordinate m), and
    upstream gradients alike or the rank's own (seeds ``seed + 10`` and
    ``seed + 11 + m``).  Returns ``{op: (output, input gradient)}`` as
    numpy, and ``"ce"``: the loss and the gradient of the rank's logits
    block of seeded (2, 5, 8) logits against seeded labels."""
    from .tp import TP
    tp = TP(mesh, {})
    m, M = tp.rank, tp.size

    def arr(s, shape):
        return torch.from_numpy(np.random.default_rng(s).standard_normal(
            shape).astype(np.float32))

    def run(fn, x, g):
        a = x.clone().requires_grad_(True)
        y = fn(a)
        y.backward(g)
        return y.detach().numpy(), a.grad.numpy()

    same, own = arr(seed, (3, 4 * M)), arr(seed + 1 + m, (3, 4 * M))
    out = {
        "copy_to": run(tp.copy_to, same, arr(seed + 11 + m, (3, 4 * M))),
        "reduce_from": run(tp.reduce_from, own, arr(seed + 10, (3, 4 * M))),
        "gather_from": run(lambda a: tp.gather_from(a, 1), own,
                           arr(seed + 10, (3, 4 * M * M))),
        "gather_partial": run(lambda a: tp.gather_from(a, 1, partial=True),
                              own, arr(seed + 11 + m, (3, 4 * M * M))),
        "scatter_to": run(lambda a: tp.scatter_to(a, 1), same,
                          arr(seed + 11 + m, (3, 4))),
    }
    logits = arr(seed + 20, (2, 5, 8))
    labels = torch.from_numpy(np.random.default_rng(seed + 21).integers(
        0, 8, (2, 5)))
    V = 8 // M
    block = logits[..., m * V:(m + 1) * V].clone().requires_grad_(True)
    loss = tp.vocab_ce(block, labels)
    loss.backward()
    out["ce"] = (float(loss.detach()), block.grad.numpy())
    return out


def tp_grads_rank(mesh, argv: list) -> dict:
    """One pass's gradients (``steps.loss_and_grads`` under ``launch.tp``)
    of qwen3 ``argv`` on the rank's (fsdp-gathered) model shards of its
    node, first batch, f32: ``{leaf: gradient}`` of the leaves replicated
    over model, as numpy -- each rank of a model line should hold the
    same."""
    from . import steps as steps_mod
    from . import train as train_mod
    from .tp import TP
    args = train_mod.parse_args(argv)
    start = f32_start(args, node=mesh.axis_index("node"), mesh=mesh)
    specs = sharding.node_param_specs(start["config"], args.nodes, mesh)
    p = start["params"]
    if mesh.shape["fsdp"] > 1:
        p = sharding.fsdp_gather(p, specs, mesh)
    tp = TP(mesh, specs)
    _, g = steps_mod.loss_and_grads(
        start["config"], {k: v[0] for k, v in p.items()},
        start["batches"][0]["tokens"][0], tp=tp)
    return {k: v.numpy() for k, v in g.items() if tp.dims[k] is None}


def single_run(argv: list, replace: dict | None = None) -> dict:
    """``argv``'s run in this process, no mesh, f32 (activations and
    momentum, :func:`f32_start`): the logged losses and consensus, and
    the final params and momentum of every node, as numpy."""
    from . import train as train_mod
    args = train_mod.parse_args(argv)
    res = train_mod.run(args, start=f32_start(args, replace=replace,
                                              f32_state=True))
    return {"losses": [h["loss"] for h in res["history"]],
            "consensus": [h["consensus"] for h in res["history"]],
            "params": _np(res["params"]),
            "momentum": _np(res["state"].momentum)}


def tp_cases_rank(rank: int, argv: list, ckpt_dir: str,
                  single_dir: str | None = None) -> dict:
    """A rank of a CPU world of 8: every :func:`tp_cases` case through
    :func:`train_rank` in f32 (the momentum too), then
    :func:`tp_regions_rank` and :func:`tp_grads_rank` on the (node 2,
    fsdp 2, model 2) mesh; then, with ``single_dir``, its share of the
    cases' :func:`single_run` (every world-th case, ``"single"``), their
    checkpoints under ``single_dir``."""
    out = {name: train_rank(rank, a, f32=True, shape=shape, axes=axes,
                            replace=rep, f32_state=True)
           for name, (a, shape, axes, rep) in tp_cases(argv,
                                                       ckpt_dir).items()}
    mesh = mesh_mod.make_mesh(*TP_MESHES["j"], device="cpu")
    out["coords"] = dict(mesh.coords)
    out["regions"] = tp_regions_rank(mesh)
    out["grads"] = tp_grads_rank(mesh, tp_cases(argv)["dmsgd_j"][0])
    if single_dir is not None:
        cases = list(tp_cases(argv, single_dir).items())
        out["single"] = {name: single_run(a, rep) for name, (a, _, _, rep)
                         in cases[rank::mesh.size]}
    return out


# ---------------------------------------------------------------------------
# model-sharded prefill: a replica's rows over its (fsdp, model) ranks
# ---------------------------------------------------------------------------

PREFILL_MESH = ((1, 2, 2), TRAIN_AXES)          # node 1, fsdp 2, model 2
# (case, arch, config fields replaced, extra flags): every family at its
# reduced config -- moe expert-parallel (E 4 over model 2) and on the ff
# dim (E 3) -- one kv head, and qwen3 through the flash-attention kernel
PREFILL_FAMILIES = (("dense", "qwen3-0.6b", None, []),
                    ("dense_pallas", "qwen3-0.6b", None,
                     ["--impl", "pallas"]),
                    ("moe", MOE_ARCH, None, []),
                    ("moe_e3", MOE_ARCH, {"n_experts": 3}, []),
                    ("kv1", "granite-34b", None, []),
                    ("ssm", "mamba2-1.3b", None, []),
                    ("hybrid", "zamba2-1.2b", None, []),
                    ("audio", "musicgen-large", None, []),
                    ("vlm", "llama-3.2-vision-90b", None, []))


def prefill_args(argv: list) -> argparse.Namespace:
    """The flags of a model-sharded prefill case: ``--arch``, reduced
    unless ``--full``, ``--layers``, the global ``--batch`` of ``--seq``
    tokens, ``--seed`` (weights, tokens and images), ``--impl``
    (``attention_impl``), ``--f32`` (f32 activations), ``--repeat``
    (timed calls after the first), ``--device``."""
    ap = argparse.ArgumentParser(prog="mesh_check --prefill")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", default="jnp", choices=["jnp", "pallas"])
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--repeat", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def prefill_config(args, replace: dict | None = None):
    """The model config of :func:`prefill_args` ``args`` (``replace``:
    fields a flag cannot name)."""
    import dataclasses

    from .. import configs
    cfg = configs.get_config(args.arch)
    if not args.full:
        cfg = configs.reduced_config(cfg)
    upd = dict(replace or {})
    if getattr(args, "impl", None):
        upd["attention_impl"] = args.impl
    if args.layers:
        upd["n_layers"] = args.layers
    if args.f32:
        upd["activation_dtype"] = torch.float32
    return dataclasses.replace(cfg, **upd)


def prefill_batch(cfg, args) -> dict:
    """The global batch on the CPU from ``args.seed``: ``tokens`` (B, S)
    int64 (audio (B, S, K)), and for the vlm family ``image_embeds`` (B,
    T, d) standard normal in f32."""
    rng = np.random.default_rng(args.seed + 1)
    shape = (args.batch, args.seq) + ((cfg.n_codebooks,)
                                      if cfg.family == "audio" else ())
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                   shape))}
    if cfg.family == "vlm":
        out["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.n_image_tokens, cfg.d_model)).astype(
                np.float32))
    return out


def prefill_weights(cfg, seed: int, device) -> dict:
    """``{name: tensor}`` of ``models.model.init(cfg, seed)`` on
    ``device``: what every rank and the single-process reference draw."""
    from ..models import model as M
    return {k: v.detach() for k, v in
            M.init(cfg, seed, device=device).named_parameters()}


def prefill_cases(argv: list) -> dict:
    """``{name: (argv, config fields replaced)}`` of the model-sharded
    prefill cases, one a :data:`PREFILL_FAMILIES` entry."""
    return {name: (argv + ["--arch", arch] + extra, rep)
            for name, arch, rep, extra in PREFILL_FAMILIES}


def prefill_rank(rank: int, argv: list, replace: dict | None = None,
                 weights=None, shape=None) -> dict:
    """A rank of a replica's model-sharded prefill on a (node, fsdp,
    model) mesh of ``shape`` (default :data:`PREFILL_MESH`'s), gloo: the
    weights cut to the rank's (fsdp, model) shards by
    ``sharding.param_specs(node_axis=False)`` (``sharding.local_shard``),
    its rows of :func:`prefill_batch` (``sharding.batch_block``), and
    ``steps.make_prefill_step(tp=, fsdp=)`` on them once, the wire log
    and the K2 / K4 launches (their counts set to 0 just before it) read
    just after it.  Then ``--repeat`` timed calls.  ``weights``:
    ``{name: array}`` or the path of an ``.npz`` of them (a world's
    arguments are pickled to each rank as it starts, one after another,
    so large ones go by file), else :func:`prefill_weights`.  Returns
    the rank's coordinates, the global indices of its rows, its last
    logits gathered whole over model (as numpy, f32; the gather after
    the log is read), the wire log, the launches, the first call's and
    the timed calls' seconds, the process's peak host memory, and on
    the card the peak memory."""
    from ..kernels.flash_attention import ops as fa_ops
    from ..kernels.ssd_scan import ops as ssd_ops
    from . import steps as steps_mod
    from .tp import TP
    args = prefill_args(argv)
    cfg = prefill_config(args, replace)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    mesh = mesh_mod.make_mesh(*(PREFILL_MESH if shape is None
                                else (shape, TRAIN_AXES)),
                              backend="gloo", device=dev)
    if isinstance(weights, (str, os.PathLike)):
        weights = dict(np.load(weights))
    full = (prefill_weights(cfg, args.seed, dev) if weights is None
            else {k: torch.as_tensor(v).to(dev) for k, v in weights.items()})
    specs = sharding.param_specs(full, mesh, cfg=cfg, node_axis=False)
    params = {k: v.contiguous() for k, v in
              sharding.local_shard(full, specs, mesh).items()}
    del full
    batch = prefill_batch(cfg, args)
    batch["rows"] = torch.arange(args.batch)
    rows = {k: v.to(dev) for k, v in sharding.batch_block(
        batch, mesh, node_axis=False).items()}
    step = steps_mod.make_prefill_step(
        cfg, tp=TP.serving(mesh, specs) if mesh.shape["model"] > 1 else None,
        fsdp=(mesh, specs) if mesh.shape["fsdp"] > 1 else None)

    def call():
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(params, rows)
        if cuda:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    mesh.log.reset()
    fa_ops.flash_attention.launches = ssd_ops.ssd_scan.launches = 0
    logits, first = call()
    launches = {"flash_attention": fa_ops.flash_attention.launches,
                "ssd_scan": ssd_ops.ssd_scan.launches}
    log = mesh.log.snapshot()
    times = [call()[1] for _ in range(args.repeat)]
    if logits.shape[-1] < cfg.vocab_size:        # the rank's vocab block
        logits = mesh.all_gather(logits.contiguous(), "model", dim=-1)
    out = {"rank": rank, "coords": dict(mesh.coords), "wire": mesh.wire,
           "rows": rows["rows"].cpu().numpy(),
           "logits": logits.float().cpu().numpy(), "log": log,
           "launches": launches, "first_s": first, "step_s": times,
           "param_elems": sum(v.numel() for v in params.values()),
           # the process's peak resident memory on the host (Linux: KiB)
           "host_peak_gb": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9}
    if cuda:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def prefill_cases_rank(rank: int, argv: list,
                       weights: dict | None = None) -> dict:
    """A rank of a CPU world of 4: every :func:`prefill_cases` case
    through :func:`prefill_rank` (``weights``: ``{case: weights}`` for
    the cases given theirs)."""
    return {name: prefill_rank(rank, a, rep, (weights or {}).get(name))
            for name, (a, rep) in prefill_cases(argv).items()}


def single_prefill(argv: list, replace: dict | None = None,
                   weights: dict | None = None):
    """The case's prefill in this process, no mesh: the single-process
    ``make_prefill_step`` on the whole batch with the plain attention
    (``attention_impl="jnp"``, what the kernel's path is held against),
    its last logits as numpy f32."""
    import dataclasses

    from . import steps as steps_mod
    from ..models import model as M
    args = prefill_args(argv)
    cfg = dataclasses.replace(prefill_config(args, replace),
                              attention_impl="jnp")
    dev = torch.device(args.device)
    full = (prefill_weights(cfg, args.seed, dev) if weights is None
            else {k: torch.as_tensor(v).to(dev) for k, v in weights.items()})
    batch = {k: v.to(dev) for k, v in prefill_batch(cfg, args).items()}
    return steps_mod.make_prefill_step(cfg)(M.params_view(full), batch
                                            ).float().cpu().numpy()


def _prefill_cli_rank(rank: int, argv: list, shape) -> dict:
    return prefill_rank(rank, argv, shape=shape)


def prefill_cli(argv: list, device: str, fsdp: int | None,
                model: int | None) -> None:
    """:func:`prefill_args`' flags ``argv`` run on a replica of ``fsdp`` x
    ``model`` spawned ranks (each extent 2 unless given), each rank's
    rows' logits held against the single-process plain prefill within
    2e-4 of max-abs; prints each rank's rows, seconds and launches, and
    rank 0's wire log."""
    if "--device" not in argv:
        argv = list(argv) + ["--device", device]
    shape = (1, fsdp or 2, model or 2)
    res = mesh_mod.spawn(_prefill_cli_rank, int(np.prod(shape)),
                         (argv, shape),
                         threads=1 if device == "cpu" else None)
    want = single_prefill(argv)
    scale = float(np.abs(want).max())
    errs = [float(np.abs(r["logits"] - want[r["rows"]]).max())
            for r in res]
    for r, e in zip(res, errs):
        print(f"rank {r['rank']} {r['coords']} ({r['wire']}): rows "
              f"{r['rows'].tolist()}, first call {r['first_s']:.3f} s, "
              f"launches {r['launches']}, max abs diff {e:.3g}")
    print("rank 0 wire (ops, bytes): " + str(
        {k: (v["ops"], v["bytes"]) for k, v in res[0]["log"].items()}))
    tol = 2e-4 * scale
    print(f"{len(res)} ranks: " + ("every rank's logits within "
                                   f"{tol:.3g} of the single process"
                                   if max(errs) <= tol else
                                   f"beyond {tol:.3g}: {errs}"))
    if max(errs) > tol:
        raise SystemExit(1)


# ---------------------------------------------------------------------------
# model-sharded decode: a replica's ring-cache decode over its (fsdp, model)
# ranks, each on its shard of the cache
# ---------------------------------------------------------------------------

DECODE_MESH = PREFILL_MESH                      # node 1, fsdp 2, model 2
# (case, arch, config fields replaced): every family at its reduced
# config -- the kv heads cut (qwen3, musicgen, zamba2's shared_kv), the
# head dim cut (granite-34b's one kv head; gemma2 with one kv head, its
# soft-cap and sliding window on that cut; the vlm cache, whose head dim
# cache_specs tries before its kv heads), the moe family expert-parallel
# (E 4) and on the ff dim (E 3), mamba2's conv on its packed channels
DECODE_FAMILIES = (("dense", "qwen3-0.6b", None),
                   ("kv1", "granite-34b", None),
                   ("gemma2_kv1", "gemma2-27b", {"n_kv_heads": 1}),
                   ("moe", MOE_ARCH, None),
                   ("moe_e3", MOE_ARCH, {"n_experts": 3}),
                   ("ssm", "mamba2-1.3b", None),
                   ("hybrid", "zamba2-1.2b", None),
                   ("audio", "musicgen-large", None),
                   ("vlm", "llama-3.2-vision-90b", None))


def decode_args(argv: list) -> argparse.Namespace:
    """The flags of a model-sharded decode case: ``--arch``, reduced
    unless ``--full``, ``--layers``, the global ``--batch``, the ring's
    ``--cache-len``, ``--prompt`` (P > 0: the cache filled by
    ``launch.serve.prefill_cache`` on a P-token prompt, the decode
    starting at position P; 0: a cache drawn from the seed, the decode
    starting at ``--start``), ``--steps`` decode steps, ``--seed``
    (weights, tokens, images, the drawn cache), ``--f32`` (f32
    activations), ``--repeat`` (timed steps after them), ``--device``."""
    ap = argparse.ArgumentParser(prog="mesh_check --decode")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=80)
    ap.add_argument("--prompt", type=int, default=0)
    ap.add_argument("--start", type=int, default=100)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--repeat", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def decode_config(args, replace: dict | None = None):
    """The model config of :func:`decode_args` ``args``, as
    :func:`prefill_config` makes it."""
    return prefill_config(args, replace)


def decode_batch(cfg, args) -> dict:
    """On the CPU from ``args.seed``: the ``tokens`` fed at the decode
    steps (B, steps) int64 (audio (B, steps, K)), the ``prompt`` (B, P)
    where ``--prompt`` is set, and for the vlm family ``image_embeds``
    (B, T, d) standard normal in f32."""
    rng = np.random.default_rng(args.seed + 1)
    k = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.steps) + k))}
    if args.prompt:
        out["prompt"] = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (args.batch, args.prompt) + k))
    if cfg.family == "vlm":
        out["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.n_image_tokens, cfg.d_model)).astype(
                np.float32))
    return out


def decode_start(args) -> int:
    """The position of the first decode step."""
    return args.prompt or args.start


def cache_arrays(cache: dict) -> dict:
    """A decode cache (``models.model.init_cache``'s tree) as ``{"kv.k":
    tensor, "ssm.conv": ..., ...}``."""
    return {f"{k}.{f}": getattr(v, f) for k, v in cache.items()
            for f in v._fields}


def cache_tree(flat: dict) -> dict:
    """The inverse of :func:`cache_arrays`."""
    from ..models import attention as attn
    from ..models import mamba2 as m2
    kinds = {"kv": attn.KVCache, "shared_kv": attn.KVCache,
             "ssm": m2.SSMCache}
    return {k: cls(*(flat[f"{k}.{f}"] for f in cls._fields))
            for k, cls in kinds.items() if f"{k}.{cls._fields[0]}" in flat}


def decode_cache(cfg, args) -> dict:
    """The global f32 cache a ``--prompt 0`` case starts from, as
    :func:`cache_arrays` of numpy arrays drawn from ``args.seed``:
    standard normal k, v and conv history, the SSM state at half that."""
    from ..models import model as M
    rng = np.random.default_rng(args.seed + 2)
    shapes = cache_arrays(M.init_cache(cfg, args.batch, args.cache_len,
                                       torch.float32, device="meta"))
    return {k: ((0.5 if k == "ssm.state" else 1.0) * rng.standard_normal(
        tuple(v.shape))).astype(np.float32) for k, v in shapes.items()}


def save_leaves(path: str, tree: dict) -> None:
    """``{name: tensor or array}`` as a directory of ``.npy`` files, one a
    leaf, which :func:`decode_rank` maps (read only where a rank's block
    lies) instead of reading whole."""
    os.makedirs(path, exist_ok=True)
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        np.save(os.path.join(path, f"{k}.npy"), v)


def _leaves(src):
    """A ``{name: array}``, the path of an ``.npz`` of them (read a member
    at a time) or of a :func:`save_leaves` directory (each leaf mapped
    copy-on-write)."""
    if not isinstance(src, (str, os.PathLike)):
        return src
    if os.path.isdir(src):
        return {f[:-4]: np.load(os.path.join(src, f), mmap_mode="c")
                for f in os.listdir(src) if f.endswith(".npy")}
    return np.load(src)


def _shards(src, names, specs: dict, mesh, dev) -> dict:
    """The rank's block of each leaf of ``src`` (:func:`_leaves`) by its
    spec, in its own storage on ``dev``: one whole leaf on the host at a
    time, its block alone on the card."""
    src = _leaves(src)
    out = {}
    for k in names:
        whole = torch.as_tensor(src[k])
        out[k] = sharding.local_shard(whole, specs[k], mesh).to(
            dev).contiguous()
        del whole
    return out


def decode_cases(argv: list) -> dict:
    """``{name: (argv, config fields replaced)}`` of the model-sharded
    decode cases, one a :data:`DECODE_FAMILIES` entry."""
    return {name: (argv + ["--arch", arch], rep)
            for name, arch, rep in DECODE_FAMILIES}


def _step_batch(batch: dict, i: int, idx: int) -> dict:
    out = {"token": batch["tokens"][:, i:i + 1], "idx": idx}
    if "image_embeds" in batch:
        out["image_embeds"] = batch["image_embeds"]
    return out


def decode_rank(rank: int, argv: list, replace: dict | None = None,
                weights=None, cache=None, shape=None) -> dict:
    """A rank of a replica's model-sharded decode on a (node, fsdp, model)
    mesh of ``shape`` (default :data:`DECODE_MESH`'s), gloo: its (fsdp,
    model) shards of the serving params
    (``sharding.param_specs(node_axis=False)``), its shard of the cache
    (``sharding.cache_specs``), its rows of :func:`decode_batch`
    (``sharding.batch_block``), each cut from one leaf at a time on the
    host and moved alone to the device; then ``--steps`` steps of
    ``steps.make_serve_step(tp=, fsdp=)`` at positions from
    :func:`decode_start`, the wire log and the kernels' launches (their
    counts set to 0 just before them) read just after them, and
    ``--repeat`` timed steps.  ``weights`` and ``cache``: ``{name:
    array}`` (:func:`cache_arrays` for the cache), the path of an
    ``.npz`` of them or a :func:`save_leaves` directory; else
    :func:`prefill_weights` drawn on the host and :func:`decode_cache`.  Returns the rank's coordinates, its rows, each
    step's logits gathered whole over model (numpy f32, the gather after
    the log is read), its cache shard after the steps (numpy), the wire
    log, the launches, each step's seconds and the call's, the process's
    peak host memory, and on the card the peak memory."""
    from ..kernels.flash_attention import ops as fa_ops
    from ..kernels.paged_attention import ops as pa_ops
    from ..kernels.ssd_scan import ops as ssd_ops
    from ..models import model as M
    from . import steps as steps_mod
    from .tp import TP
    t_all = time.perf_counter()
    args = decode_args(argv)
    cfg = decode_config(args, replace)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(0)
        torch.cuda.empty_cache()
        _release_host()
        torch.cuda.reset_peak_memory_stats()
    mesh = mesh_mod.make_mesh(*(DECODE_MESH if shape is None
                                else (shape, TRAIN_AXES)),
                              backend="gloo", device=dev)
    shapes = dict(M.init(cfg, device="meta").named_parameters())
    specs = sharding.param_specs(shapes, mesh, cfg=cfg, node_axis=False)
    params = _shards(prefill_weights(cfg, args.seed, "cpu")
                     if weights is None else weights, shapes, specs, mesh,
                     dev)
    c_shapes = cache_arrays(M.init_cache(cfg, args.batch, args.cache_len,
                                         torch.float32, device="meta"))
    c_specs = sharding.cache_specs(c_shapes, mesh, args.batch)
    shard = _shards(decode_cache(cfg, args) if cache is None else cache,
                    c_shapes, c_specs, mesh, dev)
    batch = decode_batch(cfg, args)
    batch.pop("prompt", None)
    batch["rows"] = torch.arange(args.batch)
    rows = {k: v.to(dev) for k, v in sharding.batch_block(
        batch, mesh, node_axis=False).items()}
    step = steps_mod.make_serve_step(
        cfg, tp=TP.serving(mesh, specs) if mesh.shape["model"] > 1 else None,
        fsdp=(mesh, specs) if mesh.shape["fsdp"] > 1 else None)
    tree = cache_tree(shard)
    start = decode_start(args)

    def call(i, idx):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = step(params, tree, _step_batch(rows, i, idx))
        if cuda:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    kernels = (fa_ops.flash_attention, pa_ops.paged_attention,
               ssd_ops.ssd_scan, gm_ops.gossip_mix)
    mesh.log.reset()
    for k in kernels:
        k.launches = 0
    got = [call(i, start + i) for i in range(args.steps)]
    launches = {k.__name__: k.launches for k in kernels}
    log = mesh.log.snapshot()
    final = {k: v.cpu().numpy().copy() for k, v in shard.items()}
    times = [t for _, t in got]
    times += [call(args.steps - 1, start + args.steps + j)[1]
              for j in range(args.repeat)]
    logits = []
    for out, _ in got:
        if out.shape[-1] < cfg.vocab_size:       # the rank's vocab block
            out = mesh.all_gather(out.contiguous(), "model", dim=-1)
        logits.append(out.float().cpu().numpy())
    res = {"rank": rank, "coords": dict(mesh.coords), "wire": mesh.wire,
           "rows": rows["rows"].cpu().numpy(), "logits": np.stack(logits),
           "cache": final, "log": log, "launches": launches,
           "step_s": times, "seconds": time.perf_counter() - t_all,
           "param_elems": sum(v.numel() for v in params.values()),
           "cache_bytes": sum(v.nbytes for v in final.values()),
           # the process's peak resident memory on the host (Linux: KiB)
           "host_peak_gb": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9}
    if cuda:
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params, shard, tree
        torch.cuda.empty_cache()
        _release_host()
    return res


def decode_cases_rank(rank: int, argv: list, weights: dict | None = None,
                      caches: dict | None = None) -> dict:
    """A rank of a CPU world of 4: every :func:`decode_cases` case through
    :func:`decode_rank` (``weights`` / ``caches``: ``{case: path}`` for
    the cases given theirs)."""
    return {name: decode_rank(rank, a, rep, (weights or {}).get(name),
                              (caches or {}).get(name))
            for name, (a, rep) in decode_cases(argv).items()}


def single_decode(argv: list, replace: dict | None = None, weights=None,
                  cache=None) -> dict:
    """The case's decode in this process, no mesh: the single-process
    ``make_serve_step`` on the whole batch from the same start (``cache``
    as :func:`decode_rank`'s, or with ``--prompt`` the cache
    ``launch.serve.prefill_cache`` fills).  Returns numpy arrays: the
    ``start`` cache (:func:`cache_arrays`, before the steps), each step's
    ``logits`` (steps, B, ...) in f32 and the ``final`` cache."""
    from ..models import model as M
    from . import serve as serve_mod
    from . import steps as steps_mod
    args = decode_args(argv)
    cfg = decode_config(args, replace)
    dev = torch.device(args.device)
    full = M.params_view(
        prefill_weights(cfg, args.seed, dev) if weights is None else
        {k: torch.as_tensor(v).to(dev)
         for k, v in _leaves(weights).items()})
    batch = {k: v.to(dev) for k, v in decode_batch(cfg, args).items()}
    if args.prompt:
        with torch.no_grad():
            _, tree = serve_mod.prefill_cache(
                cfg, full, batch["prompt"], cache_len=args.cache_len,
                image_embeds=batch.get("image_embeds"))
    else:
        src = _leaves(decode_cache(cfg, args) if cache is None else cache)
        tree = cache_tree({k: torch.as_tensor(src[k]).to(dev)
                           for k in src})
    start = {k: v.cpu().numpy().copy() for k, v in cache_arrays(tree).items()}
    step = steps_mod.make_serve_step(cfg)
    first = decode_start(args)
    logits = [step(full, tree, _step_batch(batch, i, first + i))[0]
              .float().cpu().numpy() for i in range(args.steps)]
    return {"start": start, "logits": np.stack(logits),
            "final": {k: v.cpu().numpy()
                      for k, v in cache_arrays(tree).items()}}


def decode_errors(res: list, want: dict, argv: list, shape=None) -> list:
    """Each rank's ``(logits max abs diff, cache shard max abs diff)``
    against :func:`single_decode`'s ``want``: its rows of every step's
    logits and its block of the final cache (``sharding.local_shard`` by
    ``cache_specs`` at its coordinates on the (node, fsdp, model) mesh of
    ``shape``, default :data:`DECODE_MESH`'s); a shape that differs
    raises."""
    args = decode_args(argv)
    mesh = mesh_mod.abstract_mesh(tuple(shape or DECODE_MESH[0]),
                                  TRAIN_AXES)
    specs = sharding.cache_specs(want["final"], mesh, args.batch)
    out = []
    for r in res:
        lo = want["logits"][:, r["rows"]]
        blk = sharding.local_shard(
            {k: torch.tensor(v) for k, v in want["final"].items()},
            specs, mesh, r["coords"])
        if r["logits"].shape != lo.shape or any(
                r["cache"][k].shape != tuple(v.shape)
                for k, v in blk.items()):
            raise AssertionError(f"rank {r['rank']}: logits "
                                 f"{r['logits'].shape} against {lo.shape}, "
                                 "or a cache shard's shape differs")
        out.append((float(np.abs(r["logits"] - lo).max()),
                    max(float(np.abs(r["cache"][k] - v.numpy()).max())
                        for k, v in blk.items())))
    return out


def _decode_cli_rank(rank: int, argv: list, shape) -> dict:
    return decode_rank(rank, argv, shape=shape)


def decode_cli(argv: list, device: str, fsdp: int | None,
               model: int | None) -> None:
    """:func:`decode_args`' flags ``argv`` run on a replica of ``fsdp`` x
    ``model`` spawned ranks (each extent 2 unless given), each rank's
    logits at every step and its final cache shard held against the
    single-process decode within 2e-4 of max-abs; prints each rank's
    rows, cache shard, median step seconds and errors, and rank 0's wire
    log a step."""
    if "--device" not in argv:
        argv = list(argv) + ["--device", device]
    args = decode_args(argv)
    shape = (1, fsdp or 2, model or 2)
    res = mesh_mod.spawn(_decode_cli_rank, int(np.prod(shape)),
                         (argv, shape),
                         threads=1 if device == "cpu" else None)
    want = single_decode(argv)
    errs = decode_errors(res, want, argv, shape)
    lo = float(np.abs(want["logits"]).max())
    ca = max(float(np.abs(v).max()) for v in want["final"].values())
    for r, (e_lo, e_ca) in zip(res, errs):
        times = sorted(r["step_s"])
        print(f"rank {r['rank']} {r['coords']} ({r['wire']}): rows "
              f"{r['rows'].tolist()}, cache shard "
              f"{ {k: v.shape for k, v in r['cache'].items()} }, median "
              f"step {times[len(times) // 2]:.3f} s, max abs diff logits "
              f"{e_lo:.3g} cache {e_ca:.3g}")
    print(f"rank 0 wire a step (ops, bytes) over {args.steps} steps: " +
          str({k: (v["ops"] / args.steps, v["bytes"] / args.steps)
               for k, v in res[0]["log"].items()}))
    ok = all(e_lo <= 2e-4 * lo and e_ca <= 2e-4 * ca for e_lo, e_ca in errs)
    print(f"{len(res)} ranks: " + (
        f"every rank's logits and cache shard within 2e-4 of max-abs "
        f"({lo:.4g}, {ca:.4g}) of the single process" if ok
        else f"beyond 2e-4 of max-abs ({lo:.4g}, {ca:.4g}): {errs}"))
    if not ok:
        raise SystemExit(1)


ROUNDTRIP_SPECS = {"w": ("node", "fsdp"), "b": (("node", "fsdp"),),
                   "h": ("node", None, "fsdp")}


def roundtrip_tree(seed: int = 3) -> dict:
    """A tree for ``local_shard`` / ``gather`` on a (node 2, fsdp 2) mesh:
    a dim on both axes at once (``b``), a replicated middle dim (``h``)."""
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((2, 16, 8))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((8, 6))
                                  .astype(np.float32)),
            "h": torch.from_numpy(rng.standard_normal((2, 8, 4))
                                  .astype(np.float32)).to(torch.bfloat16)}


def world_rank(rank: int, argv: list) -> dict:
    """A rank of a 4-rank CPU world: ``local_shard`` / ``gather`` round
    trips on a (node 2, fsdp 2) mesh, ``to_logical_mesh`` of a live mesh,
    then :func:`train_rank` in f32 on a (node 4) mesh."""
    m = mesh_mod.make_mesh((2, 2), ("node", "fsdp"), device="cpu")
    full = roundtrip_tree()
    local = sharding.local_shard(full, ROUNDTRIP_SPECS, m)
    back = sharding.gather(local, ROUNDTRIP_SPECS, m)
    flat = mesh_mod.make_mesh((4,), ("data",), device="cpu")
    logical = mesh_mod.to_logical_mesh(flat, nodes=2, fsdp=2, model=1)
    total = logical.psum(torch.tensor([float(rank)]), "node")
    return {"coords": dict(m.coords),
            "shapes": {k: tuple(v.shape) for k, v in local.items()},
            "local": _np(local), "roundtrip": _bit_equal(back, full),
            "logical": (logical.shape, dict(logical.coords),
                        float(total[0]), logical.wire),
            "train": train_rank(rank, argv, f32=True)}


def _train_entry(rank, runs, outq, goqs, tokens, runtime, shape, axes,
                 every2, f32, prefill=None, decode=None):
    out = {"runs": []}
    for i, (argv, held, shp, toks) in enumerate(runs):
        if prefill is not None and i == prefill[1]:
            out["prefill"] = prefill_rank(rank, prefill[0],
                                          shape=prefill[2])
        if decode is not None and i == decode[1]:
            out["decode"] = [decode_rank(rank, a, rep, w, c,
                                         shape=decode[2])
                             for a, rep, w, c in decode[0]]
        out["runs"].append(train_rank(
            rank, argv, outq if held else None, goqs[rank], f32=f32,
            tokens=tokens if toks is None else toks, keep=False, tag=i,
            shape=shp or shape, axes=axes))
    if every2 is not None:
        out["every2"] = every2_logs(every2, shape, axes, f32=f32,
                                    tokens=tokens)
    if runtime:
        from . import train as train_mod
        out["runtime"] = gathered_runtime_rank(
            rank, device=train_mod.parse_args(runs[0][0]).device)
    return out


def train_world(runs: list, tokens=None, timeout: float = 900.0,
                runtime: bool = False, shape=None, axes=("node",),
                every2: list | None = None, f32: bool = False,
                prefill: tuple | None = None, decode: tuple | None = None):
    """Each ``(argv, reference)`` of ``runs`` in turn on one world sharing
    the card -- on a mesh of ``shape`` on ``axes``, by default a node mesh
    of ``--nodes`` ranks; where ``reference`` (the single-process run's
    final ``(momentum, params)``, on the card or the host: it is moved to
    the ranks' device for its run's comparisons alone) is given, each
    rank's
    final ``(momentum, params)`` -- on an fsdp or model mesh its shards --
    is compared with its block of it in this process: bit equality, max
    abs difference and the reference's max-abs per rank.  ``tokens``:
    every step's tokens as ``launch.train.prepare`` sampled them (None:
    each rank samples).  A run ``(argv, reference, shape, tokens)`` takes
    its own mesh shape (the same number of ranks, on ``axes``) and
    tokens.  ``runtime``: then :func:`gathered_runtime_rank` on a
    (node 2, fsdp 2) mesh of the same ranks; ``every2`` (an argv): then
    :func:`every2_logs` of it on the same mesh (``"every2"``); ``f32``:
    every run with f32 activations (:func:`f32_start`); ``prefill``, an
    ``(argv, index, mesh shape)``: :func:`prefill_rank` of ``argv`` on
    that (node, fsdp, model) mesh of the same ranks before the run at
    ``index`` (``"prefill"``); ``decode``, a ``([(argv, replace,
    weights, cache)], index, mesh shape)``: :func:`decode_rank` of each
    case there after it (``"decode"``, a list).  ``runs`` is
    emptied: the references are this function's, each let go once the
    last run compared against it is compared, so that where the caller
    keeps no other hold on them the later runs run without them (on the
    host they sit beside 8 ranks' staging).  Returns (rank results, one
    ``{rank: comparison}`` a compared run, keyed by its index in
    ``runs``)."""
    import torch.multiprocessing as mp

    from . import train as train_mod
    given = runs
    runs = [tuple(r) + (None,) * (4 - len(r)) for r in given]
    given.clear()
    args = train_mod.parse_args(runs[0][0])
    shape = tuple(shape or (args.nodes,))
    world = int(np.prod(shape))

    def cut_of(argv, shp):
        """The run's abstract mesh and the (fsdp, model) cut of a node row,
        None on a node mesh."""
        abstract = mesh_mod.abstract_mesh(tuple(shp or shape), axes)
        if not train_mod.is_sharded(abstract):
            return abstract, None
        a = train_mod.parse_args(argv)
        return abstract, sharding.inner_only(sharding.node_param_specs(
            train_mod.config_of(a), a.nodes, abstract))

    ctx = mp.get_context("spawn")
    outq = ctx.Queue()
    goqs = [ctx.Queue() for _ in range(world)]
    comps: dict = {}
    errors: list = []

    def block(reference, rank, abstract, cut):
        at = dict(zip(axes, map(int, np.argwhere(abstract.devices
                                                 == rank)[0])))
        i = at["node"]
        parts = tuple({k: v[i:i + 1] for k, v in part.items()}
                      for part in reference)
        if cut is not None:
            parts = tuple(sharding.local_shard(p, cut, abstract, at)
                          for p in parts)
        return _packed(parts)

    def compare():
        try:
            for i, (argv, reference, shp, _) in enumerate(runs):
                if reference is None:
                    continue
                abstract, cut = cut_of(argv, shp)
                comps[i] = {}
                here = None
                for _ in range(world):
                    rank, tag, got = outq.get(timeout=timeout)
                    assert tag == i, (tag, i)
                    if here is None:
                        # a reference kept on the host comes to the
                        # ranks' device for this run's comparisons alone
                        here = tuple({k: v.to(got.device)
                                      for k, v in part.items()}
                                     for part in reference)
                    want = block(here, rank, abstract, cut)
                    comps[i][rank] = (torch.equal(got, want),
                                      float((got - want).abs().max()),
                                      float(want.abs().max()))
                    del got, want
                # this run's hold on its reference goes (a later run that
                # compares against the same one keeps it)
                runs[i] = (argv, None, shp, None)
                del here, reference
                if torch.cuda.is_initialized():
                    torch.cuda.empty_cache()
                for q in goqs:
                    q.put("done")
        except BaseException as e:          # re-raised by the caller
            errors.append(e)
            for q in goqs:
                q.put("stop")

    held = [(argv, ref is not None, shp, toks)
            for argv, ref, shp, toks in runs]
    th = threading.Thread(target=compare, daemon=True)
    th.start()
    try:
        res = mesh_mod.spawn(_train_entry, world,
                             (held, outq, goqs, tokens, runtime, shape,
                              axes, every2, f32, prefill, decode),
                             timeout=timeout,
                             threads=1 if args.device == "cpu" else None)
    finally:
        th.join(timeout=60)
    if errors:
        raise errors[0]
    return res, comps


def _train_cli_rank(rank: int, argv: list, shape, axes) -> dict:
    return train_rank(rank, argv, keep=False, shape=shape, axes=axes)


def train_cli(argv: list, device: str, fsdp: int | None = None,
              model: int | None = None) -> None:
    """``launch.train``'s flags ``argv`` run on a (node) mesh of
    ``--nodes`` spawned ranks, one a node, or with ``fsdp`` or ``model``
    on a (node, fsdp, model) mesh of ``--nodes`` x ``fsdp`` x ``model``
    ranks (an extent not given is 1; rank 0 prints the run's log); then
    each rank's median step ms and rank 0's wire log."""
    from . import train as train_mod
    if "--device" not in argv:
        argv = list(argv) + ["--device", device]
    args = train_mod.parse_args(argv)
    shape, axes = (((args.nodes,), ("node",))
                   if fsdp is None and model is None
                   else ((args.nodes, fsdp or 1, model or 1), TRAIN_AXES))
    res = mesh_mod.spawn(_train_cli_rank, int(np.prod(shape)),
                         (argv, shape, axes),
                         threads=1 if args.device == "cpu" else None)
    for r in res:
        rest = sorted(r["step_s"][1:]) or r["step_s"]
        print(f"rank {r['rank']} ({r['wire']}): median step "
              f"{1e3 * rest[len(rest) // 2]:.1f} ms, K1 {r['k1']}")
    print("rank 0 wire (ops, bytes, s, s open before the wait): " + str(
        {k: (v["ops"], v["bytes"], round(v["s"], 3), round(v["open_s"], 3))
         for k, v in res[0]["log"].items()}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (every rank on the card, gloo staged "
                         "through host memory) or cpu")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--fsdp", type=int, default=None,
                    help=f"the fsdp extent (4 nodes x fsdp ranks, default "
                         f"{FSDP}; NCCL needs that many cards); with "
                         "--train, train on a (node, fsdp, model) mesh; "
                         "with --prefill or --decode, the replica's "
                         "fsdp extent")
    ap.add_argument("--model", type=int, default=None,
                    help="with --train: the model extent of a (node, fsdp, "
                         "model) mesh (tensor-parallel training); with "
                         "--prefill or --decode, the replica's model "
                         "extent")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill", nargs=argparse.REMAINDER, default=None,
                    help="instead: the rest of the line is a prefill "
                         "case's flags (prefill_args), run on a replica of "
                         "--fsdp x --model ranks (each 2 unless given)")
    ap.add_argument("--decode", nargs=argparse.REMAINDER, default=None,
                    help="instead: the rest of the line is a decode "
                         "case's flags (decode_args), run on a replica of "
                         "--fsdp x --model ranks (each 2 unless given)")
    ap.add_argument("--train", nargs=argparse.REMAINDER, default=None,
                    help="instead: the rest of the line is launch.train's "
                         "flags, run on a (node) mesh of --nodes spawned "
                         "gloo ranks, one a node, or with --fsdp F and / or "
                         "--model M on a (node, fsdp F, model M) mesh of "
                         "--nodes x F x M")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a card; use --device cpu")
    if args.train is not None:
        train_cli(args.train, args.device, args.fsdp, args.model)
        return
    if args.prefill is not None:
        prefill_cli(args.prefill, args.device, args.fsdp, args.model)
        return
    if args.decode is not None:
        decode_cli(args.decode, args.device, args.fsdp, args.model)
        return
    fsdp = FSDP if args.fsdp is None else args.fsdp
    shape = (NODES, fsdp)
    t0 = time.perf_counter()
    res = mesh_mod.spawn(engine_rank, NODES * fsdp,
                         (shape, ("node", "fsdp"), args.device,
                          args.backend, args.seed),
                         threads=1 if args.device == "cpu" else None)
    fails = check(res, args.seed, args.device, shape)
    for name, rec in res[0]["rounds"].items():
        print(f"{name}: rank 0 wire {rec['log']} K1 {rec['k1']} "
              f"{rec['ms']:.3f} ms")
    print(f"{len(res)} ranks ({res[0]['wire']}), "
          f"{time.perf_counter() - t0:.1f} s: "
          + ("all blocks match the global path" if not fails
             else f"{len(fails)} failures: {fails[:5]}"))
    if fails:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
