"""The port's dry run (``repro_torch.launch.dryrun``), mirroring
``tests/test_dryrun_integration.py`` on the port, and its dry mesh.

* The dry mesh (``launch.mesh.dry_mesh``) refuses a tensor that is not on
  the meta device, and what it logs for one rank equals ``gossip_spec``'s
  wire accounting of the round.
* qwen3-0.6b ``train_4k`` on one pod with ``model=1, fsdp=1`` (256 nodes
  of one chip, the pure-gossip layout): one-peer's logged wire is exactly
  2 x 4 x n_params bytes a rank (the reference allows 5 %), static_exp's
  8x that in 8 permutes, int8 2 permutes and about a quarter of the
  bytes, one_peer_hypercube and random_match 1 permute and no all-gather.
  The node's gradient pass is counted once per process (``_PASSES``), so
  the five records cost one pass.
* ``decode_32k`` (qwen3, 1pod) and mamba2 ``long_500k`` (2pod) through
  the CLI: ``ALL DRY-RUNS OK``, records ok counting rank 0's step with a
  dominant term, and ``make_experiments`` prints their rows.
* qwen3 ``train_4k`` on one pod at its layout (model 16): rank 0's real
  step, the tensor-parallel pass's all-gathers and all-reduces counted,
  a dominant term named, and the flops of a chip between 1/16 of the
  node's pass and the whole of it.
* dbrx-132b ``train_4k`` (fsdp 4, micro-batches of 2): each rank counts
  its rows of the node's batch, a quarter of the gradient pass the
  records counted while the moe family kept its whole batch on every
  fsdp rank; granite-moe (fsdp 1) and qwen3 count what they counted
  then, to the flop; a routing group spread over fsdp ranks counts its
  collectives in the pass.
* n_params equals the reference's for all 10 archs, and the roofline
  suite's active parameters equal the reference's ``_active_params``.
* ``prefill_32k`` records count rank 0's model-sharded step (qwen3 and
  deepseek-67b on one pod: the replica's collectives, a dominant term,
  the flops between the even split's and the unsharded pass's), and the
  dropless experts take each route on model shards (dbrx-132b
  expert-parallel, granite-moe on the ff cut).
* decode records count rank 0's model-sharded decode on its shard of
  the cache (qwen3 ``decode_32k`` on the head-dim cut, musicgen on the
  kv heads, mamba2 ``long_500k``'s conv channels and state heads): the
  flops between the even split's and the unsharded pass's, the bytes
  at least the cache shard's, the arguments exact, the collectives
  reckoned.
"""
import json

import jax
import numpy as np
import pytest
import torch

from benchmarks import bench_roofline as JRoof
from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.benchmarks import bench_roofline as TRoof
from repro_torch.benchmarks import make_experiments as TMX
from repro_torch.core import flatbuf, gossip, topology as TT
from repro_torch.core.plan import GossipPlan
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MM
from repro_torch.launch import sharding as TS, steps as TSteps
from repro_torch.launch.cost import Cost
from repro_torch.models import model as TM
from test_torch_arch_smoke import ARCH_IDS

QWEN_PARAMS = 596_049_920
PURE_GOSSIP = {"model": 1, "fsdp": 1}


def test_dry_mesh_refuses_a_tensor_off_meta():
    mesh = MM.dry_mesh(MM.abstract_mesh((4,), ("node",)), rank=1)
    assert mesh.wire == "dry" and mesh.coords == {"node": 1}
    for op in (lambda x: mesh.permute(x, [(1, 2)], "node"),
               lambda x: mesh.psum(x, "node"),
               lambda x: mesh.all_gather(x, "node")):
        with pytest.raises(ValueError, match="meta"):
            op(torch.zeros(3))
    assert mesh.log.kinds == {}


@pytest.mark.parametrize("topology,compression", [
    ("one_peer_exp", None), ("static_exp", None), ("one_peer_hypercube", None),
    ("one_peer_exp", "int8")])
def test_dry_mesh_log_equals_gossip_spec(topology, compression):
    n = 8
    top = TT.get_topology(topology, n)
    block = {"w": torch.empty((1, 33, 7), device="meta"),
             "b": torch.empty((1, 5), dtype=torch.bfloat16, device="meta")}
    mesh = MM.dry_mesh(MM.abstract_mesh((n,), ("node",)))
    out = GossipPlan(top, mesh=mesh, compression=compression).mix(0)(block)
    assert {k: (tuple(v.shape), v.dtype) for k, v in out.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in block.items()}
    spec = gossip.gossip_spec(top, 0, flatbuf.layout_of(block, pad_multiple=1),
                              compression=compression)
    assert mesh.log.counts() == {"permute": spec["collectives_per_step"]}
    assert mesh.log.bytes() == {"permute": spec["bytes_per_node_per_step"]}


def _wire(tmp_path, topology="one_peer_exp", **knobs):
    rec = D.run_one("qwen3-0.6b", "train_4k", multi_pod=False,
                    out_dir=str(tmp_path), verbose=False, topology=topology,
                    knobs=dict(PURE_GOSSIP, **knobs))
    assert rec["ok"] and rec["nodes"] == 256 and rec["n_params"] == \
        QWEN_PARAMS
    return rec


def test_pure_gossip_wire_bytes(tmp_path):
    a = _wire(tmp_path)
    assert (tmp_path / "dryrun_qwen3-0.6b_train_4k_1pod_fsdp1-model1.json"
            ).exists()
    ir = a["gossip_ir"]
    assert ir["wire_bytes_per_rank"] == 2 * 4 * QWEN_PARAMS == 4_768_399_360
    assert ir["payload_bytes_per_shard"] == ir["wire_bytes_per_rank"]
    assert a["cost"]["collective_counts"] == {"collective-permute": 1}
    assert a["cost"]["collective_bytes"] == {
        "collective-permute": 4_768_399_360}
    # a training record counts rank 0's step: no even split, nothing
    # left uncounted, a dominant term named
    assert "uncounted" not in a and "partition" not in a
    assert a["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert a["memory_analysis"]["fits"] and a["cost"]["flops"] > 0

    b = _wire(tmp_path, "static_exp")
    assert b["gossip_ir"]["wire_bytes_per_rank"] == 8 * 4_768_399_360
    assert b["cost"]["collective_counts"] == {"collective-permute": 8}

    q = _wire(tmp_path, compression="int8")
    assert q["cost"]["collective_counts"] == {"collective-permute": 2}
    ratio = q["gossip_ir"]["wire_bytes_per_rank"] / 4_768_399_360
    assert 0.25 < ratio < 0.26, ratio

    for top in ("one_peer_hypercube", "random_match"):
        m = _wire(tmp_path, top)
        assert m["cost"]["collective_counts"] == {"collective-permute": 1}
        assert "all-gather" not in m["cost"]["collective_bytes"]


@pytest.mark.parametrize("arch,shape,mesh,tag", [
    ("qwen3-0.6b", "decode_32k", "1pod", "1pod"),
    ("mamba2-1.3b", "long_500k", "2pod", "2pod"),
])
def test_dryrun_cli(tmp_path, capsys, monkeypatch, arch, shape, mesh, tag):
    D.main(["--arch", arch, "--shape", shape, "--mesh", mesh,
            "--out", str(tmp_path)])
    assert "ALL DRY-RUNS OK" in capsys.readouterr().out
    rec = json.loads((tmp_path / f"dryrun_{arch}_{shape}_{tag}.json")
                     .read_text())
    assert rec["ok"] and rec["cost"]["flops"] > 0
    # a decode record counts rank 0's model-sharded step: its rows, its
    # replica's collectives, nothing uncounted, a dominant term named
    assert "uncounted" not in rec and "partition" not in rec
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert "dominant_counted" not in rec["roofline"]
    assert rec["rank_rows"] == (8 if shape == "decode_32k" else 1)
    assert rec["wire"]["model:psum"]["ops"] > 0
    assert rec["memory_analysis"]["temp_bytes"] is not None
    monkeypatch.setenv("DRYRUN_DIR", str(tmp_path))
    TMX.main([])
    out = capsys.readouterr().out
    assert f"| {arch} | {shape} | {tag} |" in out
    assert out.count(f"| {arch} | {shape} | {tag} |") == 2


def test_layout_knobs_move_the_count(tmp_path, capsys):
    """qwen3 ``prefill_32k`` on one pod moves with the two layout knobs
    as the reference's count does: ``gqa_layout=flat`` counts more bytes
    and a higher peak and the same flops, ``broadcast_positions=1`` a
    lower peak and fewer flops by exactly the work of the B - 1 rows it
    leaves uncomputed -- the causal mask's compare and the rope angles,
    which rank 0 computes whole for its heads' rows (since the prefill
    record counts rank 0's model-sharded step; an even split of the
    replica's step kept that saving under 1e-4 of the flops); each
    record names its knob and its dominant term."""
    recs = {}
    for tag, knobs in (("base", {}), ("flat", {"gqa_layout": "flat"}),
                       ("bcast", {"broadcast_positions": 1})):
        recs[tag] = D.run_one("qwen3-0.6b", "prefill_32k", multi_pod=False,
                              out_dir=str(tmp_path), verbose=False,
                              knobs=knobs)
        assert recs[tag]["knobs"] == knobs
    base, flat, bcast = recs["base"], recs["flat"], recs["bcast"]

    def temp(r):
        return r["memory_analysis"]["temp_bytes"]

    assert flat["cost"]["hbm_bytes"] > base["cost"]["hbm_bytes"]
    assert temp(flat) > temp(base)
    assert temp(bcast) < temp(base)
    assert abs(flat["cost"]["flops"] - base["cost"]["flops"]) <= \
        1e-4 * base["cost"]["flops"]
    assert flat["cost"]["flops"] == base["cost"]["flops"]
    # one positions row: per layer the (B, S, S) mask compare shrinks to
    # (1, S, S), and each of the q and k rope calls casts, multiplies and
    # takes cos and sin of S * hd / 2 angles a row for one row, not B
    L, B, S, hd = 28, 2, 32768, 128
    assert base["rank_rows"] == B
    assert base["cost"]["flops"] - bcast["cost"]["flops"] == \
        L * (B - 1) * (S * S + S * (3 * hd + 2))
    # a record that counts rank 0's step names its dominant term
    assert base["roofline"]["dominant"] == "memory"
    assert "dominant_counted" not in base["roofline"]
    D.main(["--arch", "qwen3-0.6b", "--shape", "prefill_32k", "--mesh",
            "1pod", "--knob", "gqa_layout=flat", "--out", str(tmp_path)])
    assert "dominant=memory\n" in capsys.readouterr().out


def test_n_params_and_active_params_match_the_reference():
    for arch in ARCH_IDS:
        shapes = jax.eval_shape(lambda: JM.init(jconfigs.get_config(arch),
                                                jax.random.key(0)))
        want = int(sum(np.prod(x.shape) for x in jax.tree.leaves(shapes)))
        cfg = tconfigs.get_config(arch)
        assert TM.param_count(TM.init(cfg, device="meta")) == want, arch
        assert TRoof.active_params(arch) == JRoof._active_params(arch, want)


def test_model_sharded_training_record_counts_the_replica(tmp_path):
    """qwen3 ``train_4k`` on one pod at its layout (16 nodes x fsdp 1 x
    model 16): the record counts rank 0's tensor-parallel step -- the
    all-gathers (k / v heads: 8 kv heads over 16 ranks) and all-reduces
    inside the replica beside the gossip's permute -- names its dominant
    term, and a chip's flops lie between 1/16 of the node's gradient pass
    (counted unsharded here) and the whole of it."""
    rec = D.run_one("qwen3-0.6b", "train_4k", multi_pod=False,
                    out_dir=str(tmp_path), verbose=False)
    assert rec["ok"] and (rec["nodes"], rec["fsdp"], rec["model_axis"]) == \
        (16, 1, 16)
    assert "uncounted" not in rec and "partition" not in rec
    counts = rec["cost"]["collective_counts"]
    assert counts["all-gather"] > 0 and counts["all-reduce"] > 0
    assert counts["collective-permute"] == 1
    # the count it gave before the moe row split, to the flop and byte
    assert rec["cost"]["flops"] == 33_228_229_779_798
    assert rec["cost"]["hbm_bytes"] == 2_248_596_840_552
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert "dominant_counted" not in rec["roofline"]
    cfg = tconfigs.get_config("qwen3-0.6b")
    params = {k: v.detach() for k, v in
              TM.init(cfg, device="meta").named_parameters()}
    tokens = torch.empty((16, 4096), dtype=torch.int32, device="meta")
    one = MM.dry_mesh(MM.abstract_mesh((1, 1, 1), ("node", "fsdp", "model")))
    node, _ = D._grad_pass(cfg, params, tokens, None, 16, one, {})
    assert node.flops / 16 < rec["cost"]["flops"] < node.flops


# dbrx-132b train_4k's flops a chip while every fsdp rank took its node's
# whole batch (before the moe row split): 1pod, 2pod
DBRX_WHOLE_BATCH_FLOPS = {False: 6_000_806_124_051_232,
                          True: 3_000_419_538_820_496}


def test_moe_training_records_count_the_ranks_rows(tmp_path):
    """dbrx-132b ``train_4k`` at its layout (fsdp 4, micro-batches of 2):
    a rank's rows are 64 / 4 = 16 (1pod) or 32 / 4 = 8 (2pod), each
    micro-batch a whole routing group on one rank (no routing op), so
    the flops a chip fall to 0.24-0.28x what the records counted with the
    node's whole batch on every rank.  granite-moe (fsdp 1: no row to
    split) counts what it counted then, to the flop and byte, as qwen3
    does in :func:`test_model_sharded_training_record_counts_the_replica`."""
    for pod, whole in DBRX_WHOLE_BATCH_FLOPS.items():
        rec = D.run_one("dbrx-132b", "train_4k", multi_pod=pod,
                        out_dir=str(tmp_path), verbose=False)
        assert rec["ok"] and rec["fsdp"] == 4
        assert 0.24 * whole <= rec["cost"]["flops"] <= 0.28 * whole, pod
        assert "all-gather" in rec["cost"]["collective_counts"]
    rec = D.run_one("granite-moe-3b-a800m", "train_4k", multi_pod=False,
                    out_dir=str(tmp_path), verbose=False)
    assert rec["fsdp"] == 1
    assert rec["cost"]["flops"] == 250_267_608_561_938
    assert rec["cost"]["hbm_bytes"] == 34_661_271_237_388


def test_dry_routing_group_counts_its_collectives():
    """A moe pass whose routing group spans the 2 fsdp ranks of a dry
    mesh (``_grad_pass(group=2)``, reduced granite-moe on meta) counts
    per layer the forward's counts all-gather, probability-sum all-reduce,
    slots reduce-scatter and outputs all-gather, and the backward's
    all-reduce, all-gather and reduce-scatter; the same pass with no
    group counts none."""
    cfg = tconfigs.reduced_config(tconfigs.get_config("granite-moe-3b-a800m"))
    params = {k: v.detach() for k, v in
              TM.init(cfg, device="meta").named_parameters()}
    tokens = torch.empty((1, 16), dtype=torch.int32, device="meta")
    dry = MM.dry_mesh(MM.abstract_mesh((1, 2, 1), ("node", "fsdp",
                                                   "model")), rank=1)
    grouped, _ = D._grad_pass(cfg, params, tokens, None, None, dry, {},
                              group=2)
    L = cfg.n_layers
    assert dict(grouped.collective_counts) == {
        "all-gather": 3 * L, "all-reduce": 2 * L, "reduce-scatter": 2 * L}
    alone, _ = D._grad_pass(cfg, params, tokens, None, None, dry, {})
    assert not any(alone.collective_counts.values())


# the prefill records' flops a chip while a replica's step was split
# evenly over its fsdp x model chips (before the model-sharded prefill),
# one pod
PREFILL_EVEN_FLOPS = {"qwen3-0.6b": 36_100_484_457_120,
                      "deepseek-67b": 969_114_516_386_234}


def _unsharded_pass(arch: str, rows: int):
    """The count of the record's prefill step on ``rows`` rows in one
    process: every leaf whole, nothing cut."""
    cfg = D._setup(arch, "prefill_32k", False, {})[0]
    params = {k: v.detach() for k, v in
              TM.init(cfg, device="meta").named_parameters()}
    batch = {k: v[:rows] for k, v in
             TSteps.input_specs(cfg, "prefill_32k").items()}
    with Cost() as c:
        TSteps.make_prefill_step(cfg)(TM.params_view(params), batch)
    return c


def test_model_sharded_prefill_record_counts_the_replica(tmp_path):
    """qwen3 (16 nodes x fsdp 1 x model 16) and deepseek-67b (4 x 4 x
    16) ``prefill_32k`` on one pod: the record counts rank 0's step --
    the fsdp gather, the tensor-parallel forward over its 2 rows (the
    batch of 32 over node x fsdp) -- with the collectives inside the
    replica, no even split and nothing left uncounted, and names its
    dominant term.  A chip's flops lie between the even split's count
    and the whole pass of its rows counted unsharded.  qwen3's model
    ops: k and v gathered in each of 28 layers (8 kv heads do not
    divide 16) and a psum each for ``wo`` and ``w_down`` (row-parallel)
    and the vocab-parallel embedding.  deepseek gathers its fsdp shards
    in one all-gather (one dtype), whose bytes are rank 0's block of the
    leaves cut over fsdp, and its peak holds the gathered leaves."""
    for arch in PREFILL_EVEN_FLOPS:
        rec = D.run_one(arch, "prefill_32k", multi_pod=False,
                        out_dir=str(tmp_path), verbose=False)
        assert rec["ok"] and rec["rank_rows"] == 2
        assert "uncounted" not in rec and "partition" not in rec
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        assert "dominant_counted" not in rec["roofline"]
        whole = _unsharded_pass(arch, 2)
        assert PREFILL_EVEN_FLOPS[arch] < rec["cost"]["flops"] < \
            whole.flops, arch
        if arch == "qwen3-0.6b":
            L, S, d = 28, 32768, 1024
            assert (rec["fsdp"], rec["model_axis"]) == (1, 16)
            assert {k: v["ops"] for k, v in rec["wire"].items()} == {
                "model:all_gather": 2 * L, "model:psum": 2 * L + 1}
            # each psum sums the rows' (2, S, d) activations: a layer's
            # two in bf16, the embedding's rows in the params' f32
            assert rec["wire"]["model:psum"]["bytes"] == \
                2 * L * 2 * S * d * 2 + 2 * S * d * 4
            assert rec["cost"]["collective_counts"] == {
                "all-gather": 2 * L, "all-reduce": 2 * L + 1}
            continue
        cfg, _, mesh, _, fsdp, _ = D._setup(arch, "prefill_32k", False, {})
        params = {k: v.detach() for k, v in
                  TM.init(cfg, device="meta").named_parameters()}
        specs = TS.param_specs(params, mesh, cfg=cfg, node_axis=False)
        blk = TS.local_shard(params, specs, mesh,
                             {a: 0 for a in mesh.axis_names})
        cut = sum(v.numel() * v.element_size() for k, v in blk.items()
                  if TS.fsdp_dim(specs[k]) is not None)
        assert fsdp == 4 and rec["wire"]["fsdp:all_gather"] == {
            "ops": 1, "bytes": cut}
        assert rec["memory_analysis"]["temp_bytes"] > fsdp * cut


def test_dropless_moe_prefill_records_take_each_route(tmp_path):
    """The moe prefill on model shards, one pod, model 16, its experts
    dropless: dbrx-132b's 16 experts divide 16 (expert-parallel: the
    expert leaves cut on E), granite-moe's 40 do not (their ff dim cut);
    both records count rank 0's step and name a dominant term, and each
    layer's experts end in one psum beside ``wo``'s, plus one for the
    vocab-parallel embedding (dbrx) or the head cut on d (granite-moe's
    49,155-token vocabulary does not divide 16)."""
    for arch, cut, layers in (("dbrx-132b", 0, 40),
                              ("granite-moe-3b-a800m", 2, 32)):
        cfg, _, mesh, _, _, _ = D._setup(arch, "prefill_32k", False, {})
        params = {k: v.detach() for k, v in
                  TM.init(cfg, device="meta").named_parameters()}
        specs = TS.param_specs(params, mesh, cfg=cfg, node_axis=False)
        assert TS.axis_dim(specs["layers.0.moe.w_gate"], "model") == cut
        rec = D.run_one(arch, "prefill_32k", multi_pod=False,
                        out_dir=str(tmp_path), verbose=False)
        assert rec["ok"] and "uncounted" not in rec
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        assert rec["wire"]["model:psum"]["ops"] == 2 * layers + 1, arch


# the decode records' flops a chip while a replica's step was split
# evenly over its fsdp x model chips (before the model-sharded decode),
# one pod
DECODE_EVEN_FLOPS = {("qwen3-0.6b", "decode_32k"): 4_443_817_287.5,
                     ("musicgen-large", "decode_32k"): 10_061_779_477.0,
                     ("mamba2-1.3b", "long_500k"): 260_090_852.4375}


def _rank0(arch: str, shape: str):
    """(cfg, rank 0's serving parameter block, its cache shard, its rows)
    of a decode record, on meta, and the cache specs."""
    cfg, _, mesh, _, _, _ = D._setup(arch, shape, False, {})
    at = {a: 0 for a in mesh.axis_names}
    params = {k: v.detach() for k, v in
              TM.init(cfg, device="meta").named_parameters()}
    blk = TS.local_shard(params, TS.param_specs(params, mesh, cfg=cfg,
                                                node_axis=False), mesh, at)
    full = TSteps.cache_struct(cfg, shape)
    specs = TS.cache_specs(full, mesh, TSteps.SHAPES[shape]["global_batch"])
    cache = TS.local_shard(full, specs, mesh, at)
    rows = TS.batch_block(TSteps.input_specs(cfg, shape), mesh,
                          node_axis=False, coords=at)
    return cfg, params, blk, cache, rows


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in
               torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def test_model_sharded_decode_record_counts_the_replica(tmp_path):
    """qwen3 ``decode_32k`` (16 nodes x fsdp 1 x model 16; 8 kv heads do
    not divide 16, so the cache is cut on the head dim: 8 of 128 columns
    a rank), musicgen ``decode_32k`` (its 32 kv heads cut, 2 a rank) and
    mamba2 ``long_500k`` (1 row; 4,352 / 16 = 272 conv channels and 64 /
    16 = 4 state heads a rank), one pod: each record counts rank 0's
    step on its rows (8 of 128, 1 of 1).  A chip's flops lie between the
    even split's count and the unsharded pass of its rows over their
    whole cache; its bytes are at least its cache shard's; its
    ``argument_bytes`` are the parameter block, the cache shard and the
    inputs exactly, its output the logits block and the cache shard,
    which it aliases.  Collectives, reckoned from the cuts: qwen3 psums
    the embedding and, in each of 28 layers, ``wo``, ``w_down`` and the
    partial logits, and gathers q, k, v and the output's head-dim block;
    musicgen psums the embedding and each of 48 ``wo`` (its MLP stack
    divides 16 and stays whole) and gathers the two norm scales a layer;
    mamba2 psums the embedding and each of 48 ``out_proj`` and gathers a
    layer ``in_proj``'s output, the conv output, the heads' y and the
    two norm scales, and the final norm's scale."""
    want = {"qwen3-0.6b": {"all-reduce": 1 + 3 * 28, "all-gather": 4 * 28},
            "musicgen-large": {"all-reduce": 1 + 48, "all-gather": 2 * 48},
            "mamba2-1.3b": {"all-reduce": 1 + 48,
                            "all-gather": 5 * 48 + 1}}
    for (arch, shape), even in DECODE_EVEN_FLOPS.items():
        rec = D.run_one(arch, shape, multi_pod=False, out_dir=str(tmp_path),
                        verbose=False)
        cfg, params, blk, cache, rows = _rank0(arch, shape)
        assert rec["ok"] and rec["rank_rows"] == rows["token"].shape[0]
        assert rec["rank_rows"] == (8 if shape == "decode_32k" else 1)
        if arch == "qwen3-0.6b":
            assert tuple(cache["kv"].k.shape) == (28, 8, 8, 32768, 8)
        if arch == "musicgen-large":
            assert tuple(cache["kv"].k.shape) == (48, 8, 2, 32768, 64)
        if arch == "mamba2-1.3b":
            assert tuple(cache["ssm"].conv.shape) == (48, 1, 3, 272)
            assert tuple(cache["ssm"].state.shape) == (48, 1, 4, 64, 128)
        full = TSteps.cache_struct(cfg, shape)
        whole_rows = {k: (v[:rec["rank_rows"]] if isinstance(v, torch.Tensor)
                          else v) for k, v in
                      TSteps.input_specs(cfg, shape).items()}
        rows_cache = torch.utils._pytree.tree_map(
            lambda t: t.narrow(1, 0, rec["rank_rows"]).clone(), full)
        with Cost() as whole:
            TSteps.make_serve_step(cfg)(TM.params_view(params), rows_cache,
                                        whole_rows)
        assert even < rec["cost"]["flops"] < whole.flops, arch
        shard = _nbytes(cache)
        assert rec["cost"]["hbm_bytes"] >= shard
        mem = rec["memory_analysis"]
        assert mem["argument_bytes"] == _nbytes(blk) + shard + _nbytes(rows)
        assert mem["alias_bytes"] == shard
        assert mem["output_bytes"] > shard
        assert rec["cost"]["collective_counts"] == want[arch], arch
        assert rec["roofline"]["dominant"] == (
            "collective" if arch == "qwen3-0.6b" else "memory")
