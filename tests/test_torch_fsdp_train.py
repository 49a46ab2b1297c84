"""fsdp-sharded training (``repro_torch.launch.train.run(args, mesh=)`` on
a node x fsdp mesh): each rank keeps its fsdp shard of its node's leaves,
gathers the node's whole leaves for the gradient pass and
reduce-scatters the gradients' mean.

One CPU world of 8 spawned ranks (gloo, a ``file://`` store under a
temporary directory, one thread a rank) runs reduced configs in f32
through each of ``mesh_check.fsdp_cases``: on the (node 4, fsdp 2,
model 1) mesh the reference's tests use (every qwen3 leaf sharded) dmsgd
with micro-batches, ``--overlap --compression int8`` with carry-buffer
checkpoints, ``parallel_msgd`` and granite-moe (its router replicated,
its rows split over fsdp: a routing group over both ranks, G = 2, and
micro-batches each a rank's, G = 1), and granite-moe on (node 2, fsdp
4, model 1), two groups of 2 ranks side by side; on the (node 4, fsdp 2)
mesh, where ``embed`` is replicated over fsdp, loss-aware gossip with
deadline skips and stragglers; then dmsgd for 2 steps of each other
family (ssm, hybrid, audio, vlm).  Then ``mesh_check.every2_logs``: a
gossip step against the same step with ``every=2``'s Identity, the
reference's differential wire check (``tests/test_shard_native.py``'s
``_HLO_2AX_TRAIN_SCRIPT``) held on the mesh's wire log.

Every case's losses and final (m, x), gathered, are held within 2e-4
against the port's single-process run and the reference's
``build_trainer`` without a mesh (the same ``alive`` flags in both
batches): GSPMD keeps the reference's sharded step equal to its unsharded
one, so that run is the reference's answer.  The reduce-scatter and the
row split sum in another order, so bit equality is not expected.  The
checkpoint directory the int8 case writes is read by
``repro.checkpoint.restore`` and equals the single-process run's within
2e-4, ``gossip_buf`` included.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.core import optim as JO, schedule as JSch, topology as JT
from repro.core.plan import GossipPlan as JPlan
from repro.launch import steps as JSteps, train as JTrain
from repro_torch.convert import (JAX_PAD_MULTIPLE, stacked_from_jax,
                                 stacked_to_jax, train_state_to_jax)
from repro_torch.launch import mesh as MM, mesh_check as MC
from repro_torch.launch import sharding as TS, train as TTrain

ARGV = ["--device", "cpu", "--nodes", "4", "--steps", "3", "--batch", "2",
        "--seq", "16", "--log-every", "1", "--hetero", "0.5", "--desync"]
TOL = dict(rtol=2e-4, atol=2e-4)
CASES = list(MC.fsdp_cases(ARGV))
WORLD = 8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's results and the mesh runs' checkpoint directory, each
    case's single-process run and checkpoint directory, and each case's
    reference run: the world runs in its own processes while this one
    computes the other two."""
    store = tmp_path_factory.mktemp("fsdp_train_store")
    mesh_ck = str(tmp_path_factory.mktemp("fsdp_train_ck"))
    one_ck = str(tmp_path_factory.mktemp("fsdp_single_ck"))
    got = {}

    def spawn():
        try:
            got["world"] = MM.spawn(MC.fsdp_cases_rank, WORLD,
                                    (ARGV, mesh_ck), store_dir=str(store),
                                    threads=1, timeout=300)
        except BaseException as e:          # re-raised below
            got["error"] = e

    th = threading.Thread(target=spawn, daemon=True)
    th.start()
    try:
        torch.set_num_threads(1)
        single, refs = {}, {}
        cases = dict(MC.fsdp_cases(ARGV, one_ck), **MC.family_cases(ARGV))
        for name, (argv, _, _) in cases.items():
            args = TTrain.parse_args(argv)
            res = TTrain.run(args, start=MC.f32_start(args))
            single[name] = {"losses": [h["loss"] for h in res["history"]],
                            "params": res["params"],
                            "momentum": res["state"].momentum,
                            "config": res["config"]}
            if name in CASES:
                refs[name] = _reference(argv)
    finally:
        th.join(timeout=300)
    if "error" in got:
        raise got["error"]
    return {"world": got["world"], "mesh_ck": mesh_ck, "single": single,
            "one_ck": one_ck, "refs": refs}


def _reference(argv):
    """The case on the reference's build_trainer without a mesh (its int8
    wire, which the reference's build_trainer does not take, through the
    same optimizer, train step and plan), the port's ``alive`` flags in
    its batches: losses and the final (flushed) params and momentum."""
    args = TTrain.parse_args(argv)
    start = MC.f32_start(args)
    tcfg = start["config"]
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config(args.arch)),
        activation_dtype=jnp.float32)
    jtop = JT.get_topology(args.topology, args.nodes)
    rt = {"loss_aware": args.loss_aware, "deadline": args.deadline_skip}
    if args.compression:
        opt = JO.make_optimizer(args.optimizer, jtop, beta=args.beta,
                                compression=args.compression,
                                overlap=args.overlap, **rt)
        plan = JPlan.for_optimizer(opt, fn=JSteps.make_train_step(
            jcfg, opt, micro_batch=args.micro_batch))
        step_for = plan.step_fn
    else:
        opt, step_for = JTrain.build_trainer(
            jcfg, jtop, args.optimizer, args.beta, args.micro_batch,
            overlap=args.overlap, **rt)
        plan = step_for.plan
    jx = jax.tree.map(jnp.asarray, stacked_to_jax(
        {k: v.clone() for k, v in start["params"].items()}, tcfg))
    js = opt.init(jx)
    lr_fn = JSch.warmup_step_decay(
        args.lr, args.warmup, [int(args.steps * 0.6),
                               int(args.steps * 0.85)])
    losses = []
    for k in range(args.steps):
        batch = start["batches"][k]
        jb = {key: jnp.asarray(v.numpy()) for key, v in batch.items()}
        jx, js, jl = step_for(k)(jx, js, jb, lr_fn(k))
        losses.append(float(jl))
    if args.overlap:
        jx, js = plan.flush_step_fn(args.steps)(jx, js)
    return {"losses": losses,
            "params": stacked_from_jax(jax.tree.map(np.asarray, jx), tcfg),
            "momentum": stacked_from_jax(jax.tree.map(np.asarray,
                                                      js.momentum), tcfg)}


def _row(tree, node):
    return {k: (v[node:node + 1].float().numpy()
                if isinstance(v, torch.Tensor)
                else np.asarray(v[node:node + 1], np.float32))
            for k, v in tree.items()}


def _quantum(tree: dict) -> dict:
    """One int8 level of each leaf's largest value (``max|x| / 127``)."""
    return {k: float(np.abs(np.asarray(v)).max()) / 127 for k, v in
            tree.items()}


def _specs(name):
    args, mesh = _case(name)
    return TS.node_param_specs(TTrain.config_of(args), args.nodes, mesh)


def _case(name):
    """(args, abstract mesh) of an fsdp case."""
    argv, shape, axes = MC.fsdp_cases(ARGV)[name]
    return TTrain.parse_args(argv), MM.abstract_mesh(shape, axes)


@pytest.mark.parametrize("name", CASES)
def test_fsdp_case_matches_single_process_and_reference(runs, name):
    """Each rank's logged losses and its node's final (m, x), gathered
    over fsdp, against the single-process run and the reference's, within
    2e-4; each rank's batches hold its R = B / F rows of the node's (the
    moe family's too, its routing the node's).  Under int8 the final
    (m, x) is held within 2e-4 plus one int8 level of the leaf, as the
    node-mesh test holds the reference's: an f32 rounding apart -- here
    also the reduce-scatter's and the row split's order of sums -- can
    move an element across a rounding boundary of the wire."""
    one, ref = runs["single"][name], runs["refs"][name]
    args, mesh = _case(name)
    diffs = []
    for r in runs["world"]:
        got = r[name]
        assert got["rows"] == args.batch // mesh.shape["fsdp"], name
        node = got["coords"]["node"]
        losses = [h["loss"] for h in got["history"]]
        np.testing.assert_allclose(losses, one["losses"], **TOL)
        np.testing.assert_allclose(losses, ref["losses"], **TOL)
        for part in ("params", "momentum"):
            mine, theirs = _row(one[part], node), _row(ref[part], node)
            level = (_quantum(ref[part]) if name == "overlap_int8"
                     else dict.fromkeys(theirs, 0.0))
            assert set(got[part]) == set(mine)
            for k, v in got[part].items():
                for want in (mine[k], theirs[k]):
                    np.testing.assert_allclose(v, want, rtol=TOL["rtol"],
                                               atol=TOL["atol"] + level[k])
                diffs.append(float(np.abs(v - mine[k]).max()))
    assert max(diffs) <= TOL["atol"] + (max(level.values())
                                        if name == "overlap_int8" else 0.0)


@pytest.mark.parametrize("arch", MC.FAMILY_ARCHS)
def test_every_family_trains_on_an_fsdp_mesh(runs, arch):
    """ssm, hybrid, audio and vlm (the vlm family's doubly stacked layers
    specced by ``cfg``, its images split with the tokens' rows): each
    rank's losses and its node's final (m, x), gathered, against the
    single-process run within 2e-4; every rank holds less than its
    node."""
    one = runs["single"][arch]
    for r in runs["world"]:
        got = r[arch]
        node = got["coords"]["node"]
        np.testing.assert_allclose([h["loss"] for h in got["history"]],
                                   one["losses"], **TOL)
        for part in ("params", "momentum"):
            mine = _row(one[part], node)
            assert set(got[part]) == set(mine)
            for k, v in got[part].items():
                np.testing.assert_allclose(v, mine[k], **TOL, err_msg=k)
        whole = sum(v.size for v in mine.values())
        assert sum(got["param_elems"].values()) < whole


@pytest.mark.parametrize("name", CASES)
def test_each_rank_holds_only_its_shards(runs, name):
    """A rank's params are its shards: each leaf sharded over fsdp holds
    the node's leaf's elements / F, a replicated leaf all of them (the
    2-axis mesh's ``embed``, the moe ``router``); the specs are read at
    the global node-stacked shapes."""
    specs = _specs(name)
    args, mesh = _case(name)
    cfg = TTrain.config_of(args)
    fs = mesh.shape["fsdp"]
    whole = {k: p.numel() for k, p in
             TTrain.M.init(cfg, 0, device="meta").named_parameters()}
    replicated = {k for k, s in specs.items() if TS.fsdp_dim(s) is None}
    want_rep = ({k for k in whole if k.endswith("moe.router")}
                if name.startswith("moe") else
                {"runtime": {"embed"}}.get(name, set()))
    assert replicated == want_rep
    for r in runs["world"]:
        got = r[name]["param_elems"]
        assert set(got) == set(whole)
        for k, n in got.items():
            assert n == (whole[k] if k in replicated else whole[k] // fs), k
        assert sum(got.values()) < sum(whole.values())


def _fsdp_ops(log) -> dict:
    return {k: v["ops"] for k, v in log.items() if k.startswith("fsdp:")}


def _moe_ops(log) -> dict:
    return {k: v["ops"] for k, v in log.items() if k.startswith("moe:")}


def _want_moe_ops(name) -> dict:
    """The routing ops a run logs: none where a rank's micro-batches are
    whole routing groups (G = 1) or without experts; where a group spans
    G > 1 ranks, per moe layer and micro-step (one a step: the rank's
    rows are its share of one group) the forward's all_gather of the
    counts, psum of the probability sums, reduce_scatter of the slots and
    all_gather of the outputs, and the backward's psum, all_gather (the
    reduce-scatter's) and reduce_scatter (the all-gather's)."""
    args, mesh = _case(name)
    cfg = TTrain.config_of(args)
    if not cfg.n_experts:
        return {}
    if TTrain.routing_group(mesh, args.batch, args.micro_batch) == 1:
        return {}
    passes = cfg.n_layers * args.steps
    return {"moe:all_gather": 3 * passes, "moe:psum": 2 * passes,
            "moe:reduce_scatter": 2 * passes}


def test_wire_log_differential_every2(runs):
    """The reference's differential assertion on the wire log: the
    Shifts step of ``every=2`` adds exactly one permute (one f32 dtype
    group) over the Identity step and nothing else; the fsdp ops are
    equal in both: one all_gather and one reduce_scatter a dtype group
    and one psum (the node's loss) a step."""
    for r in runs["world"]:
        gossip, base = r["every2"]
        counts = {k: v["ops"] for k, v in gossip.items()}
        base_counts = {k: v["ops"] for k, v in base.items()}
        diff = {k: counts.get(k, 0) - base_counts.get(k, 0)
                for k in set(counts) | set(base_counts)}
        assert {k: d for k, d in diff.items() if d} == {"permute": 1}
        assert _fsdp_ops(base) == _fsdp_ops(gossip) == {
            "fsdp:all_gather": 1, "fsdp:reduce_scatter": 1, "fsdp:psum": 1}
        assert gossip["fsdp:all_gather"]["bytes"] == \
            gossip["fsdp:reduce_scatter"]["bytes"]


@pytest.mark.parametrize("name", CASES)
def test_wire_logs_of_the_fsdp_steps(runs, name):
    """Per step one all_gather and one reduce_scatter a sharded dtype
    group, a psum for the node's loss and one a replicated dtype group;
    the gossip's own ops as on a node mesh: a permute a round (two under
    int8, whose scales take a pmax over fsdp; the priming step none),
    parallel_msgd's psum a step and no permute; the moe routing's ops in
    the scope ``"moe"`` on every rank (:func:`_want_moe_ops`: none at
    G = 1)."""
    argv = MC.fsdp_cases(ARGV)[name][0]
    steps = TTrain.parse_args(argv).steps
    psums = 2 if name == "runtime" or name.startswith("moe") else 1
    want_moe = _want_moe_ops(name)
    assert bool(want_moe) == (name in ("moe", "moe_g2f4")), name
    for r in runs["world"]:
        log = r[name]["log"]
        assert _fsdp_ops(log) == {"fsdp:all_gather": steps,
                                  "fsdp:reduce_scatter": steps,
                                  "fsdp:psum": psums * steps}, name
        assert _moe_ops(log) == want_moe, name
        gossip = {k: v["ops"] for k, v in log.items() if ":" not in k}
        if name == "parallel_msgd":
            assert gossip == {"psum": steps}
        elif name == "overlap_int8":
            assert gossip["permute"] == 2 * (steps - 1)
            assert gossip["pmax"] == steps - 1
            assert "ckpt:gather" in log and "ckpt:all_gather" not in log
        else:
            assert gossip["permute"] == steps


def test_reduce_scatter_sums_the_line_and_keeps_the_block(runs):
    """``Mesh.reduce_scatter`` over the fsdp line: the sum of the two
    ranks' tensors, this rank's block of dim 0 (and of dim 1 for the
    transpose); the log counts the block's bytes, the link (g - 1) times
    them."""
    mesh = MM.abstract_mesh(*MC.FSDP_MESH)
    for rank, r in enumerate(runs["world"]):
        at = dict(zip(mesh.axis_names, map(int, np.argwhere(
            mesh.devices == rank)[0])))
        line = [int(q) for q in mesh.devices[at["node"], :, at["model"]]]
        total = sum(np.random.default_rng(5 + q).standard_normal(
            (4, 3)).astype(np.float32) for q in line)
        a, b, log = r["reduce_scatter"]
        f = at["fsdp"]
        np.testing.assert_allclose(a, total[2 * f:2 * f + 2], rtol=1e-6)
        np.testing.assert_allclose(b, total.T[:, 2 * f:2 * f + 2],
                                   rtol=1e-6)
        rec = log["reduce_scatter"]
        assert rec["ops"] == 2 and rec["bytes"] == 2 * a.nbytes
        assert rec["link"] == 2 * a.nbytes


def _like(single_case, carry: bool):
    """A JAX ``like`` tree of the driver's checkpoint of ``single_case``."""
    cfg = single_case["config"]
    live = train_state_to_jax(single_case["params"],
                              single_case["momentum"], cfg)
    like = jax.tree.map(lambda t: jnp.zeros(tuple(t.shape), jnp.float32),
                        live)
    if carry:
        n = next(iter(single_case["params"].values())).shape[0]
        per_node = 2 * sum(v[0].numel()
                           for v in single_case["params"].values())
        width = per_node + -per_node % JAX_PAD_MULTIPLE
        like["gossip_buf"] = (jnp.zeros((n, width), jnp.float32),)
    return like


def test_fsdp_checkpoint_equals_single_process(runs):
    """The carry-buffer checkpoint the int8 case writes (each leaf
    gathered over fsdp, the node rows at rank 0, ``gossip_buf`` unpacked,
    gathered and converted node by node) is read by
    repro.checkpoint.restore and equals the single-process run's within
    2e-4 plus one int8 level of the array (as the final (m, x) of the
    int8 case), ``gossip_buf`` included."""
    like = _like(runs["single"]["overlap_int8"], True)
    got = jckpt.restore(f"{runs['mesh_ck']}/overlap_int8", 2, like)
    want = jckpt.restore(f"{runs['one_ck']}/overlap_int8", 2, like)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_got) == len(flat_want) == len(jax.tree.leaves(like))
    for (path, g), (_, w) in zip(flat_got, flat_want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=TOL["rtol"],
                                   atol=TOL["atol"] + np.abs(w).max() / 127,
                                   err_msg=str(path))
    assert "gossip_buf" in got
    assert np.abs(np.asarray(got["gossip_buf"][0])).max() > 0


# ---------------------------------------------------------------------------
# no world: the dry mesh's reduce-scatter, the fsdp cut of the specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [0, 1])
def test_dry_reduce_scatter_logs_the_block(dim):
    """``dry_mesh``'s reduce_scatter returns a meta tensor of the rank's
    block and logs its bytes, the link (g - 1) times them."""
    dry = MM.dry_mesh(MM.abstract_mesh((4, 2), ("node", "fsdp")), rank=3)
    x = torch.empty((4, 6) if dim == 0 else (3, 8), device="meta")
    out = dry.reduce_scatter(x, "fsdp", dim=dim)
    assert out.device.type == "meta"
    assert tuple(out.shape) == ((2, 6) if dim == 0 else (3, 4))
    rec = dry.log.kinds["reduce_scatter"]
    assert rec["ops"] == 1 and rec["bytes"] == out.nbytes
    assert rec["link"] == out.nbytes
    with pytest.raises(ValueError, match="meta"):
        dry.reduce_scatter(torch.zeros(4), "fsdp")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m",
                                  "llama-3.2-vision-90b"])
def test_fsdp_only_keeps_the_fsdp_cut(arch):
    """``inner_only`` of ``node_param_specs`` -- the cut of a rank's node
    row -- keeps the fsdp entry of each spec, and the model one, and
    drops the node axis (the node row is cut elsewhere)."""
    from repro_torch import configs as tconfigs
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    mesh = MM.abstract_mesh((4, 2, 2), MC.TRAIN_AXES)
    specs = TS.node_param_specs(cfg, 4, mesh)
    cut = TS.inner_only(specs)
    assert set(cut) == set(specs)
    for k, s in specs.items():
        assert len(cut[k]) == len(s)
        assert TS.fsdp_dim(cut[k]) == TS.fsdp_dim(s)
        assert TS.axis_dim(cut[k], "model") == TS.axis_dim(s, "model")
        assert set(cut[k]) <= {"fsdp", "model", None}
