"""Model-sharded (tensor-parallel) training
(``repro_torch.launch.train.run(args, mesh=)`` on (node, fsdp, model)
meshes): each rank keeps its (fsdp, model) shard of its node's leaves, as
the reference's sharding rules cut them, and runs a tensor-parallel
forward and backward on its model shards (``launch/tp.py``).

One CPU world of 8 spawned ranks (gloo, a ``file://`` store under a
temporary directory, one thread a rank) runs reduced configs in f32
(activations and momentum) through each of ``mesh_check.tp_cases``:
qwen3 on (node 2, fsdp 2, model 2) with micro-batches and remat, and on
(node 4, fsdp 1, model 2) at 3 layers (its dense MLP cut on the ff dim);
``--overlap --compression int8`` with carry-buffer checkpoints,
``parallel_msgd`` and ``--loss-aware --deadline-skip``; then every
family on both meshes -- moe with 4 experts (expert-parallel) on both
and 3 (``dataclasses.replace``: the ff route, remat on) on (node 2,
fsdp 2, model 2), where its rows split over fsdp and its routing group
spans both fsdp ranks, ssm, hybrid, audio and vlm -- and granite-34b
(one kv head: the k / v gather).  Then the four region ops
and the vocab-parallel CE against one process's autograd, and one
pass's gradients of the leaves replicated over model.

Every case's losses and final (m, x), gathered whole, are held within
2e-4 of max-abs against the port's single-process run, and the qwen3
and the row-split moe cases also against the reference's
``build_trainer`` without a mesh
(GSPMD keeps the reference's sharded step equal to its unsharded one).
Under int8 the final state and the checkpoint are held within 2e-4 plus
one int8 level of the leaf, as in the fsdp and node-mesh tests: a sum
taken in another order can move an element across a rounding boundary
of the wire.
"""
import concurrent.futures as cf
import dataclasses
import multiprocessing as mp
import os
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
from repro_torch.launch import tp as TPm

ARGV = ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
        "--log-every", "1", "--hetero", "0.5", "--desync"]
TOL = 2e-4
CASES = MC.tp_cases(ARGV)
QWEN = ("dmsgd_j", "dmsgd_k")
MOE = ("moe_j", "moe_e3_j")         # rows split over fsdp 2: G = 2
WORLD = 8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's results and the mesh runs' checkpoint directory, each
    case's single-process run and checkpoint directory, and the qwen3
    and moe cases' reference runs: the world runs in its own processes,
    each rank
    then taking its share of the single-process runs, and the reference's
    in one more process."""
    store = tmp_path_factory.mktemp("tp_train_store")
    mesh_ck = str(tmp_path_factory.mktemp("tp_train_ck"))
    one_ck = str(tmp_path_factory.mktemp("tp_single_ck"))
    got = {}

    def spawn():
        try:
            got["world"] = MM.spawn(MC.tp_cases_rank, WORLD,
                                    (ARGV, mesh_ck, one_ck),
                                    store_dir=str(store), threads=1,
                                    timeout=300)
        except BaseException as e:          # re-raised below
            got["error"] = e

    th = threading.Thread(target=spawn, daemon=True)
    th.start()
    ex = cf.ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"),
                                initializer=_one_xla_thread)
    try:
        refs = ex.submit(_references).result(timeout=300)
    finally:
        ex.shutdown(cancel_futures=True)
        th.join(timeout=300)
    if "error" in got:
        raise got["error"]
    single = {}
    for r in got["world"]:
        single.update(r.pop("single"))
    assert set(single) == set(CASES)
    return {"world": got["world"], "mesh_ck": mesh_ck, "single": single,
            "one_ck": one_ck, "refs": refs}


def _one_xla_thread():
    """XLA's CPU client on one thread (set before its first computation):
    the world's ranks hold the cores."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1").strip()


def _references() -> dict:
    """:func:`_reference` of each qwen3 and moe case (in a process of its
    own)."""
    return {name: _reference(CASES[name][0], CASES[name][3])
            for name in QWEN + MOE}


def _reference(argv, rep=None):
    """The case on the reference's build_trainer without a mesh, f32
    activations (``rep``: the case's config fields replaced), the port's
    batches: losses and the final params and momentum."""
    args = TTrain.parse_args(argv)
    start = MC.f32_start(args, replace=rep)
    tcfg = start["config"]
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config(args.arch)),
        activation_dtype=jnp.float32, n_layers=tcfg.n_layers, **(rep or {}))
    opt, step_for = JTrain.build_trainer(
        jcfg, JT.get_topology(args.topology, args.nodes), args.optimizer,
        args.beta, args.micro_batch)
    jx = jax.tree.map(jnp.asarray, stacked_to_jax(
        {k: v.clone() for k, v in start["params"].items()}, tcfg))
    js = opt.init(jx)
    lr_fn = JSch.warmup_step_decay(
        args.lr, args.warmup, [int(args.steps * 0.6),
                               int(args.steps * 0.85)])
    losses = []
    for k in range(args.steps):
        jb = {key: jnp.asarray(v.numpy())
              for key, v in start["batches"][k].items()}
        jx, js, jl = step_for(k)(jx, js, jb, lr_fn(k))
        losses.append(float(jl))
    return {"losses": losses,
            "params": _numpy(stacked_from_jax(jax.tree.map(np.asarray, jx),
                                              tcfg)),
            "momentum": _numpy(stacked_from_jax(
                jax.tree.map(np.asarray, js.momentum), tcfg))}


def _numpy(tree: dict) -> dict:
    return {k: np.asarray(v.float().numpy() if isinstance(v, torch.Tensor)
                          else v, np.float32) for k, v in tree.items()}


def _row(tree, node):
    return {k: np.asarray(v[node:node + 1], np.float32)
            for k, v in tree.items()}


def _close(got, want, level=0.0, what=""):
    """Within TOL of the array's max-abs (plus ``level``)."""
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale + level, (what, err, scale, level)


def _hold(r, one, name, level=None):
    node = r["coords"]["node"]
    np.testing.assert_allclose([h["loss"] for h in r["history"]],
                               one["losses"], rtol=TOL, atol=TOL)
    if "consensus" in one:               # the logged consensus distance
        np.testing.assert_allclose([h["consensus"] for h in r["history"]],
                                   one["consensus"], rtol=TOL, atol=TOL)
    for part in ("params", "momentum"):
        want = _row(one[part], node)
        assert set(r[part]) == set(want)
        for k, v in r[part].items():
            lv = 0.0 if level is None else float(np.abs(want[k]).max()) / 127
            _close(v, want[k], lv, f"{name} {part} {k}")


@pytest.mark.parametrize("name", QWEN)
def test_qwen3_matches_single_process_and_reference(runs, name):
    """qwen3 on both meshes: each rank's losses and its node's final
    (m, x), gathered whole, against the single-process run and the
    reference's build_trainer, within 2e-4 of max-abs."""
    for r in runs["world"]:
        _hold(r[name], runs["single"][name], name)
        _hold(r[name], runs["refs"][name], name)


@pytest.mark.parametrize("name", MOE)
def test_moe_matches_single_process_and_reference(runs, name):
    """granite-moe on (node 2, fsdp 2, model 2), expert-parallel and on
    the ff slice under remat: each rank's batches hold its R = B / F
    rows, its routing the node's (the group spans both fsdp ranks), and
    its losses and its node's final (m, x), gathered whole -- the
    router's and the experts' training -- are held against the
    single-process run and the reference's build_trainer within 2e-4 of
    max-abs."""
    args = TTrain.parse_args(CASES[name][0])
    fs = CASES[name][1][1]
    assert TTrain.routing_group(MM.abstract_mesh(*CASES[name][1:3]),
                                args.batch, args.micro_batch) == fs
    for r in runs["world"]:
        assert r[name]["rows"] == args.batch // fs
        _hold(r[name], runs["single"][name], name)
        _hold(r[name], runs["refs"][name], name)


@pytest.mark.parametrize("name", [n for n in CASES if n not in QWEN])
def test_case_matches_single_process(runs, name):
    """Every other case -- the driver's flags on qwen3 and every family
    on both meshes -- against the single-process run within 2e-4 of
    max-abs (int8: plus one int8 level of the leaf)."""
    for r in runs["world"]:
        _hold(r[name], runs["single"][name], name,
              level=True if name == "overlap_int8" else None)


def _specs(name):
    argv, shape, axes, rep = CASES[name]
    args = TTrain.parse_args(argv)
    return MC.case_config(args, rep), TS.node_param_specs(
        MC.case_config(args, rep), args.nodes, MM.abstract_mesh(shape, axes))


@pytest.mark.parametrize("name", ["dmsgd_j", "dmsgd_k", "moe_k", "moe_e3_j",
                                  "ssm_j", "vlm_k"])
def test_each_rank_holds_only_its_shards(runs, name):
    """A rank's params are its (fsdp, model) shards: each leaf holds the
    node's leaf's elements over the extents its spec cuts it by, and a
    rank holds less than its node."""
    cfg, specs = _specs(name)
    shape = dict(zip(MC.TRAIN_AXES, CASES[name][1]))
    whole = {k: p.numel() for k, p in
             TTrain.M.init(cfg, 0, device="meta").named_parameters()}
    cut = 0
    for r in runs["world"]:
        got = r[name]["param_elems"]
        assert set(got) == set(whole)
        for k, n in got.items():
            parts = int(np.prod([shape[a] for a in ("fsdp", "model")
                                 if TS.axis_dim(specs[k], a) is not None]))
            assert n == whole[k] // parts, k
            cut += TPm.model_dim(specs[k]) is not None
        assert sum(got.values()) < sum(whole.values())
    assert cut


def test_wire_logs_by_mesh(runs):
    """Each case's model ops are the same on every rank and run every
    step; the (node 2, fsdp 2, model 2) cases also gather and scatter
    over fsdp, the (node 4, fsdp 1, model 2) ones run no fsdp op; the
    moe routing's ops (scope ``"moe"``) run alike on every rank of the
    row-split moe cases and nowhere else."""
    for name, (argv, shape, _, _) in CASES.items():
        logs = [r[name]["log"] for r in runs["world"]]
        model = [{k: v["ops"] for k, v in log.items()
                  if k.startswith("model:")} for log in logs]
        assert all(m == model[0] for m in model) and model[0], name
        moe = [{k: v["ops"] for k, v in log.items()
                if k.startswith("moe:")} for log in logs]
        assert all(m == moe[0] for m in moe), name
        assert bool(moe[0]) == (name in MOE), (name, moe[0])
        fsdp = {k for log in logs for k in log if k.startswith("fsdp:")}
        if shape[1] == 1:
            assert not fsdp, (name, fsdp)
        else:
            assert {"fsdp:all_gather", "fsdp:reduce_scatter"} <= fsdp, name


def _expected_regions(m: int, M: int, seed: int = 7) -> dict:
    def arr(s, shape):
        return np.random.default_rng(s).standard_normal(shape).astype(
            np.float32)

    own = [arr(seed + 1 + i, (3, 4 * M)) for i in range(M)]
    g_same = arr(seed + 10, (3, 4 * M))
    g_wide = arr(seed + 10, (3, 4 * M * M))
    g_own = [arr(seed + 11 + i, (3, 4 * M)) for i in range(M)]
    g_own_wide = [arr(seed + 11 + i, (3, 4 * M * M)) for i in range(M)]
    g_own_narrow = [arr(seed + 11 + i, (3, 4)) for i in range(M)]
    same = arr(seed, (3, 4 * M))
    w = 4 * M
    return {
        "copy_to": (same, sum(g_own)),
        "reduce_from": (sum(own), g_same),
        "gather_from": (np.concatenate(own, 1), g_wide[:, m * w:(m + 1) * w]),
        "gather_partial": (np.concatenate(own, 1),
                           sum(g_own_wide)[:, m * w:(m + 1) * w]),
        "scatter_to": (same[:, m * 4:(m + 1) * 4],
                       np.concatenate(g_own_narrow, 1)),
    }


def test_region_ops_and_vocab_ce_match_one_process(runs):
    """copy_to, reduce_from, gather_from (both backwards), scatter_to and
    the vocab-parallel CE on every rank's model line, forward and
    backward, against what one process's autograd gives on the whole
    tensors."""
    logits = torch.from_numpy(np.random.default_rng(27).standard_normal(
        (2, 5, 8)).astype(np.float32)).requires_grad_(True)
    labels = torch.from_numpy(np.random.default_rng(28).integers(
        0, 8, (2, 5)))
    lo = logits.float()
    mx = lo.amax(-1, keepdim=True).detach()
    lse = mx.squeeze(-1) + torch.log(torch.exp(lo - mx).sum(-1))
    loss = (lse - lo.gather(-1, labels[..., None]).squeeze(-1)).mean()
    loss.backward()
    M = 2
    for r in runs["world"]:
        m = r["coords"]["model"]
        want = _expected_regions(m, M)
        for op, (y, g) in want.items():
            got_y, got_g = r["regions"][op]
            np.testing.assert_allclose(got_y, y, rtol=1e-6, atol=1e-6,
                                       err_msg=op)
            np.testing.assert_allclose(got_g, g, rtol=1e-6, atol=1e-6,
                                       err_msg=op)
        got_loss, got_grad = r["regions"]["ce"]
        np.testing.assert_allclose(got_loss, float(loss.detach()), rtol=1e-6)
        np.testing.assert_allclose(got_grad,
                                   logits.grad[..., m * 4:(m + 1) * 4],
                                   rtol=1e-5, atol=1e-7)


def test_replicated_leaves_get_one_gradient_on_a_model_line(runs):
    """A leaf replicated over model (the norm scales, the 2-layer dense
    MLP) gets the same gradient on every rank of a model line: the
    compute that reads it is replicated, and a whole leaf read by a
    rank's own heads (qk-norm) enters through copy_to."""
    lines: dict = {}
    for r in runs["world"]:
        c = r["coords"]
        lines.setdefault((c["node"], c["fsdp"]), []).append(r["grads"])
    names = set()
    for grads in lines.values():
        assert len(grads) == 2
        names |= set(grads[0])
        for k, g in grads[0].items():
            np.testing.assert_array_equal(grads[1][k], g, err_msg=k)
    assert {"layers.0.attn.q_norm.scale", "layers.0.mlp.w_gate",
            "final_norm.scale"} <= names


def _like(single_case, cfg):
    """A JAX ``like`` tree of the driver's carry-buffer checkpoint."""
    params = {k: torch.from_numpy(v) for k, v in
              single_case["params"].items()}
    live = train_state_to_jax(params, params, cfg)
    like = jax.tree.map(lambda t: jnp.zeros(tuple(t.shape), jnp.float32),
                        live)
    n = next(iter(params.values())).shape[0]
    per_node = 2 * sum(v[0].numel() for v in params.values())
    width = per_node + -per_node % JAX_PAD_MULTIPLE
    like["gossip_buf"] = (jnp.zeros((n, width), jnp.float32),)
    return like


def test_tp_checkpoint_equals_single_process(runs):
    """The carry-buffer checkpoint of the int8 case on (node 4, fsdp 1,
    model 2) -- each leaf gathered over model, the node rows at rank 0,
    ``gossip_buf`` unpacked, gathered and converted node by node -- is
    read by repro.checkpoint.restore and equals the single-process run's
    within 2e-4 of max-abs plus one int8 level of the array."""
    like = _like(runs["single"]["overlap_int8"],
                 _specs("overlap_int8")[0])
    got = jckpt.restore(f"{runs['mesh_ck']}/overlap_int8", 2, like)
    want = jckpt.restore(f"{runs['one_ck']}/overlap_int8", 2, like)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_got) == len(flat_want) == len(jax.tree.leaves(like))
    for (path, g), (_, w) in zip(flat_got, flat_want):
        w = np.asarray(w)
        _close(np.asarray(g), w, float(np.abs(w).max()) / 127, str(path))
    assert np.abs(np.asarray(got["gossip_buf"][0])).max() > 0
