"""Training on a node mesh does all that one process does
(``repro_torch.launch.train.run(args, mesh=)``, one rank a node).

One CPU world of 4 spawned ranks (gloo, a ``file://`` store under a
temporary directory, one thread a rank) runs reduced qwen3 in f32 for 3
steps through each of ``mesh_check.train_cases``: the overlapped trainer
(its delayed round's wire posted before the rank's gradients and
completed after them) plain with carry-buffer checkpoints, and under
int8 with flush-on-save checkpoints; ``parallel_msgd`` (the gradient mean
one ``psum`` per dtype group); then ``build_trainer(warmup_steps=1)`` on
the mesh; then runtime rounds with 2 nodes a rank on a (node 2, fsdp 2)
mesh of 4-node trees.  Every case is held against the single-process
port run (bit for bit here, asserted within 2e-4) and against the
reference's ``build_trainer`` without a mesh (2e-4, the reference's f32
tolerance); each checkpoint directory a mesh run writes is read by
``repro.checkpoint.restore`` and equals the single-process run's array
for array; the runtime blocks equal the global path bit for bit.
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
from repro_torch.launch import train as TTrain

ARGV = ["--device", "cpu", "--nodes", "4", "--steps", "3", "--batch", "2",
        "--seq", "16", "--log-every", "1", "--hetero", "0.5", "--desync"]
TOL = dict(rtol=2e-4, atol=2e-4)
CASES = ["overlap", "overlap_int8", "parallel_msgd", "warmup"]
CKPT = {"overlap": True, "overlap_int8": False}   # carries gossip_buf


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's results and the mesh runs' checkpoint directory, each
    case's single-process run and checkpoint directory, and each case's
    reference run: the world runs in its own processes while this one
    computes the other two."""
    store = tmp_path_factory.mktemp("mesh_train_store")
    mesh_ck = str(tmp_path_factory.mktemp("mesh_train_ck"))
    one_ck = str(tmp_path_factory.mktemp("single_ck"))
    got = {}

    def spawn():
        try:
            got["world"] = MM.spawn(MC.train_cases_rank, 4, (ARGV, mesh_ck),
                                    store_dir=str(store), threads=1,
                                    timeout=300)
        except BaseException as e:          # re-raised below
            got["error"] = e

    th = threading.Thread(target=spawn, daemon=True)
    th.start()
    try:
        torch.set_num_threads(1)
        single = {}
        for name, argv in MC.train_cases(ARGV, one_ck).items():
            args = TTrain.parse_args(argv)
            res = TTrain.run(args, start=MC.f32_start(args))
            single[name] = {"losses": [h["loss"] for h in res["history"]],
                            "params": res["params"],
                            "momentum": res["state"].momentum,
                            "config": res["config"]}
        single["warmup"] = MC.warmup_run(TTrain.parse_args(ARGV), 1)
        refs = {name: _reference(name) for name in CASES}
    finally:
        th.join(timeout=300)
    if "error" in got:
        raise got["error"]
    return {"world": got["world"], "mesh_ck": mesh_ck, "single": single,
            "one_ck": one_ck, "refs": refs}


def _reference(name):
    """The case on the reference's build_trainer without a mesh (its int8
    wire, which the reference's build_trainer does not take, through
    the same optimizer, train step and plan): losses, the final (flushed)
    params and momentum, the plan keys."""
    args = TTrain.parse_args(dict(MC.train_cases(ARGV), warmup=ARGV)[name])
    start = MC.f32_start(args)
    tcfg = start["config"]
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config("qwen3-0.6b")),
        activation_dtype=jnp.float32)
    jtop = JT.get_topology("one_peer_exp", args.nodes)
    if args.compression:
        opt = JO.make_optimizer(args.optimizer, jtop, beta=args.beta,
                                compression=args.compression,
                                overlap=args.overlap)
        plan = JPlan.for_optimizer(opt, fn=JSteps.make_train_step(jcfg, opt))
        step_for = plan.step_fn
    else:
        opt, step_for = JTrain.build_trainer(
            jcfg, jtop, args.optimizer, args.beta, overlap=args.overlap,
            warmup_steps=1 if name == "warmup" else 0)
        plan = step_for.plan
    jx = jax.tree.map(jnp.asarray, stacked_to_jax(
        {k: v.clone() for k, v in start["params"].items()}, tcfg))
    js = opt.init(jx)
    lr_fn = JSch.warmup_step_decay(
        args.lr, args.warmup, [int(args.steps * 0.6),
                               int(args.steps * 0.85)])
    losses = []
    for k in range(args.steps):
        jb = {"tokens": jnp.asarray(start["batches"][k]["tokens"].numpy())}
        jx, js, jl = step_for(k)(jx, js, jb, lr_fn(k))
        losses.append(float(jl))
    if args.overlap:
        jx, js = plan.flush_step_fn(args.steps)(jx, js)
    return {"losses": losses,
            "params": stacked_from_jax(jax.tree.map(np.asarray, jx), tcfg),
            "momentum": stacked_from_jax(jax.tree.map(np.asarray,
                                                      js.momentum), tcfg),
            "keys": [plan.realization_key(k) for k in range(args.steps)]}


def _rows(tree, rank):
    return {k: np.asarray(v[rank:rank + 1], np.float32)
            for k, v in tree.items()}


def _quantum(tree: dict) -> dict:
    """One int8 level of each leaf's largest value (``max|x| / 127``)."""
    return {k: float(np.abs(np.asarray(v)).max()) / 127 for k, v in
            tree.items()}


@pytest.mark.parametrize("name", CASES)
def test_node_mesh_case_matches_single_process_and_reference(runs, name):
    """Each rank's losses and final (m, x) against the single-process run
    and the reference's, within 2e-4; the warm-up's plan keys are the
    reference's.  Under int8 the reference's final (m, x) is held within
    2e-4 plus one int8 level of the leaf: an f32 rounding apart in the
    frameworks' forwards can move an element across a rounding boundary
    of the wire (both quantizers agree bit for bit on the same inputs,
    tests/test_torch_int8.py)."""
    one, ref = runs["single"][name], runs["refs"][name]
    for rank, r in enumerate(runs["world"]):
        got = r[name]
        losses = (got["losses"] if name == "warmup"
                  else [h["loss"] for h in got["history"]])
        np.testing.assert_allclose(losses, one["losses"], **TOL)
        np.testing.assert_allclose(losses, ref["losses"], **TOL)
        for part in ("params", "momentum"):
            mine, theirs = _rows(one[part], rank), _rows(ref[part], rank)
            level = (_quantum(ref[part]) if name == "overlap_int8"
                     else dict.fromkeys(theirs, 0.0))
            assert set(got[part]) == set(mine)
            for k, v in got[part].items():
                np.testing.assert_allclose(v, mine[k], **TOL)
                np.testing.assert_allclose(v, theirs[k], rtol=TOL["rtol"],
                                           atol=TOL["atol"] + level[k])
    if name == "warmup":
        assert runs["world"][0]["warmup"]["keys"] == one["keys"] == \
            ref["keys"]
        assert ref["keys"][0] == ("warmup",)


def test_wire_logs_of_the_node_mesh_steps(runs):
    """An overlapped step's delayed round is one permute a dtype group
    (two under int8), open while the gradients ran; parallel_msgd's step
    one psum a gradient dtype group; the logging, flushes and checkpoints
    in scopes of their own."""
    res = runs["world"]
    delayed = 2          # 3 steps: a round in flight at steps 1 and 2
    for r in res:
        for name, per_round in (("overlap", 1), ("overlap_int8", 2)):
            log = r[name]["log"]
            assert log["permute"]["ops"] == delayed * per_round, name
            assert log["permute"]["open_s"] > 0
            assert log["flush:permute"]["ops"] == per_round
            assert log["log:permute"]["ops"] == 3 * per_round
            assert "ckpt:gather" in log
        assert "ckpt:permute" in r["overlap_int8"]["log"]
        log = r["parallel_msgd"]["log"]
        assert log["psum"]["ops"] == 3 and "permute" not in log
        assert "log:psum" in log
        assert set(r["warmup"]["log"]) == {"psum", "permute"}


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


@pytest.mark.parametrize("name", sorted(CKPT))
def test_mesh_checkpoint_equals_single_process(runs, name):
    """The checkpoint a mesh run writes (rank 0, the node rows gathered)
    is read by repro.checkpoint.restore and equals the single-process
    run's array for array: carry-buffer with gossip_buf, flush-on-save
    without."""
    like = _like(runs["single"][name], CKPT[name])
    got = jckpt.restore(f"{runs['mesh_ck']}/{name}", 2, like)
    want = jckpt.restore(f"{runs['one_ck']}/{name}", 2, like)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_got) == len(flat_want) == len(jax.tree.leaves(like))
    for (path, g), (_, w) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=str(path))
    assert ("gossip_buf" in got) == CKPT[name]


def test_runtime_rounds_with_two_nodes_a_rank(runs):
    """Shifts and Matching with metadata, loss-aware weights, a per-node
    gate and fixed points, on a (node 2, fsdp 2) mesh of 4-node trees:
    every block bit for bit the global path's; each rank gathers the
    payload and its per-node values over the node axis."""
    res = runs["world"]
    names = {name for name, _ in MC.runtime_rounds(
        4, MC.runtime_inputs(4), slice(None), "cpu")}
    for r in res:
        rt = r["runtime"]
        assert set(rt["rounds"]) == names
        want = MC.gathered_runtime_expected(rt["coords"])
        for name, blocks in rt["rounds"].items():
            for k, v in blocks.items():
                np.testing.assert_array_equal(v, want[name][k],
                                              err_msg=f"{name}.{k}")
        assert rt["log"]["all_gather"]["ops"] > 0
        assert "permute" not in rt["log"]
