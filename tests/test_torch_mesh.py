"""The port's logical mesh, sharding rules and training on a mesh
(``repro_torch.launch.mesh`` / ``sharding``, ``launch.train.run(mesh=)``)
against the JAX package's.

* The sharding rules against the reference's ``param_specs`` /
  ``cache_specs`` / ``batch_spec`` on every reduced config, on (node,
  fsdp) and (node, fsdp, model) meshes: the port's per-layer leaves take
  their JAX leaf's spec with the stacked layer axes dropped.  The
  reference's rules read only ``mesh.axis_names`` and
  ``mesh.devices.shape``, so the port's abstract mesh stands in for a JAX
  mesh and no JAX devices are needed.
* One CPU world of 4 spawned ranks (gloo, a ``file://`` store under
  ``tmp_path``): ``local_shard`` / ``gather`` round trips on a (node 2,
  fsdp 2) mesh, ``to_logical_mesh`` of a live mesh, and 3 DmSGD steps of
  reduced qwen3 in f32 on a (node 4) mesh, one rank per node, held
  against the port's single-process run and the reference's
  ``build_trainer`` without a mesh.
* Training on (node, fsdp, model) meshes builds -- fsdp and model
  extents above 1 alike (items 18b-b and 18b-c) -- and what a training
  mesh cannot be still raises (a node axis of another size, an axis
  besides node, fsdp and model); a rank's ``prepare`` builds only its
  own node.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.core import schedule as JSch, topology as JT
from repro.launch import mesh as JMesh, sharding as JS, train as JTrain
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.benchmarks import common
from repro_torch.convert import stacked_from_jax, stacked_from_nested
from repro_torch.core import topology as TT
from repro_torch.launch import mesh as MM, mesh_check as MC
from repro_torch.launch import sharding as TS, tp as TP, train as TTrain
from repro_torch.models import model as TM

ARCHS = [tconfigs.get_config(a).name for a in tconfigs.ARCHS]
MESHES = [((4, 2), ("node", "fsdp")), ((2, 2, 2), ("node", "fsdp", "model")),
          ((2, 4, 4), ("node", "fsdp", "model"))]
NODES = 2
TRAIN_ARGV = ["--device", "cpu", "--nodes", "4", "--steps", "3", "--batch",
              "2", "--seq", "16", "--log-every", "1", "--hetero", "0.5",
              "--desync"]
_LAYER = re.compile(r"((?:cross_)?layers)\.(\d+)\.(.+)")


@pytest.fixture(scope="module")
def jax_shapes():
    """Each reduced config's JAX param shapes (``eval_shape``)."""
    out = {}
    for arch in ARCHS:
        cfg = jconfigs.reduced_config(jconfigs.get_config(arch))
        out[arch] = jax.eval_shape(lambda c=cfg: JM.init(c, jax.random.key(0)))
    return out


def _port_tree(jshapes, arch, n):
    """The port's node-stacked tree (meta tensors) of the JAX shapes."""
    tcfg = tconfigs.reduced_config(tconfigs.get_config(arch))

    def meta(tree):
        return {k: meta(v) if isinstance(v, dict) else
                torch.empty((n,) + tuple(v.shape), device="meta")
                for k, v in tree.items()}

    return tcfg, stacked_from_nested(meta(jshapes), tcfg)


def _ref_specs(jshapes, n, mesh, node_axis):
    lead = (n,) if node_axis else ()
    tree = jax.tree.map(lambda s: jax.ShapeDtypeStruct(lead + s.shape,
                                                       s.dtype), jshapes)
    specs = JS.param_specs(tree, mesh, node_axis=node_axis)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {".".join(p.key for p in path): tuple(s) for path, s in flat}


@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("node_axis", [True, False])
def test_param_specs_match_reference(jax_shapes, shape, axes, node_axis):
    """Every reduced config's port leaves take their JAX leaf's spec with
    the stacked axes dropped (training and serving trees)."""
    mesh = MM.abstract_mesh(shape, axes)
    for arch in ARCHS:
        tcfg, port = _port_tree(jax_shapes[arch], arch, NODES)
        if not node_axis:
            port = {k: torch.empty(v.shape[1:], device="meta")
                    for k, v in port.items()}
        ref = _ref_specs(jax_shapes[arch], NODES, mesh, node_axis)
        got = TS.param_specs(port, mesh, cfg=tcfg, node_axis=node_axis)
        stacks = {"layers": (tcfg.n_layers,)}
        if tcfg.family == "vlm":
            from repro_torch.convert import _stacks
            stacks = _stacks(tcfg)
        lead = 1 if node_axis else 0
        assert set(got) == set(port)
        for name, spec in got.items():
            m = _LAYER.fullmatch(name)
            if m:
                want = ref[f"{m.group(1)}.{m.group(3)}"]
                k = len(stacks[m.group(1)])
                want = want[:lead] + want[lead + k:]
            else:
                want = ref[name]
            assert spec == want, (arch, name, spec, want)
        if tcfg.family != "vlm":      # the stack read off the tree
            assert TS.param_specs(port, mesh, node_axis=node_axis) == got


def test_payload_spec_fn_and_stacked_expert_branch(jax_shapes):
    """``gossip_payload_spec_fn`` on DmSGD's (m, x) payload is the param
    rules per half; on a model extent dividing L the dense MLP takes the
    expert-stacked branch and its per-layer leaf is replicated over
    model, as the module says; a mesh without 'node' raises."""
    mesh = MM.abstract_mesh((2, 2, 2), ("node", "fsdp", "model"))
    tcfg, port = _port_tree(jax_shapes["qwen3-0.6b"], "qwen3-0.6b", NODES)
    got = TS.gossip_payload_spec_fn(mesh, cfg=tcfg)((port, dict(port)))
    assert got[0] == got[1] == TS.param_specs(port, mesh, cfg=tcfg)
    assert tcfg.n_layers % 2 == 0
    ref = _ref_specs(jax_shapes["qwen3-0.6b"], NODES, mesh, True)
    assert ref["layers.mlp.w_gate"][1] == "model"
    assert got[0]["layers.0.mlp.w_gate"][0] == "node"
    assert "model" not in got[0]["layers.0.mlp.w_gate"]
    with pytest.raises(ValueError, match="node"):
        TS.gossip_payload_spec_fn(MM.abstract_mesh((2, 2), ("data", "fsdp")))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-1.2b",
                                  "llama-3.2-vision-90b"])
def test_cache_and_batch_specs_match_reference(arch):
    mesh = MM.abstract_mesh((2, 2, 2), ("node", "fsdp", "model"))
    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    for batch in (4, 2, 3):
        jc = jax.eval_shape(lambda: JM.init_cache(jcfg, batch, 16))
        tc = TM.init_cache(tcfg, batch, 16, device="cpu")
        want = JS.cache_specs(jc, mesh, batch)
        got = TS.cache_specs(tc, mesh, batch)
        assert set(got) == set(want)
        for key in got:
            w = jax.tree.leaves(want[key], is_leaf=lambda x: isinstance(x, P))
            assert list(got[key]) == [tuple(s) for s in w], (key, batch)
        for node_axis in (True, False):
            assert TS.batch_spec(mesh, node_axis=node_axis,
                                 batch_dim_size=batch) == \
                JS.batch_spec(mesh, node_axis=node_axis,
                              batch_dim_size=batch)


def test_logical_and_production_meshes():
    """``to_logical_mesh`` keeps the reference's reshape rule and errors;
    the production layouts are abstract; ``HW`` holds the H100's peaks
    from benchmarks/common.py and no TPU number."""
    prod = MM.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and not prod.live
    two = MM.make_production_mesh(multi_pod=True)
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    lm = MM.to_logical_mesh(prod, nodes=16, fsdp=1)
    assert lm.shape == {"node": 16, "fsdp": 1, "model": 16}
    assert MM.to_logical_mesh(two, 32, 8, model=2).shape == \
        {"node": 32, "fsdp": 8, "model": 2}
    np.testing.assert_array_equal(lm.devices.reshape(-1), np.arange(256))
    for args in ((16, 2), (3, 1, 1), (8, 8, 8)):
        with pytest.raises(ValueError) as mine:
            MM.to_logical_mesh(prod, *args)
        with pytest.raises(ValueError) as theirs:
            JMesh.to_logical_mesh(prod, *args)
        assert str(mine.value) == str(theirs.value)
    assert MM.HW["peak_flops_bf16"] == common.PEAK_BF16_FLOPS
    assert MM.HW["hbm_bw"] == common.PEAK_BYTES
    tpu = set(JMesh.HW.values())
    # net_bw, one 400 Gb/s NDR port a GPU of a DGX H100, equals v5e's ICI
    # figure by coincidence: it is pinned to its own source instead
    assert MM.HW["net_bw"] == 400e9 / 8
    assert not tpu & set(v for k, v in MM.HW.items()
                         if isinstance(v, float) and k != "net_bw")
    with pytest.raises(ValueError, match="abstract"):
        prod.permute(torch.zeros(1), [(0, 1)], "data")
    with pytest.raises(ValueError, match="cuda device"):
        MM.make_mesh((1,), ("node",), backend="nccl", device="cpu")


def test_training_on_a_mesh_refuses_item_18b():
    """fsdp extents above 1 build (ROADMAP item 18b-b), their plans on
    the mesh and the step's fsdp specs ``sharding.node_param_specs``;
    model extents above 1 build too (item 18b-c), the step's ``TP`` on
    the mesh with the same specs, fsdp 1 running no fsdp op; what still
    raises: a node axis of another size than the topology's, and an axis
    besides node, fsdp and model; on a node mesh the overlapped trainer,
    parallel_msgd, the warm-up and checkpoints (``run``'s refusals are
    ``check_mesh``'s) build, their plans on the mesh and no fsdp
    specs."""
    cfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-0.6b"))
    top = TT.one_peer_exponential(4)
    for mesh in (MM.abstract_mesh((4, 1, 2), ("node", "fsdp", "model")),
                 MM.abstract_mesh((4, 2, 2), ("node", "fsdp", "model"))):
        for kw in ({}, {"overlap": True}):
            _, step_for = TTrain.build_trainer(cfg, top, "dmsgd", 0.9,
                                               mesh=mesh, **kw)
            assert step_for.plan.mesh is mesh
            assert step_for.specs == TS.node_param_specs(cfg, 4, mesh)
            assert step_for.tp.mesh is mesh
            assert step_for.tp.dims == {
                k: TP.model_dim(v) for k, v in step_for.specs.items()}
            assert (step_for.fsdp is None) == (mesh.shape["fsdp"] == 1)
        assert TTrain.check_mesh(mesh, 4) is None
        with pytest.raises(ValueError, match="'node' axis of 8"):
            TTrain.check_mesh(mesh, 8)
    with pytest.raises(ValueError, match="axes are node, fsdp and model"):
        TTrain.check_mesh(MM.abstract_mesh((4, 2), ("node", "data")), 4)
    node = MM.abstract_mesh((4,), ("node",))
    with pytest.raises(ValueError, match="'node' axis of 8"):
        TTrain.check_mesh(node, 8)
    assert TTrain.check_mesh(node, 4) is None
    ok = MM.abstract_mesh((4, 1), ("node", "fsdp"))
    fsdp2 = MM.abstract_mesh((4, 2), ("node", "fsdp"))
    fsdp3 = MM.abstract_mesh((4, 2, 1), ("node", "fsdp", "model"))
    for name, kw in (("dmsgd", {}), ("dmsgd", {"overlap": True}),
                     ("dmsgd", {"overlap": True, "compression": "int8"}),
                     ("parallel_msgd", {}), ("dmsgd", {"warmup_steps": 1})):
        for mesh in (node, ok, fsdp2, fsdp3):
            opt, step_for = TTrain.build_trainer(cfg, top, name, 0.9,
                                                 mesh=mesh, **kw)
            assert step_for.plan.mesh is mesh
            assert opt.overlap == bool(kw.get("overlap"))
            assert opt.warmup_steps == kw.get("warmup_steps", 0)
            if mesh in (node, ok):
                assert step_for.fsdp is None
            else:
                got_mesh, specs = step_for.fsdp
                assert got_mesh is mesh
                assert specs == TS.node_param_specs(cfg, 4, mesh)


@pytest.mark.parametrize("desync", [False, True])
def test_prepare_builds_only_the_ranks_node(desync):
    """``prepare(args, node=i)`` holds node i's row of the params and of
    every per-node batch entry, as the whole run's, and no other node's
    storage (with ``--desync`` every node's start is a copy of its own);
    ``run`` refuses a start prepared for another node."""
    argv = ["--reduced", "--nodes", "4", "--steps", "2", "--batch", "1",
            "--seq", "16", "--device", "cpu", "--deadline-skip",
            "--straggler-prob", "0.25"] + (["--desync"] if desync else [])
    args = TTrain.parse_args(argv)
    full = TTrain.prepare(args)
    one = TTrain.prepare(args, node=2)
    assert full["node"] is None and one["node"] == 2
    node_bytes = sum(v[0].numel() * v.element_size()
                     for v in full["params"].values())
    assert sum(v.untyped_storage().nbytes()
               for v in one["params"].values()) == node_bytes
    for k, v in full["params"].items():
        assert torch.equal(one["params"][k], v[2:3])
    for got, want in zip(one["batches"], full["batches"]):
        assert set(got) == set(want) == {"tokens", "alive"}
        for k in want:
            assert torch.equal(got[k], want[k][2:3])
    with pytest.raises(ValueError, match="prepared for node 2"):
        TTrain.run(args, start=one)


# ---------------------------------------------------------------------------
# one world of 4 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    store = tmp_path_factory.mktemp("mesh_store")
    return MM.spawn(MC.world_rank, 4, (TRAIN_ARGV,), store_dir=str(store),
                    threads=1, timeout=300)


def test_local_shard_gather_round_trip(world):
    full = MC.roundtrip_tree()
    mesh = MM.abstract_mesh((2, 2), ("node", "fsdp"))
    for res in world:
        c = res["coords"]
        assert res["roundtrip"], c
        assert res["shapes"] == {"w": (1, 8, 8), "b": (2, 6), "h": (1, 8, 2)}
        # the block is the slice the coordinates name (b: row-major over
        # (node, fsdp))
        i, j = c["node"], c["fsdp"]
        np.testing.assert_array_equal(res["local"]["w"],
                                      full["w"][i:i + 1, 8 * j:8 * j + 8])
        k = 2 * i + j
        np.testing.assert_array_equal(res["local"]["b"],
                                      full["b"][2 * k:2 * k + 2])
        np.testing.assert_array_equal(
            res["local"]["h"], full["h"][i:i + 1, :, 2 * j:2 * j + 2].float())
        got = TS.local_shard(full, MC.ROUNDTRIP_SPECS, mesh, c)
        for key in got:
            np.testing.assert_array_equal(res["local"][key],
                                          got[key].float().numpy())


def test_live_logical_mesh(world):
    for rank, res in enumerate(world):
        shape, coords, total, wire = res["logical"]
        assert shape == {"node": 2, "fsdp": 2, "model": 1}
        assert coords == {"node": rank // 2, "fsdp": rank % 2, "model": 0}
        # the node line of rank r: r and r +- 2
        assert total == float((rank % 2) + (rank % 2 + 2))
        assert wire == "gloo"


def _single_and_reference(steps):
    args = TTrain.parse_args(TRAIN_ARGV)
    start = MC.f32_start(args)
    init = {k: v.clone() for k, v in start["params"].items()}
    batches = start["batches"]
    single = TTrain.run(args, start=start)
    # the reference's build_trainer without a mesh, from the same start
    tcfg = single["config"]
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config("qwen3-0.6b")),
        activation_dtype=jnp.float32)
    from repro_torch.convert import stacked_to_jax
    jx = jax.tree.map(jnp.asarray, stacked_to_jax(init, tcfg))
    jopt, jstep_for = JTrain.build_trainer(
        jcfg, JT.get_topology("one_peer_exp", args.nodes), "dmsgd", 0.9)
    js = jopt.init(jx)
    lr_fn = JSch.warmup_step_decay(
        args.lr, args.warmup, [int(args.steps * 0.6),
                               int(args.steps * 0.85)])
    jlosses = []
    for step in range(steps):
        jb = {"tokens": jnp.asarray(batches[step]["tokens"].numpy())}
        jx, js, jl = jstep_for(step)(jx, js, jb, lr_fn(step))
        jlosses.append(float(jl))
    ref_x = stacked_from_jax(jax.tree.map(np.asarray, jx), tcfg)
    ref_m = stacked_from_jax(jax.tree.map(np.asarray, js.momentum), tcfg)
    return single, (jlosses, ref_x, ref_m)


def test_dmsgd_on_a_node_mesh_matches_single_process_and_reference(world):
    """3 DmSGD steps of reduced qwen3 in f32, one rank per node: every
    rank's node equals the single-process run's (bit for bit here, held
    within 2e-4) and the reference's within 2e-4; the logged losses and
    consensus are the whole run's on every rank."""
    tol = dict(rtol=2e-4, atol=2e-4)
    single, (jlosses, ref_x, ref_m) = _single_and_reference(3)
    for rank, res in enumerate(world):
        tr = res["train"]
        assert tr["wire"] == "gloo" and tr["num_compiled"] == \
            single["plan"].num_compiled
        # the steps' permutes; the logging's reductions apart
        assert set(tr["log"]) == {"permute", "log:psum"}
        np.testing.assert_allclose(
            [h["loss"] for h in tr["history"]],
            [h["loss"] for h in single["history"]], **tol)
        np.testing.assert_allclose([h["loss"] for h in tr["history"]],
                                   jlosses, **tol)
        np.testing.assert_allclose(
            [h["consensus"] for h in tr["history"]],
            [h["consensus"] for h in single["history"]], rtol=1e-4,
            atol=1e-7)
        for got, want, ref in ((tr["params"], single["params"], ref_x),
                               (tr["momentum"], single["state"].momentum,
                                ref_m)):
            assert set(got) == set(want)
            for k in got:
                np.testing.assert_allclose(
                    got[k], want[k][rank:rank + 1].float().numpy(), **tol)
                np.testing.assert_allclose(
                    got[k], ref[k][rank:rank + 1].float().numpy(), **tol)
