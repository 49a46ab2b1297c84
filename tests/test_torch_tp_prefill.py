"""Model-sharded prefill (``repro_torch.launch.steps.make_prefill_step(tp=,
fsdp=)``): a replica's ``fsdp x model`` ranks prefill their rows of the
batch on their ``(fsdp, model)`` shards of the serving params -- the
fsdp shards gathered, the tensor-parallel forward (``launch/tp.py``),
the experts dropless on model shards (``models/moe.py``).

One CPU world of 4 spawned ranks (gloo, a ``file://`` store under a
temporary directory, one thread a rank) on (node 1, fsdp 2, model 2)
runs each of ``mesh_check.prefill_cases`` in f32 activations (so sums
that reorder hold to 2e-4 of max-abs): every family at its reduced
config -- qwen3, qwen3 under ``attention_impl="pallas"`` (the
flash-attention kernel on each rank's heads; its plain version on the
CPU), granite-moe with 4 experts (expert-parallel over model 2) and 3
(the ff cut), granite-34b (one kv head: k and v gathered), mamba2,
zamba2, musicgen and llama-3.2-vision -- on a batch of 4 x 16, two rows
a rank.  Each rank's last logits, gathered over model, are held against
the single-process ``make_prefill_step`` with the plain attention, and
the qwen3 and moe cases also against the reference's
``make_prefill_step`` (its Pallas kernel in interpret mode under
``"pallas"``), the weights carried across by ``convert.params_from_jax``;
each rank's wire log is counted by scope against the ops reckoned here.
The weights reach the ranks as ``.npz`` files: a world's arguments are
pickled to each rank in turn as it starts.

Single-process: the prefill step reads ``attention_impl`` as the
reference's does (the kernel once a layer under ``"pallas"``, never
under ``"jnp"``), and on ``meta`` the dry run's count holds the kernel's
formula once a layer at rank 0's heads.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as JSteps
from repro.models import model as JM
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MM, mesh_check as MC
from repro_torch.launch import steps as TSteps
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoe

ARGV = ["--device", "cpu", "--f32", "--batch", "4", "--seq", "16"]
TOL = 2e-4
CASES = MC.prefill_cases(ARGV)
REF = ("dense", "dense_pallas", "moe", "moe_e3")
WORLD = 4

# each case's wire ops a rank, reckoned from the reduced configs' cuts on
# (node 1, fsdp 2, model 2): the fsdp shards gathered in one all_gather
# (every leaf f32); a psum for the vocab-parallel embedding (V 512 cut
# over model; audio's 4 codebooks in one), for each row-parallel ``wo``
# and ``out_proj``, for each layer's experts (either route), and for the
# hybrid shared block's ``w_down`` (its MLP is cut on ff; at 2 layers a
# dense MLP's stack divides model 2 and stays whole); an all_gather for
# granite-34b's single kv head (k and v, each layer), for mamba2's
# ``in_proj`` output and its ``conv_w`` and ``conv_b`` (each layer), and
# for the shared block's ``in_proj`` output (2 applications in 7 layers)
WIRE = {
    "dense": {"model:psum": 1 + 2},
    "dense_pallas": {"model:psum": 1 + 2},
    "moe": {"model:psum": 1 + 2 * 2},
    "moe_e3": {"model:psum": 1 + 2 * 2},
    "kv1": {"model:psum": 1 + 2, "model:all_gather": 2 * 2},
    "ssm": {"model:psum": 1 + 2, "model:all_gather": 3 * 2},
    "hybrid": {"model:psum": 1 + 7 + 2 * 2,
               "model:all_gather": 3 * 7 + 2},
    "audio": {"model:psum": 1 + 2},
    "vlm": {"model:psum": 1 + 4 + 2},        # 4 self layers, 2 cross
}


def _configs(name):
    """(the reference's config, the port's) of a case, f32 activations."""
    argv, rep = CASES[name]
    args = MC.prefill_args(argv)
    tcfg = MC.prefill_config(args, rep)
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config(args.arch)),
        activation_dtype=jnp.float32, attention_impl=args.impl,
        **(rep or {}))
    return args, jcfg, tcfg


def _draw(name):
    """Seeded numpy weights at the reference's shapes (fan-in scaled), as
    the reference's tree and carried to the port's names."""
    _, jcfg, tcfg = _configs(name)
    shapes = jax.eval_shape(lambda: JM.init(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(3)

    def draw(s):
        scale = s.shape[-2] ** -0.5 if len(s.shape) >= 2 else 0.1
        return (scale * rng.standard_normal(s.shape)).astype(s.dtype)

    tree = jax.tree.map(draw, shapes)
    return tree, {k: v.numpy() for k, v in
                  params_from_jax(tree, tcfg).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's results, each case's single-process logits (the plain
    attention), and the reference cases' logits from the JAX package."""
    draws = {name: _draw(name) for name in REF}
    store = tmp_path_factory.mktemp("tp_prefill_store")
    paths = {}
    for name, (_, weights) in draws.items():
        paths[name] = str(store / f"{name}.npz")
        np.savez(paths[name], **weights)
    world = MM.spawn(MC.prefill_cases_rank, WORLD, (ARGV, paths),
                     store_dir=str(store), threads=1, timeout=300)
    single = {name: MC.single_prefill(
        argv, rep, draws[name][1] if name in draws else None)
        for name, (argv, rep) in CASES.items()}
    refs = {}
    for name in REF:
        args, jcfg, tcfg = _configs(name)
        tokens = MC.prefill_batch(tcfg, args)["tokens"].numpy()
        refs[name] = np.asarray(jax.jit(JSteps.make_prefill_step(jcfg))(
            jax.tree.map(jnp.asarray, draws[name][0]),
            {"tokens": jnp.asarray(tokens.astype(np.int32))}), np.float32)
    return {"world": world, "single": single, "refs": refs}


def _hold(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_case_matches_single_process(runs, name):
    """Each rank's rows' last logits, gathered over model, against the
    single-process prefill step on the whole batch with the plain
    attention (under ``"pallas"`` this holds the kernel's path against
    its plain version), within 2e-4 of max-abs."""
    want = runs["single"][name]
    for r in runs["world"]:
        _hold(r[name]["logits"], want[r[name]["rows"]],
              f"{name} rank {r[name]['rank']}")


@pytest.mark.parametrize("name", REF)
def test_case_matches_the_reference(runs, name):
    """qwen3 (plain and ``"pallas"``) and granite-moe under both expert
    routes: each rank's rows against the reference's
    ``make_prefill_step`` on the same weights and tokens."""
    want = runs["refs"][name]
    for r in runs["world"]:
        _hold(r[name]["logits"], want[r[name]["rows"]],
              f"{name} rank {r[name]['rank']}")


def test_rows_follow_the_batch_spec(runs):
    """The batch of 4 splits over (node 1 x fsdp 2): fsdp rank f holds
    rows 2f and 2f + 1, alike on both ranks of its model line; every
    rank holds less than the replica's parameters."""
    for r in runs["world"]:
        for name in CASES:
            f = r[name]["coords"]["fsdp"]
            assert r[name]["rows"].tolist() == [2 * f, 2 * f + 1], name
    for name, (argv, rep) in CASES.items():
        cfg = MC.prefill_config(MC.prefill_args(argv), rep)
        whole = TM.param_count(TM.init(cfg, device="meta"))
        assert all(r[name]["param_elems"] < whole
                   for r in runs["world"]), name


@pytest.mark.parametrize("name", list(CASES))
def test_wire_ops_by_scope(runs, name):
    """Each rank's wire log: one fsdp all_gather and the model ops
    reckoned in ``WIRE``, alike on every rank, nothing else."""
    want = dict(WIRE[name], **{"fsdp:all_gather": 1})
    for r in runs["world"]:
        got = {k: v["ops"] for k, v in r[name]["log"].items()}
        assert got == want, (name, r[name]["rank"], got)


def test_pallas_cases_count_no_card_launch(runs):
    """On the CPU the kernels' wrappers run their plain versions: no
    rank counts a launch."""
    for r in runs["world"]:
        for name in CASES:
            assert r[name]["launches"] == {"flash_attention": 0,
                                           "ssd_scan": 0}, name


def test_prefill_step_reads_attention_impl(runs, monkeypatch):
    """Reduced qwen3 in f32: the port's single-process prefill step under
    ``"pallas"`` calls the flash-attention wrapper once a layer (its
    plain version on the CPU) and under ``"jnp"`` never, as the
    reference's forward reads ``attention_impl``; its logits match the
    reference's step under ``"pallas"`` (the Pallas kernel in interpret
    mode) within 2e-4 of max-abs."""
    calls = []
    real = fa_ops.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention", counted)
    args, _, tcfg = _configs("dense_pallas")
    tokens = MC.prefill_batch(tcfg, args)["tokens"]
    params = TM.params_view({k: torch.from_numpy(v)
                             for k, v in _draw("dense_pallas")[1].items()})
    got = TSteps.make_prefill_step(tcfg)(params, {"tokens": tokens})
    assert len(calls) == tcfg.n_layers
    _hold(got.numpy(), runs["refs"]["dense_pallas"], "pallas step")
    calls.clear()
    TSteps.make_prefill_step(dataclasses.replace(
        tcfg, attention_impl="jnp"))(params, {"tokens": tokens})
    assert calls == []


def test_pallas_count_holds_the_kernel_once_a_layer():
    """qwen3 ``prefill_32k`` on one pod under ``--knob
    attention_impl=pallas``: rank 0's count records the flash-attention
    kernel once in each of its 28 layers, at its heads -- one query
    head of 16 over model 16, the kv head it reads picked from the
    gathered 8 -- by the kernel's formula."""
    cost, meta = D.build("qwen3-0.6b", "prefill_32k", multi_pod=False,
                         knobs={"attention_impl": "pallas"})
    assert meta["rank_rows"] == 2
    q = torch.empty((2, 32768, 1, 128), dtype=torch.bfloat16,
                    device="meta")
    flops, nbytes = fa_ops.cost(q, q)
    op = cost.by_op["flash_attention"]
    assert (op.calls, op.flops, op.bytes) == (28, 28 * flops, 28 * nbytes)


def test_dropless_refuses_a_routing_group():
    """A serving batch has no moe routing group: the dropless mixture
    refuses ``route=`` (its model shards it takes)."""
    moe = TMoe.MoE(8, 8, 2, device="cpu")
    with pytest.raises(ValueError, match="routing group"):
        TMoe.moe_apply(moe, torch.zeros(1, 2, 8), n_experts=2, top_k=1,
                       dropless=True, route=object())
