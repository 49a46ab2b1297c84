"""Model-sharded decode (``repro_torch.launch.steps.make_serve_step(tp=,
fsdp=)``): a replica's ``fsdp x model`` ranks decode their rows of the
batch on their ``(fsdp, model)`` shards of the serving params and their
shard of the ring / SSM cache as ``sharding.cache_specs`` cuts it -- the
kv heads, else the head dim (``models/attention.py: attn_decode(tp=)``),
mamba2's conv on its packed channels and its state on its heads
(``models/mamba2.py: mamba2_decode(tp=)``).

One CPU world of 4 spawned ranks (gloo, a ``file://`` store under a
temporary directory, one thread a rank) on (node 1, fsdp 2, model 2)
runs each of ``mesh_check.decode_cases`` in f32 activations: every
family at its reduced config -- qwen3 (kv heads cut), granite-34b (one
kv head: the head dim cut), gemma2 with one kv head (its soft-cap and
sliding window on the head-dim cut), granite-moe with 4 experts
(expert-parallel) and 3 (the ff cut), mamba2, zamba2, musicgen and
llama-3.2-vision with images -- 2 rows a rank of a batch of 4, from a
cache of 80 slots drawn from the seed with numpy, 3 steps at positions
100-102: past the ring's length (it wraps) and past gemma2's reduced
window of 64 (the window masks).  Each rank's logits of every step,
gathered over model, and its final cache shard are held against the
single-process ``make_serve_step`` within 2e-4 of max-abs, and the
qwen3, granite-34b, both moe and mamba2 cases also against the
reference's ``make_serve_step``, the weights carried across by
``convert.params_from_jax`` and the cache from the same numpy arrays;
each rank's wire log is counted by scope against the ops reckoned here.
The reference cases' weights reach the ranks as ``.npz`` files.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as JSteps
from repro.models import attention as JA
from repro.models import mamba2 as JM2
from repro.models import model as JM
from repro_torch.convert import params_from_jax
from repro_torch.launch import mesh as MM, mesh_check as MC
from repro_torch.launch import sharding as TS
from repro_torch.launch.tp import TP
from repro_torch.models import attention as TA
from repro_torch.models import mamba2 as TM2

ARGV = ["--device", "cpu", "--f32"]
TOL = 2e-4
CASES = MC.decode_cases(ARGV)
REF = ("dense", "kv1", "moe", "moe_e3", "ssm")
WORLD = 4
STEPS = 3

# each case's wire ops a rank in a step, reckoned from the reduced
# configs' cuts on (node 1, fsdp 2, model 2): a psum for the
# vocab-parallel embedding, for each row-parallel ``wo`` and
# ``out_proj``, for each layer's experts and for the hybrid shared
# block's ``w_down`` (a dense MLP's 2-layer stack divides model 2 and
# stays whole, as in the prefill); on the head-dim cut (granite-34b,
# gemma2 with one kv head, the vlm's self layers, whose cache
# cache_specs cuts on the head dim first) one f32 psum of the partial
# logits a layer and an all_gather each of q, k, v and of the output's
# head-dim block; for mamba2 an all_gather of ``in_proj``'s output, of
# the conv output and of the heads' y a layer; for the shared block an
# all_gather of its ``in_proj`` output (2 applications in 7 layers)
WIRE = {
    "dense": {"model:psum": 1 + 2},
    "kv1": {"model:psum": 1 + 2 + 2, "model:all_gather": 4 * 2},
    "gemma2_kv1": {"model:psum": 1 + 2 + 2, "model:all_gather": 4 * 2},
    "moe": {"model:psum": 1 + 2 * 2},
    "moe_e3": {"model:psum": 1 + 2 * 2},
    "ssm": {"model:psum": 1 + 2, "model:all_gather": 3 * 2},
    "hybrid": {"model:psum": 1 + 7 + 2 * 2,
               "model:all_gather": 3 * 7 + 2},
    "audio": {"model:psum": 1 + 2},
    "vlm": {"model:psum": 1 + 4 + 4 + 2,     # 4 self layers, 2 cross
            "model:all_gather": 4 * 4},
}


def _configs(name):
    """(parsed flags, the reference's config, the port's) of a case, f32
    activations."""
    argv, rep = CASES[name]
    args = MC.decode_args(argv)
    tcfg = MC.decode_config(args, rep)
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config(args.arch)),
        activation_dtype=jnp.float32, **(rep or {}))
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


def _jax_cache(flat):
    """The reference's cache tree of :func:`MC.cache_arrays` arrays."""
    kinds = {"kv": JA.KVCache, "shared_kv": JA.KVCache, "ssm": JM2.SSMCache}
    return {k: cls(*(jnp.asarray(flat[f"{k}.{f}"]) for f in cls._fields))
            for k, cls in kinds.items() if f"{k}.{cls._fields[0]}" in flat}


def _reference(name, tree):
    """The reference's ``make_serve_step`` from the same cache over the
    same tokens: each step's logits and the final cache, as numpy."""
    args, jcfg, tcfg = _configs(name)
    tokens = MC.decode_batch(tcfg, args)["tokens"].numpy().astype(np.int32)
    cache = _jax_cache(MC.decode_cache(tcfg, args))
    step = jax.jit(JSteps.make_serve_step(jcfg))
    params = jax.tree.map(jnp.asarray, tree)
    logits = []
    for i in range(args.steps):
        out, cache = step(params, cache, {
            "token": jnp.asarray(tokens[:, i:i + 1]),
            "idx": MC.decode_start(args) + i})
        logits.append(np.asarray(out, np.float32))
    final = {f"{k}.{f}": np.asarray(getattr(v, f))
             for k, v in cache.items() for f in v._fields}
    return {"logits": np.stack(logits), "final": final}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's results, each case's single-process decode, and the
    reference cases' decode from the JAX package."""
    draws = {name: _draw(name) for name in REF}
    store = tmp_path_factory.mktemp("tp_decode_store")
    paths = {}
    for name, (_, weights) in draws.items():
        paths[name] = str(store / f"{name}.npz")
        np.savez(paths[name], **weights)
    world = MM.spawn(MC.decode_cases_rank, WORLD, (ARGV, paths),
                     store_dir=str(store), threads=1, timeout=300)
    # the references after the world and on one thread: beside the
    # suite's other workers a world and a many-threaded parent slowed
    # each other and a neighbouring file several times over
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = {name: _reference(name, draws[name][0]) for name in REF}
        single = {name: MC.single_decode(
            argv, rep, draws[name][1] if name in draws else None)
            for name, (argv, rep) in CASES.items()}
    finally:
        torch.set_num_threads(threads)
    return {"world": world, "single": single, "refs": refs}


def _hold(res, want, name):
    """Every rank's logits and final cache shard within TOL of max-abs
    of ``want``'s (the shapes checked by ``decode_errors``)."""
    errs = MC.decode_errors(res, want, CASES[name][0])
    lo = float(np.abs(want["logits"]).max())
    ca = max(float(np.abs(v).max()) for v in want["final"].values())
    for r, (e_lo, e_ca) in zip(res, errs):
        assert e_lo <= TOL * lo, (name, r["rank"], e_lo, lo)
        assert e_ca <= TOL * ca, (name, r["rank"], e_ca, ca)


@pytest.mark.parametrize("name", list(CASES))
def test_case_matches_single_process(runs, name):
    """Each rank's rows' logits at every step, gathered over model, and
    its final cache shard against the single-process serve step on the
    whole batch and the whole cache, within 2e-4 of max-abs."""
    _hold([r[name] for r in runs["world"]], runs["single"][name], name)


@pytest.mark.parametrize("name", REF)
def test_case_matches_the_reference(runs, name):
    """qwen3, granite-34b (the head-dim cut), granite-moe under both
    expert routes and mamba2: each rank against the reference's
    ``make_serve_step`` on the same weights, cache and tokens."""
    _hold([r[name] for r in runs["world"]], runs["refs"][name], name)


@pytest.mark.parametrize("name", list(CASES))
def test_wire_ops_by_scope(runs, name):
    """Each rank's wire log over the steps: one fsdp all_gather a step
    and the model ops reckoned in ``WIRE``, alike on every rank, nothing
    else; and no kernel launched (the ring decode is plain PyTorch)."""
    want = {k: STEPS * v for k, v in
            dict(WIRE[name], **{"fsdp:all_gather": 1}).items()}
    for r in runs["world"]:
        got = {k: v["ops"] for k, v in r[name]["log"].items()}
        assert got == want, (name, r[name]["rank"], got)
        assert not any(r[name]["launches"].values()), name


def _layer_cache(shard: dict) -> float:
    """The bytes of the smallest cache one layer holds on a rank: each
    cache's shard over its stacked layers (vlm: groups x self layers)."""
    per = {}
    for k, v in shard.items():
        g = k.split(".")[0]
        per[g] = per.get(g, 0.0) + v.nbytes / np.prod(
            v.shape[:2 if v.ndim == 6 else 1])
    return min(per.values())


@pytest.mark.parametrize("name", list(CASES))
def test_cache_shards_follow_cache_specs(runs, name):
    """Each rank's cache shard has ``local_shard``'s shape under
    ``cache_specs`` at its coordinates -- a quarter of each leaf: its
    rows and half of its model cut -- and the model ops of a step send,
    a layer, fewer bytes than the smallest cache one layer holds on the
    rank: no op moves a cache."""
    args, _, tcfg = _configs(name)
    full = MC.decode_cache(tcfg, args)
    mesh = MM.abstract_mesh(MC.DECODE_MESH[0], MC.TRAIN_AXES)
    specs = TS.cache_specs(full, mesh, args.batch)
    for r in runs["world"]:
        want = TS.local_shard({k: torch.from_numpy(v) for k, v in
                               full.items()}, specs, mesh, r[name]["coords"])
        for k, v in want.items():
            assert r[name]["cache"][k].shape == tuple(v.shape), (name, k)
            assert 4 * v.numel() == full[k].size, (name, k)
        sent = sum(v["bytes"] for k, v in r[name]["log"].items()
                   if k.startswith("model:"))
        per_layer = sent / STEPS / tcfg.n_layers
        assert per_layer < _layer_cache(r[name]["cache"]), (name, per_layer)


def test_rows_and_positions(runs):
    """The batch of 4 splits over (node 1 x fsdp 2): fsdp rank f holds
    rows 2f and 2f + 1 on both ranks of its model line; the steps'
    positions pass the ring's length and gemma2's window."""
    for r in runs["world"]:
        for name in CASES:
            f = r[name]["coords"]["fsdp"]
            assert r[name]["rows"].tolist() == [2 * f, 2 * f + 1], name
    args, _, tcfg = _configs("gemma2_kv1")
    assert MC.decode_start(args) >= args.cache_len > tcfg.sliding_window


def test_gemma2_window_bites():
    """gemma2 with one kv head at the decode's positions: without its
    sliding window the single-process logits move, so the window the
    head-dim-cut ranks match is one that masks."""
    argv, rep = CASES["gemma2_kv1"]
    with_w = MC.single_decode(argv, rep)["logits"]
    without = MC.single_decode(argv, dict(rep, sliding_window=None))["logits"]
    assert np.abs(with_w - without).max() > 1e-3 * np.abs(with_w).max()


def test_a_cut_the_decode_cannot_run_raises():
    """A cache shard cut over model on neither its kv heads nor its head
    dim (its slots, say), or an SSM shard cut off its channels and
    heads, raises and names the cut: the decode never gathers a cache
    whole."""
    tp = TP(MM.dry_mesh(MM.abstract_mesh((1, 1, 2), MC.TRAIN_AXES)), {})
    kv = torch.zeros((2, 4, 8, 64))              # (B, Kv, T / 2, hd): slots
    with pytest.raises(ValueError, match="neither its 4 kv heads"):
        TA._ring_cut(tp, TA.KVCache(kv, kv), 4, 64)
    assert TA._ring_cut(tp, TA.KVCache(kv, kv), 8, 64) == "heads"
    assert TA._ring_cut(tp, TA.KVCache(kv, kv), 4, 128) == "head_dim"
    cache = TM2.SSMCache(torch.zeros((2, 3, 272)), torch.zeros((2, 16, 16,
                                                               16)))
    with pytest.raises(ValueError, match="channels and the heads"):
        TM2._ssm_cut(tp, cache, 544, 16)
    TM2._ssm_cut(tp, cache, 544, 32)
