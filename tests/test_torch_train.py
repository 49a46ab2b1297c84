"""PyTorch port parity: the DmSGD training path end to end on reduced
qwen3 (2 layers, d_model 256), with the JAX weights carried across by
``stacked_from_jax`` and the same ``SyntheticLM`` batches (bit-identical:
the pipeline is a numpy copy).  Both sides start from the same
desynchronized node params (numpy noise), train 3 steps over the one-peer
exponential graph, and must agree on the per-step losses, the params and
momentum, the consensus distance and the number of executables (the ssm
and hybrid families: tests/test_torch_train_families.py).
Tolerances: 2e-4 with activation_dtype=float32 on both sides (the
reference's f32 tolerance, tests/test_kernels.py:16; sums run in another
order), 2e-2 with bf16 activations (tests/test_kernels.py:15; bf16 rounds
at other places in the two frameworks)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import schedule as JSch, topology as JT
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import train as JTrain
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.convert import stacked_from_jax, stacked_to_jax
from repro_torch.core import schedule as TSch, topology as TT
from repro_torch.data import SyntheticLM as TSyntheticLM
from repro_torch.launch import quickstart, train as TTrain

ACT = {"f32": (jnp.float32, torch.float32, dict(rtol=2e-4, atol=2e-4)),
       "bf16": (jnp.bfloat16, torch.bfloat16, dict(rtol=2e-2, atol=2e-2))}
B, S, STEPS = 2, 16, 3


def _draw_params(arch):
    """Random weights in the JAX param tree (shapes from ``eval_shape``,
    values from numpy: no init executable to compile)."""
    cfg = jconfigs.reduced_config(jconfigs.get_config(arch))
    shapes = jax.eval_shape(lambda: JM.init(cfg, jax.random.key(0)))
    rng = np.random.default_rng(0)

    def draw(s):
        scale = s.shape[-2] ** -0.5 if len(s.shape) >= 2 else 0.1
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree.map(draw, shapes)


@pytest.fixture(scope="module")
def jax_params():
    return _draw_params("qwen3-0.6b")


def _cfgs(act, arch="qwen3-0.6b"):
    jdt, tdt, tol = ACT[act]
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config(arch)),
        activation_dtype=jdt)
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config(arch)),
        activation_dtype=tdt)
    return jcfg, tcfg, tol


def _stacked_np(np_params, n, seed=1):
    """Node-stacked params, each node nudged by its own numpy noise."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (np.broadcast_to(p, (n,) + p.shape) + 0.01 *
                   rng.standard_normal((n,) + p.shape)).astype(np.float32),
        np_params)


def _train_both(np_params, act, n, steps=STEPS, micro_batch=None,
                arch="qwen3-0.6b", optimizer="dmsgd", topology="one_peer_exp",
                straggler_prob=None, warmup_steps=0):
    """``steps`` train steps on both packages.  With ``straggler_prob``
    the trainers are loss-aware with deadline skips, and both batches
    carry the same numpy ``alive`` draws."""
    jcfg, tcfg, tol = _cfgs(act, arch)
    stacked = _stacked_np(np_params, n)
    jtop, ttop = JT.get_topology(topology, n), TT.get_topology(topology, n)
    rt = ({} if straggler_prob is None
          else {"loss_aware": True, "deadline": True})
    if warmup_steps:
        rt["warmup_steps"] = warmup_steps
    jopt, jstep_for = JTrain.build_trainer(jcfg, jtop, optimizer, 0.9,
                                           micro_batch, **rt)
    topt, tstep_for = TTrain.build_trainer(tcfg, ttop, optimizer, 0.9,
                                           micro_batch, **rt)
    jx = jax.tree.map(jnp.asarray, stacked)
    tx = stacked_from_jax(stacked, tcfg)
    js, ts = jopt.init(jx), topt.init(tx)
    jdata = JSyntheticLM(jcfg.vocab_size, n, hetero=0.5, seed=0)
    tdata = TSyntheticLM(tcfg.vocab_size, n, hetero=0.5, seed=0)
    jlr = JSch.warmup_step_decay(0.05, 10, [100, 200])
    tlr = TSch.warmup_step_decay(0.05, 10, [100, 200])
    losses = []
    for step in range(steps):
        tokens = tdata.sample(step, B, S)
        np.testing.assert_array_equal(tokens, jdata.sample(step, B, S))
        assert tlr(step) == float(jlr(step))
        jb, tb = ({"tokens": jnp.asarray(tokens)},
                  {"tokens": torch.from_numpy(tokens)})
        if straggler_prob is not None:
            alive = np.random.default_rng(2**20 + step).random(n) \
                >= straggler_prob
            jb["alive"], tb["alive"] = (jnp.asarray(alive),
                                        torch.from_numpy(alive))
        jx, js, jl = jstep_for(step)(jx, js, jb, jlr(step))
        tx, ts, tl = tstep_for(step)(tx, ts, tb, tlr(step))
        losses.append((float(tl), float(jl)))
    return (tcfg, tol, losses, (jx, js, jstep_for.plan),
            (tx, ts, tstep_for.plan))


def _check_state(tcfg, tol, tx, ts, jx, js):
    """Params and every momentum slot against the JAX tree, leaf by leaf."""
    pairs = [(tx, jx)]
    if isinstance(js.momentum, dict) and set(js.momentum) == {"mu", "nu"}:
        pairs += [(ts.momentum[s], js.momentum[s]) for s in ("mu", "nu")]
    else:
        pairs += [(ts.momentum, js.momentum)]
    for mine, theirs in pairs:
        back = stacked_to_jax(mine, tcfg)
        flat_t = jax.tree_util.tree_leaves_with_path(back)
        flat_j = dict(jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda a: np.asarray(a, np.float32), theirs)))
        assert len(flat_t) == len(flat_j)
        for path, leaf in flat_t:
            np.testing.assert_allclose(leaf, flat_j[path], **tol)
    np.testing.assert_allclose(TTrain.consensus_distance(tx),
                               JTrain.consensus_distance(jx), **tol)


@pytest.mark.parametrize("act,n", [("f32", 4), ("f32", 8), ("bf16", 4),
                                   ("bf16", 8)])
def test_train_steps_match_jax(jax_params, act, n):
    tcfg, tol, losses, (jx, js, jplan), (tx, ts, tplan) = _train_both(
        jax_params, act, n)
    got, want = zip(*losses)
    np.testing.assert_allclose(got, want, **tol)
    assert len(set(got)) == STEPS                 # the loss moves
    _check_state(tcfg, tol, tx, ts, jx, js)
    assert tplan.num_compiled == jplan.num_compiled == min(
        STEPS, int(np.log2(n)))


def test_runtime_train_steps_match_jax(jax_params, n=4):
    """Loss-aware DmSGD with deadline skips: the per-node losses weight
    the edges and the same ``alive`` flags (in both batches) gate them;
    the train steps agree with the reference's (no kernel combine: every
    round is runtime-valued)."""
    tcfg, tol, losses, (jx, js, jplan), (tx, ts, tplan) = _train_both(
        jax_params, "f32", n, straggler_prob=0.4)
    got, want = zip(*losses)
    np.testing.assert_allclose(got, want, **tol)
    _check_state(tcfg, tol, tx, ts, jx, js)
    assert tplan.num_compiled == jplan.num_compiled == 2


def test_warmup_steps_match_jax(jax_params, n=4):
    """``build_trainer(warmup_steps=2)``: the plan keys of steps 0-4 are
    the reference's (the warm-up phase its own key), and over 3 steps
    (two warm-up rounds, one one-peer round) the losses and final state
    agree in f32 within 2e-4."""
    tcfg, tol, losses, (jx, js, jplan), (tx, ts, tplan) = _train_both(
        jax_params, "f32", n, warmup_steps=2)
    keys = [tplan.realization_key(k) for k in range(5)]
    assert keys == [jplan.realization_key(k) for k in range(5)]
    assert keys[:2] == [("warmup",)] * 2 and ("warmup",) not in keys[2:]
    got, want = zip(*losses)
    np.testing.assert_allclose(got, want, **tol)
    _check_state(tcfg, tol, tx, ts, jx, js)
    assert tplan.num_compiled == jplan.num_compiled == 2


def test_cli_trains_with_stragglers_on_cpu():
    """``--loss-aware --deadline-skip --straggler-prob 0.25`` on reduced
    qwen3: finite losses, the numpy straggler draws, one executable per
    distinct realization."""
    out = TTrain.run(TTrain.parse_args([
        "--device", "cpu", "--nodes", "4", "--steps", "4", "--batch", "1",
        "--seq", "16", "--log-every", "1", "--hetero", "0.5",
        "--loss-aware", "--deadline-skip", "--straggler-prob", "0.25"]))
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert np.isfinite([h["consensus"] for h in out["history"]]).all()
    assert out["alive"] == [
        (np.random.default_rng(2**20 + k).random(4) >= 0.25).tolist()
        for k in range(4)]
    assert out["plan"].num_compiled == 2
    assert out["state"].sched_pos is None


def test_quickstart_runs_short():
    out = quickstart.main(steps=3, device="cpu")
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["lemma1_err"] < 1e-5
    assert out["num_compiled"] == 3


def test_cli_on_cpu(capsys, tmp_path):
    TTrain.main(["--device", "cpu", "--nodes", "4", "--steps", "3",
                 "--batch", "1", "--seq", "16", "--log-every", "1",
                 "--hetero", "0.5"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 3
    assert "on cpu: 4 nodes, one_peer_exp, dmsgd; 2 executables" in out
    # --overlap (refused before the pipeline was ported) trains: a prime,
    # the two one-peer realizations in flight, and one flush executable
    # for each realization the logged steps drained
    TTrain.main(["--device", "cpu", "--nodes", "4", "--steps", "3",
                 "--batch", "1", "--seq", "16", "--log-every", "1",
                 "--overlap"])
    out = capsys.readouterr().out
    assert len([ln for ln in out.splitlines() if ln.startswith("step ")]) == 3
    assert "one_peer_exp, dmsgd; 5 executables for 2 gossip" in out
    with pytest.raises(ValueError, match="--deadline-skip"):
        TTrain.main(["--device", "cpu", "--steps", "1",
                     "--straggler-prob", "0.25"])
    # --ckpt-dir (refused before checkpoints were ported) saves every
    # --ckpt-every steps after step 0
    ck = tmp_path / "ck"
    TTrain.main(["--device", "cpu", "--nodes", "4", "--steps", "3",
                 "--batch", "1", "--seq", "16", "--topology", "random_match",
                 "--ckpt-dir", str(ck), "--ckpt-every", "1"])
    assert sorted(p.name for p in ck.iterdir()) == ["step_1", "step_2"]
    assert "random_match, dmsgd; " in capsys.readouterr().out
