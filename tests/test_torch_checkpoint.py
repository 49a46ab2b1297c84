"""PyTorch port parity: checkpoints.  The port writes the JAX package's
on-disk format (``<dir>/step_<N>/{manifest.json, arrays.npz}``, leaves in
JAX's flatten order at JAX's shapes, bf16 as a byte view), so a train
state saved by either package restores in the other with equal values
(bit for bit) and dtypes: reduced qwen3 (dense) with a one-slot momentum
and d_adamw's ``{"mu", "nu"}``, each with f32 and bf16 moments.  Also the
port's own round trip (mirrors tests/test_substrate.py:50-62) and the
driver's ``--ckpt-dir`` (mirrors tests/test_system.py:31-40), read back
by the JAX ``restore``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tconfigs
from repro_torch.convert import (stacked_from_jax, stacked_to_jax,
                                 train_state_from_jax, train_state_to_jax)
from repro_torch.launch import train as TTrain

N = 2


def _np_tree(arch, seed, dtype):
    """A node-stacked JAX-layout tree of random numpy leaves (``dtype``:
    float32 or jnp.bfloat16), shaped as ``arch``'s reduced params."""
    cfg = jconfigs.reduced_config(jconfigs.get_config(arch))
    shapes = jax.eval_shape(lambda: JM.init(cfg, jax.random.key(0)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: np.asarray(jnp.asarray(
            rng.standard_normal((N,) + s.shape), jnp.float32).astype(dtype)),
        shapes)


def _jax_state(arch, slots, mom_dtype):
    params = _np_tree(arch, 0, jnp.float32)
    if slots == "one":
        momentum = _np_tree(arch, 1, mom_dtype)
    else:
        momentum = {"mu": _np_tree(arch, 1, mom_dtype),
                    "nu": _np_tree(arch, 2, mom_dtype)}
    return {"params": params, "momentum": momentum}


def _port_state(jstate, tcfg):
    mom = jstate["momentum"]
    if "layers" in mom:
        momentum = stacked_from_jax(mom, tcfg)
    else:
        momentum = {s: stacked_from_jax(t, tcfg) for s, t in mom.items()}
    return stacked_from_jax(jstate["params"], tcfg), momentum


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


CASES = [("qwen3-0.6b", "one", jnp.float32), ("qwen3-0.6b", "one",
                                              jnp.bfloat16),
         ("mamba2-1.3b", "mu_nu", jnp.float32),
         ("qwen3-0.6b", "mu_nu", jnp.bfloat16)]


@pytest.mark.parametrize("arch,slots,mom_dtype", CASES)
def test_port_checkpoint_restores_in_jax(tmp_path, arch, slots, mom_dtype):
    tcfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    jstate = _jax_state(arch, slots, mom_dtype)
    params, momentum = _port_state(jstate, tcfg)
    if mom_dtype == jnp.bfloat16:
        leaf = next(iter(momentum.values()))
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf
        assert leaf.dtype == torch.bfloat16
    tckpt.save(str(tmp_path), 3, train_state_to_jax(params, momentum, tcfg))
    assert jckpt.latest_step(str(tmp_path)) == 3
    like = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), jstate)
    got = jckpt.restore(str(tmp_path), 3, like)
    want_l, want_def = jax.tree_util.tree_flatten(jstate)
    got_l, got_def = jax.tree_util.tree_flatten(got)
    assert got_def == want_def
    for g, w in zip(got_l, want_l):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("arch,slots,mom_dtype", CASES)
def test_jax_checkpoint_restores_in_port(tmp_path, arch, slots, mom_dtype):
    tcfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    jstate = _jax_state(arch, slots, mom_dtype)
    jckpt.save(str(tmp_path), 7, jax.tree.map(jnp.asarray, jstate))
    assert tckpt.latest_step(str(tmp_path)) == 7
    params, momentum = _port_state(jstate, tcfg)
    like = train_state_to_jax(
        {k: torch.zeros_like(v) for k, v in params.items()},
        ({s: {k: torch.zeros_like(v) for k, v in t.items()}
          for s, t in momentum.items()} if slots == "mu_nu" else
         {k: torch.zeros_like(v) for k, v in momentum.items()}), tcfg)
    got_p, got_m = train_state_from_jax(
        tckpt.restore(str(tmp_path), 7, like), tcfg)
    pairs = [(got_p, params)] + ([(got_m[s], momentum[s]) for s in momentum]
                                 if slots == "mu_nu" else
                                 [(got_m, momentum)])
    for got, want in pairs:
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), k


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    d = str(tmp_path / "ck")
    assert tckpt.latest_step(d) is None
    tckpt.save(d, 10, tree)
    tckpt.save(d, 20, {"a": tree["a"] * 2, "b": {"c": tree["b"]["c"] * 2}})
    assert tckpt.latest_step(d) == 20
    out = tckpt.restore(d, 20, tree)
    assert out["a"].dtype == torch.float32
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["a"], tree["a"] * 2)
    assert torch.equal(out["b"]["c"], tree["b"]["c"] * 2)
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore(d, 20, {"a": tree["a"]})


def test_train_ckpt_dir_restores_in_both(tmp_path):
    """The driver's --ckpt-dir on reduced mamba2, d_adamw over random_match:
    steps 2 and 4 are saved, and step 4 (the last step of 5) restores in
    both packages equal to the final state."""
    ck = str(tmp_path / "ck")
    out = TTrain.run(TTrain.parse_args([
        "--device", "cpu", "--arch", "mamba2-1.3b", "--optimizer", "d_adamw",
        "--topology", "random_match", "--nodes", "4", "--steps", "5",
        "--batch", "1", "--seq", "16", "--log-every", "5",
        "--ckpt-dir", ck, "--ckpt-every", "2"]))
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["step_2", "step_4"]
    cfg = out["config"]
    live = train_state_to_jax(out["params"], out["state"].momentum, cfg)
    port = tckpt.restore(ck, tckpt.latest_step(ck), live)
    jlike = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32), live)
    jgot = jckpt.restore(ck, jckpt.latest_step(ck), jlike)
    params, momentum = train_state_from_jax(port, cfg)
    assert list(momentum) == ["mu", "nu"]
    for k, v in out["params"].items():
        assert torch.equal(params[k], v)
    for s in ("mu", "nu"):
        for k, v in out["state"].momentum[s].items():
            assert torch.equal(momentum[s][k], v)
    want = stacked_to_jax(out["params"], cfg)
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(jgot["params"]),
            jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=str(path))


def _when_states(n=8, d=5, T=5):
    """The same ``gossip(when=...)`` DmSGD run on both packages: T steps,
    numpy grads and the same skip pattern.  Returns (JAX opt, params,
    state), (port opt, params, state), the grads of one more step."""
    from repro.core import optim as JO, topology as JT
    from repro_torch.core import optim as TO, topology as TT
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((n, d)).astype(np.float32)
    grads = [rng.standard_normal((n, d)).astype(np.float32)
             for _ in range(T + 1)]
    comm = [True, False, True, True, False, True][:T + 1]
    jopt = JO.dmsgd(JT.one_peer_exponential(n), beta=0.9,
                    when=lambda ctx: ctx.aux["comm"])
    topt = TO.dmsgd(TT.one_peer_exponential(n), beta=0.9,
                    when=lambda ctx: ctx.aux["comm"])
    jx, tx = {"x": jnp.asarray(x0)}, {"x": torch.from_numpy(x0.copy())}
    js, ts = jopt.init(jx), topt.init(tx)
    for k in range(T):
        jx, js = jopt.update(jx, js, {"x": jnp.asarray(grads[k])}, k,
                             jnp.float32(0.1),
                             aux={"comm": jnp.asarray(comm[k])})
        tx, ts = topt.update(tx, ts, {"x": torch.from_numpy(grads[k])}, k,
                             0.1, aux={"comm": torch.tensor(comm[k])})
    assert int(ts.sched_pos) == int(js.sched_pos) == sum(comm[:T])
    return (jopt, jx, js), (topt, tx, ts), (grads[T], comm[T])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_when_chain_sched_pos_survives_checkpoints(tmp_path, direction):
    """A ``when=`` chain's OptState -- momentum, int32 count, int32
    sched_pos, in the reference's flatten order -- saved by one package
    restores in the other, and the port resumes from it exactly."""
    from repro.core.transforms import OptState as JOptState
    from repro_torch.convert import opt_state_from_jax, opt_state_to_jax
    (jopt, jx, js), (topt, tx, ts), (g, c) = _when_states()
    d = str(tmp_path)
    if direction == "port_to_jax":
        tckpt.save(d, 5, {"params": tx, "state": opt_state_to_jax(ts)})
        like = {"params": {"x": jnp.zeros_like(jx["x"])},
                "state": JOptState({"x": jnp.zeros_like(jx["x"])},
                                   jnp.zeros((), jnp.int32), None,
                                   jnp.zeros((), jnp.int32))}
        got = jckpt.restore(d, 5, like)
        assert got["state"].sched_pos.dtype == jnp.int32
        assert int(got["state"].sched_pos) == int(ts.sched_pos)
        assert int(got["state"].count) == ts.count == 5
        np.testing.assert_array_equal(np.asarray(got["state"].momentum["x"]),
                                      ts.momentum["x"].numpy())
        return
    jckpt.save(d, 5, {"params": jx, "state": js})
    like = {"params": {"x": torch.zeros_like(tx["x"])},
            "state": opt_state_to_jax(topt.init(
                {"x": torch.zeros_like(tx["x"])}))}
    got = tckpt.restore(d, 5, like)
    state = opt_state_from_jax(got["state"])
    assert state.count == int(js.count) == 5
    assert state.sched_pos.dtype == torch.int32
    assert int(state.sched_pos) == int(js.sched_pos)
    np.testing.assert_array_equal(state.momentum["x"].numpy(),
                                  np.asarray(js.momentum["x"]))
    # the port resumes from the restored state as from its live one
    args = ({"x": torch.from_numpy(g)}, 5, 0.1)
    aux = {"comm": torch.tensor(c)}
    xa, sa = topt.update(got["params"], state, *args, aux=aux)
    jxa, jsa = jopt.update(jx, js, {"x": jnp.asarray(g)}, 5,
                           jnp.float32(0.1), aux={"comm": jnp.asarray(c)})
    assert int(sa.sched_pos) == int(jsa.sched_pos)
    np.testing.assert_allclose(xa["x"].numpy(), np.asarray(jxa["x"]),
                               rtol=1e-5, atol=1e-5)
