"""PyTorch port parity: the optimizer chains and the GossipPlan.  T = 5
steps of dmsgd / dsgd / vanilla_dmsgd / parallel_msgd from the same
params and the same per-step grads (numpy, from a seed) give the JAX
package's params and momentum within f32 1e-5 (elementwise arithmetic
and one gossip combine per step; the two sides round differently at the
~1e-7 level).  Plan keys and executable counts equal the JAX plan's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optim as JO, plan as JP, topology as JT
from repro.core.transforms import allreduce_warmup as j_warmup
from repro_torch.core import optim as TO, plan as TP, topology as TT
from repro_torch.core.transforms import allreduce_warmup as t_warmup

TOL32 = dict(rtol=1e-5, atol=1e-5)
T = 5


def _shapes():
    return {"w": (8, 6), "b": (6,), "z": (3, 2, 2)}


def _stack(n, rng):
    return {k: rng.standard_normal((n,) + s).astype(np.float32)
            for k, s in _shapes().items()}


def _run_both(name, jtop, ttop, n, warmup=0):
    rng = np.random.default_rng(11)
    x0 = _stack(n, rng)
    grads = [_stack(n, rng) for _ in range(T)]
    jopt = JO.make_optimizer(name, jtop, beta=0.9)
    topt = TO.make_optimizer(name, ttop, beta=0.9)
    if warmup:
        jopt, topt = j_warmup(warmup)(jopt), t_warmup(warmup)(topt)
    jx = {k: jnp.asarray(v) for k, v in x0.items()}
    tx = {k: torch.from_numpy(v.copy()) for k, v in x0.items()}
    js, ts = jopt.init(jx), topt.init(tx)
    for step in range(T):
        lr = 0.1 / (step + 1)
        jx, js = jopt.update(jx, js, {k: jnp.asarray(v)
                                      for k, v in grads[step].items()},
                             step, jnp.float32(lr))
        tx, ts = topt.update(tx, ts, {k: torch.from_numpy(v)
                                      for k, v in grads[step].items()},
                             step, lr)
    assert ts.count == int(js.count) == T
    return (jax.tree.map(np.asarray, jx), jax.tree.map(np.asarray,
                                                       js.momentum),
            tx, ts.momentum)


@pytest.mark.parametrize("name", ["dmsgd", "dsgd", "vanilla_dmsgd",
                                  "parallel_msgd"])
@pytest.mark.parametrize("topo,n", [("one_peer_exp", 8), ("ring", 6),
                                    ("base_k", 9)])
def test_steps_match_jax(name, topo, n):
    jx, jm, tx, tm = _run_both(name, JT.get_topology(topo, n),
                               TT.get_topology(topo, n), n)
    for k in jx:
        np.testing.assert_allclose(tx[k].numpy(), jx[k], **TOL32)
        np.testing.assert_allclose(tm[k].numpy(), jm[k], **TOL32)


def test_allreduce_warmup_matches_jax_and_averages():
    n = 8
    jx, jm, tx, tm = _run_both("dmsgd", JT.one_peer_exponential(n),
                               TT.one_peer_exponential(n), n, warmup=2)
    for k in jx:
        np.testing.assert_allclose(tx[k].numpy(), jx[k], **TOL32)
        np.testing.assert_allclose(tm[k].numpy(), jm[k], **TOL32)


@pytest.mark.parametrize("topo,n,every,warmup", [
    ("one_peer_exp", 8, 1, 0), ("one_peer_exp", 8, 2, 3),
    ("static_exp", 8, 1, 0), ("star", 6, 1, 0), ("base_k", 9, 1, 0),
    ("one_peer_hypercube", 8, 1, 2), ("ceca", 12, 1, 0)])
def test_plan_keys_and_counts_match_jax(topo, n, every, warmup):
    jp = JP.GossipPlan(JT.get_topology(topo, n), warmup_steps=warmup,
                       every=every, fn=lambda mix, x: mix(x))
    tp = TP.GossipPlan(TT.get_topology(topo, n), warmup_steps=warmup,
                       every=every, fn=lambda mix, x: mix(x))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    jx, tx = {"a": jnp.asarray(x)}, {"a": torch.from_numpy(x)}
    for step in range(12):
        assert tp.realization_key(step) == jp.realization_key(step)
        jx = jp.step_fn(step)(jx)
        tx = tp.step_fn(step)(tx)
        np.testing.assert_allclose(tx["a"].numpy(), np.asarray(jx["a"]),
                                   **TOL32)
    assert tp.num_compiled == jp.num_compiled
    assert tp.cache_stats() == jp.cache_stats()


def test_make_optimizer_refuses_later_slices():
    top = TT.one_peer_exponential(4)
    for name in ("qg_dmsgd", "d_adamw"):
        with pytest.raises(NotImplementedError, match="slice C"):
            TO.make_optimizer(name, top)
    for kw in ({"compression": "int8"}, {"overlap": True},
               {"loss_aware": True}, {"deadline": True}):
        with pytest.raises(NotImplementedError, match="slice C"):
            TO.make_optimizer("dmsgd", top, **kw)
    with pytest.raises(KeyError):
        TO.make_optimizer("sgd", top)
