"""PyTorch port parity: the optimizer chains and the GossipPlan.  T = 5
steps of dmsgd / dsgd / vanilla_dmsgd / parallel_msgd from the same
params and the same per-step grads (numpy, from a seed) give the JAX
package's params and momentum within f32 1e-5 (elementwise arithmetic
and one gossip combine per step; the two sides round differently at the
~1e-7 level).  qg_dmsgd (which divides a difference of mixed params by
lr) and d_adamw (which divides by sqrt of the second moment) amplify
that rounding, so they are held to the reference's f32 tolerance 2e-4
(tests/test_kernels.py:16).  Plan keys and executable counts equal the
JAX plan's, on aperiodic streams and under the LRU bound too."""
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
TOL_AMP = dict(rtol=2e-4, atol=2e-4)
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
        lr = float(np.float32(0.1 / (step + 1)))   # the schedule's f32 value
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


def _close_trees(t, j, tol):
    """Nested dicts of torch tensors against nested dicts of numpy."""
    assert set(t) == set(j)
    for k in t:
        if isinstance(t[k], dict):
            _close_trees(t[k], j[k], tol)
        else:
            np.testing.assert_allclose(t[k].numpy(), j[k], **tol)


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


@pytest.mark.parametrize("name", ["qg_dmsgd", "d_adamw"])
@pytest.mark.parametrize("topo,n,warmup", [
    ("one_peer_exp", 8, 0), ("one_peer_exp", 8, 2), ("ring", 6, 0),
    ("random_match", 8, 0), ("random_match", 4, 3), ("uniform", 8, 0)])
def test_qg_and_adamw_steps_match_jax(name, topo, n, warmup):
    if topo == "uniform":
        jtop = JT.one_peer_exponential(n, schedule="uniform", seed=2)
        ttop = TT.one_peer_exponential(n, schedule="uniform", seed=2)
    else:
        jtop, ttop = JT.get_topology(topo, n), TT.get_topology(topo, n)
    jx, jm, tx, tm = _run_both(name, jtop, ttop, n, warmup=warmup)
    _close_trees(tx, jx, TOL_AMP)
    _close_trees(tm, jm, TOL_AMP)
    if name == "d_adamw":
        assert list(tm) == ["mu", "nu"]
        assert all(float(v.min()) >= 0.0 for v in tm["nu"].values())


def _adamw_ref_step(x, mu, nu, g, t, lr, b1=0.9, b2=0.999, eps=1e-8, wd=0.0):
    """Single-node AdamW in numpy (tests/test_transforms.py's)."""
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    mu_hat = mu / (1 - b1 ** (t + 1))
    nu_hat = nu / (1 - b2 ** (t + 1))
    x = x - lr * (mu_hat / (np.sqrt(nu_hat) + eps) + wd * x)
    return x, mu, nu


def test_d_adamw_identical_data_matches_adamw_reference(n=8):
    """With identical grads and identical init on every node the gossip is
    a no-op (mixing equal rows with 0.5/0.5 weights is exact), so d_adamw
    tracks single-node AdamW (mirrors tests/test_transforms.py:158-182,
    with its tolerances)."""
    opt = TO.d_adamw(TT.one_peer_exponential(n), weight_decay=0.01)
    d = 6
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal(d).astype(np.float32)
    p = {"x": torch.from_numpy(x0).expand(n, d)}
    s = opt.init(p)
    assert set(s.momentum) == {"mu", "nu"} and s.count == 0
    rx, rmu, rnu = x0.copy(), np.zeros(d, np.float32), np.zeros(d, np.float32)
    for t in range(5):
        gk = rng.standard_normal(d).astype(np.float32)
        p, s = opt.update(p, s, {"x": torch.from_numpy(gk).expand(n, d)},
                          t, 1e-2)
        rx, rmu, rnu = _adamw_ref_step(rx, rmu, rnu, gk, t, 1e-2, wd=0.01)
        np.testing.assert_allclose(p["x"].numpy(), np.broadcast_to(rx, (n, d)),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s.momentum["mu"]["x"].numpy(),
                               np.broadcast_to(rmu, (n, d)),
                               rtol=1e-5, atol=1e-7)


def test_qg_dmsgd_keeps_one_slot_and_bf16_dtypes(n=4):
    """qg_dmsgd's two momentum transforms share the slot "m" (the first
    declaration's dtype wins, as the reference's setdefault); every slot
    and the params cast back to their stored dtypes."""
    top = TT.one_peer_exponential(n)
    opt = TO.qg_dmsgd(top, momentum_dtype=torch.bfloat16)
    assert opt.slot_names == ("m",)
    p = {"w": torch.ones(n, 3, dtype=torch.bfloat16)}
    s = opt.init(p)
    p, s = opt.update(p, s, {"w": torch.ones(n, 3)}, 0, 0.1)
    assert p["w"].dtype == s.momentum["w"].dtype == torch.bfloat16
    opt = TO.d_adamw(top, momentum_dtype=torch.bfloat16)
    s = opt.init(p)
    p, s = opt.update(p, s, {"w": torch.ones(n, 3)}, 0, 0.1)
    assert {s.momentum[k]["w"].dtype for k in ("mu", "nu")} == {torch.bfloat16}


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


@pytest.mark.parametrize("pool,max_compiles,steps", [
    (None, 256, 40), (None, 4, 40), (3, 256, 120), (None, 2, 12)])
def test_random_match_plan_keys_and_counts_match_jax(pool, max_compiles,
                                                     steps):
    """An aperiodic matching stream keys one executable per distinct
    pairing: the LRU bound, the pooled plateau (<= pool) and every
    hit/miss/eviction counter equal the JAX plan's (mirrors
    tests/test_realization_ir.py:78-104)."""
    n = 8
    jp = JP.GossipPlan(JT.bipartite_random_match(n, seed=0, pool=pool),
                       fn=lambda mix, x: mix(x), max_compiles=max_compiles)
    tp = TP.GossipPlan(TT.bipartite_random_match(n, seed=0, pool=pool),
                       fn=lambda mix, x: mix(x), max_compiles=max_compiles)
    x = np.random.default_rng(1).standard_normal((n, 5)).astype(np.float32)
    jx, tx = {"a": jnp.asarray(x)}, {"a": torch.from_numpy(x)}
    for step in range(steps):
        assert tp.realization_key(step) == jp.realization_key(step)
        jx = jp.step_fn(step)(jx)
        tx = tp.step_fn(step)(tx)
        assert tp.cache_stats() == jp.cache_stats()
    np.testing.assert_allclose(tx["a"].numpy(), np.asarray(jx["a"]), **TOL32)
    assert tp.num_compiled == jp.num_compiled <= min(max_compiles,
                                                     pool or steps)
    if pool is not None:                        # converged: no more misses
        misses = tp.cache_stats()["misses"]
        for step in range(steps, steps + 30):
            tp.step_fn(step)
        assert tp.cache_stats()["misses"] == misses


def test_uniform_one_peer_plan_matches_jax():
    """The uniform one-peer order visits at most tau shift realizations."""
    n = 16
    jp = JP.GossipPlan(JT.one_peer_exponential(n, "uniform", seed=4),
                       fn=lambda mix, x: mix(x))
    tp = TP.GossipPlan(TT.one_peer_exponential(n, "uniform", seed=4),
                       fn=lambda mix, x: mix(x))
    x = np.random.default_rng(2).standard_normal((n, 3)).astype(np.float32)
    jx, tx = {"a": jnp.asarray(x)}, {"a": torch.from_numpy(x)}
    for step in range(20):
        assert tp.realization_key(step) == jp.realization_key(step)
        jx, tx = jp.step_fn(step)(jx), tp.step_fn(step)(tx)
    np.testing.assert_allclose(tx["a"].numpy(), np.asarray(jx["a"]), **TOL32)
    assert tp.cache_stats() == jp.cache_stats()
    assert tp.num_compiled == jp.num_compiled <= 4


def test_make_optimizer_refuses_later_slices():
    """int8 (item 8) and overlap (item 10) build for every optimizer whose
    reference takes them; the runtime hooks (item 9) build, for dmsgd and
    dsgd only, as in the reference."""
    top = TT.one_peer_exponential(4)
    jtop = JT.one_peer_exponential(4)
    for name in ("dmsgd", "dsgd", "vanilla_dmsgd", "qg_dmsgd", "d_adamw"):
        for mod, t in ((TO, top), (JO, jtop)):
            opt = mod.make_optimizer(name, t, compression="int8")
            assert opt.compression == "int8" and not opt.overlap
    for name in ("d_adamw", "vanilla_dmsgd", "dsgd", "dmsgd"):
        opt = TO.make_optimizer(name, top, overlap=True)
        assert opt.overlap and opt.compression is None
        assert opt.overlap == JO.make_optimizer(name, jtop,
                                                overlap=True).overlap
    # parallel_msgd has no payload: compression is ignored, as there
    assert TO.make_optimizer("parallel_msgd", top,
                             compression="int8").compression is None
    for name in ("dmsgd", "dsgd"):
        for kw in ({"loss_aware": True}, {"deadline": True},
                   {"loss_aware": True, "deadline": True}):
            opt = TO.make_optimizer(name, top, **kw)
            assert opt.has_runtime_gossip and not opt.scheduled_gossip
    # a composition the pipeline cannot run is a ValueError on both sides
    for mod, t in ((TO, top), (JO, jtop)):
        with pytest.raises(ValueError, match="AFTER the overlapped"):
            mod.make_optimizer("qg_dmsgd", t, overlap=True)
        with pytest.raises(ValueError, match="parallel_msgd"):
            mod.make_optimizer("parallel_msgd", t, overlap=True)
        with pytest.raises(ValueError, match="dmsgd/dsgd"):
            mod.make_optimizer("d_adamw", t, loss_aware=True)
    with pytest.raises(KeyError):
        TO.make_optimizer("sgd", top)
