"""PyTorch port parity: runtime-valued realizations (ROADMAP item 9) --
tensor weights, ``Gated`` rounds, the data-dependent schedule position,
loss-aware (AL-DSGD) and deadline gossip.

The first part ports every test of tests/test_runtime_realizations.py to
the port, as the reference states them: static-weight rounds stay
bit-identical when the same weights arrive as tensors, gated skips keep
finite-time exact averaging once a full COMMUNICATING period completes,
a pool of runtime-weighted rounds of one structure builds ONE executable,
the piggybacked metadata adds bytes and no collective, and every
unsupported composition refuses.  The reference's HLO subprocess test has
no counterpart (the port lowers no HLO); in its place a runtime round is
shown to gather exactly as often as its static round.

The second part holds the port against the JAX package on the same numpy
inputs: one combine at 1e-5 (K1's tolerance, tests/test_kernels.py:189;
the JAX static combine runs its Pallas kernel in interpret mode),
multi-step trajectories at f32 2e-4 (tests/test_kernels.py:16), and the
plan counters on the reference's pool streams exactly.  Torch is pinned
to one thread (as tests/test_torch_train_families.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gossip as JG, optim as JO, schedule as JS
from repro.core import topology as JT, transforms as JTr
from repro.core.plan import GossipPlan as JPlan
from repro_torch.core import flatbuf as TF, gossip as TG, optim as TO
from repro_torch.core import schedule as TS, topology as TT
from repro_torch.core import transforms as TTr
from repro_torch.core.plan import GossipPlan as TPlan
from repro_torch.launch import mesh_check as MC

TOL32 = dict(rtol=1e-5, atol=1e-5)
TOL_TRAJ = dict(rtol=2e-4, atol=2e-4)
TOLBF = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def jax_interpret():
    JG.set_pallas_mode("interpret")
    yield
    JG.set_pallas_mode("auto")


def _np_tree(n, d=6, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((n, d)).astype(np.float32),
            "b": rng.standard_normal((n, d + 1)).astype(np.float32)}


def _tree(n, d=6, seed=0):
    return {k: torch.from_numpy(v) for k, v in _np_tree(n, d, seed).items()}


def _jtree(n, d=6, seed=0):
    return {k: jnp.asarray(v) for k, v in _np_tree(n, d, seed).items()}


def _consensus(tree):
    return max(float((v - v.mean(0, keepdim=True)).abs().max())
               for v in tree.values())


def _tree_equal(x, y):
    return all(torch.equal(x[k], y[k]) for k in x)


def _close(t, j, tol):
    for k in t:
        np.testing.assert_allclose(t[k].float().numpy(),
                                   np.asarray(j[k], np.float32), **tol)


# ---------------------------------------------------------------------------
# Part 1: the reference's properties, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_node", [False, True])
@pytest.mark.parametrize("make", [
    lambda n: TT.one_peer_exponential(n).realization(1),
    lambda n: TT.one_peer_hypercube(n).realization(0),
], ids=["shifts", "matching"])
def test_traced_weights_bit_identical_to_static(make, per_node, n=8):
    r = make(n)
    tree = _tree(n)
    static = TG.mix_realization(tree, r)

    def tensor(w):
        w = torch.tensor(w, dtype=torch.float32)
        return w.expand(n).clone() if per_node else w

    runtime = r.with_weights(tuple(tensor(w) for w in r.weight_values()))
    assert runtime.traced and not r.traced
    assert _tree_equal(static, TG.mix_realization(tree, runtime))


def test_python_bool_gate_folds_at_construction(n=8):
    r = TT.one_peer_hypercube(n).realization(0)
    assert TT.Gated(r, True) is r
    assert TT.Gated(r, np.bool_(True)) is r
    assert isinstance(TT.Gated(r, False), TT.Identity)
    with pytest.raises(TypeError):
        TT.Gated(TT.Gated(r, torch.tensor(True)), torch.tensor(True))


def test_gated_scalar_selects_mix_or_identity(n=8):
    r = TT.one_peer_exponential(n).realization(0)
    tree = _tree(n)
    mixed = TG.mix_realization(tree, r)
    on = TG.mix_realization(tree, TT.Gated(r, torch.tensor(True)))
    off = TG.mix_realization(tree, TT.Gated(r, torch.tensor(False)))
    assert _tree_equal(on, mixed)
    assert _tree_equal(off, tree)


def test_gated_matching_partial_gate_preserves_mean_exactly(n=8):
    r = TT.one_peer_hypercube(n).realization(0)
    tree = _tree(n)
    alive = torch.tensor([True, False, True, True, True, False, True, True])
    out = TG.mix_realization(tree, TT.Gated(r, alive))
    dead = ~alive
    for k in tree:
        np.testing.assert_allclose(out[k].mean(0).numpy(),
                                   tree[k].mean(0).numpy(), atol=2e-6)
        assert torch.equal(out[k][dead], tree[k][dead])


@pytest.mark.parametrize("make", [
    lambda n: TT.one_peer_exponential(n),
    lambda n: TT.base_k(n, 1),
    lambda n: TT.ceca(n),
], ids=["one_peer_exp", "base_k2", "ceca"])
def test_scheduled_skip_exact_averaging_after_full_period(make, n=8):
    top = make(n)
    tree = _tree(n)
    mean0 = {k: v.mean(0) for k, v in tree.items()}
    pos = TS.initial_position()
    comms = 0
    for g in [True, False, True, False, False, True, True, True]:
        if comms == top.period:
            break
        gate = torch.tensor(g)
        tree = TG.mix_scheduled(tree, top, pos, gate)
        pos = TS.advance_position(pos, gate)
        comms += int(g)
    assert comms == top.period and int(pos) == top.period
    assert pos.dtype == torch.int32
    assert _consensus(tree) < 1e-4
    for k, m in mean0.items():
        np.testing.assert_allclose(tree[k].mean(0).numpy(), m.numpy(),
                                   atol=1e-5)


def _quad(n, d, seed=0):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((n, d, d)) * 0.2 + np.eye(d)).astype(np.float32)
    b = (rng.standard_normal((n, d)) * 0.3).astype(np.float32)
    return A, b


def _x_star(A, b):
    n = A.shape[0]
    H = np.einsum("nij,nik->jk", A, A) / n
    rhs = np.einsum("nij,ni->j", A, b) / n
    return np.linalg.solve(H, rhs)


def _quad_grad(A, b, x):
    r = torch.einsum("nij,nj->ni", A, x) - b
    return r, torch.einsum("nij,ni->nj", A, r)


def test_scheduled_optimizer_advances_position_only_on_comm(n=8):
    d = 5
    A_np, b_np = _quad(n, d)
    A, b = torch.from_numpy(A_np), torch.from_numpy(b_np)
    opt = TO.dmsgd(TT.one_peer_exponential(n), beta=0.8,
                   when=lambda ctx: ctx.aux["comm"])
    params = {"x": torch.zeros((n, d))}
    state = opt.init(params)
    plan = TPlan.for_optimizer(
        opt, fn=lambda mix, p, s, g, lr, aux: opt.update_with_mix(
            p, s, g, lr, mix, aux=aux))
    T = 600
    for k in range(T):
        _, g = _quad_grad(A, b, params["x"])
        params, state = plan.step_fn(k)(params, state, {"x": g}, 0.05,
                                        {"comm": torch.tensor(k % 2 == 0)})
    assert plan.num_compiled == 1
    assert plan.realization_key(7) == ("scheduled",)
    assert int(state.sched_pos) == T // 2      # odd steps skipped
    xs = params["x"].numpy()
    assert np.linalg.norm(xs.mean(0) - _x_star(A_np, b_np)) < 0.1


def test_plan_weighted_pool_compiles_once_per_structure(n=8):
    partner = tuple(range(n - 1, -1, -1))
    rng = np.random.default_rng(0)
    reals = tuple(TT.Matching(partner, torch.tensor(w, dtype=torch.float32))
                  for w in rng.uniform(0.3, 0.7, size=4))
    top = TT.Topology("weighted_pool", n, max_degree=1, realizations=reals)
    plan = TPlan(top, fn=lambda mix, t: mix(t))
    tree = _tree(n)
    for k in range(12):
        plan.step_fn(k)(tree)
    assert plan.num_compiled == 1
    reals_s = tuple(TT.Matching(partner, float(w))
                    for w in rng.uniform(0.3, 0.7, size=4))
    top_s = TT.Topology("static_pool", n, max_degree=1, realizations=reals_s)
    plan_s = TPlan(top_s, fn=lambda mix, t: mix(t))
    for k in range(12):
        plan_s.step_fn(k)(tree)
    assert plan_s.num_compiled == 4


def test_plan_gated_pool_shares_one_executable(n=8):
    inner = TT.one_peer_hypercube(n).realization(0)
    rng = np.random.default_rng(0)
    reals = tuple(TT.Gated(inner, torch.from_numpy(rng.random(n) > 0.4))
                  for _ in range(5))
    top = TT.Topology("gated_pool", n, max_degree=1, realizations=reals)
    plan = TPlan(top, fn=lambda mix, t: mix(t))
    tree = _tree(n)
    outs = [plan.step_fn(k)(tree) for k in range(10)]
    assert plan.num_compiled == 1
    # the shared executable applies each step's own gate
    for k, out in enumerate(outs):
        assert _tree_equal(out, TG.mix_realization(tree, reals[k % 5]))


def test_plan_static_keys_unchanged_by_refactor(n=8):
    plan = TPlan(TT.one_peer_exponential(n), fn=lambda mix, t: mix(t))
    keys = {plan.realization_key(k) for k in range(6)}
    assert all(k[0] == "shifts" for k in keys)
    assert len(keys) == 3


def _quad_run(opt, n=8, d=5, T=400, lr=0.05, seed=0, aux_fn=None):
    A_np, b_np = _quad(n, d, seed)
    A, b = torch.from_numpy(A_np), torch.from_numpy(b_np)
    params = {"x": torch.zeros((n, d))}
    state = opt.init(params)
    for k in range(T):
        r, g = _quad_grad(A, b, params["x"])
        aux = aux_fn(k, 0.5 * torch.sum(r * r, 1)) if aux_fn else None
        params, state = opt.update(params, state, {"x": g}, k, lr, aux=aux)
    return np.linalg.norm(params["x"].numpy().mean(0) - _x_star(A_np, b_np))


def test_al_dsgd_converges(n=8):
    opt = TO.dmsgd(TT.one_peer_exponential(n), beta=0.8, loss_aware=True)
    err = _quad_run(opt, n, aux_fn=lambda k, loss: {"loss": loss})
    assert err < 0.15, err


def test_deadline_skip_converges_with_stragglers(n=8):
    opt = TO.dmsgd(TT.one_peer_exponential(n), beta=0.8, deadline=True,
                   loss_aware=True)
    rng = np.random.default_rng(1)
    err = _quad_run(opt, n, aux_fn=lambda k, loss: {
        "loss": loss, "alive": torch.from_numpy(rng.random(n) > 0.25)})
    assert err < 0.25, err


def test_gossip_spec_counts_meta_bytes_without_collectives(n=8):
    top = TT.one_peer_exponential(n)
    layout = TF.layout_of({"w": torch.zeros((n, 64))})
    base = TG.gossip_spec(top, 0, layout=layout)
    meta = TG.gossip_spec(top, 0, layout=layout, meta_cols=2)
    assert meta["collectives_per_step"] == base["collectives_per_step"]
    mult = meta["wire_multiplier"]
    assert meta["meta_bytes_per_node_per_step"] == 4 * 2 * mult
    assert meta["bytes_per_node_per_step"] == \
        base["bytes_per_node_per_step"] + 4 * 2 * mult
    gated = TG.gossip_spec(
        TT.Topology("g", n, max_degree=1, realizations=(TT.Gated(
            top.realization(0), torch.tensor(True)),)), 0, layout=layout)
    assert gated["gated"] is True
    assert gated["bytes_per_node_per_step"] == base["bytes_per_node_per_step"]


@pytest.mark.parametrize("kind", ["shifts", "matching"])
def test_runtime_round_gathers_as_often_as_static(kind, monkeypatch, n=8):
    """The reference's HLO test, restated for one process: a loss-aware,
    gated round moves exactly the static round's rows -- the same number
    of rolls (Shifts) or gathers (Matching) of the payload groups -- and
    its metadata rides one more gather of the tiny (n, M) rows per edge,
    never a second gather of the payload."""
    r = (TT.static_exponential(n).realization(0) if kind == "shifts"
         else TT.one_peer_hypercube(n).realization(0))
    tree = dict(_tree(n), h=torch.ones((n, 3), dtype=torch.bfloat16))
    calls = []
    roll, index_select = torch.roll, torch.Tensor.index_select

    def counted_roll(x, *a, **k):
        calls.append(tuple(x.shape))
        return roll(x, *a, **k)

    def counted_select(x, *a, **k):
        calls.append(tuple(x.shape))
        return index_select(x, *a, **k)

    monkeypatch.setattr(torch, "roll", counted_roll)
    monkeypatch.setattr(torch.Tensor, "index_select", counted_select)
    TG.mix_realization(tree, r)
    static = list(calls)
    calls.clear()
    rule = TTr.al_dsgd()
    TG.mix_realization(tree, TT.Gated(r, torch.ones(n, dtype=torch.bool)),
                       meta=torch.arange(n, dtype=torch.float32),
                       edge_weight=rule.edge_weight)
    payload = [c for c in calls if c[1] > 2]
    meta = [c for c in calls if c[1] <= 2]
    assert payload == static
    assert len(meta) == r.max_degree and all(c == (n, 2) for c in meta)


def test_runtime_gossip_refuses_int8_compression(n=8):
    with pytest.raises(ValueError, match="int8"):
        TO.dmsgd(TT.one_peer_exponential(n), loss_aware=True,
                 compression="int8")
    with pytest.raises(ValueError, match="compression"):
        TG.mix_realization(_tree(n), TT.Gated(
            TT.one_peer_exponential(n).realization(0),
            torch.ones(n, dtype=torch.bool)), compression="int8")


def test_runtime_gossip_refuses_overlap(n=8):
    with pytest.raises(ValueError, match="overlap"):
        TO.dmsgd(TT.one_peer_exponential(n), deadline=True, overlap=True)


def test_runtime_gossip_refuses_warmup_wrap(n=8):
    opt = TO.dmsgd(TT.one_peer_exponential(n), loss_aware=True)
    with pytest.raises(ValueError, match="warm"):
        TTr.allreduce_warmup(3)(opt)


def test_when_refuses_every_gt_one():
    with pytest.raises(ValueError, match="every"):
        TTr.gossip(where=("x_next",), every=2, when=lambda ctx: True)


def test_deadline_skip_must_precede_gossip(n=8):
    with pytest.raises(ValueError, match="deadline"):
        TTr.chain(
            TTr.trace_momentum(0.9),
            TTr.scale_by_lr("m"),
            TTr.gossip(where=("m_next", "x_next")),
            TTr.deadline_skip(),
            topology=TT.one_peer_exponential(n), name="bad", beta=0.9)


def test_scheduled_plan_refuses_aperiodic(n=8):
    opt = TO.dmsgd(TT.bipartite_random_match(n, seed=0), beta=0.9,
                   when=lambda ctx: ctx.aux["comm"])
    with pytest.raises(TT.AperiodicScheduleError):
        TPlan.for_optimizer(opt)
    with pytest.raises(TT.AperiodicScheduleError):
        TG.mix_scheduled(_tree(n), TT.bipartite_random_match(n), 0)


def test_runtime_refusals_match_reference(tmp_path, n=8):
    """The reference's other loud refusals: a per-node gate on a Dense
    round, a Gated round with an explicit node_gate, metadata on a Dense
    round, a missing aux flag.  A runtime round with mesh= mixes with one
    rank per node (tests/test_torch_shard_native.py); with several nodes
    a rank it takes the gathered global path (here all n nodes on one
    rank), bit for bit the single-process round."""
    tree = _tree(n)
    alive = torch.ones(n, dtype=torch.bool)
    dense = TT.Dense(np.full((n, n), 1.0 / n))
    with pytest.raises(ValueError, match="Dense"):
        TG.mix_realization(tree, TT.Gated(dense, alive))
    with pytest.raises(ValueError, match="node_gate"):
        TG.mix_realization(tree, TT.Gated(
            TT.one_peer_hypercube(n).realization(0), alive), node_gate=alive)
    with pytest.raises(ValueError, match="permute wire"):
        TG.mix_realization(tree, dense, node_gate=alive)
    gate = alive.clone()
    gate[1] = False
    want = TG.mix_shifts(tree, 0.5, [(1, 0.5)], node_gate=gate)
    with MC.one_rank_mesh(tmp_path) as mesh:
        got = TG.mix_shifts(tree, 0.5, [(1, 0.5)], mesh=mesh, node_gate=gate)
        assert set(mesh.log.counts()) == {"all_gather"}
    for k in want:
        assert torch.equal(got[k], want[k]), k
    opt = TO.dmsgd(TT.one_peer_exponential(n), deadline=True)
    params = {"x": torch.zeros((n, 3))}
    with pytest.raises(ValueError, match="alive"):
        opt.update(params, opt.init(params), params, 0, 0.1, aux={})


# ---------------------------------------------------------------------------
# Part 2: parity with the JAX package on the same numpy inputs
# ---------------------------------------------------------------------------

def _tensor(a):
    return torch.from_numpy(np.asarray(a))


def _both(make_real, n=8):
    """A realization builder run on both packages' IR with numpy weights
    turned into each side's arrays."""
    return (make_real(JT, jnp.asarray), make_real(TT, _tensor))


_W = np.random.default_rng(3).uniform(0.2, 0.8, size=8).astype(np.float32)
_ALIVE = np.array([True, True, False, True, True, True, False, True])
_LOSS = np.random.default_rng(4).uniform(0.5, 2.0, size=8).astype(np.float32)

ROUNDS = {
    # tensor weights: per-node shift weight, derived self weight
    "shifts_per_node": lambda M, arr: M.Shifts(None, ((-1, arr(_W * 0.5)),
                                                      (2, arr(_W * 0.25)))),
    "shifts_scalar": lambda M, arr: M.Shifts(arr(np.float32(0.4)),
                                             ((-3, arr(np.float32(0.6))),)),
    "matching_per_node": lambda M, arr: M.Matching((1, 0, 3, 2, 4, 6, 5, 7),
                                                   arr(_W)),
    "gated_scalar_on": lambda M, arr: M.Gated(
        M.static_exponential(8).realization(0), arr(np.array(True))),
    "gated_scalar_off": lambda M, arr: M.Gated(
        M.static_exponential(8).realization(0), arr(np.array(False))),
    "gated_shifts_per_node": lambda M, arr: M.Gated(
        M.static_exponential(8).realization(0), arr(_ALIVE)),
    "gated_matching_per_node": lambda M, arr: M.Gated(
        M.Matching((1, 0, 3, 2, 4, 6, 5, 7)), arr(_ALIVE)),
    "dense_traced": lambda M, arr: M.Dense(arr(
        M.ring(8).weights(0).astype(np.float32))),
}


@pytest.mark.parametrize("loss_aware", [False, True])
@pytest.mark.parametrize("name", sorted(ROUNDS))
def test_runtime_rounds_match_jax(name, loss_aware, jax_interpret):
    jr, tr = _both(ROUNDS[name])
    kw_j, kw_t = {}, {}
    if loss_aware:
        jrule, trule = JTr.al_dsgd(pull=3.0), TTr.al_dsgd(pull=3.0)
        kw_j = dict(meta=jnp.asarray(_LOSS), edge_weight=jrule.edge_weight)
        kw_t = dict(meta=torch.from_numpy(_LOSS),
                    edge_weight=trule.edge_weight)
    if loss_aware and name == "dense_traced":
        # a Dense round all-gathers: both sides refuse the metadata
        for mix, t, r, kw in ((JG.mix_realization, _jtree(8), jr, kw_j),
                              (TG.mix_realization, _tree(8), tr, kw_t)):
            with pytest.raises(ValueError, match="permute wire"):
                mix(t, r, **kw)
        return
    want = JG.mix_realization(_jtree(8), jr, **kw_j)
    got = TG.mix_realization(_tree(8), tr, **kw_t)
    _close(got, want, TOL32)


def test_bf16_only_payload_rounds_received_losses_like_jax(jax_interpret,
                                                           n=8):
    """No f32 group: the losses ride group 0 cast to bf16, so the RECEIVED
    losses round to bf16 while each node's own stays f32 -- the reference's
    concatenate -> permute -> slice.  Losses 1 apart by less than a bf16
    step and a strong pull make the rounding move the weights by ~15 %, so
    the 2e-2 comparison pins it."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, 33)).astype(np.float32)
    loss = (1.0 + 0.003 * np.arange(n)).astype(np.float32)
    jt = {"w": jnp.asarray(x).astype(jnp.bfloat16)}
    tt = {"w": torch.from_numpy(x).to(torch.bfloat16)}
    jrule, trule = JTr.al_dsgd(pull=100.0), TTr.al_dsgd(pull=100.0)
    r_j = JT.one_peer_exponential(n).realization(0)
    r_t = TT.one_peer_exponential(n).realization(0)
    want = JG.mix_realization(jt, r_j, meta=jnp.asarray(loss),
                              edge_weight=jrule.edge_weight)
    got = TG.mix_realization(tt, r_t, meta=torch.from_numpy(loss),
                             edge_weight=trule.edge_weight)
    _close(got, want, TOLBF)
    # without the rounding the mix would differ by far more than 2e-2
    exact = TG.mix_realization({"w": tt["w"].float()}, r_t,
                               meta=torch.from_numpy(loss),
                               edge_weight=trule.edge_weight)
    assert float((exact["w"] - got["w"].float()).abs().max()) > 0.1


def _traj_both(make_opts, n, T, aux_fn, d=5, lr=0.05):
    """``T`` steps of a JAX and a port optimizer on the same quadratic,
    with the same per-step aux (numpy draws injected into both)."""
    A, b = _quad(n, d)
    jopt, topt = make_opts()
    jx, tx = {"x": jnp.zeros((n, d))}, {"x": torch.zeros((n, d))}
    js, ts = jopt.init(jx), topt.init(tx)
    jA, jb, tA, tb = (jnp.asarray(A), jnp.asarray(b), torch.from_numpy(A),
                      torch.from_numpy(b))
    for k in range(T):
        jr = jnp.einsum("nij,nj->ni", jA, jx["x"]) - jb
        jg = jnp.einsum("nij,ni->nj", jA, jr)
        tr, tg = _quad_grad(tA, tb, tx["x"])
        ja, ta = aux_fn(k, np.asarray(0.5 * jnp.sum(jr * jr, axis=1)))
        jx, js = jopt.update(jx, js, {"x": jg}, k, jnp.float32(lr), aux=ja)
        tx, ts = topt.update(tx, ts, {"x": tg}, k, lr, aux=ta)
    return jx, js, tx, ts


def _aux_pair(loss=True, alive_p=None, comm=None, seed=7, n=8):
    rng = np.random.default_rng(seed)

    def fn(k, jloss):
        ja, ta = {}, {}
        if loss:
            # the JAX losses, so both sides weight the same edges
            ja["loss"], ta["loss"] = jnp.asarray(jloss), torch.from_numpy(
                np.array(jloss, np.float32))
        if alive_p is not None:
            alive = rng.random(n) >= alive_p
            ja["alive"], ta["alive"] = jnp.asarray(alive), torch.from_numpy(
                alive)
        if comm is not None:
            ja["comm"], ta["comm"] = (jnp.asarray(comm(k)),
                                      torch.tensor(comm(k)))
        return ja, ta
    return fn


def _al_chain(mod_t, mod_top, n, gn_weight):
    return mod_t.chain(
        mod_t.trace_momentum(0.8), mod_t.scale_by_lr("m"),
        mod_t.deadline_skip(),
        mod_t.gossip(where=("m_next", "x_next"),
                     weights_from=mod_t.al_dsgd(gn_weight=gn_weight)),
        topology=mod_top.one_peer_exponential(n), name="al", beta=0.8)


@pytest.mark.parametrize("case", ["loss_aware", "deadline", "both",
                                  "al_gn", "dsgd_hypercube"])
def test_runtime_optimizer_trajectories_match_jax(case, jax_interpret,
                                                  n=8, T=40):
    if case == "al_gn":
        make = lambda: (_al_chain(JTr, JT, n, 0.5),    # noqa: E731
                        _al_chain(TTr, TT, n, 0.5))
        aux = _aux_pair(alive_p=0.25)
    elif case == "dsgd_hypercube":
        make = lambda: (JO.dsgd(JT.one_peer_hypercube(n), deadline=True,   # noqa: E731,E501
                                loss_aware=2.5),
                        TO.dsgd(TT.one_peer_hypercube(n), deadline=True,
                                loss_aware=2.5))
        aux = _aux_pair(alive_p=0.3)
    else:
        kw = {"loss_aware": case != "deadline",
              "deadline": case != "loss_aware"}
        make = lambda: (JO.dmsgd(JT.one_peer_exponential(n), beta=0.8,   # noqa: E731,E501
                                 **kw),
                        TO.dmsgd(TT.one_peer_exponential(n), beta=0.8, **kw))
        aux = _aux_pair(loss=kw["loss_aware"],
                        alive_p=0.25 if kw["deadline"] else None)
    jx, js, tx, ts = _traj_both(make, n, T, aux)
    _close(tx, jx, TOL_TRAJ)
    _close(ts.momentum, js.momentum, TOL_TRAJ)


def test_mix_scheduled_with_skips_matches_jax(jax_interpret, n=8, T=30):
    """``gossip(when=...)``: the schedule position counts the communicating
    rounds on both sides, and the params follow the reference's."""
    comm = lambda k: k % 3 != 1                        # noqa: E731
    make = lambda: tuple(                              # noqa: E731
        mod.dmsgd(top.one_peer_exponential(n), beta=0.8,
                  when=lambda ctx: ctx.aux["comm"])
        for mod, top in ((JO, JT), (TO, TT)))
    jx, js, tx, ts = _traj_both(make, n, T, _aux_pair(loss=False, comm=comm))
    assert int(ts.sched_pos) == int(js.sched_pos) == sum(
        comm(k) for k in range(T))
    _close(tx, jx, TOL_TRAJ)
    _close(ts.momentum, js.momentum, TOL_TRAJ)
    # the position and its advance, alone
    jp, tp = JS.initial_position(), TS.initial_position()
    for g in (True, False, True):
        jp = JS.advance_position(jp, jnp.asarray(g))
        tp = TS.advance_position(tp, torch.tensor(g))
    assert int(tp) == int(jp) == 2
    assert int(TS.advance_position(tp)) == int(JS.advance_position(jp)) == 3


def _pool_streams(mod, arr, n=8):
    partner = tuple(range(n - 1, -1, -1))
    rng = np.random.default_rng(0)
    weighted = tuple(mod.Matching(partner, arr(np.float32(w)))
                     for w in rng.uniform(0.3, 0.7, size=4))
    static = tuple(mod.Matching(partner, float(w))
                   for w in rng.uniform(0.3, 0.7, size=4))
    inner = mod.one_peer_hypercube(n).realization(0)
    rng = np.random.default_rng(0)
    gated = tuple(mod.Gated(inner, arr(rng.random(n) > 0.4))
                  for _ in range(5))
    return {name: mod.Topology(name, n, max_degree=1, realizations=reals)
            for name, reals in (("weighted_pool", weighted),
                                ("static_pool", static),
                                ("gated_pool", gated))}


@pytest.mark.parametrize("stream", ["weighted_pool", "static_pool",
                                    "gated_pool"])
def test_plan_counters_match_jax_on_pool_streams(stream, jax_interpret,
                                                 n=8):
    jtop = _pool_streams(JT, jnp.asarray)[stream]
    ttop = _pool_streams(TT, _tensor)[stream]
    jplan = JPlan(jtop, fn=lambda mix, t: mix(t))
    tplan = TPlan(ttop, fn=lambda mix, t: mix(t))
    jt, tt = _jtree(n), _tree(n)
    for k in range(12):
        assert (tplan.realization_key(k)[0]
                == jplan.realization_key(k)[0])
        _close(tplan.step_fn(k)(tt), jplan.step_fn(k)(jt), TOL32)
    assert tplan.num_compiled == jplan.num_compiled
    assert tplan.cache_stats() == jplan.cache_stats()
