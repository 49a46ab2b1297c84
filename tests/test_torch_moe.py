"""PyTorch port parity: the moe family (``models/moe.py`` and the moe
branches of the model, serving and training paths) on reduced
granite-moe-3b-a800m (2 layers, d_model 256, 4 experts, top-2), with the
JAX weights carried across by ``params_from_jax`` and inputs made with
numpy.  The reference runs as its own tests run it on the CPU (its
kernels in interpret mode with ``attention_impl="pallas"``).  Tolerances
are the reference's (tests/test_kernels.py:15-16): f32 2e-4; bf16 2e-2,
relative to the output's max-abs where a whole layer or model is held.

Also: the decodes are dropless whatever ``cfg.moe_dropless`` is, the
train loss takes the capacity dispatch, the engine's sampled streams are
batch-invariant, one DmSGD step through the trainer matches the
reference's, the int8 scale groups and checkpoints of moe trees are the
reference's, and a reduced dbrx-132b in bf16 keeps its router in f32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as JSteps
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as TSteps
from repro_torch.launch import train as TTrain
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.serve import ServeEngine
from test_torch_checkpoint import \
    test_jax_checkpoint_restores_in_port as _jax_ckpt_in_port
from test_torch_checkpoint import \
    test_port_checkpoint_restores_in_jax as _port_ckpt_in_jax
from test_torch_int8 import \
    test_model_payload_scales_follow_jax_leaves as _int8_scales
from test_torch_model import _f32, _pool_from_prefill
from test_torch_train import _check_state, _draw_params, _train_both

ARCH = "granite-moe-3b-a800m"
TOL32 = dict(rtol=2e-4, atol=2e-4)
BF16_REL = 2e-2
ACT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
PAGE = 4


def _cfgs(act="f32", **upd):
    jdt, tdt = ACT[act]
    jcfg = dataclasses.replace(jconfigs.reduced_config(
        jconfigs.get_config(ARCH)), activation_dtype=jdt, **upd)
    tcfg = dataclasses.replace(tconfigs.reduced_config(
        tconfigs.get_config(ARCH)), activation_dtype=tdt, **upd)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, JM.init(jcfg, jax.random.key(0)))


def _model(np_params, tcfg):
    model = TM.Model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg))
    return model


def _layer(np_params, i=0):
    """Layer ``i``'s moe leaves: the JAX dict and the port's ``MoE``."""
    jp = {k: jnp.asarray(v[i]) for k, v in
          np_params["layers"]["moe"].items()}
    d, e = jp["router"].shape
    f = jp["w_gate"].shape[-1]
    tp = TMoE.MoE(d, f, e)
    tp.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in jp.items()})
    return jp, tp


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close_rel(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# ---------------------------------------------------------------------------
# models/moe.py
# ---------------------------------------------------------------------------

def test_route_matches_jax(weights):
    jp, tp = _layer(weights)
    xf = _x((40, jp["router"].shape[0]))
    jg, ji, ja = JMoE._route(jp, jnp.asarray(xf), 4, 2)
    with torch.no_grad():
        tg, ti, ta = TMoE._route(tp, torch.from_numpy(xf), 4, 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL32)
    np.testing.assert_allclose(float(ta), float(ja), **TOL32)
    assert tg.dtype == ta.dtype == torch.float32


@pytest.mark.parametrize("dropless,cf", [(True, 1.25), (False, 1.25),
                                         (False, 0.5)])
@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_moe_apply_matches_jax(weights, act, dropless, cf):
    jp, tp = _layer(weights, 1)
    jdt, tdt = ACT[act]
    x = _x((3, 8, jp["router"].shape[0]), seed=2)
    kw = dict(n_experts=4, top_k=2, capacity_factor=cf, dropless=dropless)
    jy, ja = JMoE.moe_apply(jp, jnp.asarray(x, jdt), **kw)
    with torch.no_grad():
        ty, ta = TMoE.moe_apply(tp, torch.from_numpy(x).to(tdt), **kw)
    assert ty.dtype == tdt and ty.shape == x.shape
    if act == "f32":
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL32)
    else:
        _close_rel(ty, jy, BF16_REL)
    np.testing.assert_allclose(float(ta), float(ja),
                               **(TOL32 if act == "f32" else {"rtol": 2e-2}))


def test_capacity_overflow_drops_the_reference_set(weights):
    """capacity_factor 0.5: every expert keeps the first ``capacity`` of
    its assignments in token order (a = t * k + j), the rest are dropped;
    the port's kept set is the one the reference's routing implies, and
    a token with every choice dropped comes out zero on both sides."""
    jp, tp = _layer(weights, 1)
    x = _x((24, jp["router"].shape[0]), seed=3)
    _, ji, _ = JMoE._route(jp, jnp.asarray(x), 4, 2)
    ji = np.asarray(ji)
    T, k = ji.shape
    capacity = int(max(1, -(-T * k * 0.5 // 4)))
    seen = np.zeros(4, int)
    want = np.zeros(T * k, bool)
    for a, e in enumerate(ji.reshape(-1)):
        want[a] = seen[e] < capacity
        seen[e] += 1
    assert 0 < (~want).sum() and want.sum() <= 4 * capacity
    cap, order, _, keep = TMoE._dispatch(torch.from_numpy(ji), 4, 0.5)
    assert cap == capacity
    got = np.zeros(T * k, bool)
    got[order.numpy()] = keep.numpy()
    np.testing.assert_array_equal(got, want)
    dead = ~want.reshape(T, k).any(1)
    jy, _ = JMoE.moe_apply(jp, jnp.asarray(x[None]), n_experts=4, top_k=2,
                           capacity_factor=0.5, dropless=False)
    with torch.no_grad():
        ty, _ = TMoE.moe_apply(tp, torch.from_numpy(x[None]), n_experts=4,
                               top_k=2, capacity_factor=0.5, dropless=False)
    assert (np.asarray(jy)[0][dead] == 0).all()
    assert (ty[0].numpy()[dead] == 0).all()
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL32)


@pytest.mark.parametrize("G,cf", [(1, 1.25), (2, 1.25), (4, 1.25),
                                  (2, 0.5), (4, 0.5)])
def test_group_routing_is_the_whole_groups(weights, G, cf):
    """A routing group's 24 tokens split into G equal shares, in token
    order, as G fsdp ranks hold them: each share's dispatch
    (``_group_dispatch``, offsets the exclusive prefix of the shares'
    ``_counts``) keeps exactly the assignments ``_dispatch`` keeps on the
    whole group, each at the whole group's position of its expert (the
    group's capacity, 15 or 6, laid out at a width padded to a multiple
    of G: 15 / 16 / 16 / 6 / 8); the aux loss from the shares' count
    totals and probability sums is ``_route``'s on the whole group (and
    the reference's) within 2e-4."""
    jp, tp = _layer(weights, 1)
    E, k, T = 4, 2, 24
    x = torch.from_numpy(_x((T, jp["router"].shape[0]), seed=5))
    with torch.no_grad():
        _, idx, aux = TMoE._route(tp, x, E, k)
        shares = [TMoE._gates(tp, part, k) for part in x.chunk(G)]
    _, _, jaux = JMoE._route(jp, jnp.asarray(x.numpy()), E, k)
    cap, order, slot, keep = TMoE._dispatch(idx, E, cf)
    want = {}                                # kept a -> (expert, position)
    for a, s_, kp in zip(order.tolist(), slot.tolist(), keep.tolist()):
        if kp:
            want[a] = divmod(s_, cap)
    assert 0 < len(want) <= T * k
    counts = [TMoE._counts(i, E) for _, i, _ in shares]
    assert torch.equal(sum(counts), TMoE._counts(idx, E))
    got, offset = {}, torch.zeros(E, dtype=torch.int64)
    for r, (_, i, _) in enumerate(shares):
        assert torch.equal(i, idx[r * T // G:(r + 1) * T // G])
        c, width, o, s_, kp = TMoE._group_dispatch(i, E, cf, G, offset)
        assert c == cap and width % G == 0 and cap <= width < cap + G
        for a, sl, keep_a in zip(o.tolist(), s_.tolist(), kp.tolist()):
            if keep_a:
                got[r * (T // G) * k + a] = divmod(sl, width)
        offset = offset + counts[r]
    assert got == want
    if G > 1 and cf == 1.25:
        assert cap % G                       # padding slots, never kept
    total = sum(counts).float()
    prob_sum = sum(p.sum(0) for _, _, p in shares)
    group_aux = TMoE._aux(total / T, prob_sum / T, E, k)
    np.testing.assert_allclose(float(group_aux), float(aux), **TOL32)
    np.testing.assert_allclose(float(group_aux), float(jaux), **TOL32)


def test_rows_over_fsdp_keeps_a_straddling_group_whole():
    """A moe node batch of 6 over fsdp 2 (3 rows a rank) in micro-batches
    of 2: a routing group neither holds a rank's rows whole nor lies
    whole within them, so the rows stay whole on every rank (the dense
    family's split); a routing group spans 1 rank at micro-batches of
    3 and 2 without them, and ``prepare`` cuts the rank's rows by it.
    ``build_trainer`` on such a mesh wants the node's batch, which sets
    the group: a routing context where it spans 2 ranks, none where it
    is a rank's or the rows stay whole."""
    from repro_torch.core import topology as ttopo
    from repro_torch.launch import mesh as TMesh
    mesh = TMesh.abstract_mesh((2, 2, 1), ("node", "fsdp", "model"))
    _, tcfg = _cfgs()
    dense = tconfigs.reduced_config(tconfigs.get_config("qwen3-0.6b"))
    assert TTrain.routing_group(mesh, 6, 2) is None
    assert not TTrain.rows_over_fsdp(tcfg, mesh, 6, 2)
    assert TTrain.rows_over_fsdp(dense, mesh, 6, 2)
    assert TTrain.routing_group(mesh, 6, 3) == 1
    assert TTrain.routing_group(mesh, 6) == TTrain.routing_group(mesh, 6,
                                                                 6) == 2
    assert TTrain.rows_over_fsdp(tcfg, mesh, 6, 3)
    base = ["--arch", ARCH, "--device", "cpu", "--nodes", "2", "--steps",
            "1", "--batch", "6", "--seq", "8"]
    for micro, rows in (("2", 6), ("3", 3)):
        args = TTrain.parse_args(base + ["--micro-batch", micro])
        start = TTrain.prepare(args, node=1, fsdp=1, mesh=mesh)
        assert start["batches"][0]["tokens"].shape[:2] == (1, rows)
    top = ttopo.get_topology("one_peer_exp", 2)
    with pytest.raises(ValueError, match="batch="):
        TTrain.build_trainer(tcfg, top, "dmsgd", 0.9, mesh=mesh)
    for micro, size in ((None, 2), (2, None), (3, None)):
        _, step_for = TTrain.build_trainer(tcfg, top, "dmsgd", 0.9, micro,
                                           mesh=mesh, batch=6)
        assert getattr(step_for.route, "size", None) == size


# ---------------------------------------------------------------------------
# models/model.py
# ---------------------------------------------------------------------------

def test_init_and_counts_match_jax(weights):
    jcfg, tcfg = _cfgs()
    model = TM.init(tcfg, 0, device="cpu")
    sd = params_from_jax(weights, tcfg)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        {n: tuple(t.shape) for n, t in sd.items()}
    assert "layers.1.moe.w_down" in sd and "layers.0.mlp.w_up" not in sd
    jparams = jax.tree.map(jnp.asarray, weights)
    assert TM.param_count(model) == JM.param_count(jparams)
    assert TM.active_param_count(model, tcfg) == \
        JM.active_param_count(jparams, jcfg) < TM.param_count(model)
    # fan_in = shape[-2]: (E, d, f) experts at d^-0.5, (E, f, d) at f^-0.5
    moe = model.layers[0].moe
    assert float(moe.w_down.detach().std()) < float(moe.w_gate.detach().std())
    assert float(moe.w_gate.detach().abs().max()) <= 2 * tcfg.d_model ** -0.5


@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("dropless", [True, False])
def test_forward_logits_and_aux_match_jax(weights, act, dropless):
    jcfg, tcfg = _cfgs(act, moe_dropless=dropless)
    model = _model(weights, tcfg)
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 12))
    jl, ja = JM.forward(jax.tree.map(jnp.asarray, weights), jcfg,
                        jnp.asarray(tokens))
    with torch.no_grad():
        tl, ta = TM.forward(model, tcfg, torch.from_numpy(tokens))
    assert float(ta) > 0 and ta.dtype == torch.float32
    if act == "f32":
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL32)
        np.testing.assert_allclose(float(ta), float(ja), **TOL32)
    else:
        _close_rel(tl, jl, BF16_REL)
        np.testing.assert_allclose(float(ta), float(ja), rtol=2e-2)


@pytest.mark.parametrize("remat", [False, True])
def test_train_loss_and_gradients_match_jax(weights, remat):
    """``train_loss_fn`` (CE + 0.01 aux, capacity dispatch) and the
    gradient of every leaf, f32, with and without remat."""
    jcfg, tcfg = _cfgs(remat=remat, capacity_factor=0.75)
    model = _model(weights, tcfg)
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 16))
    jloss, jgrads = jax.value_and_grad(JSteps.train_loss_fn)(
        jax.tree.map(jnp.asarray, weights), jcfg, jnp.asarray(tokens))
    tloss = TSteps.train_loss_fn(model, tcfg, torch.from_numpy(tokens))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL32)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL32)
    assert float(model.layers[0].moe.router.grad.abs().max()) > 0


def test_train_loss_takes_capacity_dispatch(weights):
    """The loss is the capacity-dispatch forward's (tokens overflow at
    capacity_factor 0.5, so the dropless one differs), whatever
    ``moe_dropless`` is."""
    _, tcfg = _cfgs(capacity_factor=0.5)
    model = _model(weights, tcfg)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (2, 16)))

    def loss_of(cfg):
        logits, aux = TM.forward(model, cfg, tokens)
        ce = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]).float(),
            torch.roll(tokens, -1, 1).reshape(-1))
        return float(ce + TSteps.AUX_WEIGHT * aux)

    with torch.no_grad():
        got = float(TSteps.train_loss_fn(model, tcfg, tokens))
        capacity = loss_of(dataclasses.replace(tcfg, moe_dropless=False))
        dropless = loss_of(tcfg)
    np.testing.assert_allclose(got, capacity, rtol=1e-6)
    assert abs(capacity - dropless) > 1e-4


@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_prefill_and_paged_decode_match_jax(weights, act):
    """forward_prefill's logits and k/v, then 3 paged decode steps of 2
    live rows at ragged positions beside 2 trash-padded rows."""
    jcfg, tcfg = _cfgs(act)
    jcfg = dataclasses.replace(jcfg, attention_impl="pallas")
    model = _model(weights, tcfg)
    jparams = jax.tree.map(jnp.asarray, weights)
    rng = np.random.default_rng(7)
    B, S = 2, 16
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jl, (jk, jv) = JM.forward_prefill(jparams, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        tl, (tk, tv) = TM.forward_prefill(model, tcfg,
                                          torch.from_numpy(tokens))

    def close(got, want):
        if act == "f32":
            np.testing.assert_allclose(_f32(got), _f32(want), **TOL32)
        else:
            _close_rel(got, want, BF16_REL)

    for got, want in ((tl, jl), (tk, jk), (tv, jv)):
        assert got.shape == want.shape and got.dtype == tcfg.activation_dtype
        close(got, want)
    pages = 1 + rng.permutation(2 * 6).reshape(2, 6).astype(np.int32)
    table = np.zeros((4, 6), np.int32)
    table[:2] = pages
    pk, pv = _pool_from_prefill(_f32(jk), _f32(jv), table[:2], np.float32)
    jpool = {"k": jnp.asarray(pk, jcfg.activation_dtype),
             "v": jnp.asarray(pv, jcfg.activation_dtype)}
    tpool = {"k": torch.from_numpy(pk).to(tcfg.activation_dtype),
             "v": torch.from_numpy(pv).to(tcfg.activation_dtype)}
    positions = np.array([S, S - 5, 0, 0], np.int32)
    token = np.zeros((4, 1), np.int32)
    token[:2, 0] = np.argmax(_f32(jl)[:, -1], -1)
    for _ in range(3):
        jlog, jpool = JM.decode_step_paged(
            jparams, jcfg, jnp.asarray(token), jpool, jnp.asarray(table),
            jnp.asarray(positions), page_size=PAGE)
        with torch.no_grad():
            tlog, tpool = TM.decode_step_paged(
                model, tcfg, torch.from_numpy(token), tpool,
                torch.from_numpy(table), torch.from_numpy(positions),
                page_size=PAGE)
        close(tlog[:2], jlog[:2])
        token[:2, 0] = np.argmax(_f32(jlog)[:2, 0], -1)
        positions[:2] += 1


def test_decode_step_matches_forward(weights):
    """Token-by-token ring decode against the full forward (2e-2, as
    tests/test_arch_smoke.py:138-170), with ``moe_dropless=False`` in the
    config: both decodes stay dropless, bit for bit the dropless
    config's."""
    _, tcfg = _cfgs()
    model = _model(weights, tcfg)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, tcfg.vocab_size, (2, 10)))
    capacity = dataclasses.replace(tcfg, moe_dropless=False,
                                   capacity_factor=0.25)
    with torch.no_grad():
        full, _ = TM.forward(model, tcfg, tokens)
        outs = {}
        for name, cfg in (("dropless", tcfg), ("capacity", capacity)):
            cache = TM.init_cache(cfg, batch=2, cache_len=10,
                                  dtype=torch.float32, device="cpu")
            outs[name] = torch.cat([TM.decode_step(
                model, cfg, tokens[:, t:t + 1], cache, t)[0]
                for t in range(10)], 1)
        short, _ = TM.forward(model, capacity, tokens)
        pool = {n: torch.zeros(tcfg.n_layers, tcfg.n_kv_heads, 8, PAGE,
                               tcfg.head_dim) for n in ("k", "v")}
        table = torch.arange(1, 5, dtype=torch.int32).reshape(2, 2)
        paged = {}
        for name, cfg in (("dropless", tcfg), ("capacity", capacity)):
            p = {n: t.clone() for n, t in pool.items()}
            paged[name] = TM.decode_step_paged(
                model, cfg, tokens[:, :1], p, table,
                torch.zeros(2, dtype=torch.int32), page_size=PAGE)[0]
    np.testing.assert_allclose(outs["dropless"].numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)
    assert torch.equal(outs["capacity"], outs["dropless"])
    assert torch.equal(paged["capacity"], paged["dropless"])
    assert not torch.allclose(short, full, atol=1e-3)   # forward drops


def test_engine_sampled_stream_batch_invariant(weights):
    """temperature > 0: a request's stream depends only on (seed, rid,
    step); co-batching (prefill and decode buckets of 1 and 2 rows) must
    not change its tokens -- the dropless experts see each token alone."""
    _, tcfg = _cfgs()
    model = _model(weights, tcfg)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, tcfg.vocab_size, (n,)) for n in (5, 8)]

    def engine(seed=7):
        return ServeEngine(tcfg, model, n_pages=64, page_size=PAGE,
                           max_seq=32, max_batch=4, prefill_token_budget=32,
                           pool_dtype=torch.float32, temperature=0.8,
                           seed=seed, device="cpu")

    solo = engine()
    r_solo = solo.submit(prompts[0], max_new=4)
    solo.run()
    both = engine()
    r_both = both.submit(prompts[0], max_new=4)
    both.submit(prompts[1], max_new=4)
    both.run()
    assert r_solo.generated == r_both.generated
    assert both.stats()["compile_cache"]["entries"] >= 2


def test_serve_cli_runs_moe(capsys):
    """``launch.serve.main --arch granite-moe-3b-a800m`` (the reduced
    config through the engine and ``serve_trace``)."""
    tserve.main(["--device", "cpu", "--arch", ARCH, "--n-requests", "3",
                 "--rate", "1000", "--mean-prompt", "5", "--max-new", "3",
                 "--max-seq", "32", "--pages", "32"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} on cpu: served 3 requests, 9 new tokens" in out


# ---------------------------------------------------------------------------
# training, int8 scales, checkpoints
# ---------------------------------------------------------------------------

def test_dmsgd_step_matches_jax():
    """One DmSGD step over the one-peer graph on 4 nodes through
    ``build_trainer`` (the driver's trainer) on both sides, f32: the loss
    (capacity dispatch plus aux), params, momentum and consensus."""
    tcfg, tol, losses, (jx, js, jplan), (tx, ts, tplan) = _train_both(
        _draw_params(ARCH), "f32", 4, steps=1, arch=ARCH)
    assert tcfg.family == "moe"
    (got, want), = losses
    np.testing.assert_allclose(got, want, **tol)
    _check_state(tcfg, tol, tx, ts, jx, js)
    assert tplan.num_compiled == jplan.num_compiled == 1


@pytest.fixture
def one_thread():
    """One torch thread (under the test runner's parallel workers the
    default oversubscribes the cores; see test_torch_train_families.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_driver_trains_moe_on_cpu(one_thread):
    """The driver on the CPU: the loss falls and consensus stays finite."""
    out = TTrain.run(TTrain.parse_args([
        "--arch", ARCH, "--device", "cpu", "--nodes", "4", "--steps", "12",
        "--batch", "4", "--seq", "32", "--warmup", "2", "--lr", "0.3",
        "--log-every", "1"]))
    losses = [h["loss"] for h in out["history"]]
    assert out["config"].family == "moe" and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.1
    assert all(np.isfinite(h["consensus"]) for h in out["history"])


def test_int8_scale_groups_of_moe_leaves():
    """``layers.<i>.moe.w_gate`` joins ``layers.moe.w_gate``: one scale per
    (node, JAX leaf), the reference's bit for bit."""
    _int8_scales(ARCH)


@pytest.mark.parametrize("slots,mom_dtype", [("one", jnp.float32),
                                             ("mu_nu", jnp.bfloat16)])
def test_moe_checkpoints_cross_read(tmp_path, slots, mom_dtype):
    _port_ckpt_in_jax(tmp_path / "port", ARCH, slots, mom_dtype)
    _jax_ckpt_in_port(tmp_path / "jax", ARCH, slots, mom_dtype)


def test_reduced_dbrx_bf16_keeps_router_f32():
    jcfg = dataclasses.replace(jconfigs.reduced_config(
        jconfigs.get_config("dbrx-132b")), param_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tconfigs.reduced_config(
        tconfigs.get_config("dbrx-132b")), param_dtype=torch.bfloat16)
    model = TM.init(tcfg, 0, device="cpu")
    moe = model.layers[0].moe
    assert moe.router.dtype == torch.float32
    assert moe.w_gate.dtype == moe.w_down.dtype == torch.bfloat16
    jp = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.key(0)))
    sd = params_from_jax(jp, tcfg)
    assert sd["layers.1.moe.router"].dtype == torch.float32
    assert sd["layers.1.moe.w_up"].dtype == torch.bfloat16
    model.load_state_dict(sd)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with torch.no_grad():
        logits, aux = TM.forward(model, tcfg, tokens)
    assert torch.isfinite(logits.float()).all() and torch.isfinite(aux)
