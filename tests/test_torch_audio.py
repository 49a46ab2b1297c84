"""PyTorch port parity: the audio family (musicgen-large: a dense stack
over the sum of K = 4 codebook embeddings, K lm heads) on reduced
musicgen-large (2 layers, d_model 256, vocab 512, 4 codebooks), with the
JAX weights carried across by ``params_from_jax`` and inputs made with
numpy.  The reference runs as its own tests run it on the CPU (its
kernels in interpret mode with ``attention_impl="pallas"``).  Tolerances
are the reference's (tests/test_kernels.py:15-16): f32 2e-4; bf16 2e-2,
relative to the logits' max-abs where a whole model is held.

Covered: the codebook embedding sum in bf16 bit for bit, the forward,
the train loss and every gradient, prefill and paged decode, the
ring-cache decode against the forward, the engine's frames (greedy
against the ring-cache loop, as tests/test_serve_engine.py::
test_engine_audio_family; sampled, batch-invariant, one independent draw
per codebook), ``generate``'s fast prefill against its loop, one DmSGD
step through the training driver's trainer against the reference's, its
codebook batches, the int8 scale groups of the (K, V, d) leaves and
checkpoints both packages read."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import topology as JT
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import serve as jserve
from repro.launch import steps as JSteps
from repro.launch import train as JTrain
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax, stacked_from_jax
from repro_torch.core import topology as TT
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as TSteps
from repro_torch.launch import train as TTrain
from repro_torch.models import model as TM
from repro_torch.serve import ServeEngine
from test_torch_checkpoint import \
    test_jax_checkpoint_restores_in_port as _jax_ckpt_in_port
from test_torch_checkpoint import \
    test_port_checkpoint_restores_in_jax as _port_ckpt_in_jax
from test_torch_int8 import \
    test_model_payload_scales_follow_jax_leaves as _int8_scales
from test_torch_model import _f32, _pool_from_prefill
from test_torch_train import _check_state, _stacked_np

ARCH = "musicgen-large"
TOL32 = dict(rtol=2e-4, atol=2e-4)
BF16_REL = 2e-2
ACT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
PAGE = 4
K = 4


def _cfgs(act="f32", arch=ARCH, **upd):
    jdt, tdt = ACT[act]
    jcfg = dataclasses.replace(jconfigs.reduced_config(
        jconfigs.get_config(arch)), activation_dtype=jdt, **upd)
    tcfg = dataclasses.replace(tconfigs.reduced_config(
        tconfigs.get_config(arch)), activation_dtype=tdt, **upd)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, JM.init(jcfg, jax.random.key(0)))


def _model(np_params, tcfg):
    model = TM.Model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg))
    return model


def _frames(shape, seed, vocab=512):
    """Random (..., K) codebook tokens."""
    return np.random.default_rng(seed).integers(
        0, vocab, shape + (K,)).astype(np.int32)


def _close_rel(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _close(act, got, want):
    if act == "f32":
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL32)
    else:
        _close_rel(got, want, BF16_REL)


# ---------------------------------------------------------------------------
# models/model.py
# ---------------------------------------------------------------------------

def test_init_and_counts_match_jax(weights):
    """(K, V, d) embed and (K, d, V) heads, the reference's names, shapes
    and parameter count; init at the reference's scales (embed d^-0.5,
    heads fan_in d)."""
    jcfg, tcfg = _cfgs()
    model = TM.init(tcfg, 0, device="cpu")
    sd = params_from_jax(weights, tcfg)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        {n: tuple(t.shape) for n, t in sd.items()}
    d, V = tcfg.d_model, tcfg.vocab_size
    assert tuple(model.embed.shape) == (K, V, d)
    assert tuple(model.lm_head.shape) == (K, d, V)
    jparams = jax.tree.map(jnp.asarray, weights)
    assert TM.param_count(model) == JM.param_count(jparams)
    assert TM.active_param_count(model, tcfg) == \
        JM.active_param_count(jparams, jcfg) == TM.param_count(model)
    for name, scale in (("embed", d ** -0.5), ("lm_head", d ** -0.5)):
        w = getattr(model, name).detach()
        assert float(w.abs().max()) <= 2 * scale
        np.testing.assert_allclose(float(w.std()), float(
            np.asarray(weights[name]).std()), rtol=0.05)


def test_embed_tokens_bf16_bit_exact(weights):
    """The K codebook embeddings summed left to right in bf16, then the
    sqrt(d) scale: the reference's bits."""
    jcfg, tcfg = _cfgs("bf16")
    model = _model(weights, tcfg)
    tokens = _frames((3, 10), 1)
    want = JM._embed_tokens(jax.tree.map(jnp.asarray, weights), jcfg,
                            jnp.asarray(tokens))
    with torch.no_grad():
        got = TM._embed_tokens(model, tcfg, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_forward_logits_match_jax(weights, act):
    jcfg, tcfg = _cfgs(act)
    model = _model(weights, tcfg)
    tokens = _frames((2, 12), 2)
    jl, ja = JM.forward(jax.tree.map(jnp.asarray, weights), jcfg,
                        jnp.asarray(tokens))
    with torch.no_grad():
        tl, ta = TM.forward(model, tcfg, torch.from_numpy(tokens))
    assert tuple(tl.shape) == jl.shape == (2, 12, K, tcfg.vocab_size)
    assert tl.dtype == tcfg.activation_dtype and float(ta) == 0.0
    _close(act, tl, jl)


@pytest.mark.parametrize("remat", [False, True])
def test_train_loss_and_gradients_match_jax(weights, remat):
    """``train_loss_fn`` on (B, S, K) tokens (the mean over B S K of the
    K heads' CE) and the gradient of every leaf, f32, with and without
    remat."""
    jcfg, tcfg = _cfgs(remat=remat)
    model = _model(weights, tcfg)
    tokens = _frames((2, 16), 3)
    jloss, jgrads = jax.value_and_grad(JSteps.train_loss_fn)(
        jax.tree.map(jnp.asarray, weights), jcfg, jnp.asarray(tokens))
    tloss = TSteps.train_loss_fn(model, tcfg, torch.from_numpy(tokens))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL32)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL32)
    assert all(float(model.embed.grad[k].abs().max()) > 0 for k in range(K))


@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_prefill_and_paged_decode_match_jax(weights, act):
    """forward_prefill's (B, S, K, V) logits and k/v, then 3 paged decode
    steps of (B, 1, K) frames, 2 live rows at ragged positions beside 2
    trash-padded rows, against the reference's "pallas" path."""
    jcfg, tcfg = _cfgs(act)
    jcfg = dataclasses.replace(jcfg, attention_impl="pallas")
    model = _model(weights, tcfg)
    jparams = jax.tree.map(jnp.asarray, weights)
    rng = np.random.default_rng(4)
    B, S = 2, 16
    tokens = _frames((B, S), 4)
    jl, (jk, jv) = JM.forward_prefill(jparams, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        tl, (tk, tv) = TM.forward_prefill(model, tcfg,
                                          torch.from_numpy(tokens))
    for got, want in ((tl, jl), (tk, jk), (tv, jv)):
        assert got.shape == want.shape and got.dtype == tcfg.activation_dtype
        _close(act, got, want)
    pages = 1 + rng.permutation(2 * 6).reshape(2, 6).astype(np.int32)
    table = np.zeros((4, 6), np.int32)
    table[:2] = pages
    pk, pv = _pool_from_prefill(_f32(jk), _f32(jv), table[:2], np.float32)
    jpool = {"k": jnp.asarray(pk, jcfg.activation_dtype),
             "v": jnp.asarray(pv, jcfg.activation_dtype)}
    tpool = {"k": torch.from_numpy(pk).to(tcfg.activation_dtype),
             "v": torch.from_numpy(pv).to(tcfg.activation_dtype)}
    positions = np.array([S, S - 5, 0, 0], np.int32)
    token = np.zeros((4, 1, K), np.int32)
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
        assert tuple(tlog.shape) == (4, 1, K, tcfg.vocab_size)
        _close(act, tlog[:2], jlog[:2])
        token[:2, 0] = np.argmax(_f32(jlog)[:2, 0], -1)
        positions[:2] += 1
    for name in ("k", "v"):             # page 0 is the trash page
        _close(act, tpool[name][:, :, 1:], jpool[name][:, :, 1:])


def test_decode_step_matches_forward(weights):
    """Frame-by-frame ring decode against the full forward (2e-2, as
    tests/test_arch_smoke.py:138-170), and the ring cache's shape."""
    _, tcfg = _cfgs()
    model = _model(weights, tcfg)
    tokens = torch.from_numpy(_frames((2, 10), 5))
    cache = TM.init_cache(tcfg, batch=2, cache_len=10, dtype=torch.float32,
                          device="cpu")
    assert tuple(cache["kv"].k.shape) == (tcfg.n_layers, 2,
                                          tcfg.n_kv_heads, 10, tcfg.head_dim)
    with torch.no_grad():
        full, _ = TM.forward(model, tcfg, tokens)
        steps = torch.cat([TM.decode_step(model, tcfg, tokens[:, t:t + 1],
                                          cache, t)[0] for t in range(10)], 1)
    assert steps.shape == full.shape
    np.testing.assert_allclose(steps.numpy(), full.numpy(), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# serving: the engine and generate
# ---------------------------------------------------------------------------

def _greedy_ring(tcfg, model, prompt, max_new, cache_len=32):
    """The ring-cache greedy loop, one request at a time (the reference's
    tests/test_serve_engine.py::_greedy_dense): frames of K argmaxes."""
    toks = torch.as_tensor(prompt).long()[None]
    cache = TM.init_cache(tcfg, batch=1, cache_len=cache_len,
                          dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for t in range(toks.shape[1]):
            logits, cache = TM.decode_step(model, tcfg, toks[:, t:t + 1],
                                           cache, t)
        out = []
        for t in range(toks.shape[1], toks.shape[1] + max_new):
            cur = logits[:, -1].float().argmax(-1)          # (1, K)
            out.append(cur[0].numpy())
            logits, cache = TM.decode_step(model, tcfg, cur[:, None], cache,
                                           t)
    return out


def _engine(tcfg, model, **kw):
    return ServeEngine(tcfg, model, n_pages=64, page_size=PAGE, max_seq=32,
                       pool_dtype=torch.float32, device="cpu", **kw)


def test_engine_audio_family(weights):
    """Audio requests serve end to end through the engine ((P, K)
    prompts, (Bb, Lb, K) and (Bb, 1, K) buffers); greedy frames equal the
    ring-cache greedy loop's per codebook."""
    _, tcfg = _cfgs()
    model = _model(weights, tcfg)
    eng = _engine(tcfg, model, temperature=0.0)
    rng = np.random.default_rng(3)
    reqs = [eng.submit(rng.integers(0, tcfg.vocab_size, (p, K)), max_new=3)
            for p in (4, 6)]
    eng.run()
    for r in reqs:
        got = np.stack(r.generated)
        assert got.shape == (3, K) and got.dtype == np.int32
        np.testing.assert_array_equal(
            got, np.stack(_greedy_ring(tcfg, model, r.prompt, 3)))


def test_engine_sampled_stream_batch_invariant(weights):
    """temperature > 0: a request's frames depend only on (seed, rid,
    step); co-batching (buckets of 1 and 2 rows) must not change them."""
    _, tcfg = _cfgs()
    model = _model(weights, tcfg)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, tcfg.vocab_size, (n, K)) for n in (5, 8)]
    solo = _engine(tcfg, model, temperature=0.8, seed=7)
    r_solo = solo.submit(prompts[0], max_new=4)
    solo.run()
    both = _engine(tcfg, model, temperature=0.8, seed=7)
    r_both = both.submit(prompts[0], max_new=4)
    both.submit(prompts[1], max_new=4)
    both.run()
    np.testing.assert_array_equal(np.stack(r_solo.generated),
                                  np.stack(r_both.generated))
    assert both.stats()["compile_cache"]["entries"] >= 2


def test_codebooks_sampled_independently(weights):
    """Identical logits in every codebook row: greedy gives K equal codes
    (the f32 argmax of each row), sampling K independent draws -- in
    ``sample_tokens`` and in the engine's ``_sample`` -- which part (a
    single shared draw would repeat one code K times)."""
    _, tcfg = _cfgs()
    V = tcfg.vocab_size
    row = torch.zeros(V)                  # uniform: a draw rarely repeats
    lg = row.expand(3, K, V)
    assert torch.equal(tserve.sample_tokens(lg, 0.0),
                       torch.zeros(3, 1, K, dtype=torch.long))
    gen = torch.Generator().manual_seed(0)
    drawn = tserve.sample_tokens(lg, 0.8, gen)
    assert tuple(drawn.shape) == (3, 1, K)
    assert all(len(set(drawn[b, 0].tolist())) > 1 for b in range(3))
    eng = _engine(tcfg, _model(weights, tcfg), temperature=0.8, seed=1)
    req = eng.submit(np.zeros((2, K), np.int64), max_new=2)
    logits = np.zeros((K, V), np.float32)
    logits[:, 7] = 1.0
    greedy = _engine(tcfg, eng.params)._sample(logits, req)
    np.testing.assert_array_equal(greedy, np.full(K, 7, np.int32))
    frames = [eng._sample(np.zeros((K, V), np.float32), req)
              for _ in range(2)]
    assert frames[0].dtype == np.int32 and frames[0].shape == (K,)
    np.testing.assert_array_equal(frames[0], frames[1])   # (seed, rid, step)
    assert len(set(frames[0].tolist())) > 1


@pytest.mark.parametrize("cache_len", [32, 16])    # 16 < 12 + 6: wraps
def test_generate_fast_prefill_equals_loop(weights, cache_len):
    """``generate`` on (B, P, K) prompts: one forward_prefill ring-filled
    against the prompt fed frame by frame (last logits and every cache
    slot, f32 2e-4); the greedy frames of both prefills equal JAX's
    ``generate`` at temperature 0 (its top-2 gaps asserted above 1e-3)."""
    jcfg, tcfg = _cfgs()
    model = _model(weights, tcfg)
    prompts = _frames((2, 12), 6)
    with torch.no_grad():
        fl, fc = tserve.prefill_cache(tcfg, model, torch.from_numpy(prompts),
                                      cache_len=cache_len)
        ll, lc = tserve.prefill_cache(tcfg, model, torch.from_numpy(prompts),
                                      cache_len=cache_len, mode="loop")
    assert fl.shape == ll.shape == (2, 1, K, tcfg.vocab_size)
    np.testing.assert_allclose(fl.numpy(), ll.numpy(), **TOL32)
    for a, b in ((fc["kv"].k, lc["kv"].k), (fc["kv"].v, lc["kv"].v)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL32)
    jparams = jax.tree.map(jnp.asarray, weights)
    want = np.array(jserve.generate(jcfg, jparams, jnp.asarray(prompts),
                                    max_new=6, cache_len=cache_len,
                                    temperature=0.0, seed=0))
    assert want.shape == (2, 18, K)
    jc = JM.init_cache(jcfg, batch=2, cache_len=cache_len,
                       dtype=jnp.float32)
    gaps = []
    for t in range(17):
        jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(want[:, t:t + 1]),
                                jc, jnp.asarray(t, jnp.int32))
        if t >= 11:
            top2 = np.sort(np.asarray(jl[:, 0]), -1)[..., -2:]
            gaps.append(top2[..., 1] - top2[..., 0])
    assert (np.stack(gaps) > 1e-3).all()
    for mode in ("auto", "loop"):
        got = tserve.generate(tcfg, model, torch.from_numpy(prompts),
                              max_new=6, cache_len=cache_len,
                              temperature=0.0, prefill=mode, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want, err_msg=mode)
    sampled = tserve.generate(tcfg, model, torch.from_numpy(prompts),
                              max_new=3, temperature=0.8, seed=2,
                              device="cpu")
    assert tuple(sampled.shape) == (2, 15, K)
    assert ((sampled >= 0) & (sampled < tcfg.vocab_size)).all()


def test_serve_cli_runs_audio(capsys):
    """``launch.serve.main --arch musicgen-large --temperature 0.8``: the
    reduced config through the engine on (P, 4) prompts; a frame counts
    as one token."""
    tserve.main(["--device", "cpu", "--arch", ARCH, "--n-requests", "3",
                 "--rate", "1000", "--mean-prompt", "5", "--max-new", "3",
                 "--max-seq", "32", "--pages", "32", "--temperature", "0.8"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} on cpu: served 3 requests, 9 new tokens" in out


# ---------------------------------------------------------------------------
# training, int8 scales, checkpoints
# ---------------------------------------------------------------------------

def train_both(np_params, jcfg, tcfg, n, batches, micro_batch=None):
    """One DmSGD step a batch over the one-peer graph on ``n`` nodes
    through ``build_trainer`` (the drivers' trainer) on both packages,
    from the same node-stacked numpy params; ``batches`` are numpy dicts
    ({"tokens"} and, for vlm, {"image_embeds"}).  Returns the per-step
    (port, JAX) losses and both final states."""
    stacked = _stacked_np(np_params, n)
    jtop = JT.get_topology("one_peer_exp", n)
    ttop = TT.get_topology("one_peer_exp", n)
    jopt, jstep_for = JTrain.build_trainer(jcfg, jtop, "dmsgd", 0.9,
                                           micro_batch)
    topt, tstep_for = TTrain.build_trainer(tcfg, ttop, "dmsgd", 0.9,
                                           micro_batch)
    jx = jax.tree.map(jnp.asarray, stacked)
    tx = stacked_from_jax(stacked, tcfg)
    js, ts = jopt.init(jx), topt.init(tx)
    losses = []
    for step, batch in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        jx, js, jl = jstep_for(step)(jx, js, jb, 0.05)
        tx, ts, tl = tstep_for(step)(tx, ts, tb, 0.05)
        losses.append((float(tl), float(jl)))
    return losses, (jx, js, jstep_for.plan), (tx, ts, tstep_for.plan)


def test_dmsgd_step_matches_jax(weights):
    """One DmSGD step on 4 nodes, f32, from the training driver's (n, B,
    S, K) codebook batch: loss, params, momentum and consensus."""
    jcfg, tcfg = _cfgs()
    n = 4
    data = JSyntheticLM(jcfg.vocab_size, n, hetero=0.5, seed=0)
    batch = {"tokens": data.sample(0, 2, 16, K)}
    assert batch["tokens"].shape == (n, 2, 16, K)
    losses, (jx, js, jplan), (tx, ts, tplan) = train_both(
        weights, jcfg, tcfg, n, [batch])
    (got, want), = losses
    np.testing.assert_allclose(got, want, **TOL32)
    _check_state(tcfg, TOL32, tx, ts, jx, js)
    assert tplan.num_compiled == jplan.num_compiled == 1


@pytest.fixture
def one_thread():
    """One torch thread (under the test runner's parallel workers the
    default oversubscribes the cores; see test_torch_train_families.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_driver_trains_audio_on_cpu(one_thread):
    """The driver on the CPU draws the reference's (n, B, S, K) batches
    (its numpy pipeline, bit for bit); the loss falls and consensus stays
    finite."""
    argv = ["--arch", ARCH, "--device", "cpu", "--nodes", "4", "--steps",
            "12", "--batch", "4", "--seq", "16", "--warmup", "2", "--lr",
            "0.3", "--log-every", "1"]
    args = TTrain.parse_args(argv)
    first = TTrain.prepare(args)["batches"][3]["tokens"].numpy()
    np.testing.assert_array_equal(first, JSyntheticLM(
        512, 4, seed=0).sample(3, 4, 16, K))
    out = TTrain.run(args)
    losses = [h["loss"] for h in out["history"]]
    assert out["config"].family == "audio" and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.05
    assert all(np.isfinite(h["consensus"]) for h in out["history"])


def test_int8_scale_groups_of_audio_leaves():
    """The (K, V, d) embed and (K, d, V) heads are one scale group each,
    and ``layers.<i>.<rest>`` joins ``layers.<rest>``: one scale per
    (node, JAX leaf), the reference's bit for bit."""
    _int8_scales(ARCH)


@pytest.mark.parametrize("slots,mom_dtype", [("one", jnp.float32),
                                             ("mu_nu", jnp.bfloat16)])
def test_audio_checkpoints_cross_read(tmp_path, slots, mom_dtype):
    _port_ckpt_in_jax(tmp_path / "port", ARCH, slots, mom_dtype)
    _jax_ckpt_in_port(tmp_path / "jax", ARCH, slots, mom_dtype)
