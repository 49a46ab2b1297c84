"""PyTorch port parity: the Mamba-2 block and the ssm family (reduced
mamba2-1.3b) against the JAX package, with the JAX weights carried across
by ``params_from_jax`` and the inputs made with numpy.  The JAX SSD-scan
kernel runs in interpret mode (``attention_impl="pallas"``), as its own
tests run it on the CPU; the port's wrapper takes the naive recurrence
there.  Tolerances: float32 2e-4 and bfloat16 2e-2, as
tests/test_kernels.py:15-16; the whole model in bfloat16 is held to 2e-2
of the logits' max-abs (``_close_model``), as chip_smoke.py holds the card
against the CPU: the two frameworks' matmuls sum in different orders, which
flips some of each layer's bfloat16 roundings by one ulp, and small
logits then differ by more than 2e-2 of themselves."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import mamba2 as jm2
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax, stacked_from_jax, \
    stacked_to_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import mamba2 as tm2
from repro_torch.models import model as TM

TOL = dict(rtol=2e-2, atol=2e-2)
TOL32 = dict(rtol=2e-4, atol=2e-4)
ACT = {"f32": (jnp.float32, torch.float32, TOL32),
       "bf16": (jnp.bfloat16, torch.bfloat16, TOL)}
# the block at reduced widths: d_model 64, d_inner 128, 4 heads of 32,
# d_state 16, 2 groups
BLOCK = dict(d_state=16, head_dim=32, expand=2, d_conv=4, n_groups=2)
D_MODEL = 64


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_model(got, want, act):
    """Model-level logits: f32 2e-4; bf16 2e-2 (rtol) and 2e-2 of the
    reference's max-abs (atol)."""
    got, want = _f32(got), _f32(want)
    if act == "f32":
        np.testing.assert_allclose(got, want, **TOL32)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2,
                                   atol=2e-2 * float(np.abs(want).max()))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _block_pair():
    """JAX mamba2 params (random A_log, D and dt_bias too, so each leaf
    matters) and the port's module holding the same values."""
    jp = jm2.mamba2_init(jax.random.key(3), D_MODEL, **BLOCK)
    rng = np.random.default_rng(4)
    h = 2 * D_MODEL // BLOCK["head_dim"]
    jp["A_log"] = jnp.asarray(rng.uniform(0.0, 2.8, h), jnp.float32)
    jp["D"] = jnp.asarray(rng.standard_normal(h), jnp.float32)
    jp["dt_bias"] = jnp.asarray(0.5 * rng.standard_normal(h), jnp.float32)
    jp["conv_b"] = jnp.asarray(0.1 * rng.standard_normal(
        jp["conv_b"].shape), jnp.float32)
    jp["norm"]["scale"] = jnp.asarray(0.1 * rng.standard_normal(
        jp["norm"]["scale"].shape), jnp.float32)
    mod = tm2.Mamba2(D_MODEL, **BLOCK)
    mod.load_state_dict({k: torch.from_numpy(np.asarray(v).copy())
                         for k, v in _flat(jp)})
    return jp, mod


@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("history", [False, True])
def test_causal_conv_matches_jax(act, history):
    jdt, tdt, tol = ACT[act]
    rng = np.random.default_rng(1)
    xbc = rng.standard_normal((2, 9, 40)).astype(np.float32)
    w = (0.5 * rng.standard_normal((4, 40))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(40)).astype(np.float32)
    hist = rng.standard_normal((2, 3, 40)).astype(np.float32)
    got = tm2._causal_conv(torch.from_numpy(xbc).to(tdt),
                           torch.from_numpy(w).to(tdt),
                           torch.from_numpy(bias).to(tdt),
                           torch.from_numpy(hist) if history else None)
    want = jm2._causal_conv(jnp.asarray(xbc, jdt), jnp.asarray(w, jdt),
                            jnp.asarray(bias, jdt),
                            jnp.asarray(hist) if history else None)
    assert got.dtype == tdt and got.shape == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["pallas", "jnp"])
def test_mamba2_apply_matches_jax(impl, act):
    jdt, tdt, tol = ACT[act]
    jp, mod = _block_pair()
    x = np.random.default_rng(2).standard_normal(
        (2, 32, D_MODEL)).astype(np.float32)
    want = jm2.mamba2_apply(jp, jnp.asarray(x, jdt), chunk=8, impl=impl,
                            **BLOCK)
    with torch.no_grad():
        got = tm2.mamba2_apply(mod, torch.from_numpy(x).to(tdt), chunk=8,
                               impl=impl, **BLOCK)
    assert got.dtype == tdt and got.shape == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_mamba2_decode_matches_jax(act):
    jdt, tdt, tol = ACT[act]
    jp, mod = _block_pair()
    d_inner = 2 * D_MODEL
    conv_dim = d_inner + 2 * BLOCK["n_groups"] * BLOCK["d_state"]
    h = d_inner // BLOCK["head_dim"]
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((2, 6, 1, D_MODEL)).astype(np.float32)
    jc = jm2.init_ssm_cache(2, 4, conv_dim, h, BLOCK["head_dim"],
                            BLOCK["d_state"], jnp.float32)
    tc = tm2.init_ssm_cache(2, 4, conv_dim, h, BLOCK["head_dim"],
                            BLOCK["d_state"], torch.float32)
    for t in range(6):
        jo, jc = jm2.mamba2_decode(jp, jnp.asarray(xs[:, t], jdt), jc,
                                   **BLOCK)
        with torch.no_grad():
            to, tc = tm2.mamba2_decode(mod, torch.from_numpy(xs[:, t]).to(tdt),
                                       tc, **BLOCK)
        assert to.dtype == tdt
        np.testing.assert_allclose(_f32(to), _f32(jo), **tol)
        np.testing.assert_allclose(_f32(tc.conv), _f32(jc.conv), **tol)
        np.testing.assert_allclose(_f32(tc.state), _f32(jc.state), **tol)


# ---------------------------------------------------------------------------
# the ssm family: reduced mamba2-1.3b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_setup():
    cfg = jconfigs.reduced_config(jconfigs.get_config("mamba2-1.3b"))
    params = JM.init(cfg, jax.random.key(0))
    return cfg, params, jax.tree.map(np.asarray, params)


def _pair(jax_setup, act, impl="jnp"):
    jcfg, jparams, np_params = jax_setup
    jdt, tdt, tol = ACT[act]
    jcfg = dataclasses.replace(jcfg, attention_impl=impl,
                               activation_dtype=jdt)
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config("mamba2-1.3b")),
        attention_impl=impl, activation_dtype=tdt)
    model = TM.Model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg))
    return jcfg, jparams, tcfg, model, tol


def test_param_names_shapes_and_init_values_match_jax(jax_setup):
    jcfg, _, np_params = jax_setup
    tcfg = tconfigs.reduced_config(tconfigs.get_config("mamba2-1.3b"))
    assert tcfg.is_attention_free and jcfg.is_attention_free
    sd = params_from_jax(np_params, tcfg)
    model = TM.init(tcfg, 0, device="cpu")
    named = dict(model.named_parameters())
    assert {n: tuple(p.shape) for n, p in named.items()} == \
        {n: tuple(t.shape) for n, t in sd.items()}
    assert "lm_head" not in named                      # tied embeddings
    assert {n: p.dtype for n, p in named.items()} == \
        {n: t.dtype for n, t in sd.items()}
    for i in range(tcfg.n_layers):
        for leaf in ("A_log", "dt_bias", "D", "conv_b"):
            name = f"layers.{i}.mixer.{leaf}"
            np.testing.assert_allclose(named[name].detach().numpy(),
                                       sd[name].numpy(), rtol=1e-6, atol=0)
        for name in (f"layers.{i}.ln.scale", f"layers.{i}.mixer.norm.scale"):
            assert not named[name].detach().any()
        # conv_w: truncated normal at d_conv^-0.5, as the reference's
        w = named[f"layers.{i}.mixer.conv_w"].detach()
        assert float(w.abs().max()) <= 2 * tcfg.d_conv ** -0.5
        assert 0.3 < float(w.std()) / tcfg.d_conv ** -0.5 < 1.2
    again = TM.init(tcfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))


def test_params_and_stacked_round_trip(jax_setup):
    _, _, np_params = jax_setup
    tcfg = tconfigs.reduced_config(tconfigs.get_config("mamba2-1.3b"))
    sd = params_from_jax(np_params, tcfg)
    np.testing.assert_array_equal(
        sd["layers.1.mixer.in_proj"].numpy(),
        np_params["layers"]["mixer"]["in_proj"][1])
    np.testing.assert_array_equal(
        sd["layers.0.ln.scale"].numpy(), np_params["layers"]["ln"]["scale"][0])
    stacked_np = jax.tree.map(lambda a: np.stack([a, a + 1.0]), np_params)
    stacked = stacked_from_jax(stacked_np, tcfg)
    assert set(stacked) == set(sd)
    back = stacked_to_jax(stacked, tcfg)
    for (k1, a), (k2, b) in zip(sorted(_flat(back)),
                                sorted(_flat(stacked_np))):
        assert k1 == k2
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["pallas", "jnp"])
def test_forward_matches_jax(jax_setup, impl, act):
    jcfg, jparams, tcfg, model, _ = _pair(jax_setup, act, impl)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    jl, jaux = JM.forward(jparams, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        tl, taux = TM.forward(model, tcfg, torch.from_numpy(tokens))
    assert tl.shape == jl.shape and tl.dtype == tcfg.activation_dtype
    assert float(taux) == float(jaux) == 0.0
    _close_model(tl, jl, act)


def test_forward_backward_with_remat(jax_setup):
    """The train forward (plain chunked scan, remat on) has a gradient for
    every parameter, and remat does not change it."""
    _, _, tcfg, model, _ = _pair(jax_setup, "f32")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 16)))
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        model.zero_grad()
        logits, _ = TM.forward(model, cfg, tokens)
        torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, cfg.vocab_size),
            tokens[:, 1:].reshape(-1)).backward()
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()}
    for name, g in grads[True].items():
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, grads[False][name], rtol=1e-5,
                                   atol=1e-7)
    assert float(grads[True]["layers.0.mixer.A_log"].abs().max()) > 0


@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_decode_step_matches_jax(jax_setup, act):
    jcfg, jparams, tcfg, model, tol = _pair(jax_setup, act)
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    jc = JM.init_cache(jcfg, batch=2, cache_len=16, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, batch=2, cache_len=16, dtype=torch.float32,
                       device="cpu")
    for t in range(tokens.shape[1]):
        jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(tokens[:, t:t + 1]),
                                jc, jnp.asarray(t, jnp.int32))
        with torch.no_grad():
            tl, tc = TM.decode_step(model, tcfg,
                                    torch.from_numpy(tokens[:, t:t + 1]), tc, t)
        assert tl.shape == jl.shape == (2, 1, jcfg.vocab_size)
        _close_model(tl, jl, act)
    np.testing.assert_allclose(_f32(tc["ssm"].state), _f32(jc["ssm"].state),
                               **tol)
    np.testing.assert_allclose(_f32(tc["ssm"].conv), _f32(jc["ssm"].conv),
                               **tol)


@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_decode_reproduces_forward(jax_setup, act):
    """Token-by-token decode reproduces the full-sequence forward logits
    (tests/test_arch_smoke.py:137-161, inside the port), through the
    kernel wrapper (impl "pallas") and the plain chunked scan."""
    _, _, tcfg, model, tol = _pair(jax_setup, act, "pallas")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 24)))
    with torch.no_grad():
        full, _ = TM.forward(model, tcfg, tokens)
        plain, _ = TM.forward(model, dataclasses.replace(
            tcfg, attention_impl="jnp"), tokens)
        cache = TM.init_cache(tcfg, batch=2, cache_len=24,
                              dtype=torch.float32, device="cpu")
        outs = []
        for t in range(tokens.shape[1]):
            lg, cache = TM.decode_step(model, tcfg, tokens[:, t:t + 1], cache,
                                       t)
            outs.append(lg)
    dec = torch.cat(outs, dim=1)
    np.testing.assert_allclose(_f32(dec), _f32(full), **tol)
    np.testing.assert_allclose(_f32(plain), _f32(full), **tol)


def _jax_decode_logits(jcfg, jparams, toks):
    """JAX decode_step logits (f32) after each token of ``toks``."""
    jc = JM.init_cache(jcfg, batch=toks.shape[0], cache_len=toks.shape[1],
                       dtype=jnp.float32)
    out = []
    for t in range(toks.shape[1]):
        lg, jc = JM.decode_step(jparams, jcfg, jnp.asarray(toks[:, t:t + 1]),
                                jc, jnp.asarray(t, jnp.int32))
        out.append(np.asarray(lg[:, 0], np.float32))
    return np.stack(out, 1)


def test_generate_follows_jax_generate(jax_setup):
    """JAX ``generate`` at temperature 0, then the port along its tokens:
    teacher-forced, the port's decode logits at every step agree with
    JAX's; and since this seed's top-2 logit gap exceeds 1e-3 at every
    sampled step (asserted, so the check cannot flake), the port's own
    greedy chain gives the same tokens."""
    jcfg, jparams, tcfg, model, tol = _pair(jax_setup, "f32")
    prompts = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    max_new = 8
    jtoks = np.array(jserve.generate(jcfg, jparams, jnp.asarray(prompts),
                                     max_new=max_new, cache_len=32,
                                     temperature=0.0, seed=0))
    assert jtoks.shape == (2, 6 + max_new)
    jlog = _jax_decode_logits(jcfg, jparams, jtoks)
    # teacher-forced: the port's decode along JAX's tokens
    cache = TM.init_cache(tcfg, batch=2, cache_len=32, dtype=torch.float32,
                          device="cpu")
    with torch.no_grad():
        for t in range(jtoks.shape[1]):
            lg, cache = TM.decode_step(
                model, tcfg, torch.from_numpy(jtoks[:, t:t + 1]), cache, t)
            np.testing.assert_allclose(lg[:, 0].numpy(), jlog[:, t], **tol)
    # the greedy chain
    sampled = jlog[:, 5:5 + max_new]                  # logits of each pick
    top2 = np.sort(sampled, -1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0] > 1e-3).all()
    np.testing.assert_array_equal(sampled.argmax(-1), jtoks[:, 6:])
    got = tserve.generate(tcfg, model, torch.from_numpy(prompts),
                          max_new=max_new, cache_len=32, temperature=0.0,
                          seed=0, device="cpu")
    np.testing.assert_array_equal(got.numpy(), jtoks)


def test_generate_samples_with_a_seeded_generator(jax_setup):
    _, _, tcfg, model, _ = _pair(jax_setup, "bf16")
    prompts = torch.zeros((3, 4), dtype=torch.long)
    a = tserve.generate(tcfg, model, prompts, max_new=5, temperature=1.0,
                        seed=7, device="cpu")
    b = tserve.generate(tcfg, model, prompts, max_new=5, temperature=1.0,
                        seed=7, device="cpu")
    assert a.shape == (3, 9) and torch.equal(a, b)
    assert torch.equal(a[:, :4], prompts)
    assert ((0 <= a) & (a < tcfg.vocab_size)).all()


def test_sample_tokens_shapes():
    g = torch.Generator().manual_seed(0)
    lg = torch.randn(3, 2, 11)                         # audio: (B, K, V)
    assert tserve.sample_tokens(lg, 0.0).shape == (3, 1, 2)
    assert tserve.sample_tokens(lg, 0.7, g).shape == (3, 1, 2)
    lg = torch.randn(4, 11)
    assert torch.equal(tserve.sample_tokens(lg, 0.0)[:, 0], lg.argmax(-1))


def test_serving_entry_points_refuse_ssm_and_dense_decode_raises():
    """The refusals that remain: the paged serving entry points refuse the
    ssm and hybrid families (served by generate).  Every family now builds
    a ring cache and decodes: the dense and moe ring-cache decodes
    (tests/test_torch_generate.py, tests/test_torch_moe.py) and, since
    the audio and vlm families were ported, musicgen's (B, 1, K) frames
    and llama-3.2-vision's step over its images, which this test once saw
    refused (tests/test_torch_audio.py, tests/test_torch_vlm.py)."""
    tok = torch.zeros((1, 4), dtype=torch.long)
    from repro_torch.serve import ServeEngine
    for arch in ("mamba2-1.3b", "zamba2-1.2b"):
        cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
        model = TM.init(cfg, 0, device="cpu")
        with pytest.raises(NotImplementedError, match="paged"):
            TM.forward_prefill(model, cfg, tok)
        with pytest.raises(NotImplementedError, match="paged"):
            ServeEngine(cfg, model, n_pages=8, device="cpu")
    for arch in ("musicgen-large", "llama-3.2-vision-90b"):
        cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
        model = TM.init(cfg, 0, device="cpu")
        cache = TM.init_cache(cfg, batch=1, cache_len=8, device="cpu")
        audio = cfg.family == "audio"
        token = tok[:, :1, None].expand(1, 1, cfg.n_codebooks) if audio \
            else tok[:, :1]
        img = None if audio else torch.zeros(1, cfg.n_image_tokens,
                                             cfg.d_model)
        with torch.no_grad():
            logits, cache = TM.decode_step(model, cfg, token, cache, 0,
                                           image_embeds=img)
        want = (1, 1) + ((cfg.n_codebooks,) if audio else ()) + (
            cfg.vocab_size,)
        assert tuple(logits.shape) == want
        assert torch.isfinite(logits.float()).all()
        assert float(cache["kv"].k.abs().max()) > 0
    for arch in ("qwen3-0.6b", "granite-moe-3b-a800m"):
        dense = tconfigs.reduced_config(tconfigs.get_config(arch))
        cache = TM.init_cache(dense, batch=1, cache_len=8, device="cpu")
        assert tuple(cache["kv"].k.shape) == (
            dense.n_layers, 1, dense.n_kv_heads, 8, dense.head_dim)
