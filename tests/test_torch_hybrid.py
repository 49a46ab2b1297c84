"""PyTorch port parity: the hybrid family (reduced zamba2-1.2b: 7 mamba
layers, the shared attention + MLP block after each group of 3, so twice,
then one tail layer; 4 heads of 64 with 4 kv heads, G = 1) against the
JAX package, with the JAX weights carried across by ``params_from_jax``
and the inputs made with numpy.  The JAX kernels run in interpret mode
(``attention_impl="pallas"``), as their own tests run them on the CPU; the
port's wrappers take their plain versions there.  Tolerances: float32
2e-4 as tests/test_kernels.py:15-16; the whole model in bfloat16 2e-2 of
the logits' max-abs, as tests/test_torch_mamba2.py holds the ssm family
(the two frameworks' matmuls round differently in bfloat16).

In bfloat16 the port is held to the JAX functions run op by op
(``jax.disable_jit()``), which round every bfloat16 op as the port's eager
ops do.  Compiled, XLA fuses the elementwise ops of a layer and keeps
their intermediates in f32, and at this depth the reference's own
compiled and op-by-op forwards part by 2.1-2.6 % of the logits' max-abs
(the port and the op-by-op reference by 1.3-1.4 %; measured on reduced
zamba2 at seed 0, both impls) -- beyond the 2e-2 this family is held to,
so against the compiled reference the bfloat16 check would measure XLA's
fusion, not the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax, stacked_from_jax, \
    stacked_to_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM

TOL32 = dict(rtol=2e-4, atol=2e-4)
ACT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_model(got, want, act):
    got, want = _f32(got), _f32(want)
    if act == "f32":
        np.testing.assert_allclose(got, want, **TOL32)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2,
                                   atol=2e-2 * float(np.abs(want).max()))


def _jax_run(act, fn, *args, **kw):
    """``fn`` as compiled (f32) or op by op (bf16; module docstring)."""
    if act == "bf16":
        with jax.disable_jit():
            return fn(*args, **kw)
    return fn(*args, **kw)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def jax_setup():
    """Reduced zamba2 with non-zero norm scales everywhere (the init's are
    zero), so that a scale read from the wrong leaf shows."""
    cfg = jconfigs.reduced_config(jconfigs.get_config("zamba2-1.2b"))
    params = JM.init(cfg, jax.random.key(0))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(0.2 * rng.standard_normal(a.shape),
                                        a.dtype)
        if getattr(path[-1], "key", None) == "scale" else a, params)
    return cfg, params, jax.tree.map(np.asarray, params)


def _tcfg(**kw):
    return dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config("zamba2-1.2b")), **kw)


def _pair(jax_setup, act, impl="jnp"):
    jcfg, jparams, np_params = jax_setup
    jdt, tdt = ACT[act]
    jcfg = dataclasses.replace(jcfg, attention_impl=impl,
                               activation_dtype=jdt)
    tcfg = _tcfg(attention_impl=impl, activation_dtype=tdt)
    model = TM.Model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg))
    return jcfg, jparams, tcfg, model


def test_reduced_config_shape():
    cfg = _tcfg()
    assert cfg.family == "hybrid" and cfg.n_layers == 7
    assert cfg.shared_attn_every == 3 and cfg.n_heads == cfg.n_kv_heads
    assert cfg.head_dim == 64 and not cfg.is_attention_free


def test_param_names_shapes_and_init_values_match_jax(jax_setup):
    _, _, np_params = jax_setup
    tcfg = _tcfg()
    sd = params_from_jax(np_params, tcfg)
    model = TM.init(tcfg, 0, device="cpu")
    named = dict(model.named_parameters())
    assert {n: tuple(p.shape) for n, p in named.items()} == \
        {n: tuple(t.shape) for n, t in sd.items()}
    assert {n: p.dtype for n, p in named.items()} == \
        {n: t.dtype for n, t in sd.items()}
    assert "lm_head" not in named                      # tied embeddings
    assert sum(n.startswith("shared_attn.") for n in named) == 10
    assert named["shared_attn.in_proj"].shape == (2 * tcfg.d_model,
                                                  tcfg.d_model)
    # truncated normals on [-2, 2] at fan_in^-0.5 (in_proj: fan_in 2
    # d_model), as the reference's: std 0.88 of the scale, as JAX's init
    jinit = JM.init(jconfigs.reduced_config(jconfigs.get_config(
        "zamba2-1.2b")), jax.random.key(0))["shared_attn"]
    for name, fan_in, jleaf in (
            ("shared_attn.in_proj", 2 * tcfg.d_model, jinit["in_proj"]),
            ("shared_attn.attn.wq", tcfg.d_model, jinit["attn"]["wq"]),
            ("shared_attn.mlp.w_down", tcfg.d_ff, jinit["mlp"]["w_down"])):
        w = named[name].detach()
        assert float(w.abs().max()) <= 2 * fan_in ** -0.5
        ratio = float(w.std()) / fan_in ** -0.5
        jratio = float(np.std(np.asarray(jleaf))) / fan_in ** -0.5
        assert abs(ratio - jratio) < 0.03, (name, ratio, jratio)
    for name in ("shared_attn.ln1.scale", "shared_attn.ln2.scale",
                 "layers.6.ln.scale"):
        assert not named[name].detach().any()
    for i in range(tcfg.n_layers):
        np.testing.assert_allclose(
            named[f"layers.{i}.mixer.A_log"].detach().numpy(),
            sd[f"layers.{i}.mixer.A_log"].numpy(), rtol=1e-6, atol=0)
    again = TM.init(tcfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))


def test_params_and_stacked_round_trip(jax_setup):
    _, _, np_params = jax_setup
    tcfg = _tcfg()
    sd = params_from_jax(np_params, tcfg)
    np.testing.assert_array_equal(sd["shared_attn.in_proj"].numpy(),
                                  np_params["shared_attn"]["in_proj"])
    np.testing.assert_array_equal(sd["shared_attn.attn.wo"].numpy(),
                                  np_params["shared_attn"]["attn"]["wo"])
    np.testing.assert_array_equal(
        sd["layers.6.mixer.out_proj"].numpy(),
        np_params["layers"]["mixer"]["out_proj"][6])
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
    jcfg, jparams, tcfg, model = _pair(jax_setup, act, impl)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    jl, jaux = _jax_run(act, JM.forward, jparams, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        tl, taux = TM.forward(model, tcfg, torch.from_numpy(tokens))
    assert tl.shape == jl.shape and tl.dtype == tcfg.activation_dtype
    assert float(taux) == float(jaux) == 0.0
    _close_model(tl, jl, act)


def test_forward_shared_block_matters(jax_setup):
    """The shared block feeds the stream: zeroing its in_proj changes the
    logits, and the embedding joins unscaled (hybrid is not in the
    sqrt(d_model) list)."""
    _, _, tcfg, model = _pair(jax_setup, "f32")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (1, 16)))
    with torch.no_grad():
        base, _ = TM.forward(model, tcfg, tokens)
        x = TM._embed_tokens(model, tcfg, tokens)
        torch.testing.assert_close(x, model.embed[tokens], rtol=0, atol=0)
        saved = model.shared_attn.in_proj.clone()
        model.shared_attn.in_proj.zero_()
        cut, _ = TM.forward(model, tcfg, tokens)
        model.shared_attn.in_proj.copy_(saved)
    assert float((base - cut).abs().max()) > 1e-2


def test_forward_backward_with_remat_matches_jax_grad(jax_setup):
    """The train forward (plain attention and chunked scan, remat on the
    mamba layers): the port's gradient of the next-token cross-entropy
    against ``jax.grad`` of the same loss, leaf by leaf, at 2e-4 of each
    leaf's max-abs; and remat does not change the port's gradient."""
    jcfg, jparams, tcfg, model = _pair(jax_setup, "f32")
    jcfg = dataclasses.replace(jcfg, remat=True)
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32)

    def jloss(p):
        lg, _ = JM.forward(p, jcfg, jnp.asarray(tokens))
        lp = jax.nn.log_softmax(lg[:, :-1].astype(jnp.float32), -1)
        tgt = jnp.asarray(tokens[:, 1:])
        return -jnp.take_along_axis(lp, tgt[..., None], -1).mean()

    jgrads = params_from_jax(jax.tree.map(np.asarray, jax.grad(jloss)(
        jparams)), tcfg)
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        model.zero_grad()
        logits, _ = TM.forward(model, cfg, torch.from_numpy(tokens).long())
        torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, cfg.vocab_size),
            torch.from_numpy(tokens[:, 1:]).long().reshape(-1)).backward()
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert set(grads[True]) == set(jgrads)
    for name, g in grads[True].items():
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, grads[False][name], rtol=1e-5,
                                   atol=1e-7)
        want = jgrads[name].numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-4,
                                   atol=2e-4 * float(np.abs(want).max()),
                                   err_msg=name)
    for name in ("shared_attn.in_proj", "shared_attn.attn.wk",
                 "layers.6.mixer.A_log"):
        assert float(grads[True][name].abs().max()) > 0, name


@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_init_cache_and_decode_step_match_jax(jax_setup, act):
    jcfg, jparams, tcfg, model = _pair(jax_setup, act)
    cache_len = 6                      # the rings wrap after 6 tokens
    jc = JM.init_cache(jcfg, batch=2, cache_len=cache_len,
                       dtype=jnp.float32)
    tc = TM.init_cache(tcfg, batch=2, cache_len=cache_len,
                       dtype=torch.float32, device="cpu")
    assert set(tc) == set(jc) == {"ssm", "shared_kv"}
    for name in ("k", "v"):
        assert tuple(getattr(tc["shared_kv"], name).shape) == \
            getattr(jc["shared_kv"], name).shape == (2, 2, 4, cache_len, 64)
    for name in ("conv", "state"):
        assert tuple(getattr(tc["ssm"], name).shape) == \
            getattr(jc["ssm"], name).shape
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    for t in range(tokens.shape[1]):
        jl, jc = _jax_run(act, JM.decode_step, jparams, jcfg,
                          jnp.asarray(tokens[:, t:t + 1]), jc,
                          jnp.asarray(t, jnp.int32))
        with torch.no_grad():
            tl, tc = TM.decode_step(model, tcfg,
                                    torch.from_numpy(tokens[:, t:t + 1]), tc, t)
        assert tl.shape == jl.shape == (2, 1, jcfg.vocab_size)
        _close_model(tl, jl, act)
    for got, want in ((tc["ssm"].state, jc["ssm"].state),
                      (tc["ssm"].conv, jc["ssm"].conv),
                      (tc["shared_kv"].k, jc["shared_kv"].k),
                      (tc["shared_kv"].v, jc["shared_kv"].v)):
        _close_model(got, want, act)


@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_decode_reproduces_forward(jax_setup, act):
    """Token-by-token decode reproduces the full-sequence forward logits,
    through the kernel wrappers ("pallas") and the plain path; each
    application of the shared block reads its own ring (a ring indexed by
    layer would part from the forward after the first group)."""
    _, _, tcfg, model = _pair(jax_setup, act, "pallas")
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
    _close_model(dec, full, act)
    _close_model(plain, full, act)
    # both rings were written, and they differ (two applications)
    k = cache["shared_kv"].k
    assert k[0].abs().max() > 0 and k[1].abs().max() > 0
    assert not torch.allclose(k[0], k[1])


def _jax_decode_logits(jcfg, jparams, toks, cache_len):
    jc = JM.init_cache(jcfg, batch=toks.shape[0], cache_len=cache_len,
                       dtype=jnp.float32)
    out = []
    for t in range(toks.shape[1]):
        lg, jc = JM.decode_step(jparams, jcfg, jnp.asarray(toks[:, t:t + 1]),
                                jc, jnp.asarray(t, jnp.int32))
        out.append(np.asarray(lg[:, 0], np.float32))
    return np.stack(out, 1)


def test_generate_follows_jax_generate(jax_setup):
    """JAX ``generate`` at temperature 0 (its hybrid prefill loops token by
    token), then the port: teacher-forced decode logits agree at every
    step; the top-2 gap of every sampled step exceeds 1e-3 (asserted, so
    the greedy chains cannot part on a near-tie) and the port's own
    greedy chain gives the same tokens.  cache_len 12 < 6 + 8 tokens, so
    the shared block's rings wrap."""
    jcfg, jparams, tcfg, model = _pair(jax_setup, "f32")
    prompts = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    max_new, cache_len = 8, 12
    jtoks = np.array(jserve.generate(jcfg, jparams, jnp.asarray(prompts),
                                     max_new=max_new, cache_len=cache_len,
                                     temperature=0.0, seed=0))
    assert jtoks.shape == (2, 6 + max_new)
    jlog = _jax_decode_logits(jcfg, jparams, jtoks, cache_len)
    cache = TM.init_cache(tcfg, batch=2, cache_len=cache_len,
                          dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for t in range(jtoks.shape[1]):
            lg, cache = TM.decode_step(
                model, tcfg, torch.from_numpy(jtoks[:, t:t + 1]), cache, t)
            np.testing.assert_allclose(lg[:, 0].numpy(), jlog[:, t], **TOL32)
    sampled = jlog[:, 5:5 + max_new]                  # logits of each pick
    top2 = np.sort(sampled, -1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0] > 1e-3).all()
    np.testing.assert_array_equal(sampled.argmax(-1), jtoks[:, 6:])
    got = tserve.generate(tcfg, model, torch.from_numpy(prompts),
                          max_new=max_new, cache_len=cache_len,
                          temperature=0.0, seed=0, device="cpu")
    np.testing.assert_array_equal(got.numpy(), jtoks)
