"""PyTorch port parity: the dense family's legacy ``generate`` -- a fast
prefill (one ``forward_prefill`` whose k/v fill a ring cache,
``_ring_fill``) or the token-by-token loop, then ``decode_step`` over the
ring (``attn_decode``) -- against the JAX package's, on reduced qwen3 and
reduced gemma2 (its local/global layers, with the window cut to 8 on both
sides so that it bites, attention and final softcaps).  JAX weights are
carried across by ``params_from_jax``; inputs are made with numpy; f32
activations (a bf16 near-tie could flip an argmax) at 2e-4, as
tests/test_kernels.py:15-16."""
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
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM

TOL32 = dict(rtol=2e-4, atol=2e-4)
WINDOW = 8                     # gemma2's local window, cut to bite here


def _cfgs(arch):
    upd = dict(activation_dtype=jnp.float32)
    if arch == "gemma2-27b":
        upd["sliding_window"] = WINDOW
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config(arch)), **upd)
    upd["activation_dtype"] = torch.float32
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config(arch)), **upd)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=["qwen3-0.6b", "gemma2-27b",
                                        "granite-moe-3b-a800m"])
def pair(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = JM.init(jcfg, jax.random.key(0))
    model = TM.Model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          tcfg))
    return jcfg, jparams, tcfg, model


@pytest.mark.parametrize("S,cache_len", [(5, 8), (8, 8), (13, 8), (21, 4)])
def test_ring_fill_matches_jax(S, cache_len):
    """For S < cache_len the slots past the prompt stay zero; for S >
    cache_len only the last cache_len tokens survive, at slot t(s)."""
    rng = np.random.default_rng(S)
    k, v = (rng.standard_normal((3, 2, S, 2, 16)).astype(np.float32)
            for _ in range(2))
    got = tserve._ring_fill(torch.from_numpy(k), torch.from_numpy(v),
                            cache_len, torch.float32)
    want = jserve._ring_fill(jnp.asarray(k), jnp.asarray(v), cache_len,
                             jnp.float32)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (3, 2, 2, cache_len, 16)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # slot s holds token t(s) = (S-1) - mod(S-1-s, cache_len)
    s = np.arange(cache_len)
    t = (S - 1) - np.mod(S - 1 - s, cache_len)
    np.testing.assert_array_equal(got.k.numpy()[:, :, :, s[t >= 0]],
                                  k.transpose(0, 1, 3, 2, 4)[:, :, :,
                                                             t[t >= 0]])


def test_init_cache_matches_jax(pair):
    jcfg, _, tcfg, _ = pair
    jc = JM.init_cache(jcfg, batch=3, cache_len=10, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, batch=3, cache_len=10, dtype=torch.float32,
                       device="cpu")
    assert set(tc) == set(jc) == {"kv"}
    assert tuple(tc["kv"].k.shape) == jc["kv"].k.shape == \
        (tcfg.n_layers, 3, tcfg.n_kv_heads, 10, tcfg.head_dim)
    assert not tc["kv"].k.any() and tc["kv"].v.dtype == torch.float32


def test_fast_prefill_equals_loop(pair):
    """One forward_prefill ring-filled against the prompt fed token by
    token through decode_step: last-token logits and every cache slot."""
    _, _, tcfg, model = pair
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 12)))
    with torch.no_grad():
        fl, fc = tserve.prefill_cache(tcfg, model, prompts, cache_len=16)
        ll, lc = tserve.prefill_cache(tcfg, model, prompts, cache_len=16,
                                      mode="loop")
    assert fl.shape == ll.shape == (2, 1, tcfg.vocab_size)
    np.testing.assert_allclose(fl.numpy(), ll.numpy(), **TOL32)
    for a, b in ((fc["kv"].k, lc["kv"].k), (fc["kv"].v, lc["kv"].v)):
        assert a.dtype == b.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL32)
    with pytest.raises(ValueError, match="prefill mode"):
        tserve.prefill_cache(tcfg, model, prompts, mode="fast")


@pytest.mark.parametrize("cache_len", [32, 16])    # 16 < 12 + 8: wraps
def test_generate_follows_jax_generate(pair, cache_len):
    """JAX ``generate`` (its fast prefill) at temperature 0, then the port:
    teacher-forced, its ring decode logits agree with JAX's decode_step at
    every step; the top-2 gap of every sampled step exceeds 1e-3
    (asserted, so the chains cannot part on a near-tie); and the port's
    own greedy chain, with either prefill, gives JAX's tokens."""
    jcfg, jparams, tcfg, model = pair
    prompts = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    plen, max_new = prompts.shape[1], 8
    jtoks = np.array(jserve.generate(jcfg, jparams, jnp.asarray(prompts),
                                     max_new=max_new, cache_len=cache_len,
                                     temperature=0.0, seed=0))
    assert jtoks.shape == (2, plen + max_new)
    jc = JM.init_cache(jcfg, batch=2, cache_len=cache_len,
                       dtype=jnp.float32)
    tc = TM.init_cache(tcfg, batch=2, cache_len=cache_len,
                       dtype=torch.float32, device="cpu")
    jlog = []
    for t in range(jtoks.shape[1]):
        jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(jtoks[:, t:t + 1]),
                                jc, jnp.asarray(t, jnp.int32))
        with torch.no_grad():
            tl, tc = TM.decode_step(model, tcfg,
                                    torch.from_numpy(jtoks[:, t:t + 1]), tc, t)
        jlog.append(np.asarray(jl[:, 0]))
        np.testing.assert_allclose(tl[:, 0].numpy(), jlog[-1], **TOL32)
    np.testing.assert_allclose(tc["kv"].k.numpy(), np.asarray(jc["kv"].k),
                               **TOL32)
    sampled = np.stack(jlog, 1)[:, plen - 1:plen - 1 + max_new]
    top2 = np.sort(sampled, -1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0] > 1e-3).all()
    np.testing.assert_array_equal(sampled.argmax(-1), jtoks[:, plen:])
    for mode in ("auto", "loop"):
        got = tserve.generate(tcfg, model, torch.from_numpy(prompts),
                              max_new=max_new, cache_len=cache_len,
                              temperature=0.0, seed=0, prefill=mode,
                              device="cpu")
        np.testing.assert_array_equal(got.numpy(), jtoks, err_msg=mode)


def test_generate_samples_with_a_seeded_generator(pair):
    _, _, tcfg, model = pair
    prompts = torch.zeros((3, 4), dtype=torch.long)
    a, b = (tserve.generate(tcfg, model, prompts, max_new=5, temperature=1.0,
                            seed=7, device="cpu") for _ in range(2))
    assert a.shape == (3, 9) and torch.equal(a, b)
    assert torch.equal(a[:, :4], prompts)
    assert ((0 <= a) & (a < tcfg.vocab_size)).all()
