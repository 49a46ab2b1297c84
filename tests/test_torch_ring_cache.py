"""PyTorch port parity: the ring-buffer KV cache (``attn_decode``).

The three properties of tests/test_ring_cache.py, on the port: after the
decode of token ``idx`` slot ``s`` holds token ``t(s) = idx - mod(idx - s,
cache_len)``; a wrapped ring of size ``cl`` equals a full cache with a
window of ``cl``; a ring that never wraps equals an oversized one.  Then
``attn_decode`` token by token against the JAX one (qk-norm, a window,
softcap, a ring that wraps), with the JAX weights carried across and the
inputs made with numpy.  Tolerances: the properties 1e-5 (1e-6 where the
reference's are), f32 2e-4 and bf16 2e-2 as tests/test_kernels.py:15-16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.models import attention as TA
from tests._hypothesis_compat import given, settings, st

B, H, KV, HD, D = 2, 4, 2, 16, 32


def _module(jp, qk_norm=False):
    mod = TA.Attention(D, H, KV, HD, qk_norm)
    sd = {k: torch.from_numpy(np.asarray(v).copy())
          for k, v in jp.items() if not isinstance(v, dict)}
    for name in ("q_norm", "k_norm"):
        if name in jp:
            sd[f"{name}.scale"] = torch.from_numpy(
                np.asarray(jp[name]["scale"]).copy())
    mod.load_state_dict(sd)
    return mod


def _params(seed=0, qk_norm=False):
    jp = JA.attn_init(jax.random.key(seed), d_model=D, n_heads=H, n_kv=KV,
                      head_dim=HD, qk_norm=qk_norm)
    if qk_norm:                        # non-zero scales, so the norms matter
        rng = np.random.default_rng(seed)
        for name in ("q_norm", "k_norm"):
            jp[name] = {"scale": jnp.asarray(
                0.3 * rng.standard_normal(HD), jnp.float32)}
    return jp, _module(jp, qk_norm)


def _decode_seq(mod, xs, cache_len, window=None):
    """The port's decode of xs (B, N, d) token by token: per-step outputs
    and the final cache."""
    cache = TA.init_kv_cache(B, KV, cache_len, HD, torch.float32)
    ys = []
    with torch.no_grad():
        for t in range(xs.shape[1]):
            y, cache = TA.attn_decode(
                mod, torch.from_numpy(xs[:, t:t + 1]), cache, t,
                n_heads=H, n_kv=KV, head_dim=HD, window=window)
            ys.append(y)
    return torch.cat(ys, dim=1).float().numpy(), cache


def _xs(seed, n):
    return np.random.default_rng(seed).standard_normal(
        (B, n, D)).astype(np.float32)


@settings(max_examples=12, deadline=None)
@given(cl=st.integers(2, 9), n=st.integers(1, 24))
def test_ring_slot_invariant(cl, n):
    """Slot s of a ring cache == slot t(s) of a full cache (same tokens)."""
    _, mod = _params()
    xs = _xs(1, n)
    _, ring = _decode_seq(mod, xs, cache_len=cl)
    _, full = _decode_seq(mod, xs, cache_len=max(n, cl))
    idx = n - 1
    s = np.arange(cl)
    t = idx - np.mod(idx - s, cl)
    valid = t >= 0
    for a, b in ((ring.k, full.k), (ring.v, full.v)):
        np.testing.assert_allclose(a.numpy()[:, :, s[valid]],
                                   b.numpy()[:, :, t[valid]], rtol=1e-6,
                                   atol=1e-6)
        # slots no token reached yet stay zero
        assert not a.numpy()[:, :, s[~valid]].any()


@settings(max_examples=10, deadline=None)
@given(cl=st.integers(2, 8), n=st.integers(9, 20))
def test_wrapped_ring_equals_windowed_full_cache(cl, n):
    """A wrapped ring of size cl == a full cache with window=cl."""
    _, mod = _params()
    xs = _xs(2, n)
    y_ring, _ = _decode_seq(mod, xs, cache_len=cl)
    y_full, _ = _decode_seq(mod, xs, cache_len=n, window=cl)
    np.testing.assert_allclose(y_ring, y_full, rtol=1e-5, atol=1e-5)


def test_unwrapped_ring_equals_full_cache():
    """cache_len >= n: the ring never wraps and matches an oversized cache
    (every slot s holds token s)."""
    _, mod = _params()
    n = 7
    xs = _xs(3, n)
    y_a, cache = _decode_seq(mod, xs, cache_len=n)
    y_b, big = _decode_seq(mod, xs, cache_len=3 * n)
    np.testing.assert_allclose(y_a, y_b, rtol=1e-6, atol=1e-6)
    assert cache.k.shape[2] == n and torch.isfinite(cache.k).all()
    torch.testing.assert_close(cache.k, big.k[:, :, :n], rtol=0, atol=0)


@pytest.mark.parametrize("act,tol", [("f32", 2e-4), ("bf16", 2e-2)])
@pytest.mark.parametrize("cache_len,window,cap", [
    (16, None, None),         # never wraps
    (5, None, 30.0),          # wraps, softcap
    (16, 4, None),            # a window inside the ring
    (6, 4, 20.0),             # wraps, window and softcap
])
def test_attn_decode_matches_jax(cache_len, window, cap, act, tol):
    """The port's attn_decode, token by token with qk-norm, against the
    JAX attn_decode on the same weights and inputs: outputs and the
    cache's (rotated, normed) keys and values."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[act]
    jp, mod = _params(5, qk_norm=True)
    n = 11
    xs = _xs(4, n)
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, qk_norm=True, window=window,
              attn_cap=cap)
    jc = JA.init_kv_cache(B, KV, cache_len, HD, jnp.float32)
    tc = TA.init_kv_cache(B, KV, cache_len, HD, torch.float32)
    for t in range(n):
        jy, jc = JA.attn_decode(jp, jnp.asarray(xs[:, t:t + 1], jdt), jc,
                                jnp.asarray(t, jnp.int32), **kw)
        with torch.no_grad():
            ty, tc2 = TA.attn_decode(mod, torch.from_numpy(
                xs[:, t:t + 1]).to(tdt), tc, t, **kw)
        assert tc2 is tc and ty.dtype == tdt and ty.shape == jy.shape
        np.testing.assert_allclose(ty.float().numpy(),
                                   np.asarray(jy.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), rtol=tol,
                               atol=tol)


def test_init_kv_cache_stacks():
    c = TA.init_kv_cache(3, KV, 8, HD, torch.bfloat16, stack=(5,))
    assert c.k.shape == c.v.shape == (5, 3, KV, 8, HD)
    assert c.k.dtype == torch.bfloat16 and not c.k.any()
    j = JA.init_kv_cache(3, KV, 8, HD)
    assert c.k.shape[1:] == j.k.shape
