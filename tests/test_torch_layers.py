"""PyTorch port parity: shared layers (rms_norm, rope, softcap, swiglu MLP)
against the JAX package on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = dict(rtol=2e-2, atol=2e-2)
TOL32 = dict(rtol=2e-4, atol=2e-4)
DTYPES = {"f32": (jnp.float32, torch.float32, TOL32),
          "bf16": (jnp.bfloat16, torch.bfloat16, TOL)}


def _both(a, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a)).to(tdt)


def _close(got_t, want_j, dtype):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j.astype(jnp.float32)),
                               **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 4, 2, 128)])
def test_rms_norm(shape, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    scale = rng.standard_normal(shape[-1]).astype(np.float32) * 0.1
    xj, xt = _both(x, dtype)
    got = TL.rms_norm(torch.from_numpy(scale), xt, 1e-6)
    want = JL.rms_norm({"scale": jnp.asarray(scale)}, xj, 1e-6)
    assert got.dtype == xt.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope(theta, dtype):
    rng = np.random.default_rng(1)
    B, S, H, hd = 2, 7, 3, 64
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = rng.integers(0, 4000, (B, S)).astype(np.int32)
    xj, xt = _both(x, dtype)
    got = TL.rope(xt, torch.from_numpy(pos), theta)
    want = JL.rope(xj, jnp.asarray(pos), theta)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_softcap(cap, dtype):
    x = np.random.default_rng(2).standard_normal((4, 33)).astype(np.float32)
    xj, xt = _both(x * 40, dtype)
    _close(TL.softcap(xt, cap), JL.softcap(xj, cap), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["swiglu", "geglu"])
def test_mlp_apply(kind, dtype):
    rng = np.random.default_rng(3)
    d, f = 64, 96
    w = {n: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
         for n, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                      ("w_down", (f, d)))}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    mlp = TL.MLP(d, f)
    with torch.no_grad():
        for n, a in w.items():
            getattr(mlp, n).copy_(torch.from_numpy(a))
        xj, xt = _both(x, dtype)
        got = TL.mlp_apply(mlp, xt, kind)
    want = JL.mlp_apply({n: jnp.asarray(a) for n, a in w.items()}, xj, kind)
    _close(got, want, dtype)


def test_dense_init_truncated_normal():
    gen = torch.Generator().manual_seed(0)
    w = TL.dense_init(gen, (256, 512))
    scale = 256 ** -0.5
    assert w.shape == (256, 512) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 2 * scale
    # std of N(0,1) truncated to [-2, 2] is 0.8796
    assert abs(float(w.std()) / scale - 0.8796) < 0.02
    again = TL.dense_init(torch.Generator().manual_seed(0), (256, 512))
    assert torch.equal(w, again)
    bf = TL.dense_init(torch.Generator().manual_seed(0), (8,), scale=1.0,
                       dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
