"""PyTorch port: K1 gossip_mix.  On the CPU the wrapper takes the plain
version, held here against the JAX Pallas kernel in interpret mode over
the sweep of tests/test_kernels.py (shapes, degrees 1 and 3, f32 and
bf16).  Tolerances: f32 1e-5 (tests/test_kernels.py:189; the two sides
round the products differently, ~1e-7 apart); bf16 2e-2
(tests/test_kernels.py:15, one bf16 rounding of the f32 sum)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gossip_mix import ops as jgm_ops
from repro_torch.kernels.gossip_mix import kernel as tgm_kernel
from repro_torch.kernels.gossip_mix import ops as tgm_ops
from repro_torch.kernels.gossip_mix import ref as tgm_ref

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}


def _inputs(shape, degree, act, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for _ in range(degree + 1)]
    jdt, tdt = DT[act]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 1024), (3, 5, 7), (1000,), (17,),
                                   (128, 4096)])
@pytest.mark.parametrize("degree", [1, 3])
def test_gossip_mix_matches_jax(shape, degree, act):
    (jx, *jr), (tx, *tr) = _inputs(shape, degree, act, sum(shape) + degree)
    w_self = 1.0 / (degree + 1)
    ws = tuple([w_self] * degree)
    n0 = tgm_ops.gossip_mix.launches
    got = tgm_ops.gossip_mix(tx, tr, w_self=w_self, ws=ws)
    assert tgm_ops.gossip_mix.launches == n0       # the CPU runs no kernel
    want = jgm_ops.gossip_mix(jx, jr, w_self=w_self, ws=ws, interpret=True)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[act])


@pytest.mark.parametrize("n,degree", [(1, 1), (4097, 2), (5000, 4),
                                      (33, 3)])
def test_gossip_mix_random_weights(n, degree):
    """Dirichlet weights, as tests/test_kernels.py's property test."""
    (jx, *jr), (tx, *tr) = _inputs((n,), degree, "f32", n * 13 + degree)
    ws = tuple(float(w) for w in
               np.random.default_rng(n).dirichlet(np.ones(degree + 1))[1:])
    w_self = 1.0 - sum(ws)
    got = tgm_ops.gossip_mix(tx, tr, w_self=w_self, ws=ws)
    want = jgm_ops.gossip_mix(jx, jr, w_self=w_self, ws=ws, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["f32"])


def test_plain_version_keeps_inputs_and_dtype():
    x = torch.ones(10)
    r = torch.full((10,), 3.0)
    out = tgm_ref.gossip_mix_ref(x, [r], 0.5, (0.5,))
    assert torch.equal(out, torch.full((10,), 2.0))
    assert torch.equal(x, torch.ones(10))          # accumulates out of place
    xb = x.to(torch.bfloat16)
    assert tgm_ref.gossip_mix_ref(xb, [r.to(torch.bfloat16)], 0.5,
                                  (0.5,)).dtype == torch.bfloat16


class _Elsewhere(torch.Tensor):
    """A tensor that reports a device the wrapper does not take."""

    @property
    def device(self):
        return torch.device("xpu")


def test_wrappers_refuse_what_they_do_not_take():
    x = torch.Tensor._make_subclass(_Elsewhere, torch.zeros(8))
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        tgm_ops.gossip_mix(x, [x], w_self=0.5, ws=(0.5,))
    # meta (the dry run's shapes, taken since the dry run was ported): an
    # empty output, nothing launched
    m = torch.zeros(8, device="meta")
    n = tgm_ops.gossip_mix.launches
    out = tgm_ops.gossip_mix(m, [m], w_self=0.5, ws=(0.5,))
    assert out.device.type == "meta" and out.shape == m.shape
    assert tgm_ops.gossip_mix.launches == n
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgm_kernel.gossip_mix_cuda(torch.zeros(8), [torch.zeros(8)], 0.5,
                                   (0.5,))
    with pytest.raises(ValueError, match="receives"):
        tgm_kernel.gossip_mix_cuda(torch.zeros(8), [torch.zeros(8)], 0.5,
                                   (0.25, 0.25))
