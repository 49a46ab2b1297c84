"""PyTorch port parity: the SSD scan (``kernels/ssd_scan``) and the plain
chunked algorithm (``models.mamba2.ssd_chunked``) against the JAX
package's on the same numpy inputs.  The JAX kernel runs in interpret
mode, as its own tests run it on the CPU; the port's wrapper takes its
plain version (the naive recurrence) for CPU tensors.  Tolerances are the
JAX tests': 1e-3 for the scan against the recurrence
(tests/test_kernels.py:117), 2e-3 in the property test (:152), 2e-4 for
float32 chunked against chunked, values and gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._hypothesis_compat import given, settings, st

from repro.kernels.ssd_scan import ops as jssd_ops, ref as jssd_ref
from repro.models import mamba2 as jm2
from repro_torch.kernels.ssd_scan import ops as tssd_ops, ref as tssd_ref
from repro_torch.models import mamba2 as tm2

TOL_SCAN = dict(rtol=1e-3, atol=1e-3)
TOL_PROP = dict(rtol=2e-3, atol=2e-3)
TOL32 = dict(rtol=2e-4, atol=2e-4)


def _inputs(b, s, h, p, g, n, seed, a_scale=0.3, model_a=False):
    """x, dt (softplus of a normal), A, B, C as numpy float32: A =
    -exp(a_scale N) as tests/test_kernels.py draws it, or the model's own
    range -linspace(1, 16, h) (exp(cum) underflows within a chunk)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    if model_a:
        A = -np.linspace(1.0, 16.0, h).astype(np.float32)
    else:
        A = -np.exp(a_scale * rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 128, 2, 64, 1, 64, 64),
    (2, 256, 4, 32, 2, 32, 128),
    (1, 64, 2, 64, 1, 128, 32),
    (1, 512, 2, 64, 1, 64, 128),
])
def test_ssd_scan_matches_jax_kernel(b, s, h, p, g, n, chunk):
    arrs = _inputs(b, s, h, p, g, n, seed=s + h)
    jy, jh = jssd_ops.ssd_scan(*_j(arrs), chunk=chunk, interpret=True)
    ty, th = tssd_ops.ssd_scan(*_t(arrs), chunk=chunk)
    assert ty.shape == (b, s, h, p) and th.shape == (b, h, p, n)
    assert ty.dtype == torch.float32 and th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL_SCAN)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL_SCAN)


@settings(max_examples=8, deadline=None)
@given(
    s_pow=st.integers(6, 9),
    h=st.sampled_from([1, 2, 4]),
    chunk_pow=st.integers(5, 7),
)
def test_ssd_scan_property(s_pow, h, chunk_pow):
    """Mirrors tests/test_kernels.py test_ssd_scan_property: the port's scan
    and its chunked algorithm (at the chunk the scan would run) against
    the JAX recurrence."""
    b, p, g, n = 1, 32, 1, 32
    s, chunk = 2 ** s_pow, 2 ** chunk_pow
    arrs = _inputs(b, s, h, p, g, n, seed=s_pow * 31 + h)
    jy, jh = jssd_ref.ssd_ref(*_j(arrs))
    ty, th = tssd_ops.ssd_scan(*_t(arrs), chunk=chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL_PROP)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL_PROP)
    cy, ch = tm2.ssd_chunked(*_t(arrs),
                             chunk=tssd_ops.chunk_len(s, chunk))
    np.testing.assert_allclose(cy.numpy(), np.asarray(jy), **TOL_PROP)
    np.testing.assert_allclose(ch.numpy(), np.asarray(jh), **TOL_PROP)


@pytest.mark.parametrize("s,chunk,want", [
    (2048, 128, 128), (64, 128, 64), (1000, 128, 8), (96, 64, 32),
    (40, 16, 8), (7, 128, 7), (999, 128, 1),
])
def test_chunk_len_halves_until_it_divides(s, chunk, want):
    assert tssd_ops.chunk_len(s, chunk) == want


@pytest.mark.parametrize("s,chunk", [(96, 64), (40, 16)])
def test_ssd_scan_non_dividing_s_matches_jax_kernel(s, chunk):
    """s not a multiple of chunk: both wrappers halve the chunk until it
    divides s."""
    arrs = _inputs(1, s, 2, 32, 1, 16, seed=s)
    jy, jh = jssd_ops.ssd_scan(*_j(arrs), chunk=chunk, interpret=True)
    ty, th = tssd_ops.ssd_scan(*_t(arrs), chunk=chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL_SCAN)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL_SCAN)


def test_ragged_model_range_chunked_matches_recurrence():
    """s = 1000 runs in chunks of 8, with the model's A range (decays that
    underflow inside a chunk): chunked == recurrence, no NaN."""
    arrs = _inputs(1, 1000, 4, 32, 2, 16, seed=5, model_a=True)
    jy, jh = jssd_ref.ssd_ref(*_j(arrs))
    ck = tssd_ops.chunk_len(1000, 128)
    cy, ch = tm2.ssd_chunked(*_t(arrs), chunk=ck)
    assert torch.isfinite(cy).all() and torch.isfinite(ch).all()
    np.testing.assert_allclose(cy.numpy(), np.asarray(jy), **TOL_SCAN)
    np.testing.assert_allclose(ch.numpy(), np.asarray(jh), **TOL_SCAN)


@pytest.mark.parametrize("model_a", [False, True])
def test_ssd_ref_with_h0_matches_jax(model_a):
    arrs = _inputs(2, 48, 4, 32, 2, 16, seed=7, model_a=model_a)
    h0 = np.random.default_rng(8).standard_normal(
        (2, 4, 32, 16)).astype(np.float32)
    jy, jh = jssd_ref.ssd_ref(*_j(arrs), h0=jnp.asarray(h0))
    ty, th = tssd_ref.ssd_ref(*_t(arrs), h0=torch.from_numpy(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL32)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL32)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,model_a", [
    (2, 64, 4, 32, 1, 16, 16, False),
    (1, 96, 4, 16, 2, 32, 32, True),
    (1, 128, 2, 64, 1, 64, 64, False),
])
def test_ssd_chunked_values_and_grads_match_jax(b, s, h, p, g, n, chunk,
                                                model_a):
    arrs = _inputs(b, s, h, p, g, n, seed=s + n, model_a=model_a)
    rng = np.random.default_rng(11)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    wy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    wh = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def jloss(x, dt, A, B, C, h0):
        y, hT = jm2.ssd_chunked(x, dt, A, B, C, chunk=chunk, h0=h0)
        return jnp.sum(y * wy) + jnp.sum(hT * wh), (y, hT)

    jgrads, (jy, jh) = jax.grad(jloss, argnums=tuple(range(6)),
                                has_aux=True)(*_j(arrs), jnp.asarray(h0))
    leaves = [t.requires_grad_(True) for t in _t(arrs + (h0,))]
    ty, th = tm2.ssd_chunked(*leaves[:5], chunk=chunk, h0=leaves[5])
    loss = (ty * torch.from_numpy(wy)).sum() + (th * torch.from_numpy(wh)).sum()
    tgrads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL32)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), **TOL32)
    for name, tg, jg in zip(("x", "dt", "A", "B", "C", "h0"), tgrads,
                            jgrads):
        assert torch.isfinite(tg).all(), name
        scale = max(1.0, float(np.abs(np.asarray(jg)).max()))
        np.testing.assert_allclose(tg.numpy() / scale,
                                   np.asarray(jg) / scale, **TOL32,
                                   err_msg=name)


class _Elsewhere(torch.Tensor):
    """A tensor that reports a device the wrapper does not take."""

    @property
    def device(self):
        return torch.device("xpu")


def test_ssd_scan_rejects_other_devices():
    x = torch.Tensor._make_subclass(_Elsewhere, torch.zeros(1, 8, 2, 32))
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        tssd_ops.ssd_scan(x, x[..., 0], x[0, 0, :, 0], x, x)
    # meta (the dry run's shapes, taken since the dry run was ported):
    # empty outputs of the kernel's shapes, nothing launched
    m = torch.zeros(1, 8, 2, 32, device="meta")
    n = tssd_ops.ssd_scan.launches
    y, h = tssd_ops.ssd_scan(m, m[..., 0], m[0, 0, :, 0], m, m)
    assert y.shape == m.shape and tuple(h.shape) == (1, 2, 32, 32)
    assert h.dtype == torch.float32 and tssd_ops.ssd_scan.launches == n


# --- the tensor-core kernel's arithmetic (csrc/ssd_scan.cu, L = 64 or
# 128): every product from TF32 operands as wgmma reads them, 3xTF32.
# TOL_TC is what tests/test_torch_cuda_kernels.py and chip_smoke.py hold
# that branch to on the card, x max(1, max-abs): 3xTF32 errs by 2e-6 to
# 1.5e-5 (the model's A range at s = 2048), single TF32 by ~5e-4, so a
# kernel that dropped its lo terms fails.
TOL_TC = 5e-5


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to
    nearest with ties away from zero, as float32 with the low 13 bits 0."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """A float32 operand as ``wgmma`` reads it in TF32: low 13 bits
    ignored."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)


def _mm(eq: str, a: torch.Tensor, b: torch.Tensor, terms: int):
    """``einsum(eq, a, b)`` from TF32 operands: 3 terms split each operand
    into hi = rna(a) and lo = rna(a - hi) and sum hi.hi + hi.lo + lo.hi;
    1 term is single TF32 (hi.hi)."""
    a_hi, b_hi = _tf32_round(a), _tf32_round(b)
    out = torch.einsum(eq, _tf32_read(a_hi), _tf32_read(b_hi))
    if terms == 3:
        a_lo, b_lo = _tf32_round(a - a_hi), _tf32_round(b - b_hi)
        out = (out + torch.einsum(eq, _tf32_read(a_hi), _tf32_read(b_lo))
               + torch.einsum(eq, _tf32_read(a_lo), _tf32_read(b_hi)))
    return out


def _ssd_chunked_tf32(x, dt, A, B, C, *, chunk: int, terms: int = 3):
    """The chunked SSD scan as the CUDA kernel's tensor-core branch
    computes it, in plain PyTorch: chunk states Bᵀ(w x), the f32 pass
    over chunks, then y = exp(cum_t) (C H_inᵀ) + ((C Bᵀ) ∘ decay) (dt x),
    every product from TF32 operands (``terms`` 3 or 1).  Same arguments and results as
    ``ssd_ref``; ``chunk`` divides s."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc, rep = s // chunk, h // g
    x, dt, A = x.float(), dt.float(), A.float()
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bh = B.float().reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Ch = C.float().reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    cum = torch.cumsum(dtc * A, dim=2)                     # (b,nc,l,h)
    w = torch.exp(cum[:, :, -1:] - cum) * dtc              # (b,nc,l,h)
    states = _mm("bcuhn,bcuhp->bchpn", Bh, xc * w[..., None], terms)
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(carry)
        carry = carry * torch.exp(cum[:, c, -1])[..., None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                        # (b,nc,h,p,n)
    y = _mm("bcthn,bchpn->bcthp", Ch, h_in, terms) * torch.exp(cum)[..., None]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    ct = cum.permute(0, 1, 3, 2)                           # (b,nc,h,l)
    diff = (ct[..., :, None] - ct[..., None, :]).masked_fill(~tri, -1e30)
    M = _mm("bcthn,bcuhn->bchtu", Ch, Bh, terms) * torch.exp(diff)
    y = y + _mm("bchtu,bcuhp->bcthp", M, xc * dtc[..., None], terms)
    return y.reshape(b, s, h, p), carry


def test_tf32_round_is_rna_with_13_zero_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -11, 3.0e-30, -7.25])
    got = _tf32_round(x)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    want = [1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10), 1.0 + 2 * 2.0 ** -10]
    np.testing.assert_array_equal(got[:4].numpy(),
                                  np.asarray(want, np.float32))
    assert float(got[5]) == -7.25                   # already TF32
    assert abs(float(got[4]) - 3.0e-30) <= 3.0e-30 * 2.0 ** -11


def _tf32_err(arrs, chunk, terms):
    jy, jh = jssd_ref.ssd_ref(*_j(arrs))
    ty, th = _ssd_chunked_tf32(*_t(arrs), chunk=chunk, terms=terms)
    errs = []
    for got, want in ((ty, jy), (th, jh)):
        want = np.asarray(want)
        errs.append(float(np.abs(got.numpy() - want).max())
                    / max(1.0, float(np.abs(want).max())))
    return errs, (ty, th)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 256, 4, 64, 1, 128, 128),   # mamba2-1.3b's head, state and chunk
    (2, 128, 4, 32, 2, 64, 64),     # P 32, two groups, L 64
    (1, 512, 2, 64, 1, 64, 256),    # the longest chunk (FMA on the card)
])
@pytest.mark.parametrize("model_a", [False, True])
def test_3xtf32_emulation_matches_jax(b, s, h, p, g, n, chunk, model_a):
    """3xTF32 products hold the reference's 1e-3 x max(1, max-abs) against
    the JAX recurrence and the Pallas kernel in interpret mode, with the
    test's and the model's A range, and TOL_TC against the recurrence."""
    arrs = _inputs(b, s, h, p, g, n, seed=s + n + model_a, model_a=model_a)
    errs, (ty, th) = _tf32_err(arrs, chunk, 3)
    assert max(errs) <= 1e-3, errs
    assert max(errs) <= TOL_TC, errs
    jy, jh = jssd_ops.ssd_scan(*_j(arrs), chunk=chunk, interpret=True)
    for got, want in ((ty, jy), (th, jh)):
        want = np.asarray(want)
        tol = 1e-3 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=tol)


@pytest.mark.parametrize("model_a", [False, True])
def test_single_tf32_is_far_less_accurate_than_3xtf32(model_a, capsys):
    """Why three products: at mamba2-1.3b's widths single TF32 (~3 digits)
    errs by far more than 3xTF32, and TOL_TC lies between the two.  Prints
    both relative errors."""
    arrs = _inputs(1, 256, 4, 64, 1, 128, seed=3, model_a=model_a)
    e3, _ = _tf32_err(arrs, 128, 3)
    e1, _ = _tf32_err(arrs, 128, 1)
    with capsys.disabled():
        a_range = "model" if model_a else "test"
        print(f"\nssd 3xTF32 vs single TF32, A={a_range}: y, h_final "
              f"error / max(1, max-abs): 3xTF32 "
              f"{e3[0]:.3g}, {e3[1]:.3g}; single {e1[0]:.3g}, {e1[1]:.3g}")
    assert max(e3) * 10 < max(e1)
    assert max(e3) <= TOL_TC < max(e1), (e3, e1)
