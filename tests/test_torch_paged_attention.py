"""PyTorch port parity: paged-attention decode.  The port's entry point on
CPU tensors (its plain version) against the JAX Pallas kernel in interpret
mode, over the sweep of tests/test_paged_attention.py.  The CUDA kernel is
held to the plain version in test_torch_cuda_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ops as jpa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops, ref as pa_ref

TOL32 = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=2e-2, atol=2e-2)


def _setup(B, H, Kv, D, page_size, lengths, n_pages=None, seed=0):
    """Numpy pools + a page table mapping each sequence's tokens to
    DISJOINT pages in arrival-interleaved (non-contiguous) order."""
    lengths = np.asarray(lengths, np.int32)
    per_seq = [-(-int(ln) // page_size) for ln in lengths]
    pmax = max(per_seq)
    total = sum(per_seq)
    n_pages = n_pages or total + 3
    rng = np.random.default_rng(seed)
    order = rng.permutation(np.arange(1, total + 1))  # page 0 = trash
    table = np.zeros((B, pmax), np.int32)
    at = 0
    for b, n in enumerate(per_seq):
        table[b, :n] = order[at:at + n]
        at += n
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((Kv, n_pages, page_size, D)).astype(np.float32)
    vp = rng.standard_normal((Kv, n_pages, page_size, D)).astype(np.float32)
    return q, kp, vp, table, lengths


def _run_both(q, kp, vp, table, lens, **kw):
    got = pa_ops.paged_attention(*(torch.from_numpy(a) for a in
                                   (q, kp, vp, table, lens)), **kw)
    want = jpa_ops.paged_attention(*(jnp.asarray(a) for a in
                                     (q, kp, vp, table, lens)),
                                   interpret=True, **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("B,H,Kv,D,page_size,lengths", [
    (1, 4, 4, 64, 16, [37]),          # MHA, partial last page
    (2, 4, 2, 64, 16, [64, 16]),      # GQA, exact page boundaries
    (3, 8, 1, 64, 8, [5, 23, 17]),    # MQA, ragged lengths
    (2, 4, 2, 128, 4, [9, 31]),       # many tiny pages, fat head
    (4, 2, 2, 32, 32, [1, 33, 64, 2]),  # length-1 seq (single live token)
])
def test_paged_matches_jax_kernel(B, H, Kv, D, page_size, lengths):
    got, want = _run_both(*_setup(B, H, Kv, D, page_size, lengths))
    np.testing.assert_allclose(got, want, **TOL32)


@pytest.mark.parametrize("window", [None, 8, 64])
@pytest.mark.parametrize("attn_cap", [None, 30.0])
def test_paged_window_softcap(window, attn_cap):
    got, want = _run_both(*_setup(2, 4, 2, 64, 16, [50, 29], seed=3),
                          window=window, attn_cap=attn_cap)
    np.testing.assert_allclose(got, want, **TOL32)


def test_paged_bf16_matches_jax_kernel():
    q, kp, vp, table, lens = _setup(2, 4, 2, 64, 16, [50, 29], seed=4)
    got = pa_ops.paged_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kp).bfloat16(),
        torch.from_numpy(vp).bfloat16(), torch.from_numpy(table),
        torch.from_numpy(lens))
    want = jpa_ops.paged_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(table), jnp.asarray(lens),
        interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **TOL)


def test_trash_rows_are_finite():
    """A padded bucket row (all-trash page table, length 1) must produce
    finite output."""
    q, kp, vp, table, lens = _setup(2, 4, 2, 64, 16, [40, 1], seed=5)
    table[1] = 0                     # row 1: every page -> trash
    got, want = _run_both(q, kp, vp, table, lens)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL32)


def test_ignores_stale_pool_content():
    """Tokens beyond `lengths` (stale garbage from freed pages) must not
    leak into the output."""
    q, kp, vp, table, lens = _setup(1, 4, 2, 64, 16, [20], seed=11)
    got1, _ = _run_both(q, kp, vp, table, lens)
    pg = int(table[0, 1])            # page holding tokens 16..31
    kp[:, pg, 4:] = 1e9
    vp[:, pg, 4:] = -1e9
    got2, want2 = _run_both(q, kp, vp, table, lens)
    np.testing.assert_allclose(got1, got2, **TOL32)
    np.testing.assert_allclose(got2, want2, **TOL32)


def test_ref_matches_dense_attention():
    """The page-gather plain version agrees with ordinary dense attention
    when pages are laid out contiguously."""
    B, H, Kv, D, ps, T = 2, 4, 2, 64, 8, 24
    rng = np.random.default_rng(7)
    lens = torch.tensor([T, T - 7], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    kd = torch.from_numpy(rng.standard_normal((B, Kv, T, D)).astype(np.float32))
    vd = torch.from_numpy(rng.standard_normal((B, Kv, T, D)).astype(np.float32))
    n_per = T // ps
    kp = torch.zeros(Kv, 1 + B * n_per, ps, D)
    vp = torch.zeros_like(kp)
    table = torch.zeros(B, n_per, dtype=torch.int32)
    for b in range(B):
        for p in range(n_per):
            pg = 1 + b * n_per + p
            kp[:, pg] = kd[b, :, p * ps:(p + 1) * ps]
            vp[:, pg] = vd[b, :, p * ps:(p + 1) * ps]
            table[b, p] = pg
    got = pa_ref.paged_attention_ref(q, kp, vp, table, lens)
    G = H // Kv
    logits = torch.einsum("bkgd,bktd->bkgt", q.reshape(B, Kv, G, D),
                          kd) * D ** -0.5
    mask = torch.arange(T)[None, :] < lens[:, None]
    logits = torch.where(mask[:, None, None], logits, -2.0 ** 30)
    want = torch.einsum("bkgt,bktd->bkgd", torch.softmax(logits, -1),
                        vd).reshape(B, H, D)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL32)
