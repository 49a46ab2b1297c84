"""PyTorch port parity: paged-attention decode.  The port's entry point on
CPU tensors (its plain version) against the JAX Pallas kernel in interpret
mode, over the sweep of tests/test_paged_attention.py.  The CUDA kernel is
held to the plain version in test_torch_cuda_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ops as jpa_ops
from repro_torch.kernels.paged_attention import (kernel as pa_kernel,
                                                 ops as pa_ops, ref as pa_ref)

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


# --- the CUDA kernel's split-K arithmetic (csrc/paged_attention.cu), in
# plain PyTorch: per-split partials (m, l, acc) and their merge.  Splits of
# 2 pages of 16 tokens put split boundaries at 32, 64, ...


def _split_emulation(q, k_pages, v_pages, page_table, lengths, *,
                     window=None, attn_cap=None, pages_per_split=None):
    """Each split of ``pages_per_split`` pages (the wrapper's
    ``split_plan`` by default) gives an f32 partial (m, l, acc) over its
    visible tokens -- (-2^30, 0, 0) where it has none -- and the merge is
    ``sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s`` with l == 0
    guarded to 1.  Same arguments and result as ``paged_attention_ref``
    wherever every length is >= 1."""
    B, H, D = q.shape
    Kv, _, page_size, _ = k_pages.shape
    Pmax = page_table.shape[1]
    G = H // Kv
    pps, n_split = ((pages_per_split, -(-Pmax // pages_per_split))
                    if pages_per_split else
                    pa_kernel.split_plan(
                        Pmax, page_size,
                        B * Kv * -(-G // pa_kernel.GROUP_ROWS)))
    # pad the table with page 0 to whole splits: those tokens lie past
    # every length
    table = torch.zeros((B, n_split * pps), dtype=torch.long,
                        device=q.device)
    table[:, :Pmax] = page_table.long()
    T = n_split * pps * page_size
    k = k_pages[:, table].permute(1, 0, 2, 3, 4).reshape(B, Kv, T, D)
    v = v_pages[:, table].permute(1, 0, 2, 3, 4).reshape(B, Kv, T, D)
    logits = torch.einsum("bkgd,bktd->bkgt", q.reshape(B, Kv, G, D).float(),
                          k.float()) * D ** -0.5
    if attn_cap is not None:
        logits = attn_cap * torch.tanh(logits / attn_cap)
    t = torch.arange(T, device=q.device)[None, :]
    ln = lengths.long()[:, None]
    valid = t < ln
    if window is not None:
        valid &= t > ln - 1 - window
    S = pps * page_size
    valid = valid.reshape(B, 1, 1, n_split, S)
    x = logits.reshape(B, Kv, G, n_split, S)
    m = torch.where(valid, x, pa_ref.NEG_INF).amax(-1)     # (B, Kv, G, ns)
    p = torch.where(valid, torch.exp(x - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bkgst,bkstd->bkgsd", p,
                       v.float().reshape(B, Kv, n_split, S, D))
    M = m.amax(-1, keepdim=True)
    w = torch.exp(m - M)
    den = (w * l).sum(-1)
    num = torch.einsum("bkgs,bkgsd->bkgd", w, acc)
    den = torch.where(den == 0, torch.ones_like(den), den)
    return (num / den[..., None]).reshape(B, H, D).to(q.dtype)


def _run_split(q, kp, vp, table, lens, dtype=torch.float32, pps=2, **kw):
    t = [torch.from_numpy(a) for a in (q, kp, vp, table, lens)]
    t[:3] = [a.to(dtype) for a in t[:3]]
    got = _split_emulation(*t, pages_per_split=pps, **kw)
    ref = pa_ref.paged_attention_ref(*t, **kw)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jpa_ops.paged_attention(
        *(jnp.asarray(a, jd) for a in (q, kp, vp)), jnp.asarray(table),
        jnp.asarray(lens), interpret=True, **kw)
    assert got.dtype == dtype
    return (got.float().numpy(), ref.float().numpy(),
            np.asarray(want.astype(jnp.float32)))


# lengths 1, page_size - 1, a split boundary - 1, + 0, + 1, and Pmax x
# page_size (the longest row sets Pmax = 6)
SPLIT_LENGTHS = [1, 15, 31, 32, 33, 96]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 8])
def test_split_k_emulation_matches_jax_kernel_and_ref(G, dtype):
    arrs = _setup(len(SPLIT_LENGTHS), 2 * G, 2, 64, 16, SPLIT_LENGTHS,
                  seed=20 + G)
    got, ref, want = _run_split(*arrs, dtype=dtype)
    tol = TOL32 if dtype == torch.float32 else TOL
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, ref, **tol)


@pytest.mark.parametrize("window,attn_cap", [
    (5, None),      # narrower than a split: the first splits are empty
    (40, 30.0),     # the window starts mid-split, softcap
    (1, None),      # the last token alone
    (None, 50.0),   # softcap alone
])
@pytest.mark.parametrize("G", [1, 2, 8])
def test_split_k_emulation_window_softcap(G, window, attn_cap):
    arrs = _setup(3, 2 * G, 2, 128, 16, [96, 70, 33], seed=30 + G)
    got, ref, want = _run_split(*arrs, window=window, attn_cap=attn_cap)
    np.testing.assert_allclose(got, want, **TOL32)
    np.testing.assert_allclose(got, ref, **TOL32)


@pytest.mark.parametrize("pps", [1, 3, 8])
def test_split_k_emulation_any_split_size(pps):
    """Splits of 1 page, of a count that does not divide Pmax, and of more
    pages than Pmax (one split) agree alike; so do the default plan's."""
    arrs = _setup(4, 4, 2, 64, 8, [1, 7, 40, 17], seed=pps)
    got, ref, want = _run_split(*arrs, pps=pps)
    np.testing.assert_allclose(got, want, **TOL32)
    got_default = _split_emulation(
        *(torch.from_numpy(a) for a in arrs))
    np.testing.assert_allclose(got_default.numpy(), ref, **TOL32)


def test_split_k_empty_splits_contribute_zero():
    """A row whose visible tokens fill one split only: the empty partials
    (m = -2^30, l = 0, acc = 0) leave the result bit-identical to the
    one-split plan."""
    q, kp, vp, table, lens = _setup(1, 4, 2, 64, 16, [96], seed=9)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, lens)]
    many = _split_emulation(*args, window=20, pages_per_split=1)
    one = _split_emulation(*args, window=20, pages_per_split=6)
    np.testing.assert_allclose(many.numpy(), one.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("pmax,page_size,rows,want", [
    (32, 16, 64, (8, 4)),      # the serve shape: 8 x 8 x 4 = 256 blocks
    (64, 16, 64, (16, 4)),     # chip_smoke's ragged batch: one wave
    (512, 16, 8, (16, 32)),    # one 8,192-token sequence: 256 blocks
    (32, 16, 512, (32, 1)),    # 64 sequences fill the card unsplit
    (300, 1, 1, (128, 3)),     # one-token pages: 128 a split
    (5, 256, 1, (1, 5)),       # pages longer than a split: one a split
    (4, 16, 1, (4, 1)),        # a table shorter than a split
    (4096, 16, 64, (128, 32)),  # at most 128 pages a split
])
def test_split_plan_depends_on_shapes_only(pmax, page_size, rows, want):
    assert pa_kernel.split_plan(pmax, page_size, rows) == want


def test_split_plan_rejects_too_long_a_table():
    with pytest.raises(ValueError, match="splits"):
        pa_kernel.split_plan(1024 * 128 + 1, 1, 4096)
