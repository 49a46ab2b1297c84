"""PyTorch port parity: flash attention.  The port's entry point on CPU
tensors (its plain version) against the JAX Pallas kernel in interpret
mode and the JAX oracle, over the sweep of tests/test_kernels.py.  The
CUDA kernel is held to the plain version in test_torch_cuda_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops, ref as jfa_ref
from repro.models import attention as JA
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.models import attention as TA

TOL = dict(rtol=2e-2, atol=2e-2)
TOL32 = dict(rtol=2e-4, atol=2e-4)
DTYPES = {"f32": (jnp.float32, torch.float32, TOL32),
          "bf16": (jnp.bfloat16, torch.bfloat16, TOL)}


def _qkv(B, S, T, H, Kv, D, seed, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, S, H, D), (B, T, Kv, D), (B, T, Kv, D))]
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,T,H,Kv,D", [
    (1, 128, 128, 4, 4, 64),     # MHA
    (2, 256, 256, 4, 2, 64),     # GQA
    (1, 128, 128, 8, 1, 128),    # MQA, fat head_dim
    (1, 192, 192, 2, 2, 64),     # non-pow2 seq (padding path)
    (1, 64, 64, 2, 1, 32),       # tiny blocks
])
def test_flash_attention_shapes(B, S, T, H, Kv, D, dtype):
    (qj, kj, vj), (qt, kt, vt) = _qkv(B, S, T, H, Kv, D, S + H, dtype)
    got = fa_ops.flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == qt.dtype and got.shape == (B, S, H, D)
    tol = DTYPES[dtype][2]
    want_kernel = jfa_ops.flash_attention(qj, kj, vj, causal=True,
                                          interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want_kernel), **tol)
    want_ref = jfa_ref.attention_ref(qj, kj, vj, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want_ref), **tol)


@pytest.mark.parametrize("window", [32, 128, None])
@pytest.mark.parametrize("attn_cap", [None, 50.0])
def test_flash_attention_window_softcap(window, attn_cap):
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, 256, 256, 4, 2, 64, 0, "f32")
    got = fa_ops.flash_attention(qt, kt, vt, causal=True, window=window,
                                 attn_cap=attn_cap)
    want = jfa_ops.flash_attention(qj, kj, vj, causal=True, window=window,
                                   attn_cap=attn_cap, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ref_noncausal(causal):
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, 64, 64, 4, 4, 32, 5, "f32")
    got = fa_ref.attention_ref(qt, kt, vt, causal=causal)
    want = jfa_ref.attention_ref(qj, kj, vj, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL32)


def test_attn_apply_matches_jax_pallas_and_sdpa():
    """attn_apply (kernel path) == JAX attn_apply(impl='pallas') on the
    same weights, and == the port's positions-masked _sdpa."""
    B, S, H, Kv, D, d_model = 2, 128, 4, 2, 64, 96
    rng = np.random.default_rng(7)
    w = {n: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
         for n, s in (("wq", (d_model, H * D)), ("wk", (d_model, Kv * D)),
                      ("wv", (d_model, Kv * D)), ("wo", (H * D, d_model)))}
    x = rng.standard_normal((B, S, d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    p = TA.Attention(d_model, H, Kv, D)
    with torch.no_grad():
        for n, a in w.items():
            getattr(p, n).copy_(torch.from_numpy(a))
        kw = dict(n_heads=H, n_kv=Kv, head_dim=D,
                  positions=torch.from_numpy(pos))
        got = TA.attn_apply(p, torch.from_numpy(x), **kw)
        q, k, v = TA._project_qkv(p, torch.from_numpy(x), H, Kv, D, False,
                                  torch.from_numpy(pos), 10000.0)
        mask = torch.ones(S, S, dtype=torch.bool).tril()[None, None]
        oracle = TA._sdpa(q, k, v, mask).reshape(B, S, H * D) @ p.wo
    want = JA.attn_apply({n: jnp.asarray(a) for n, a in w.items()},
                         jnp.asarray(x), n_heads=H, n_kv=Kv, head_dim=D,
                         positions=jnp.asarray(pos), impl="pallas")
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_f32(got), _f32(oracle), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("attn_cap", [None, 50.0])
@pytest.mark.parametrize("H,Kv", [(4, 2), (8, 1)])
def test_sdpa_flat_layout_matches_jax(H, Kv, attn_cap):
    """``_sdpa(gqa_layout="flat")`` (K and V repeated to H heads, scores
    (B, H, S, T)) against the reference's flat layout, in f32, under a
    (B, 1, S, T) and a broadcast (1, 1, S, T) causal mask; and the grouped
    layout gives the same values."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, 64, 64, H, Kv, 32, H + Kv, "f32")
    for rows in (2, 1):
        mask = np.broadcast_to(np.tril(np.ones((64, 64), bool)),
                               (rows, 1, 64, 64))
        got = TA._sdpa(qt, kt, vt, torch.from_numpy(mask.copy()), attn_cap,
                       gqa_layout="flat")
        want = JA._sdpa(qj, kj, vj, jnp.asarray(mask), attn_cap,
                        gqa_layout="flat")
        assert got.shape == (2, 64, H, 32)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL32)
        grouped = TA._sdpa(qt, kt, vt, torch.from_numpy(mask.copy()),
                           attn_cap)
        np.testing.assert_allclose(_f32(got), _f32(grouped), **TOL32)


class _Elsewhere(torch.Tensor):
    """A tensor that reports a device the wrappers do not take."""

    @property
    def device(self):
        return torch.device("xpu")


def test_flash_attention_raises_off_cpu_and_cuda():
    # off the CPU, the card and meta (the dry run's shapes, since the
    # dry run was ported: an empty output, nothing launched) it raises
    q = torch.Tensor._make_subclass(_Elsewhere, torch.zeros(1, 4, 2, 64))
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        fa_ops.flash_attention(q, q, q)
    m = torch.zeros(1, 4, 2, 64, device="meta")
    n = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(m, m, m)
    assert out.device.type == "meta" and out.shape == m.shape
    assert fa_ops.flash_attention.launches == n


def _wgmma_arithmetic(q, k, v, *, causal=True, window=None, attn_cap=None):
    """The bf16 CUDA kernel's arithmetic (csrc/flash_attention.cu,
    wg::flash_fwd_wgmma) in torch on the CPU: per 64-row query tile, the
    64-key tiles between its window start and causal diagonal, in order;
    f32 scores of the bf16 inputs, f32 running m, l and acc; P rounded to
    bf16 before P V while l sums the unrounded P; a row that has seen only
    masked keys subtracts 0.  A test helper: it sits on no path."""
    B, S, H, D = q.shape
    T, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(G, dim=2) for x in (k, v))
    out = torch.empty(B, S, H, D, dtype=q.dtype)
    for q0 in range(0, S, 64):
        rows = torch.arange(q0, min(q0 + 64, S))
        last = min(T, S, q0 + 64) if causal else T
        lo = max(0, q0 - window + 1) // 64 if window else 0
        m = torch.full((B, H, len(rows)), fa_ref.NEG_INF)
        l = torch.zeros(B, H, len(rows))
        acc = torch.zeros(B, H, len(rows), D)
        for c0 in range(lo * 64, last, 64):
            cols = torch.arange(c0, min(c0 + 64, T))
            s = torch.einsum("brhd,bchd->bhrc", qf[:, rows], kf[:, cols])
            s = s * D ** -0.5
            if attn_cap is not None:
                s = attn_cap * torch.tanh(s / attn_cap)
            ok = torch.ones(len(rows), len(cols), dtype=torch.bool)
            if causal:
                ok &= cols[None] <= rows[:, None]
            if window is not None:
                ok &= cols[None] > rows[:, None] - window
            s = torch.where(ok, s, fa_ref.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - torch.where(m_new == fa_ref.NEG_INF, 0.0,
                                          m_new)[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhrc,bchd->bhrd", p.bfloat16().float(), vf[:, cols])
            m = m_new
        l = torch.where(l == 0, 1.0, l)
        out[:, rows] = (acc / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    return out


# reduced qwen3-0.6b widths (4 heads of 64, G = 1) and G = 2, windows that
# start mid-tile, softcap; S ragged against the 64-row tiles
@pytest.mark.parametrize("Kv", [4, 2])
@pytest.mark.parametrize("S,window,attn_cap", [
    (130, None, None), (200, 48, None), (130, None, 50.0), (256, 100, 30.0),
])
def test_wgmma_arithmetic_holds_the_bf16_tolerance(S, window, attn_cap, Kv):
    """Rounding P to bf16 before P V (the bf16 kernel; the JAX kernel
    multiplies in f32) stays within the reference's bf16 tolerance of the
    JAX kernel in interpret mode and of the JAX oracle."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, S, S, 4, Kv, 64, S + Kv, "bf16")
    got = _wgmma_arithmetic(qt, kt, vt, window=window, attn_cap=attn_cap)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    want = jfa_ops.flash_attention(qj, kj, vj, causal=True, window=window,
                                   attn_cap=attn_cap, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    want_ref = jfa_ref.attention_ref(qj, kj, vj, causal=True, window=window,
                                     attn_cap=attn_cap)
    np.testing.assert_allclose(_f32(got), _f32(want_ref), **TOL)
