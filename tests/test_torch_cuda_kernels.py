"""The PyTorch port's CUDA kernels against their plain versions, on the
card.  Marked ``gpu``: each test skips where there is no CUDA device.
Imports neither JAX nor the JAX package, so it runs on the machine with
the card:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.paged_attention import ops as pa_ops, ref as pa_ref

TOL = dict(rtol=2e-2, atol=2e-2)
TOL32 = dict(rtol=2e-4, atol=2e-4)
TOLS = {torch.float32: TOL32, torch.bfloat16: TOL}

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Kv,D,window,cap", [
    (2, 256, 4, 2, 64, None, None),
    (1, 192, 8, 1, 128, None, None),    # ragged last query/key tile
    (2, 320, 4, 4, 64, 32, None),       # window starts mid-sequence
    (4, 512, 16, 8, 128, 128, 50.0),    # qwen3 widths, window + softcap
])
def test_flash_attention_kernel(cuda, B, S, H, Kv, D, window, cap, dtype):
    g = torch.Generator(device=cuda).manual_seed(S + H)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, S, H, D), (B, S, Kv, D), (B, S, Kv, D)))
    n0 = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(q, k, v, window=window, attn_cap=cap)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, fa_ref.attention_ref(q, k, v, window=window, attn_cap=cap),
           dtype)


def test_flash_attention_kernel_rejects(cuda):
    q = torch.zeros(1, 64, 2, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q, q)                  # head_dim 96
    q = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q, q)                  # float16
    q = torch.zeros(1, 40, 2, 64, device=cuda)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q, q, causal=False)    # padded, non-causal


def _pages(B, H, Kv, D, page_size, lengths, dtype, device, seed):
    rng = np.random.default_rng(seed)
    per_seq = [-(-int(n) // page_size) for n in lengths]
    total = sum(per_seq)
    order = rng.permutation(np.arange(1, total + 1))      # page 0 = trash
    table = np.zeros((B, max(per_seq)), np.int32)
    at = 0
    for b, n in enumerate(per_seq):
        table[b, :n] = order[at:at + n]
        at += n
    n_pages = total + 3
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((Kv, n_pages, page_size, D)).astype(np.float32)
    vp = rng.standard_normal((Kv, n_pages, page_size, D)).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)       # noqa: E731
    return (to(q).to(dtype), to(kp).to(dtype), to(vp).to(dtype), to(table),
            to(np.asarray(lengths, np.int32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Kv,D,page_size,lengths,window,cap", [
    (3, 8, 1, 64, 8, [5, 23, 17], None, None),
    (2, 4, 2, 128, 4, [9, 131], 8, 30.0),
    (8, 16, 8, 128, 16, [1024, 40, 517, 64, 300, 999, 16, 777], None, None),
])
def test_paged_attention_kernel(cuda, B, H, Kv, D, page_size, lengths,
                                window, cap, dtype):
    q, kp, vp, table, lens = _pages(B, H, Kv, D, page_size, lengths, dtype,
                                    cuda, seed=13)
    table[-1] = 0                    # a trash-padded row, as in a bucket
    lens[-1] = 1
    n0 = pa_ops.paged_attention.launches
    got = pa_ops.paged_attention(q, kp, vp, table, lens, window=window,
                                 attn_cap=cap)
    torch.cuda.synchronize()
    assert pa_ops.paged_attention.launches == n0 + 1
    assert torch.isfinite(got).all()
    _close(got, pa_ref.paged_attention_ref(q, kp, vp, table, lens,
                                           window=window, attn_cap=cap),
           dtype)
