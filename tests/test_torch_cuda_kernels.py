"""The PyTorch port's CUDA kernels against their plain versions, on the
card.  Marked ``gpu``: each test skips where there is no CUDA device.
Imports neither JAX nor the JAX package, so it runs on the machine with
the card:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.gossip_mix import ops as gm_ops, ref as gm_ref
from repro_torch.kernels.paged_attention import ops as pa_ops, ref as pa_ref
from repro_torch.kernels.ssd_scan import (kernel as ssd_kernel,
                                          ops as ssd_ops, ref as ssd_ref)
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as M

TOL = dict(rtol=2e-2, atol=2e-2)
TOL32 = dict(rtol=2e-4, atol=2e-4)
TOLS = {torch.float32: TOL32, torch.bfloat16: TOL}
# gossip_mix: tests/test_kernels.py:189 (f32), :15 (bf16)
GM_TOLS = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: TOL}
# ssd_scan's tensor-core branch, x max(1, max-abs): 3xTF32 errs by up to
# 1.5e-5 and single TF32 by ~5e-4 (tests/test_torch_ssd_scan.py)
SSD_TOL_TC = 5e-5

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


def _qkv(B, S, T, H, Kv, D, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(dtype)
            for s in ((B, S, H, D), (B, T, Kv, D), (B, T, Kv, D))]


def _flash_check(q, k, v, dtype, **kw):
    n0 = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    _close(got, fa_ref.attention_ref(q, k, v, **kw), dtype)


# bf16: the wgmma kernel (blocks pair two heads of a kv head where G is
# even, two 64-row tiles of one head where G is odd); f32: the FMA kernel.
# S = 1, 63, 65 and 1000 are ragged against the 64-row query and key tiles.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("S", [1, 63, 65, 1000])
def test_flash_attention_kernel_ragged_gqa(cuda, S, G, D, dtype):
    q, k, v = _qkv(2, S, S, 2 * G, 2, D, dtype, cuda, S + 7 * G + D)
    _flash_check(q, k, v, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D,S,window,cap", [
    (1, 128, 1000, 100, None),   # window starts mid-tile, odd G
    (2, 128, 777, 37, 30.0),     # qwen3's G, window + softcap
    (3, 64, 200, 70, None),      # odd G > 1
    (4, 64, 300, 1, None),       # window 1: the diagonal alone
    (8, 64, 129, 200, 50.0),     # window wider than the sequence
])
def test_flash_attention_kernel_window_softcap(cuda, G, D, S, window, cap,
                                               dtype):
    q, k, v = _qkv(1, S, S, 2 * G, 2, D, dtype, cuda, S + G)
    _flash_check(q, k, v, dtype, window=window, attn_cap=cap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T", [(128, 128), (100, 192)])
def test_flash_attention_kernel_noncausal(cuda, S, T, dtype):
    q, k, v = _qkv(2, S, T, 4, 2, 128, dtype, cuda, S + T)
    _flash_check(q, k, v, dtype, causal=False)


def test_flash_attention_kernel_serving_bucket(cuda):
    """The serving prefill's bucket: qwen3-0.6b widths, 8 x 512, bf16."""
    q, k, v = _qkv(8, 512, 512, 16, 8, 128, torch.bfloat16, cuda, 8)
    _flash_check(q, k, v, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,cap", [(None, None), (100, 30.0)])
def test_flash_attention_kernel_moe_prefill_bucket(cuda, window, cap,
                                                   dtype):
    """granite-moe-3b-a800m's prefill bucket, (4, 512, 24, 8, 64): G 3,
    the odd-G path (two 64-row tiles of one head a block) at D 64."""
    q, k, v = _qkv(4, 512, 512, 24, 8, 64, dtype, cuda, 24)
    _flash_check(q, k, v, dtype, window=window, attn_cap=cap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,cap", [(None, None), (100, 30.0)])
def test_flash_attention_kernel_audio_prefill_bucket(cuda, window, cap,
                                                     dtype):
    """musicgen-large's prefill bucket, (4, 512, 32, 32, 64): MHA (G 1)
    at D 64, 32 kv heads."""
    q, k, v = _qkv(4, 512, 512, 32, 32, 64, dtype, cuda, 32)
    _flash_check(q, k, v, dtype, window=window, attn_cap=cap)


def test_flash_attention_kernel_bench_kernels_shape(cuda):
    """``bench_kernels``' row, (1, 512, 4, 2, 64) causal f32: the f32 FMA
    branch at D 64, G 2, held at the reference's 2e-4."""
    q, k, v = _qkv(1, 512, 512, 4, 2, 64, torch.float32, cuda, 64)
    _flash_check(q, k, v, torch.float32)


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


def _paged_check(q, kp, vp, table, lens, dtype, **kw):
    n0 = pa_ops.paged_attention.launches
    got = pa_ops.paged_attention(q, kp, vp, table, lens, **kw)
    torch.cuda.synchronize()
    assert pa_ops.paged_attention.launches == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    _close(got, pa_ref.paged_attention_ref(q, kp, vp, table, lens, **kw),
           dtype)


# The split-K kernel's edges at page 16, 128-token splits: lengths 1,
# page_size - 1, a split boundary - 1 / + 0 / + 1, Pmax x page_size; a
# window narrower than a split (whole splits empty) and one that starts
# mid-split, with softcap; and a trash-padded last row (all page 0).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,cap", [(None, None), (5, None),
                                        (200, 30.0), (1, 50.0)])
def test_paged_attention_kernel_split_edges(cuda, window, cap, dtype):
    lengths = [1, 15, 127, 128, 129, 384, 1]
    q, kp, vp, table, lens = _pages(7, 16, 8, 128, 16, lengths, dtype, cuda,
                                    seed=17)
    table[-1] = 0
    _paged_check(q, kp, vp, table, lens, dtype, window=window, attn_cap=cap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8, 16])
def test_paged_attention_kernel_gqa_widths(cuda, G, D, dtype):
    """G = 3 pads its 4-row group, G = 16 takes two groups of 8."""
    lengths = [300, 1, 129, 40]
    q, kp, vp, table, lens = _pages(4, 2 * G, 2, D, 16, lengths, dtype,
                                    cuda, seed=G + D)
    table[1] = 0                     # trash-padded row
    _paged_check(q, kp, vp, table, lens, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,cap", [(None, None), (100, 30.0)])
def test_paged_attention_kernel_moe_decode(cuda, window, cap, dtype):
    """granite-moe-3b-a800m's decode step: B 8 at 257-288 tokens, Pmax
    32, H 24, Kv 8, D 64.  G 3 runs in groups of GT 4 rows, so every
    block has a partial group (3 live rows of 4)."""
    lengths = np.random.default_rng(3).integers(257, 289, 8).tolist()
    q, kp, vp, table, lens = _pages(8, 24, 8, 64, 16, lengths, dtype, cuda,
                                    seed=29)
    _paged_check(q, kp, vp, table, lens, dtype, window=window, attn_cap=cap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,cap", [(None, None), (100, 30.0)])
def test_paged_attention_kernel_audio_decode(cuda, window, cap, dtype):
    """musicgen-large's decode step at ragged lengths: H 32, Kv 32, D 64
    (G 1, so GT 1: one query row a group), a long row beside short ones
    and a trash-padded last row."""
    lengths = [288, 1, 257, 40, 1000, 129, 16, 1]
    q, kp, vp, table, lens = _pages(8, 32, 32, 64, 16, lengths, dtype, cuda,
                                    seed=31)
    table[-1] = 0
    _paged_check(q, kp, vp, table, lens, dtype, window=window, attn_cap=cap)


@pytest.mark.parametrize("page_size", [1, 4, 8, 32, 256])
def test_paged_attention_kernel_page_sizes(cuda, page_size):
    """Runs of a page's rows are bulk-copied whole; pages shorter and
    longer than a chunk, a split, and the ring."""
    lengths = [1000, 3, 257]
    q, kp, vp, table, lens = _pages(3, 8, 4, 64, page_size, lengths,
                                    torch.bfloat16, cuda, seed=page_size)
    _paged_check(q, kp, vp, table, lens, torch.bfloat16, window=700)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_long_context(cuda, dtype):
    """B = 1 at 8,192 tokens, page 16 (Pmax 512, 64 splits)."""
    q, kp, vp, table, lens = _pages(1, 16, 8, 128, 16, [8192], dtype, cuda,
                                    seed=81)
    _paged_check(q, kp, vp, table, lens, dtype)
    _paged_check(q, kp, vp, table, lens, dtype, window=3000, attn_cap=30.0)


def test_paged_attention_kernel_cuda_graph_replay(cuda):
    """Captured once, replayed after `lengths` and `page_table` changed in
    place: the grid is fixed by the shapes and the wrapper reads nothing
    back from the card, so the replay is right at the new lengths."""
    dtype = torch.bfloat16
    q, kp, vp, table, lens = _pages(8, 16, 8, 128, 16, [512] * 8, dtype,
                                    cuda, seed=5)
    lens.copy_(torch.tensor([257, 270, 288, 300, 1, 511, 128, 129],
                            dtype=torch.int32))
    pa_ops.paged_attention(q, kp, vp, table, lens)      # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa_ops.paged_attention(q, kp, vp, table, lens)
    for new_lens in ([512, 1, 2, 3, 128, 129, 300, 17],
                     [40, 400, 16, 15, 500, 256, 1, 333]):
        lens.copy_(torch.tensor(new_lens, dtype=torch.int32))
        perm = torch.randperm(table.numel(), generator=torch.Generator()
                              .manual_seed(sum(new_lens)))
        table.copy_(table.flatten()[perm.to(cuda)].view_as(table))
        graph.replay()
        torch.cuda.synchronize()
        _close(out, pa_ref.paged_attention_ref(q, kp, vp, table, lens), dtype)


def test_paged_attention_kernel_calls_share_no_state(cuda):
    """The merge's counters lie in each call's own scratch: a captured
    graph replays right after a larger call (130 sequences at Kv 8, more
    counters than any earlier call), and while that call runs on another
    stream, and every result agrees with the plain version."""
    dtype = torch.bfloat16
    small = _pages(8, 16, 8, 128, 16, [257, 270, 288, 300, 1, 511, 128, 129],
                   dtype, cuda, seed=6)
    pa_ops.paged_attention(*small)                      # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa_ops.paged_attention(*small)
    big = _pages(130, 16, 8, 128, 16, [40 + 7 * i for i in range(130)],
                 dtype, cuda, seed=7)
    first = pa_ops.paged_attention(*big)
    main, side = torch.cuda.current_stream(), torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        side_out = pa_ops.paged_attention(*big)
        graph.replay()
    again = pa_ops.paged_attention(*big)                # meanwhile, on main
    main.wait_stream(side)
    torch.cuda.synchronize()
    _close(out, pa_ref.paged_attention_ref(*small), dtype)
    want = pa_ref.paged_attention_ref(*big)
    for got in (first, side_out, again):
        _close(got, want, dtype)
    graph.replay()
    torch.cuda.synchronize()
    _close(out, pa_ref.paged_attention_ref(*small), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,degree", [
    ((8, 1024), 1), ((3, 5, 7), 3), ((17,), 2), ((1,), 1),
    ((4, 1 << 20), 1), ((3, 1_000_003), 3),    # odd tail past the vectors
    ((4096,), 1020),                           # ceca over a prime n = 1021
])
def test_gossip_mix_kernel(cuda, shape, degree, dtype):
    g = torch.Generator(device=cuda).manual_seed(degree + len(shape))
    x, *recvs = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                 for _ in range(degree + 1))
    ws = tuple(float(w) for w in np.random.default_rng(degree).dirichlet(
        np.ones(degree + 1))[1:])
    w_self = 1.0 - sum(ws)
    n0 = gm_ops.gossip_mix.launches
    got = gm_ops.gossip_mix(x, recvs, w_self=w_self, ws=ws)
    torch.cuda.synchronize()
    assert gm_ops.gossip_mix.launches == n0 + 1
    assert got.dtype == dtype and got.shape == x.shape
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        gm_ref.gossip_mix_ref(x, recvs, w_self, ws).float().cpu().numpy(),
        **GM_TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gossip_mix_kernel_on_a_rank_shard(cuda, dtype):
    """A shard-native round's buffers: one node's (1, B) local block, B
    odd (``pad_multiple=1`` packing), the received block a fresh
    tensor."""
    B = 2 * 3 * 5 * 7 * 11 * 13 + 1
    g = torch.Generator(device=cuda).manual_seed(18)
    x, r = (torch.randn((1, B), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    n0 = gm_ops.gossip_mix.launches
    got = gm_ops.gossip_mix(x, [r], w_self=0.5, ws=(0.5,))
    torch.cuda.synchronize()
    assert gm_ops.gossip_mix.launches == n0 + 1
    assert got.shape == (1, B) and got.dtype == dtype
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        gm_ref.gossip_mix_ref(x, [r], 0.5, (0.5,)).float().cpu().numpy(),
        **GM_TOLS[dtype])


def test_gossip_mix_kernel_unaligned_input(cuda):
    base = torch.randn(4 * 1000 + 1, device=cuda)
    x, r = base[1:], base[:-1]                  # 4-byte offset views
    got = gm_ops.gossip_mix(x, [r], w_self=0.25, ws=(0.75,))
    np.testing.assert_allclose(
        got.cpu().numpy(), (0.25 * x + 0.75 * r).cpu().numpy(),
        **GM_TOLS[torch.float32])


def test_gossip_mix_kernel_past_2_31_elements(cuda):
    """The training payload exceeds 2^31 elements: the kernel's counts and
    indices are 64-bit.  Checked where the card has room for x, one
    receive and the output (3 x 8.6 GB)."""
    n = (1 << 31) + 4099                    # past 2^31, with an odd tail
    if torch.cuda.mem_get_info(cuda)[0] < 3 * 4 * n + (4 << 30):
        pytest.skip("needs ~30 GB of free device memory")
    g = torch.Generator(device=cuda).manual_seed(31)
    x = torch.randn(n, generator=g, device=cuda)
    r = torch.randn(n, generator=g, device=cuda)
    got = gm_ops.gossip_mix(x, [r], w_self=0.5, ws=(0.5,))
    torch.cuda.synchronize()
    tail = slice((1 << 31) - 4096, n)        # the region past 2^31 and before
    np.testing.assert_allclose(
        got[tail].cpu().numpy(), (0.5 * x[tail] + 0.5 * r[tail]).cpu().numpy(),
        **GM_TOLS[torch.float32])
    idx = torch.randint(0, n, (1 << 20,), generator=g, device=cuda)
    np.testing.assert_allclose(
        got[idx].cpu().numpy(), (0.5 * x[idx] + 0.5 * r[idx]).cpu().numpy(),
        **GM_TOLS[torch.float32])


def _gm_inputs(n, degree, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x, *recvs = (torch.randn(n, generator=g, device=device).to(dtype)
                 for _ in range(degree + 1))
    ws = tuple(float(w) for w in np.random.default_rng(seed).dirichlet(
        np.ones(degree + 1))[1:])
    return x, recvs, 1.0 - sum(ws), ws


# Degrees 1 and 2 run their own kernels.  Receives of weight 0.0 lift the
# degree to 3, the generic kernel, without changing the sum: fmaf(0, r, acc)
# == acc for finite r, so the two must agree bit for bit.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 4099, 1_000_003, 3 << 22])
@pytest.mark.parametrize("degree", [1, 2])
def test_gossip_mix_fast_paths_match_generic_bits(cuda, degree, n, dtype):
    x, recvs, w_self, ws = _gm_inputs(n, degree, dtype, cuda, n + degree)
    fast = gm_ops.gossip_mix(x, recvs, w_self=w_self, ws=ws)
    pad = 3 - degree
    generic = gm_ops.gossip_mix(x, recvs + [x] * pad, w_self=w_self,
                                ws=ws + (0.0,) * pad)
    torch.cuda.synchronize()
    assert torch.equal(fast, generic)


def test_gossip_mix_fast_path_past_2_31_elements_matches_generic(cuda):
    """Degree 2 past 2^31 elements, with an odd tail, bit for bit against
    the generic kernel.  Checked where the card has room for x, two
    receives and two outputs (5 x 8.6 GB)."""
    n = (1 << 31) + 4099
    if torch.cuda.mem_get_info(cuda)[0] < 5 * 4 * n + (4 << 30):
        pytest.skip("needs ~47 GB of free device memory")
    x, recvs, w_self, ws = _gm_inputs(n, 2, torch.float32, cuda, 2)
    fast = gm_ops.gossip_mix(x, recvs, w_self=w_self, ws=ws)
    generic = gm_ops.gossip_mix(x, recvs + [x], w_self=w_self,
                                ws=ws + (0.0,))
    torch.cuda.synchronize()
    assert torch.equal(fast, generic)


def test_flash_attention_kernel_refuses_autograd(cuda):
    q = torch.randn(1, 64, 2, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 64, 2, 64, device=cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        fa_ops.flash_attention(q, k, k)
    with torch.no_grad():                     # serving: no gradient needed
        assert fa_ops.flash_attention(q, k, k).shape == q.shape


def test_train_forward_backward_reaches_every_attention_weight(cuda):
    """The train forward takes the plain attention on the card, so the
    backward gives wq, wk, wv and the qk-norm scales a gradient (the
    forward-only kernel would have cut them off)."""
    cfg = configs.reduced_config(configs.get_config("qwen3-0.6b"))
    model = M.init(cfg, 0, device=cuda)
    leaves = {k: p.detach().clone().requires_grad_(True)
              for k, p in model.named_parameters()}
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda)
    n0 = fa_ops.flash_attention.launches
    loss = steps_mod.train_loss_fn(M.params_view(leaves), cfg, tokens)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert fa_ops.flash_attention.launches == n0
    for i in range(cfg.n_layers):
        for w in ("wq", "wk", "wv", "wo"):
            g = grads[f"layers.{i}.attn.{w}"]
            assert torch.isfinite(g).all() and float(g.abs().max()) > 0, w
    assert float(grads["layers.0.attn.q_norm.scale"].abs().max()) > 0


def _ssd_inputs(b, s, h, p, g, n, device, seed, model_a=False):
    """As tests/test_kernels.py:108-113 draws them (A = -exp(0.3 N)), or
    with the model's own A range, A_log = log(linspace(1, 16, h))."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x, dt = rn(b, s, h, p), torch.nn.functional.softplus(rn(b, s, h))
    A = (-torch.linspace(1.0, 16.0, h, device=device) if model_a
         else -torch.exp(0.3 * rn(h)))
    return x, dt, A, rn(b, s, g, n), rn(b, s, g, n)


def _ssd_close(got, want, tc=False):
    """tests/test_kernels.py:117-118: 1e-3, scaled by max(1, max-abs); on
    the tensor-core branch (``tc``) also a max abs error within SSD_TOL_TC
    x max(1, max-abs), which a kernel in single TF32 would exceed."""
    scale = max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-3, atol=1e-3 * scale)
    if tc:
        err = float((got - want).abs().max())
        assert err <= SSD_TOL_TC * scale, (
            f"max abs err {err} beyond {SSD_TOL_TC} x max(1, {scale})")


def _on_tensor_cores(s, chunk, n):
    return ssd_kernel.tensor_core_branch(ssd_ops.chunk_len(s, chunk), n)


@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("s", [64, 1000, 2048])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_scan_kernel(cuda, g, s, chunk):
    h, p, n = 4, 64, 128
    for model_a in (False, True):
        x, dt, A, B, C = _ssd_inputs(1, s, h, p, g, n, cuda, s + g, model_a)
        n0 = ssd_ops.ssd_scan.launches
        y, hT = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd_ops.ssd_scan.launches == n0 + 1
        assert y.shape == x.shape and hT.shape == (1, h, p, n)
        assert torch.isfinite(y).all() and torch.isfinite(hT).all()
        y_ref, h_ref = ssd_ref.ssd_ref(x, dt, A, B, C)
        tc = _on_tensor_cores(s, chunk, n)
        _ssd_close(y, y_ref, tc)
        _ssd_close(hT, h_ref, tc)


# Both branches: the 3xTF32 tensor-core kernels where the chunk run is 64
# or 128 and N a multiple of 64 (s = 64 runs L = 64; chunk 128 at
# s = 2048), the FMA kernels elsewhere (chunk 32 and 256, s = 1000's
# L = 8, N 16).
@pytest.mark.parametrize("chunk", [32, 128, 256])
@pytest.mark.parametrize("s", [64, 1000, 2048])
@pytest.mark.parametrize("p,n", [(32, 16), (32, 64), (32, 128), (64, 16),
                                 (64, 64), (64, 128)])
def test_ssd_scan_kernel_branches(cuda, p, n, s, chunk):
    for g, model_a in ((2, False), (1, True)):
        x, dt, A, B, C = _ssd_inputs(1, s, 4, p, g, n, cuda,
                                     s + p + n + chunk, model_a)
        n0 = ssd_ops.ssd_scan.launches
        y, hT = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd_ops.ssd_scan.launches == n0 + 1
        assert torch.isfinite(y).all() and torch.isfinite(hT).all()
        y_ref, h_ref = ssd_ref.ssd_ref(x, dt, A, B, C)
        tc = _on_tensor_cores(s, chunk, n)
        _ssd_close(y, y_ref, tc)
        _ssd_close(hT, h_ref, tc)


@pytest.mark.parametrize("p,n", [(32, 16), (32, 32), (64, 64)])
def test_ssd_scan_kernel_other_widths(cuda, p, n):
    x, dt, A, B, C = _ssd_inputs(2, 96, 4, p, 2, n, cuda, p + n)
    y, hT = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=32)
    y_ref, h_ref = ssd_ref.ssd_ref(x, dt, A, B, C)
    _ssd_close(y, y_ref)
    _ssd_close(hT, h_ref)


def test_ssd_scan_kernel_refuses_autograd_and_rejects(cuda):
    x, dt, A, B, C = _ssd_inputs(1, 64, 2, 64, 1, 128, cuda, 0)
    with pytest.raises(RuntimeError, match="forward-only"):
        ssd_ops.ssd_scan(x.requires_grad_(True), dt, A, B, C)
    with torch.no_grad():                      # inference: no gradient
        assert ssd_ops.ssd_scan(x, dt, A, B, C)[0].shape == x.shape
    x = x.detach()
    with pytest.raises(ValueError, match="float32"):
        ssd_ops.ssd_scan(x.bfloat16(), dt, A, B, C)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_ops.ssd_scan(x[..., :48], dt, A, B, C)


def test_mamba2_forward_pallas_equals_jnp_on_the_card(cuda):
    """Reduced mamba2: forward through the kernel ("pallas": one launch
    per layer) against the plain chunked scan ("jnp"), both on the card."""
    cfg = dataclasses.replace(
        configs.reduced_config(configs.get_config("mamba2-1.3b")),
        attention_impl="pallas", activation_dtype=torch.float32)
    model = M.init(cfg, 0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda)
    with torch.no_grad():
        n0 = ssd_ops.ssd_scan.launches
        got, _ = M.forward(model, cfg, tokens)
        assert ssd_ops.ssd_scan.launches == n0 + cfg.n_layers
        want, _ = M.forward(model, dataclasses.replace(
            cfg, attention_impl="jnp"), tokens)
        assert ssd_ops.ssd_scan.launches == n0 + cfg.n_layers
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **TOL32)


def test_hybrid_forward_pallas_equals_jnp_on_the_card(cuda):
    """Reduced zamba2 (7 mamba layers, the shared block twice): forward
    through K4 (7 launches a call) and K2 (2) against the plain chunked
    scan and attention, both on the card."""
    cfg = dataclasses.replace(
        configs.reduced_config(configs.get_config("zamba2-1.2b")),
        attention_impl="pallas", activation_dtype=torch.float32)
    model = M.init(cfg, 0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda)
    with torch.no_grad():
        s0, f0 = ssd_ops.ssd_scan.launches, fa_ops.flash_attention.launches
        got, _ = M.forward(model, cfg, tokens)
        assert ssd_ops.ssd_scan.launches == s0 + 7
        assert fa_ops.flash_attention.launches == f0 + 2
        want, _ = M.forward(model, dataclasses.replace(
            cfg, attention_impl="jnp"), tokens)
        assert ssd_ops.ssd_scan.launches == s0 + 7
        assert fa_ops.flash_attention.launches == f0 + 2
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **TOL32)


def test_flash_attention_kernel_hybrid_width(cuda):
    """K2 bf16 at zamba2's shared-block width: D 64, G 1, 32 heads, 2048
    tokens (the card tests above stop at 1000 tokens for G 1, D 64)."""
    q, k, v = _qkv(1, 2048, 2048, 32, 32, 64, torch.bfloat16, cuda, 64)
    _flash_check(q, k, v, torch.bfloat16)


def test_dense_generate_fast_prefill_equals_loop_on_the_card(cuda):
    """Reduced qwen3 in f32: the fast prefill (one forward_prefill, K2 once
    per layer) ring-filled against the token-by-token loop (no kernel):
    last-token logits and the ring; then generate runs with each."""
    from repro_torch.launch import serve as S
    cfg = dataclasses.replace(
        configs.reduced_config(configs.get_config("qwen3-0.6b")),
        activation_dtype=torch.float32)
    model = M.init(cfg, 0, device=cuda)
    prompts = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda)
    with torch.no_grad():
        f0 = fa_ops.flash_attention.launches
        fl, fc = S.prefill_cache(cfg, model, prompts, cache_len=32)
        assert fa_ops.flash_attention.launches == f0 + cfg.n_layers
        ll, lc = S.prefill_cache(cfg, model, prompts, cache_len=32,
                                 mode="loop")
        assert fa_ops.flash_attention.launches == f0 + cfg.n_layers
    for got, want in ((fl, ll), (fc["kv"].k, lc["kv"].k),
                      (fc["kv"].v, lc["kv"].v)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **TOL32)
    a, b = (S.generate(cfg, model, prompts, max_new=8, cache_len=32,
                       temperature=0.0, prefill=mode, device=cuda)
            for mode in ("auto", "loop"))
    for out in (a, b):
        assert out.shape == (2, 32) and torch.equal(out[:, :24], prompts)
        assert ((0 <= out) & (out < cfg.vocab_size)).all()
