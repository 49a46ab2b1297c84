"""The port's counter of a step's work (``repro_torch.launch.cost``)
against the JAX package's ``launch/hlo_cost.py``, and the four kernel
wrappers on the meta device.

* ``tests/test_substrate.py``'s two ``hlo_cost`` checks on the port's
  per-layer loop: a forward within [1, 1.3] x 2 B D^2 L, a gradient with
  per-layer checkpointing within [3.5, 5.0] x L x 2 B D^2 (the
  reference's bounds), counted on the CPU and on meta alike.
* Reduced qwen3's forward: the matmul flops equal the analytic count
  exactly, and the total is within 15 % of ``analyze_hlo`` of the
  reference's jitted forward (XLA fuses, so its elementwise and byte
  counts part from an eager count; the 15 % is on flops only).
* A train step counted on the CPU and on meta: equal op by op (the chip
  check holds the card against meta the same way).
* Each kernel wrapper on meta returns its kernel's output shapes and
  dtypes, launches nothing, and under a count records exactly its
  formula; ``peak_bytes`` and the wire's link factors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro import configs as jconfigs
from repro.launch.hlo_cost import analyze_hlo
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.benchmarks.bench_kernels import flash_cost, ssd_cost
from repro_torch.core import gossip
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.gossip_mix import ops as gm_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.launch import mesh as MM
from repro_torch.launch import train as TTrain
from repro_torch.launch.cost import Cost
from repro_torch.launch.time_paged import cost as paged_cost
from repro_torch.models import model as TM

HLO_TOL = 0.15          # the port's flops against analyze_hlo's


def _draw(shape, device, seed=0):
    if device == "meta":
        return torch.empty(shape, device="meta")
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_forward_loop_flops(device):
    L, B, D = 7, 8, 64
    w, x = _draw((L, D, D), device), _draw((B, D), device, 1)
    with Cost() as c:
        y = x
        for layer in range(L):
            y = torch.tanh(y @ w[layer])
        y.sum()
    expect = 2 * B * D * D * L
    assert expect <= c.flops <= 1.3 * expect, (c.flops, expect)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_grad_with_per_layer_checkpointing(device):
    L, B, D = 5, 4, 32
    w = _draw((L, D, D), device).requires_grad_(True)
    x = _draw((B, D), device, 1)

    def body(c, wl):
        return torch.tanh(c @ wl)

    with Cost() as c:
        y = x
        for layer in range(L):
            y = checkpoint(body, y, w[layer], use_reentrant=False)
        torch.autograd.grad((y ** 2).sum(), w)
    per = 2 * B * D * D
    # forward + recomputed forward + 2x backward = 4x, and elementwise
    assert 3.5 * L * per <= c.flops <= 5.0 * L * per, (c.flops, L * per)
    # x needs no gradient: the first layer's input gradient is skipped
    assert c.by_op["mm"].calls == 4 * L - 1


def test_reduced_qwen3_forward_against_hlo_cost():
    upd = dict(remat=False)
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config("qwen3-0.6b")),
        activation_dtype=jnp.float32, **upd)
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config("qwen3-0.6b")),
        activation_dtype=torch.float32, **upd)
    B, S = 2, 64
    params = jax.eval_shape(lambda: JM.init(jcfg, jax.random.key(0)))
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    txt = jax.jit(lambda p, t: JM.forward(p, jcfg, t)[0]).lower(
        params, tok).compile().as_text()
    ref = analyze_hlo(txt)
    model = TM.init(tcfg, device="meta")
    with Cost() as c:
        TM.forward(model, tcfg, torch.empty((B, S), dtype=torch.int32,
                                            device="meta"))
    T, d, hd = B * S, tcfg.d_model, tcfg.head_dim
    H, Kv, f, V = tcfg.n_heads, tcfg.n_kv_heads, tcfg.d_ff, tcfg.vocab_size
    per_layer = (2 * T * d * hd * (2 * H + 2 * Kv)      # q, k, v, o
                 + 2 * 2 * B * H * S * S * hd           # q k^T, p v
                 + 3 * 2 * T * d * f)                   # swiglu
    analytic = tcfg.n_layers * per_layer + 2 * T * d * V
    matmul = sum(op.flops for name, op in c.by_op.items()
                 if name in ("mm", "bmm", "addmm", "baddbmm"))
    print(f"port {c.flops:.6e} flops ({matmul:.6e} in matmuls), "
          f"hlo_cost {ref.flops:.6e}, analytic matmuls {analytic:.6e}")
    assert matmul == analytic
    assert abs(c.flops - ref.flops) <= HLO_TOL * ref.flops


def test_train_step_counts_equal_on_cpu_and_meta():
    """A kernel-free DmSGD step of reduced qwen3 on 4 nodes (the combine's
    plain version) counted on the CPU and on meta: the same ops, flops
    and bytes; the chip check holds the card against meta so."""
    args = TTrain.parse_args(["--device", "cpu", "--nodes", "4", "--steps",
                              "2", "--batch", "2", "--seq", "16"])
    start = TTrain.prepare(args)
    opt, step_for = TTrain.build_trainer(
        start["config"], start["topology"], args.optimizer, args.beta,
        momentum_dtype=start["momentum_dtype"])
    params = {k: v.contiguous() for k, v in start["params"].items()}
    state, batch = opt.init(params), start["batches"][1]
    metas = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in params.items()}
    meta_state = opt.init(metas)
    meta_batch = {"tokens": batch["tokens"].to("meta")}
    with gossip.kernel_mode("off"):
        with Cost() as cpu:
            step_for(1)(params, state, batch, 0.1)
        with Cost() as meta:
            step_for(1)(metas, meta_state, meta_batch, 0.1)
    assert cpu.ops() == meta.ops()
    assert (cpu.flops, cpu.hbm_bytes, cpu.peak_bytes) == (
        meta.flops, meta.hbm_bytes, meta.peak_bytes)
    assert cpu.by_op["mm"].calls > 0 and cpu.flops > 0


def test_peak_bytes_follows_the_live_storages():
    with Cost() as c:
        a = torch.empty(1000, device="meta")        # 4000 bytes live
        b = a + 1                                   # 8000
        del a                                       # 4000
        d = b * 2                                   # 8000
        e = d.view(10, 100)                         # a view: no storage
        del b, d, e                                 # 0
        f = torch.zeros(3000, device="meta")        # 12000
    assert c.peak_bytes == 12000 and f.numel() == 3000
    assert c.by_op["add"].bytes == 8000 and c.by_op["add"].flops == 1000
    assert "view" not in c.by_op


def test_add_scales_and_to_dict():
    x = torch.empty((4, 8), device="meta")
    with Cost() as one:
        x.sum(-1)
    total = Cost()
    total.add(one, k=3)
    d = total.to_dict()
    assert d["flops"] == 3 * 4 * 4 and d["hbm_bytes"] == 3 * (128 + 16)
    assert total.by_op["sum"].calls == 3 and d["peak_bytes"] == 16
    assert set(d) == {"flops", "hbm_bytes", "collective_bytes",
                      "collective_counts", "total_collective_bytes",
                      "peak_bytes"}


def test_wire_link_factors():
    """The dry mesh's log read by ``add_wire`` with the reference's
    factors over (node 4, fsdp 2): permute 1x, all-reduce 2 (g - 1) / g,
    all-gather (g - 1) x the block."""
    mesh = MM.dry_mesh(MM.abstract_mesh((4, 2), ("node", "fsdp")), rank=0)
    x = torch.empty(256, device="meta")                      # 1024 bytes
    mesh.permute(x, [(0, 1), (1, 0)], "node")
    mesh.permute(x, [(1, 1)], "node")                         # sends none
    mesh.psum(x, "node")
    mesh.pmax(x, ("fsdp",))
    out = mesh.all_gather(x, "fsdp")
    assert tuple(out.shape) == (512,) and out.device.type == "meta"
    c = Cost()
    c.add_wire(mesh.log)
    assert dict(c.collective_counts) == {"collective-permute": 2,
                                         "all-reduce": 2, "all-gather": 1}
    assert dict(c.collective_bytes) == {
        "collective-permute": 1024.0,
        "all-reduce": 2 * 3 / 4 * 1024 + 2 * 1 / 2 * 1024,
        "all-gather": 1024.0}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _counted(fn, name):
    counters = (fa_ops.flash_attention, pa_ops.paged_attention,
                ssd_ops.ssd_scan, gm_ops.gossip_mix)
    before = [k.launches for k in counters]
    with Cost() as c:
        out = fn()
    assert [k.launches for k in counters] == before
    assert set(c.by_op) <= {name, "_to_copy"}
    return out, c


def test_flash_attention_on_meta():
    B, S, H, Kv, D = 2, 64, 8, 2, 32
    q, k = _meta(B, S, H, D, dtype=torch.bfloat16), _meta(
        B, S, Kv, D, dtype=torch.bfloat16)
    out, c = _counted(lambda: fa_ops.flash_attention(q, k, k, window=16),
                      "flash_attention")
    want = fa_ref.attention_ref(torch.zeros(B, S, H, D), torch.zeros(
        B, S, Kv, D), torch.zeros(B, S, Kv, D), window=16)
    assert out.shape == want.shape and out.dtype == torch.bfloat16
    flops, nbytes = flash_cost((B, S, H, Kv, D), 2, 16)
    assert (c.flops, c.hbm_bytes) == (flops, nbytes)
    assert c.by_op["flash_attention"].calls == 1


def test_paged_attention_on_meta():
    B, H, Kv, D, P, pmax = 3, 8, 2, 32, 4, 5
    q, pages = _meta(B, H, D), _meta(Kv, 16, P, D)
    table = _meta(B, pmax, dtype=torch.int32)
    lengths = _meta(B, dtype=torch.int32)
    out, c = _counted(lambda: pa_ops.paged_attention(
        q, pages, pages, table, lengths, window=12), "paged_attention")
    ln = np.full(B, pmax * P)                 # meta holds no lengths
    want = pa_ref.paged_attention_ref(
        torch.zeros(B, H, D), torch.zeros(Kv, 16, P, D),
        torch.zeros(Kv, 16, P, D), torch.zeros(B, pmax, dtype=torch.int32),
        torch.full((B,), pmax * P, dtype=torch.int32), window=12)
    assert out.shape == want.shape and out.dtype == torch.float32
    assert (c.flops, c.hbm_bytes) == paged_cost(ln, pmax, 4, (H, Kv, D), 12)


def test_ssd_scan_on_meta():
    b, s, h, p, g, n = 2, 64, 4, 16, 2, 8
    args = (_meta(b, s, h, p), _meta(b, s, h), _meta(h), _meta(b, s, g, n),
            _meta(b, s, g, n))
    (y, state), c = _counted(lambda: ssd_ops.ssd_scan(*args, chunk=32),
                             "ssd_scan")
    want_y, want_state = ssd_ref.ssd_ref(
        torch.zeros(b, s, h, p), torch.zeros(b, s, h), torch.zeros(h),
        torch.zeros(b, s, g, n), torch.zeros(b, s, g, n))
    assert y.shape == want_y.shape and state.shape == want_state.shape
    assert state.dtype == torch.float32
    assert (c.flops, c.hbm_bytes) == ssd_cost((b, s, h, p, g, n), 32)


def test_gossip_mix_on_meta():
    x = _meta(4, 1000)
    out, c = _counted(lambda: gm_ops.gossip_mix(x, [x, x], w_self=0.5,
                                                ws=(0.25, 0.25)),
                      "gossip_mix")
    assert out.shape == x.shape and out.dtype == x.dtype
    # two receives: 5 operations an element; 2 + 2 tensors of 16 kB
    assert (c.flops, c.hbm_bytes) == (5 * 4000, 4 * 16000)
    # no count active: the meta path still runs nothing
    assert gm_ops.gossip_mix(x, [x], w_self=0.5, ws=(0.5,)).device.type \
        == "meta"
