"""PyTorch port: int8 wire compression.

The port's int8 rounds against the JAX package's on the same numpy
inputs: bit for bit on small trees (the reference eager, op by op),
within the quantization bound of the full-precision mix (one int8 step,
``max|x| / 127``, times 0.51 plus 1e-6: the reference's own tolerance,
tests/test_gossip.py).  On a reduced-qwen3 and a reduced-zamba2 ``(m, x)``
payload converted with ``stacked_from_jax`` the scale groups are pinned:
one scale per (node, JAX leaf), the reference's scale values bit for
bit, the results equal where the quantized codes agree and otherwise off
by at most one quantum (``w x scale``) on fewer than 0.1 % of elements,
and ``gossip_spec``'s int8 scale bytes equal the reference's.  Fixed
points keep their full-precision value, the plan threads compression and
refuses it on dense regimes, and int8 with a runtime hook is the
reference's ``ValueError``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import flatbuf as JF, gossip as JG, optim as JO
from repro.core import topology as JT
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.convert import stacked_from_jax, stacked_to_jax
from repro_torch.core import flatbuf as TF, gossip as TG, optim as TO
from repro_torch.core import topology as TT
from repro_torch.core.plan import GossipPlan

SCHED_TOPS = [("ring", {}), ("static_exp", {}), ("one_peer_exp", {}),
              ("one_peer_exp", {"schedule": "random_perm"}),
              ("one_peer_exp", {"schedule": "uniform"})]


def _np_tree(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (2.7 * rng.standard_normal((n, 5, 3))).astype(np.float32),
            "b": rng.standard_normal((n, 4)).astype(np.float32),
            "h": rng.standard_normal((n, 3, 6)).astype(np.float32)}


def _pair(n, seed=0, bf16=("h",)):
    t = _np_tree(n, seed)
    jt = {k: jnp.asarray(v).astype(jnp.bfloat16 if k in bf16
                                   else jnp.float32) for k, v in t.items()}
    tt = {k: torch.from_numpy(v).to(torch.bfloat16 if k in bf16
                                    else torch.float32)
          for k, v in t.items()}
    return jt, tt


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bit_equal(got, want):
    for k in want:
        np.testing.assert_array_equal(_f32(got[k]), _f32(want[k]),
                                      err_msg=k)


def _step_bound(quant, exact, tree):
    for k in tree:
        step = float(np.abs(_f32(tree[k])).max()) / 127.0
        assert float(np.abs(_f32(quant[k]) - _f32(exact[k])).max()) \
            <= step * 0.51 + 1e-6, k


def _quadratic_problem(n, d, seed=0, hetero=0.3):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, d, d)) * 0.3 + np.eye(d)
    b = rng.standard_normal((n, d)) * hetero
    H = np.einsum("nij,nik->jk", A, A) / n
    x_star = np.linalg.solve(H, np.einsum("nij,ni->j", A, b) / n)
    return (torch.tensor(A, dtype=torch.float32),
            torch.tensor(b, dtype=torch.float32), x_star)


def test_int8_compressed_gossip():
    """One int8 one-peer round: bit for bit the reference's, within one
    int8 step of the exact mix; DmSGD with int8 converges on a quadratic
    (the reference's 2000 steps, error < 0.15)."""
    n = 8
    jtop, top = JT.one_peer_exponential(n), TT.one_peer_exponential(n)
    jt, tree = _pair(n, seed=9)
    quant = TG.mix(tree, top, 0, compression="int8")
    _bit_equal(quant, JG.mix(jt, jtop, 0, compression="int8"))
    _step_bound(quant, TG.mix(tree, top, 0), tree)

    A, b, x_star = _quadratic_problem(n, 5)
    opt = TO.dmsgd(top, beta=0.8, compression="int8")
    params = {"x": torch.zeros((n, 5))}
    state = opt.init(params)
    for k in range(2000):
        r = torch.einsum("nij,nj->ni", A, params["x"]) - b
        g = {"x": torch.einsum("nij,ni->nj", A, r)}
        params, state = opt.update(params, state, g, k, 0.02)
    err = float(np.linalg.norm(params["x"].mean(0).numpy() - x_star))
    assert err < 0.15, err


@pytest.mark.parametrize("name,kw", SCHED_TOPS)
def test_flat_int8_bit_identical_to_reference(name, kw, n=8):
    """int8 Shifts rounds of every neighbour-schedule family over five
    steps: bit for bit the reference's flat path and its historical
    per-leaf path (per-leaf scales)."""
    jtop = JT.get_topology(name, n, **kw)
    top = TT.get_topology(name, n, **kw)
    jt, tree = _pair(n, seed=5)
    for step in range(5):
        r, jr = top.realization(step), jtop.realization(step)
        got = TG.mix_shifts(tree, r.self_w, list(r.shifts), "int8")
        _bit_equal(got, JG.mix_shifts(jt, jr.self_w, list(jr.shifts),
                                      "int8"))
        _bit_equal(got, JG.mix_shifts_per_leaf(jt, jr.self_w,
                                               list(jr.shifts), "int8"))
        assert all(got[k].dtype == tree[k].dtype for k in tree)


def test_int8_fixed_points_keep_value_exactly():
    """An imperfect matching: fixed points keep their full-precision value
    bit for bit; paired nodes are quantized, within one int8 step."""
    partner = (1, 0, 2, 3)
    rng = np.random.default_rng(3)
    tree = {"w": torch.from_numpy(
        (rng.standard_normal((4, 9)) * 2.7).astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal((4, 3))
                              .astype(np.float32))}
    out = TG.mix_matching(tree, partner, 0.5, compression="int8")
    exact = TG.mix_matching(tree, partner, 0.5)
    for k in tree:
        assert torch.equal(out[k][2:], tree[k][2:])
        err = (out[k][:2] - exact[k][:2]).abs()
        assert float(err.max()) > 0.0
        step = float(tree[k].abs().max()) / 127.0
        assert float(err.max()) <= step * 0.51 + 1e-6


def test_matching_realization_int8_through_ir():
    """The same through mix_realization for w_self != 0.5 (where the
    blend is not exact in f32 and only the mask keeps the fixed point),
    bit for bit the reference's."""
    x = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    for w_self in (0.5, 0.3, 0.45):
        m = TT.Matching((2, 1, 0, 4, 3), w_self)
        jm = JT.Matching((2, 1, 0, 4, 3), w_self)
        for comp in (None, "int8"):
            out = TG.mix_realization({"x": torch.from_numpy(x)}, m,
                                     compression=comp)
            assert torch.equal(out["x"][1], torch.from_numpy(x[1]))
            if comp:
                _bit_equal(out, JG.mix_realization(
                    {"x": jnp.asarray(x)}, jm, compression=comp))


def test_gossip_spec_int8_splits_payload_and_scales():
    """int8 rounds move two buffers per dtype group (payload and scale
    rows); the byte counts are the reference's except the payload's
    padding (8 columns here, 8,192 there)."""
    shapes = {"w": (8, 130), "b": (8, 6), "h": (8, 10)}
    ttree = {k: torch.zeros(s, dtype=torch.bfloat16 if k == "h"
                            else torch.float32) for k, s in shapes.items()}
    jtree = {k: jnp.zeros(s, jnp.bfloat16 if k == "h" else jnp.float32)
             for k, s in shapes.items()}
    layout, jlayout = TF.layout_of(ttree), JF.layout_of(jtree)
    for top, jtop in ((TT.one_peer_exponential(8),
                       JT.one_peer_exponential(8)),
                      (TT.static_exponential(8), JT.static_exponential(8))):
        plain = TG.gossip_spec(top, 0, layout=layout)
        quant = TG.gossip_spec(top, 0, layout=layout, compression="int8")
        jquant = JG.gossip_spec(jtop, 0, layout=jlayout, compression="int8")
        assert plain["scale_bytes_per_node_per_step"] == 0
        for key in ("collectives_per_step", "scale_bytes_per_node_per_step",
                    "wire_multiplier", "rounds"):
            assert quant[key] == jquant[key], key
        assert quant["collectives_per_step"] == 2 * plain[
            "collectives_per_step"]
        assert quant["payload_bytes_per_node_per_step"] == quant[
            "wire_multiplier"] * sum(g.padded for g in layout.groups)
        assert quant["bytes_per_node_per_step"] == (
            quant["payload_bytes_per_node_per_step"]
            + quant["scale_bytes_per_node_per_step"])


def test_quantized_dmsgd_bit_identical(n=8):
    """quantize_int8() in the chain == the hand-written int8 DmSGD step
    (the mix of the (beta m + g, x - lr m) payload), bit for bit."""
    top = TT.one_peer_exponential(n)
    opt = TO.dmsgd(top, beta=0.8, compression="int8")
    assert opt.compression == "int8"
    _, p = _pair(n, seed=2, bf16=())
    s = opt.init(p)
    rp, rm = p, s.momentum
    for k in range(4):
        _, g = _pair(n, seed=200 + k, bf16=())
        p, s = opt.update(p, s, g, k, 0.05)
        pre_m = {i: 0.8 * rm[i] + g[i] for i in rm}
        pre_x = {i: rp[i] - 0.05 * rm[i] for i in rp}
        rm, rp = TG.mix((pre_m, pre_x), top, k, compression="int8")
        for i in p:
            assert torch.equal(p[i], rp[i]) and torch.equal(
                s.momentum[i], rm[i])


def test_plan_refuses_compression_on_dense_regimes(n=8):
    with pytest.raises(ValueError, match="dense matrices"):
        GossipPlan(TT.star(n), compression="int8")
    with pytest.raises(ValueError, match="dense matrices"):
        GossipPlan(TT.base_k(9, 2), compression="int8")
    opt = TO.dmsgd(TT.star(n), beta=0.9, compression="int8")
    x = {"x": torch.zeros((n, 3))}
    with pytest.raises(ValueError, match="dense matrices"):
        opt.update(x, opt.init(x), x, 0, 0.1)


def test_plan_int8_compression_threaded(n=8):
    """The plan carries the optimizer's compression into its executor;
    the warm-up rounds mix in full precision."""
    top = TT.one_peer_exponential(n)
    opt = TO.dmsgd(top, beta=0.9, compression="int8")
    plan = GossipPlan.for_optimizer(opt)
    assert plan.compression == "int8"
    _, tree = _pair(n, seed=6, bf16=())
    r = top.realization(0)
    _bit_equal(plan.mix(0)(tree), TG.mix_shifts(tree, r.self_w,
                                                list(r.shifts), "int8"))
    warm = GossipPlan(top, warmup_steps=1, compression="int8")
    _bit_equal(warm.mix(0)(tree), TG.mix(tree, TT.full_averaging(n), 0))


def test_plan_int8_compression_on_matchings(n=8):
    top = TT.one_peer_hypercube(n)
    _, tree = _pair(n, seed=6)
    quant = GossipPlan(top, compression="int8").mix(0)(tree)
    _step_bound(quant, GossipPlan(top).mix(0)(tree), tree)


def test_runtime_gossip_refuses_int8_compression(n=8):
    for mod, top in ((TO, TT.one_peer_exponential(n)),
                     (JO, JT.one_peer_exponential(n))):
        with pytest.raises(ValueError, match="int8"):
            mod.dmsgd(top, loss_aware=True, compression="int8")


# ---------------------------------------------------------------------------
# Model payloads: the scale groups are the reference's JAX leaves
# ---------------------------------------------------------------------------

def _payload(arch, n=4):
    """A node-stacked (m, x) payload of reduced ``arch`` in the JAX layout
    (numpy) and its port conversion."""
    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    shapes = jax.eval_shape(lambda: JM.init(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(1)

    def draw(s):
        scale = rng.uniform(0.05, 3.0)        # leaves of unlike magnitude
        return (scale * rng.standard_normal((n,) + s.shape)).astype(
            np.float32)

    m, x = jax.tree.map(draw, shapes), jax.tree.map(draw, shapes)
    return (m, x), (stacked_from_jax(m, tcfg), stacked_from_jax(x, tcfg)), \
        tcfg


def _jax_names(tree):
    """{(payload position, dotted JAX name): leaf index} of a (m, x)
    payload in the JAX layout."""
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {(p[0].idx, ".".join(str(k.key) for k in p[1:])): i
            for i, (p, _) in enumerate(paths)}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-1.2b"])
def test_model_payload_scales_follow_jax_leaves(arch):
    """One scale per (node, JAX leaf): the port's per-layer slots of one
    layer-stacked JAX leaf read one scale column, and its values are the
    reference's bit for bit; one int8 round agrees with the reference's
    where the codes agree and is off by at most one quantum elsewhere, on
    fewer than 0.1 % of elements; the spec's scale bytes are the
    reference's."""
    n = 4
    (jm, jx), tpay, tcfg = _payload(arch, n)
    jpay = jax.tree.map(jnp.asarray, (jm, jx))
    layout, jlayout = TF.layout_of(tpay), JF.layout_of(jpay)
    assert len(layout.groups) == len(jlayout.groups) == 1
    g, jg = layout.groups[0], jlayout.groups[0]
    assert len(g.scale_groups) == len(jg.slots) < len(g.slots)

    _, bufs = TF.pack(tpay, layout)
    sc = TG._scale_columns(bufs[0], g).numpy()
    jsc = np.asarray(JG._leaf_scales(jpay, jlayout)[0])
    names = _jax_names(jpay)
    for j, key in enumerate(g.scale_groups):
        np.testing.assert_array_equal(sc[:, j], jsc[:, names[key]],
                                      err_msg=str(key))
    np.testing.assert_array_equal(sc[:, -1], jsc[:, -1])

    top, jtop = TT.one_peer_exponential(n), JT.one_peer_exponential(n)
    r = top.realization(0)
    (s, w), = r.shifts
    got = TG.mix_realization(tpay, r, compression="int8")
    want = JG.mix_realization(jpay, jtop.realization(0), compression="int8")
    got = jax.tree.leaves(tuple(stacked_to_jax(t, tcfg) for t in got))
    want = [np.asarray(v) for v in jax.tree.leaves(want)]
    # the quantum of each (node, JAX leaf): the sender's scale times w
    quanta = w * np.roll(jsc, s, 0)
    differ = total = 0
    for i, (a, b) in enumerate(zip(got, want)):
        q = quanta[:, i].reshape((n,) + (1,) * (a.ndim - 1))
        d = np.abs(a - b)
        assert (d <= q * (1 + 1e-5) + 1e-6 * np.abs(b).max()).all(), i
        differ += int((d > 0).sum())
        total += d.size
    assert differ < 1e-3 * total, (differ, total)

    spec = TG.gossip_spec(top, 0, layout=layout, compression="int8")
    jspec = JG.gossip_spec(jtop, 0, layout=jlayout, compression="int8")
    assert spec["scale_bytes_per_node_per_step"] == \
        jspec["scale_bytes_per_node_per_step"] == 4 * (len(jg.slots) + 1)
