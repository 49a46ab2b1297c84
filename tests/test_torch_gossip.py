"""PyTorch port parity: the single-process gossip engine.  Every static
family at n = 8 mixes like the JAX package (its Pallas combine in
interpret mode) over one period; every mix preserves the global mean;
Lemma 1 holds at n in {8, 16}.  Tolerances: f32 leaves 1e-5 (the
reference's own, tests/test_gossip.py); bf16 leaves 2e-2 (one bf16
rounding of the f32 combine, tests/test_kernels.py:15)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flatbuf as JF, gossip as JG, topology as JT
from repro_torch.core import flatbuf as TF, gossip as TG, topology as TT
from repro_torch.launch import mesh_check as MC

TOL32 = dict(rtol=1e-5, atol=1e-5)
TOLBF = dict(rtol=2e-2, atol=2e-2)
STATIC = sorted(set(TT.TOPOLOGIES) - {"random_match"})


@pytest.fixture
def jax_interpret():
    """Drive the JAX combine through its Pallas kernel (interpret mode);
    restore "auto" afterwards."""
    JG.set_pallas_mode("interpret")
    yield
    JG.set_pallas_mode("auto")


def _np_tree(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((n, 8, 16)).astype(np.float32),
            "b": rng.standard_normal((n, 4)).astype(np.float32),
            "h": rng.standard_normal((n, 3, 5)).astype(np.float32)}


def _pair(n, seed=0, bf16=("h",)):
    t = _np_tree(n, seed)
    jt = {k: jnp.asarray(v).astype(jnp.bfloat16 if k in bf16 else jnp.float32)
          for k, v in t.items()}
    tt = {k: torch.from_numpy(v).to(torch.bfloat16 if k in bf16
                                    else torch.float32)
          for k, v in t.items()}
    return jt, tt


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(tgot, jgot, bf16=("h",)):
    for k in tgot:
        np.testing.assert_allclose(_f32(tgot[k]), _f32(jgot[k]),
                                   **(TOLBF if k in bf16 else TOL32))


@pytest.mark.parametrize("name", STATIC)
def test_static_family_mixes_like_jax(name, jax_interpret):
    n = 8
    jtop, ttop = JT.get_topology(name, n), TT.get_topology(name, n)
    jt, tt = _pair(n, seed=len(name))
    for k in range(jtop.period):
        jt = JG.mix(jt, jtop, k)
        tt = TG.mix(tt, ttop, k)
        _close(tt, jt)


@pytest.mark.parametrize("name", STATIC)
def test_global_mean_is_preserved(name):
    n = 8
    top = TT.get_topology(name, n)
    _, tree = _pair(n, seed=2, bf16=())
    for step in range(2 * top.period):
        out = TG.mix(tree, top, step)
        for k in tree:
            np.testing.assert_allclose(out[k].mean(0).numpy(),
                                       tree[k].mean(0).numpy(), **TOL32)
        tree = out


@pytest.mark.parametrize("n", [8, 16])
def test_one_peer_period_reaches_consensus(n):
    """Lemma 1 at the tree level: after tau mixes all nodes are equal (the
    check of tests/test_gossip.py:67-76)."""
    top = TT.one_peer_exponential(n)
    _, tree = _pair(n, seed=3, bf16=())
    for step in range(int(math.log2(n))):
        tree = TG.mix(tree, top, step)
    for leaf in tree.values():
        avg = leaf.mean(0, keepdim=True).expand(leaf.shape)
        np.testing.assert_allclose(leaf.numpy(), avg.numpy(), **TOL32)


def test_matching_fixed_points_are_bit_exact():
    partner = (1, 0, 2, 4, 3, 5)                   # nodes 2 and 5 stay put
    _, tree = _pair(6, seed=4)
    out = TG.mix_matching(tree, partner, 0.3)
    for k in tree:
        for i in (2, 5):
            assert torch.equal(out[k][i], tree[k][i])
    W = TT.Matching(partner, 0.3).dense(6)
    dense = TG.mix_dense(tree, W)
    for k in ("w", "b"):
        np.testing.assert_allclose(out[k].numpy(), dense[k].numpy(), **TOL32)


def test_kernel_mode_off_matches_auto_and_validates():
    top = TT.static_exponential(8)
    _, tree = _pair(8, seed=5)
    auto = TG.mix(tree, top, 0)
    TG.set_kernel_mode("off")
    try:
        off = TG.mix(tree, top, 0)
    finally:
        TG.set_kernel_mode("auto")
    for k in tree:
        assert torch.equal(auto[k], off[k])
    with pytest.raises(ValueError):
        TG.set_kernel_mode("interpret")


@pytest.mark.parametrize("name", ["one_peer_exp", "static_exp", "base_k",
                                  "full", "one_peer_hypercube"])
def test_gossip_spec_matches_jax(name):
    n = 8
    jtop, ttop = JT.get_topology(name, n), TT.get_topology(name, n)
    jt, tt = _pair(n)
    for k in range(jtop.period):
        js = JG.gossip_spec(jtop, k, JF.layout_of(jt))
        ts = TG.gossip_spec(ttop, k, TF.layout_of(tt))
        for key in ("kind", "rounds", "wire_multiplier", "dtype_groups",
                    "collectives_per_step", "shifts", "paired_nodes",
                    "fanin"):
            assert ts.get(key) == js.get(key), key


@pytest.mark.parametrize("name", ["one_peer_exp", "one_peer_hypercube",
                                  "base_k", "ceca", "static_exp"])
def test_mix_switch_matches_mix(name):
    """mix_switch(step) == mix(step % period) at every step of two periods,
    with the step an int or a 0-d tensor (mirrors tests/test_gossip.py:
    79-88 and the periodic half of :129-148)."""
    n = 8
    top = TT.get_topology(name, n)
    _, tree = _pair(n, seed=8)
    for step in range(2 * top.period):
        want = TG.mix(tree, top, step % top.period)
        for s in (step, torch.tensor(step)):
            got = TG.mix_switch(tree, top, s)
            for k in tree:
                assert torch.equal(got[k], want[k])


def test_mix_switch_typed_aperiodic_error(tmp_path):
    """Aperiodic schedules raise the typed error naming the schedule, as
    the reference's (tests/test_gossip.py:129-139).  With mesh= a periodic
    one mixes: on a world of one rank (node extent 1, all 8 nodes on the
    rank) the gathered global path, bit for bit the no-mesh mix."""
    tree = {"x": torch.zeros(8, 4)}
    for top in (TT.bipartite_random_match(8),
                TT.bipartite_random_match(8, pool=3),
                TT.one_peer_exponential(8, schedule="random_perm"),
                TT.one_peer_exponential(8, schedule="uniform")):
        with pytest.raises(TG.AperiodicScheduleError,
                           match=type(top.schedule).__name__):
            TG.mix_switch(tree, top, 0)
    _, tree = _pair(8, seed=5)
    top = TT.one_peer_exponential(8)
    with MC.one_rank_mesh(tmp_path) as mesh:
        got = TG.mix_switch(tree, top, 2, mesh=mesh)
        assert mesh.log.counts() == {"all_gather": 2}   # f32 + bf16 groups
    want = TG.mix_switch(tree, top, 2)
    for k in tree:
        assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("kind", ["random_match", "uniform"])
def test_aperiodic_stream_mixes_like_jax(kind, jax_interpret):
    """Ten steps of an aperiodic schedule mix like the reference's (the
    matching path's gather, or the uniform draw's shifts)."""
    n = 8
    if kind == "uniform":
        jtop = JT.one_peer_exponential(n, schedule="uniform", seed=1)
        ttop = TT.one_peer_exponential(n, schedule="uniform", seed=1)
    else:
        jtop = JT.bipartite_random_match(n, seed=1)
        ttop = TT.bipartite_random_match(n, seed=1)
    jt, tt = _pair(n, seed=9)
    for k in range(10):
        jt = JG.mix(jt, jtop, k)
        tt = TG.mix(tt, ttop, k)
        _close(tt, jt)


def test_later_slices_raise(tmp_path):
    """int8 (slice C item 8) now mixes, bit for bit the reference's int8
    round; an unknown wire format is a ValueError; mesh= (item 18) now
    mixes too: a matching on a one-rank world, int8 included, is bit for
    bit the no-mesh round."""
    jt, tree = _pair(4)
    got = TG.mix_shifts(tree, 0.5, [(1, 0.5)], compression="int8")
    want = JG.mix_shifts(jt, 0.5, [(1, 0.5)], compression="int8")
    for k in got:
        np.testing.assert_array_equal(_f32(got[k]), _f32(want[k]))
    with pytest.raises(ValueError, match="unknown compression"):
        TG.mix_shifts(tree, 0.5, [(1, 0.5)], compression="fp8")
    with MC.one_rank_mesh(tmp_path) as mesh:
        for comp in (None, "int8"):
            got = TG.mix_matching(tree, (1, 0, 3, 2), 0.5, comp, mesh)
            want = TG.mix_matching(tree, (1, 0, 3, 2), 0.5, comp)
            for k in got:
                assert torch.equal(got[k], want[k])


def test_bf16_tree_mixes_in_f32():
    """A bf16 group is combined in f32 and cast once, like the reference
    (checked against jax on a degree-3 static exponential round)."""
    jt, tt = _pair(8, seed=6, bf16=("w", "b", "h"))
    jtop, ttop = JT.static_exponential(8), TT.static_exponential(8)
    got = TG.mix(tt, ttop, 0)
    want = jax.tree.map(np.asarray, JG.mix(jt, jtop, 0))
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    _close(got, want, bf16=("w", "b", "h"))
