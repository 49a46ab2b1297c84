"""PyTorch port parity: the topology IR and the spectral analysis are copies
of the JAX package's numpy modules, so every family realizes the SAME
matrices (compared exactly) and the same spectral quantities.  The
aperiodic schedules (random_match, pooled or not, and the uniform
one-peer order) draw with numpy on both sides, so every realization is
bit-identical for the same (n, seed, step)."""
import numpy as np
import pytest
import torch

from repro.core import spectral as JS, topology as JT
from repro_torch.core import spectral as TS, topology as TT

NS = [4, 8, 9, 16]
FAMILIES = sorted(JT.TOPOLOGIES)


def _build(mod, name, n):
    try:
        return mod.get_topology(name, n), None
    except (ValueError, NotImplementedError) as e:
        return None, e


def test_same_family_registry():
    assert sorted(TT.TOPOLOGIES) == FAMILIES


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", FAMILIES)
def test_weights_equal_over_one_period(name, n):
    jt, jerr = _build(JT, name, n)
    tt, terr = _build(TT, name, n)
    if jerr is not None:                 # e.g. hypercube needs n = 2^tau
        assert type(terr) is type(jerr)
        return
    assert terr is None
    assert (tt.name, tt.n, tt.max_degree, tt.period) == \
        (jt.name, jt.n, jt.max_degree, jt.period)
    assert sorted(t.__name__ for t in tt.realization_types()) == \
        sorted(t.__name__ for t in jt.realization_types())
    steps = jt.period or 6               # random_match: aperiodic
    for k in range(steps):
        np.testing.assert_array_equal(tt.weights(k), jt.weights(k))
        assert tt.realization(k).structure_key() == \
            jt.realization(k).structure_key()
        W = jt.weights(k)
        assert TS.rho(W) == JS.rho(W)
        assert TS.spectral_gap(W) == JS.spectral_gap(W)
    np.testing.assert_array_equal(
        TS.consensus_residue_products(tt, 2 * steps),
        JS.consensus_residue_products(jt, 2 * steps))


def test_random_perm_schedule_matches():
    jt = JT.one_peer_exponential(16, schedule="random_perm", seed=3)
    tt = TT.one_peer_exponential(16, schedule="random_perm", seed=3)
    assert tt.name == jt.name and tt.period is None
    for k in range(12):
        np.testing.assert_array_equal(tt.weights(k), jt.weights(k))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", ["random_match", "random_match_pool3",
                                  "random_match_pool50", "uniform"])
def test_aperiodic_realizations_are_bit_identical(kind, seed, n):
    """Every step's realization of an aperiodic schedule, drawn by numpy
    on both sides, is the reference's (pairing or shift, and weights),
    including steps visited out of order (the uniform draw is stateful)."""
    if kind == "uniform":
        jt = JT.one_peer_exponential(n, schedule="uniform", seed=seed)
        tt = TT.one_peer_exponential(n, schedule="uniform", seed=seed)
    else:
        pool = (int(kind.removeprefix("random_match_pool"))
                if "pool" in kind else None)
        jt = JT.bipartite_random_match(n, seed=seed, pool=pool)
        tt = TT.bipartite_random_match(n, seed=seed, pool=pool)
        if pool is not None:
            assert [r.structure_key() for r in tt.realizations] == \
                [r.structure_key() for r in jt.realizations]
    assert isinstance(tt.schedule, TT.Aperiodic) and tt.period is None
    assert (tt.name, tt.max_degree) == (jt.name, jt.max_degree)
    assert sorted(t.__name__ for t in tt.realization_types()) == \
        sorted(t.__name__ for t in jt.realization_types())
    for k in [5, 0, 3] + list(range(40)) + [1000, 17]:
        tr, jr = tt.realization(k), jt.realization(k)
        assert type(tr).__name__ == type(jr).__name__
        assert tr.structure_key() == jr.structure_key()
        np.testing.assert_array_equal(tt.weights(k), jt.weights(k))
    with pytest.raises(TT.AperiodicScheduleError):
        tt.all_weights()
    with pytest.raises(TT.AperiodicScheduleError):
        tt.schedule.index(0)


def test_random_match_refuses_odd_n_and_empty_pool():
    with pytest.raises(ValueError, match="even n"):
        TT.bipartite_random_match(5)
    with pytest.raises(ValueError, match="pool"):
        TT.bipartite_random_match(8, pool=0)


def test_half_random_seed_matches():
    for seed in (0, 5):
        np.testing.assert_array_equal(TT.half_random(9, seed=seed).weights(0),
                                      JT.half_random(9, seed=seed).weights(0))


def test_later_slices_raise():
    """Runtime-valued nodes (tensor weights, ``Gated``) build, and refuse
    what the reference refuses: a concrete dense matrix, gating a gated
    or skipped round."""
    ws = torch.full((4,), 0.5)
    for r in (TT.Shifts(ws, ((1, 0.5),)), TT.Matching((1, 0, 3, 2), ws),
              TT.Gated(TT.Matching((1, 0, 3, 2)), torch.tensor(True))):
        assert r.traced
        with pytest.raises(ValueError, match="dense matrix"):
            r.dense(4)
    assert TT.Dense(torch.eye(4)).traced
    with pytest.raises(TypeError):
        TT.Gated(TT.IDENTITY, torch.tensor(True))
    with pytest.raises(ValueError, match="involution"):
        TT.Matching((1, 2, 0))


def test_lemma1_products_vanish():
    """Lemma 1 on the copied IR: one-peer exponential at n = 2^tau hits
    the exact average after tau rounds (residue at float64 rounding)."""
    for n in (8, 16):
        res = TS.consensus_residue_products(TT.one_peer_exponential(n), 6)
        tau = int(np.log2(n))
        assert res[tau - 1] < 1e-12 and res[0] > 0.1
