"""PyTorch port parity: the topology IR and the spectral analysis are copies
of the JAX package's numpy modules, so every family realizes the SAME
matrices (compared exactly) and the same spectral quantities."""
import numpy as np
import pytest

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
    if name == "random_match":
        # aperiodic schedule: the port's slice C
        assert isinstance(terr, NotImplementedError) and "slice C" in str(terr)
        return
    if jerr is not None:                 # e.g. hypercube needs n = 2^tau
        assert type(terr) is type(jerr)
        return
    assert terr is None
    assert (tt.name, tt.n, tt.max_degree, tt.period) == \
        (jt.name, jt.n, jt.max_degree, jt.period)
    assert sorted(t.__name__ for t in tt.realization_types()) == \
        sorted(t.__name__ for t in jt.realization_types())
    for k in range(jt.period):
        np.testing.assert_array_equal(tt.weights(k), jt.weights(k))
        assert tt.realization(k).structure_key() == \
            jt.realization(k).structure_key()
        W = jt.weights(k)
        assert TS.rho(W) == JS.rho(W)
        assert TS.spectral_gap(W) == JS.spectral_gap(W)
    np.testing.assert_array_equal(
        TS.consensus_residue_products(tt, 2 * jt.period),
        JS.consensus_residue_products(jt, 2 * jt.period))


def test_random_perm_schedule_matches():
    jt = JT.one_peer_exponential(16, schedule="random_perm", seed=3)
    tt = TT.one_peer_exponential(16, schedule="random_perm", seed=3)
    assert tt.name == jt.name and tt.period is None
    for k in range(12):
        np.testing.assert_array_equal(tt.weights(k), jt.weights(k))


def test_half_random_seed_matches():
    for seed in (0, 5):
        np.testing.assert_array_equal(TT.half_random(9, seed=seed).weights(0),
                                      JT.half_random(9, seed=seed).weights(0))


def test_later_slices_raise():
    with pytest.raises(NotImplementedError, match="slice C"):
        TT.one_peer_exponential(8, schedule="uniform")
    with pytest.raises(NotImplementedError, match="slice C"):
        TT.Shifts(np.zeros(4), ((1, 0.5),))          # a per-node weight
    with pytest.raises(ValueError, match="involution"):
        TT.Matching((1, 2, 0))


def test_lemma1_products_vanish():
    """Lemma 1 on the copied IR: one-peer exponential at n = 2^tau hits
    the exact average after tau rounds (residue at float64 rounding)."""
    for n in (8, 16):
        res = TS.consensus_residue_products(TT.one_peer_exponential(n), 6)
        tau = int(np.log2(n))
        assert res[tau - 1] < 1e-12 and res[0] > 0.1
