"""PyTorch port parity: training the ssm and hybrid families through the
driver's path.  Reduced mamba2-1.3b (d_adamw over random_match) and
reduced zamba2-1.2b (7 layers, two shared-block applications; qg_dmsgd
over the one-peer graph) take 2 steps of ``make_train_step`` through
``build_trainer`` on both sides, from the same numpy weights and the same
``SyntheticLM`` batches, in f32 activations, and agree within 2e-4 (the
reference's f32 tolerance, tests/test_kernels.py:16) on the losses, the
params, every momentum slot and the consensus distance; the plan's
counters are equal.  Then the driver trains both families on the CPU:
the loss falls and the consensus stays finite.

The driver runs hold torch to one CPU thread: under the test runner's
parallel workers its default (one thread a core) oversubscribes the
cores, and these short-op models then run dozens of times slower."""
import numpy as np
import pytest
import torch

from repro_torch.launch import train as TTrain
from test_torch_train import _check_state, _draw_params, _train_both


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("arch,optimizer,topology", [
    ("mamba2-1.3b", "d_adamw", "random_match"),
    ("zamba2-1.2b", "qg_dmsgd", "one_peer_exp")])
def test_ssm_and_hybrid_train_steps_match_jax(arch, optimizer, topology,
                                              one_thread):
    """``make_train_step`` through ``build_trainer`` for the ssm and hybrid
    families (the train path: ``ssd_chunked`` and the plain attention),
    f32 activations, 2 steps, 2e-4."""
    n, steps = 4, 2
    tcfg, tol, losses, (jx, js, jplan), (tx, ts, tplan) = _train_both(
        _draw_params(arch), "f32", n, steps=steps, arch=arch,
        optimizer=optimizer, topology=topology)
    if arch == "zamba2-1.2b":
        assert tcfg.n_layers >= 6 and tcfg.n_layers // \
            tcfg.shared_attn_every == 2         # two shared-block calls
    got, want = zip(*losses)
    np.testing.assert_allclose(got, want, **tol)
    _check_state(tcfg, tol, tx, ts, jx, js)
    assert tplan.num_compiled == jplan.num_compiled
    assert tplan.cache_stats() == jplan.cache_stats()


@pytest.mark.parametrize("argv", [
    ["--arch", "mamba2-1.3b", "--optimizer", "d_adamw", "--topology",
     "random_match", "--lr", "0.01"],
    ["--arch", "zamba2-1.2b", "--optimizer", "qg_dmsgd", "--lr", "0.3"]])
def test_driver_trains_ssm_and_hybrid(argv, one_thread):
    """The driver on the CPU: 16 steps of 4 x 64 tokens a node, the loss
    falls (mean of the last 3 against the first 3) and the consensus
    distance stays finite."""
    out = TTrain.run(TTrain.parse_args(argv + [
        "--device", "cpu", "--nodes", "4", "--steps", "16", "--batch", "4",
        "--seq", "64", "--warmup", "2", "--log-every", "1"]))
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 16 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.1
    assert all(np.isfinite(h["consensus"]) for h in out["history"])
