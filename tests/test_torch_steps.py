"""PyTorch port: the train step (``launch/steps.py``).  Micro-batch
accumulation against the JAX package's (one step of reduced qwen3, n = 4,
f32 activations, tolerance 2e-4 as tests/test_torch_train.py), and remat
(``torch.utils.checkpoint`` per layer) giving the same gradients as no
remat, bit for bit on the CPU."""
import dataclasses

import numpy as np
import torch

from repro_torch import configs as tconfigs
from repro_torch.convert import stacked_to_jax
from repro_torch.launch import steps as TSteps
from repro_torch.models import model as TM
from test_torch_train import _train_both, jax_params  # noqa: F401


def test_micro_batch_accumulation_matches_jax(jax_params):
    tcfg, tol, losses, (jx, _, _), (tx, _, _) = _train_both(
        jax_params, "f32", 4, steps=1, micro_batch=1)
    np.testing.assert_allclose(*zip(*losses), **tol)
    back = stacked_to_jax(tx, tcfg)
    np.testing.assert_allclose(back["layers"]["attn"]["wq"],
                               np.asarray(jx["layers"]["attn"]["wq"]), **tol)


def test_remat_gives_the_same_gradients():
    cfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-0.6b"))
    model = TM.init(cfg, 3, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)))
    grads = []
    for remat in (False, True):
        leaves = {k: p.detach().clone().requires_grad_(True)
                  for k, p in model.named_parameters()}
        loss = TSteps.train_loss_fn(
            TM.params_view(leaves), dataclasses.replace(cfg, remat=remat),
            tokens)
        grads.append(torch.autograd.grad(loss, list(leaves.values())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert all(float(g.abs().max()) > 0 for g in grads[0])
