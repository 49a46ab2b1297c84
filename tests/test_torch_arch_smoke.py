"""Per-architecture smoke tests of the PyTorch port, the analogue of
tests/test_arch_smoke.py on the port alone: on the REDUCED config of each
of the ten configs (``repro_torch.configs.reduced_config``), B 2 and S
16, on the CPU:

* one forward: logits of the expected shape, finite, a finite aux loss;
* one DmSGD train step over a 4-node one-peer exponential graph with
  stacked replicas (two updates; the parameters change);
* one decode step, which modifies the cache;
* token-by-token decode reproducing the full forward within the
  reference's 2e-2.

Parity with the JAX package is tests/test_torch_arch_parity.py's."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import optim, topology
from repro_torch.models import model as M

ARCH_IDS = [
    "mamba2-1.3b", "granite-34b", "musicgen-large", "gemma2-27b",
    "llama-3.2-vision-90b", "zamba2-1.2b", "qwen3-0.6b",
    "granite-moe-3b-a800m", "deepseek-67b", "dbrx-132b",
]

B, S = 2, 16


def _inputs(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    frame = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    tokens = torch.randint(0, cfg.vocab_size, (B, S) + frame, generator=g)
    img = (torch.randn((B, cfg.n_image_tokens, cfg.d_model), generator=g)
           if cfg.family == "vlm" else None)
    return tokens, img


def _logits_shape(cfg, s):
    if cfg.family == "audio":
        return (B, s, cfg.n_codebooks, cfg.vocab_size)
    return (B, s, cfg.vocab_size)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: under xdist every worker's default thread
    count oversubscribes the cores, and these small ops slow ~40x."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def arch_state():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = configs.reduced_config(configs.get_config(arch))
            cache[arch] = (cfg, M.init(cfg, 0, device="cpu"))
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_shapes_no_nan(arch, arch_state):
    cfg, params = arch_state(arch)
    tokens, img = _inputs(cfg, 1)
    with torch.no_grad():
        logits, aux = M.forward(params, cfg, tokens, image_embeds=img)
    assert tuple(logits.shape) == _logits_shape(cfg, S)
    assert torch.isfinite(logits.float()).all()
    assert torch.isfinite(aux)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_no_nan(arch, arch_state):
    """One full DmSGD train step over a 4-node one-peer exponential graph
    with stacked replicas: every node's gradient of the reference smoke
    test's loss (next-token CE in f32 plus 0.01 aux, the forward as
    configured), then two updates -- Algorithm 1 uses the OLD momentum in
    the x-update, so step 0 only loads the momentum buffer."""
    cfg, params = arch_state(arch)
    n = 4
    opt = optim.dmsgd(topology.one_peer_exponential(n), beta=0.9)
    stacked = {k: v.detach().expand((n,) + tuple(v.shape)).clone()
               for k, v in params.named_parameters()}
    tokens, img = _inputs(cfg, 2)

    def loss_fn(leaves):
        logits, aux = M.forward(M.params_view(leaves), cfg, tokens,
                                image_embeds=img)
        labels = torch.roll(tokens, -1, 1).reshape(-1)
        lp = torch.log_softmax(logits.reshape(-1, cfg.vocab_size).float(),
                               -1)
        ce = -lp.gather(1, labels[:, None]).mean()
        return ce + 0.01 * aux

    grads = {k: torch.empty_like(v) for k, v in stacked.items()}
    for i in range(n):
        leaves = {k: v[i].clone().requires_grad_(True)
                  for k, v in stacked.items()}
        g = torch.autograd.grad(loss_fn(leaves), list(leaves.values()),
                                allow_unused=True)
        for k, gk in zip(leaves, g):
            grads[k][i] = 0.0 if gk is None else gk
    state = opt.init(stacked)
    new, state = opt.update(stacked, state, grads, 0, 1e-3)
    new, state = opt.update(new, state, grads, 1, 1e-3)
    for leaf in new.values():
        assert torch.isfinite(leaf.float()).all()
    assert max(float((new[k] - stacked[k]).abs().max())
               for k in stacked) > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step(arch, arch_state):
    cfg, params = arch_state(arch)
    cache = M.init_cache(cfg, batch=B, cache_len=32, device="cpu")
    before = [t.clone() for t in _leaves(cache)]
    frame = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    tok = torch.zeros((B, 1) + frame, dtype=torch.long)
    img = (torch.ones((B, cfg.n_image_tokens, cfg.d_model))
           if cfg.family == "vlm" else None)
    with torch.no_grad():
        logits, cache2 = M.decode_step(params, cfg, tok, cache, 0,
                                       image_embeds=img)
    assert tuple(logits.shape) == _logits_shape(cfg, 1)
    assert torch.isfinite(logits.float()).all()
    # the cache got modified (in place, as the port's decode writes)
    d = [float((a.float() - b.float()).abs().max())
         for a, b in zip(_leaves(cache2), before)]
    assert max(d) > 0


def _leaves(cache: dict) -> list:
    return [t for part in cache.values() for t in part]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_prefill(arch, arch_state):
    """Token-by-token decode reproduces the full-sequence forward logits."""
    cfg, params = arch_state(arch)
    cfg = dataclasses.replace(cfg, remat=False)
    tokens, img = _inputs(cfg, 3)
    with torch.no_grad():
        full, _ = M.forward(params, cfg, tokens, image_embeds=img)
        cache = M.init_cache(cfg, batch=B, cache_len=S, dtype=torch.float32,
                             device="cpu")
        outs = [M.decode_step(params, cfg, tokens[:, t:t + 1], cache, t,
                              image_embeds=img)[0] for t in range(S)]
    dec = torch.cat(outs, 1)
    np.testing.assert_allclose(dec.float().numpy(), full.float().numpy(),
                               rtol=2e-2, atol=2e-2)
