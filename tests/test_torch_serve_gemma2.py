"""PyTorch port parity: the paged serving engine on reduced gemma2-27b --
its local (windowed) and global layers alternating, the attention softcap
50 and the final softcap 30 after the tied, sqrt(d)-scaled embedding --
against the JAX package's ``ServeEngine``.  The window is cut to 8 on
both sides (as tests/test_torch_generate.py does), so that it bites
inside ``max_seq`` in the prefill and in every decode step.  f32
activations and pool, the JAX weights carried across by
``params_from_jax``.  The reference runs its ``attention_impl="jnp"``
path: its ``"pallas"`` prefill raises on gemma2 (the traced per-layer
window reaches a ``pallas_call``,
src/repro/kernels/flash_attention/kernel.py:31).

The engines' greedy tokens must be equal and the logits of every sampled
step agree within 2e-4 of the reference's max-abs (tests/test_kernels.py:
16); the compile-cache counters and page statistics too."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.serve import ServeEngine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models import model as TM
from repro_torch.serve import ServeEngine

WINDOW = 8
TOL = 2e-4                     # x the reference's max-abs, f32
PROMPT_LENS = (5, 11, 14, 20)  # three of them past the window
MAX_NEW = 8


@pytest.fixture(scope="module")
def setup():
    upd = dict(sliding_window=WINDOW, activation_dtype=jnp.float32)
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config("gemma2-27b")), **upd)
    upd["activation_dtype"] = torch.float32
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config("gemma2-27b")), **upd)
    jparams = JM.init(jcfg, jax.random.key(0))
    model = TM.Model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          tcfg))
    return jcfg, jparams, tcfg, model


def _record(engine):
    """Wrap ``engine._sample`` to keep every sampled step's logits row,
    keyed by (request id, tokens generated before it)."""
    rows, sample = {}, engine._sample

    def wrapped(logits_row, req):
        rows[(req.rid, len(req.generated))] = np.asarray(logits_row,
                                                         np.float32)
        return sample(logits_row, req)

    engine._sample = wrapped
    return rows


def test_config_keeps_gemma2_features(setup):
    jcfg, _, tcfg, _ = setup
    for cfg in (jcfg, tcfg):
        assert cfg.local_global and cfg.tie_embeddings
        assert (cfg.sliding_window, cfg.attn_softcap, cfg.final_softcap) == (
            WINDOW, 50.0, 30.0)
        assert cfg.mlp_kind == "geglu" and cfg.n_layers == 2
    # layer 0 local (windowed), layer 1 global
    assert [TM._effective_window(tcfg, i) for i in range(2)] == [WINDOW,
                                                                 None]


def test_engine_greedy_and_logits_match_jax(setup):
    jcfg, jparams, tcfg, model = setup
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, (p,)) for p in PROMPT_LENS]
    kw = dict(n_pages=64, page_size=4, max_seq=32, max_batch=4,
              prefill_token_budget=64, temperature=0.0)
    jeng = JaxEngine(jcfg, jparams, pool_dtype=jnp.float32, **kw)
    teng = ServeEngine(tcfg, model, pool_dtype=torch.float32, device="cpu",
                       **kw)
    jrows, trows = _record(jeng), _record(teng)
    jreqs = [jeng.submit(p, max_new=MAX_NEW) for p in prompts]
    treqs = [teng.submit(p, max_new=MAX_NEW) for p in prompts]
    jeng.run()
    teng.run()
    assert len(teng.finished) == len(PROMPT_LENS)
    for a, b in zip(treqs, jreqs):
        assert len(a.generated) == MAX_NEW
        assert [int(x) for x in a.generated] == [int(x) for x in b.generated]
    assert set(trows) == set(jrows) and len(trows) == 4 * MAX_NEW
    scale = max(np.abs(r).max() for r in jrows.values())
    err = max(np.abs(trows[k] - jrows[k]).max() for k in jrows)
    assert err <= TOL * scale, (err, scale)
    # the final softcap bounds every logit by 30
    assert scale < 30.0
    assert teng.compile_cache.stats() == jeng.compile_cache.stats()
    st, jst = teng.stats(), jeng.stats()
    for key in ("steps", "decoded_tokens", "peak_pages", "peak_kv_bytes"):
        assert st[key] == jst[key], key


def test_window_changes_the_served_logits(setup):
    """The cut window bites: the same engine on the same weights with every
    layer global gives other logits on the long prompts."""
    _, _, tcfg, model = setup
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, tcfg.vocab_size, (PROMPT_LENS[-1],))
    out = {}
    for name, cfg in (("local", tcfg), ("global", dataclasses.replace(
            tcfg, sliding_window=None))):
        eng = ServeEngine(cfg, model, n_pages=16, page_size=4, max_seq=32,
                          max_batch=1, pool_dtype=torch.float32,
                          device="cpu")
        out[name] = _record(eng)
        eng.submit(prompt, max_new=2)
        eng.run()
    diff = max(np.abs(out["local"][k] - out["global"][k]).max()
               for k in out["local"])
    scale = max(np.abs(r).max() for r in out["local"].values())
    assert diff > 100 * TOL * scale
