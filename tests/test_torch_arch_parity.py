"""PyTorch port parity on all ten configs: the reduced config of every
arch the reference registers (``ARCH_IDS`` and the one-thread fixture are
test_torch_arch_smoke.py's), the same numpy inputs on both sides and the
JAX weights carried across by ``params_from_jax``, f32 activations, held
at 2e-4 of the reference's max-abs (tests/test_kernels.py:16).  For each
config:

* the forward's logits and aux loss (the reference's default ``"jnp"``
  attention; vlm with image embeddings, audio with (B, S, K) frames);
* the logits of 4 ring-cache decode steps;
* for the paged families (``PAGED_FAMILIES``): ``forward_prefill`` (its
  logits and k/v) and 2 ``decode_step_paged`` steps over a page pool
  filled from it (the pool too);
* the params and momentum after DmSGD updates over
  ``one_peer_exponential(4)`` on the same numpy gradients.

``reduced_config`` caps the heads at 4, which loses the real query heads
per kv head.  Three more cases keep the real (H, Kv) at head_dim 16:
granite-34b (48, 1), G 48 over one kv head; deepseek-67b (64, 8), G 8;
dbrx-132b (48, 8), G 6 -- the GQA bookkeeping behind the kernels' GT = 8
launches on the card.

The weights are numpy draws at the JAX tree's shapes (nonzero norm scales
and vlm gates, so that neither hides a wrong conversion); the JAX
functions are jitted once per config and shared through a module-scoped
fixture."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import optim as JO, topology as JT
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax, stacked_from_jax, \
    stacked_to_jax
from repro_torch.core import optim as TO, topology as TT
from repro_torch.models import model as TM
from test_torch_arch_smoke import ARCH_IDS, one_thread  # noqa: F401

# the real (n_heads, n_kv_heads) at a narrow head: G 48, 8 and 6
GQA = {"granite-34b/g48": ("granite-34b", 48, 1),
       "deepseek-67b/g8": ("deepseek-67b", 64, 8),
       "dbrx-132b/g6": ("dbrx-132b", 48, 8)}
CASES = ARCH_IDS + list(GQA)
PAGED_CASES = [c for c in CASES
               if jconfigs.get_config(c.split("/")[0]).family
               in TM.PAGED_FAMILIES]
TOL = 2e-4                    # x the reference's max-abs, f32
B, S, PAGE, DECODE = 2, 16, 4, 4


def _cfgs(case):
    arch, upd = case, dict(activation_dtype=jnp.float32, remat=False)
    if case in GQA:
        arch, h, kv = GQA[case]
        upd.update(n_heads=h, n_kv_heads=kv, head_dim=16)
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config(arch)), **upd)
    upd["activation_dtype"] = torch.float32
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config(arch)), **upd)
    return jcfg, tcfg


def _draw(jcfg, seed=0):
    """Weights at the JAX tree's shapes, from numpy."""
    shapes = jax.eval_shape(lambda: JM.init(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = s.shape[-2] ** -0.5 if len(s.shape) >= 2 else 0.1
        return (scale * rng.standard_normal(s.shape)).astype(s.dtype)

    return jax.tree.map(draw, shapes)


class Pair:
    """One case's configs, weights on both sides and jitted JAX functions."""

    def __init__(self, case):
        self.jcfg, self.tcfg = jcfg, tcfg = _cfgs(case)
        self.np_params = _draw(jcfg)
        self.jparams = jax.tree.map(jnp.asarray, self.np_params)
        self.model = TM.Model(tcfg, device="cpu")
        self.model.load_state_dict(params_from_jax(self.np_params, tcfg))
        self.forward = jax.jit(lambda p, t, img: JM.forward(
            p, jcfg, t, image_embeds=img))
        self.decode = jax.jit(lambda p, t, c, i, img: JM.decode_step(
            p, jcfg, t, c, i, image_embeds=img))
        if jcfg.family in JM.PAGED_FAMILIES:
            self.prefill = jax.jit(lambda p, t: JM.forward_prefill(p, jcfg,
                                                                   t))
            self.decode_paged = jax.jit(
                lambda p, t, pool, tab, pos: JM.decode_step_paged(
                    p, jcfg, t, pool, tab, pos, page_size=PAGE))
        rng = np.random.default_rng(1)
        frame = (jcfg.n_codebooks,) if jcfg.family == "audio" else ()
        self.tokens = rng.integers(0, jcfg.vocab_size,
                                   (B, S) + frame).astype(np.int32)
        self.img = (rng.standard_normal((B, jcfg.n_image_tokens,
                                         jcfg.d_model)).astype(np.float32)
                    if jcfg.family == "vlm" else None)

    def jimg(self):
        return None if self.img is None else jnp.asarray(self.img)

    def timg(self):
        return None if self.img is None else torch.from_numpy(self.img)


@pytest.fixture(scope="module")
def pairs():
    made = {}

    def get(case):
        if case not in made:
            made[case] = Pair(case)
        return made[case]

    return get


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= TOL * max(scale, 1e-30), (what, err, scale)


def _argmax(logits):
    """Greedy next tokens (B, 1) (audio (B, 1, K)) from the last step."""
    return np.argmax(_np(logits)[:, -1], -1)[:, None].astype(np.int32)


def test_cases_cover_every_config():
    """The ten configs of both registries, each once."""
    assert sorted(jconfigs._ALIAS[a] for a in ARCH_IDS) == sorted(
        jconfigs.ARCHS) == sorted(tconfigs.ARCHS)
    assert {tconfigs.get_config(a).name for a in ARCH_IDS} == set(ARCH_IDS)
    assert len(PAGED_CASES) == 10        # 7 paged configs + 3 GQA cases
    for case, (_, h, kv) in GQA.items():
        _, tcfg = _cfgs(case)
        assert (tcfg.n_heads // tcfg.n_kv_heads, tcfg.n_kv_heads) == (
            h // kv, kv)


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(case, pairs):
    p = pairs(case)
    jl, jaux = p.forward(p.jparams, jnp.asarray(p.tokens), p.jimg())
    with torch.no_grad():
        tl, taux = TM.forward(p.model, p.tcfg,
                              torch.from_numpy(p.tokens).long(),
                              image_embeds=p.timg())
    _close(tl, jl, "logits")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_decode_steps_match_jax(case, pairs):
    """4 ring-cache decode steps from an empty f32 cache, fed the
    reference's greedy picks."""
    p = pairs(case)
    jcache = JM.init_cache(p.jcfg, batch=B, cache_len=8, dtype=jnp.float32)
    tcache = TM.init_cache(p.tcfg, batch=B, cache_len=8,
                           dtype=torch.float32, device="cpu")
    tok = p.tokens[:, :1]
    for t in range(DECODE):
        jl, jcache = p.decode(p.jparams, jnp.asarray(tok), jcache,
                              jnp.asarray(t, jnp.int32), p.jimg())
        with torch.no_grad():
            tl, tcache = TM.decode_step(p.model, p.tcfg,
                                        torch.from_numpy(tok).long(),
                                        tcache, t, image_embeds=p.timg())
        _close(tl, jl, f"decode step {t}")
        tok = _argmax(jl)


def _pool(k, v, table):
    """Prefill k/v (L, B, S, Kv, hd) scattered through ``table`` into a
    zeroed f32 pool (L, Kv, n_pages, PAGE, hd), page 0 the trash page."""
    L, Bk, Sk, Kv, hd = k.shape
    shape = (L, Kv, int(table.max()) + 1, PAGE, hd)
    pk, pv = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for b in range(Bk):
        for t in range(Sk):
            pk[:, :, table[b, t // PAGE], t % PAGE] = k[:, b, t]
            pv[:, :, table[b, t // PAGE], t % PAGE] = v[:, b, t]
    return pk, pv


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_prefill_and_decode_match_jax(case, pairs):
    """``forward_prefill`` and 2 ``decode_step_paged`` steps: 2 live rows
    at ragged positions and a trash-padded row."""
    p = pairs(case)
    jl, (jk, jv) = p.prefill(p.jparams, jnp.asarray(p.tokens))
    with torch.no_grad():
        tl, (tk, tv) = TM.forward_prefill(p.model, p.tcfg,
                                          torch.from_numpy(p.tokens).long())
    for got, want, what in ((tl, jl, "logits"), (tk, jk, "k"),
                            (tv, jv, "v")):
        _close(got, want, f"prefill {what}")
    n_per = (S + 2) // PAGE + 1
    table = np.zeros((3, n_per), np.int32)
    table[:2] = 1 + np.random.default_rng(2).permutation(
        2 * n_per).reshape(2, n_per)
    pk, pv = _pool(_np(jk), _np(jv), table[:2])
    jpool = {"k": jnp.asarray(pk), "v": jnp.asarray(pv)}
    tpool = {"k": torch.from_numpy(pk.copy()),
             "v": torch.from_numpy(pv.copy())}
    positions = np.array([S, S - 3, 0], np.int32)
    frame = p.tokens.shape[2:]
    token = np.zeros((3, 1) + frame, np.int32)
    token[:2] = _argmax(jl)
    for step in range(2):
        jlog, jpool = p.decode_paged(p.jparams, jnp.asarray(token), jpool,
                                     jnp.asarray(table),
                                     jnp.asarray(positions))
        with torch.no_grad():
            tlog, tpool = TM.decode_step_paged(
                p.model, p.tcfg, torch.from_numpy(token).long(), tpool,
                torch.from_numpy(table), torch.from_numpy(positions),
                page_size=PAGE)
        _close(tlog[:2], jlog[:2], f"paged decode step {step}")
        token[:2] = _argmax(jlog[:2])
        positions[:2] += 1
    for name in ("k", "v"):             # page 0 is the trash page
        _close(tpool[name][:, :, 1:], jpool[name][:, :, 1:], f"pool {name}")


@pytest.mark.parametrize("case", ARCH_IDS)
def test_dmsgd_updates_match_jax(case, pairs):
    """Two DmSGD updates (beta 0.9) over ``one_peer_exponential(4)`` from
    the same desynchronized node params, on the same numpy gradients:
    x and the momentum after each."""
    p, n = pairs(case), 4
    rng = np.random.default_rng(3)
    x0 = jax.tree.map(lambda a: (a + 0.01 * rng.standard_normal(
        (n,) + a.shape)).astype(np.float32), p.np_params)
    grads = [jax.tree.map(lambda a: rng.standard_normal(
        (n,) + a.shape).astype(np.float32), p.np_params) for _ in range(2)]
    jopt = JO.dmsgd(JT.one_peer_exponential(n), beta=0.9)
    topt = TO.dmsgd(TT.one_peer_exponential(n), beta=0.9)
    jx = jax.tree.map(jnp.asarray, x0)
    tx = stacked_from_jax(x0, p.tcfg)
    js, ts = jopt.init(jx), topt.init(tx)
    for step, g in enumerate(grads):
        jx, js = jopt.update(jx, js, jax.tree.map(jnp.asarray, g), step,
                             jnp.float32(0.05))
        tx, ts = topt.update(tx, ts, stacked_from_jax(g, p.tcfg), step, 0.05)
        for mine, theirs, what in ((tx, jx, "x"), (ts.momentum, js.momentum,
                                                   "m")):
            back = dict(jax.tree_util.tree_leaves_with_path(
                stacked_to_jax(mine, p.tcfg)))
            want = jax.tree_util.tree_leaves_with_path(theirs)
            assert len(back) == len(want)
            for path, leaf in want:
                _close(back[path], leaf, f"{what} after step {step}: "
                       f"{jax.tree_util.keystr(path)}")
