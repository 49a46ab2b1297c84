"""PyTorch port parity: the vlm family (llama-3.2-vision: groups of
self-attention layers, each followed by a gated cross-attention layer
over the image embeddings) on reduced llama-3.2-vision-90b
(``reduced_config``: 6 layers, 2 groups of 2 self + 1 cross, d_model
256, 16 image tokens), with the JAX weights carried across by
``params_from_jax`` and inputs made with numpy.  The reference's
``cross_attn_init`` makes a zero ``gate``, so ``tanh(gate) = 0`` and a
fresh cross layer adds nothing: every case sets the gates non-zero in
the JAX params first (:func:`_gated`).  Tolerances are the reference's
(tests/test_kernels.py:15-16): f32 2e-4; bf16 2e-2 of the logits'
max-abs.

Covered: ``cross_attn_apply`` alone, the forward, the loss and every
gradient with the reference's images, the ring caches and the decode
step, ``generate(image_embeds=)`` at temperature 0, one train step with
injected images (also by micro-batches), the converters' round trips,
the int8 scale groups of ``layers.*`` and ``cross_layers.*``,
checkpoints both ways, and the paged entry points' refusals."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.launch import steps as JSteps
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.convert import (params_from_jax, stacked_from_jax,
                                 stacked_to_jax, train_state_from_jax,
                                 train_state_to_jax)
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as TSteps
from repro_torch.launch import train as TTrain
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.serve import ServeEngine
from test_torch_audio import train_both
from test_torch_checkpoint import \
    test_jax_checkpoint_restores_in_port as _jax_ckpt_in_port
from test_torch_checkpoint import \
    test_port_checkpoint_restores_in_jax as _port_ckpt_in_jax
from test_torch_int8 import \
    test_model_payload_scales_follow_jax_leaves as _int8_scales
from test_torch_model import _f32
from test_torch_train import _check_state

ARCH = "llama-3.2-vision-90b"
TOL32 = dict(rtol=2e-4, atol=2e-4)
BF16_REL = 2e-2
ACT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
GATES = (0.5, -0.7)          # one per group of the reduced config


def _cfgs(act="f32", **upd):
    jdt, tdt = ACT[act]
    jcfg = dataclasses.replace(jconfigs.reduced_config(
        jconfigs.get_config(ARCH)), activation_dtype=jdt, **upd)
    tcfg = dataclasses.replace(tconfigs.reduced_config(
        tconfigs.get_config(ARCH)), activation_dtype=tdt, **upd)
    return jcfg, tcfg


def _gated(np_params):
    """The params with each cross layer's gate set non-zero."""
    out = jax.tree.map(np.array, np_params)
    out["cross_layers"]["xattn"]["gate"] = np.asarray(GATES, np.float32)
    return out


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    return _gated(jax.tree.map(np.asarray, JM.init(jcfg, jax.random.key(0))))


def _model(np_params, tcfg):
    model = TM.Model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg))
    return model


def _images(b, cfg, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


def _close(act, got, want):
    if act == "f32":
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL32)
    else:
        got, want = _f32(got), _f32(want)
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


# ---------------------------------------------------------------------------
# models/attention.py and models/model.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_cross_attn_apply_matches_jax(weights, act):
    """One cross layer's gated attention alone: qk-norm, no RoPE, no
    mask, the image embeddings cast to the activation dtype."""
    jcfg, tcfg = _cfgs(act)
    jdt, tdt = ACT[act]
    g = 1
    jp = jax.tree.map(lambda a: jnp.asarray(a[g]),
                      weights["cross_layers"]["xattn"])
    pre = f"cross_layers.{g}.xattn."
    tp = TA.CrossAttention(tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
                           tcfg.head_dim)
    tp.load_state_dict({k[len(pre):]: v for k, v in params_from_jax(
        weights, tcfg).items() if k.startswith(pre)})
    x = np.random.default_rng(1).standard_normal(
        (2, 7, tcfg.d_model)).astype(np.float32)
    img = _images(2, tcfg, 2)
    kw = dict(n_heads=tcfg.n_heads, n_kv=tcfg.n_kv_heads,
              head_dim=tcfg.head_dim)
    want = JA.cross_attn_apply(jp, jnp.asarray(x, jdt), jnp.asarray(img),
                               **kw)
    with torch.no_grad():
        got = TA.cross_attn_apply(tp, torch.from_numpy(x).to(tdt),
                                  torch.from_numpy(img), **kw)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert float(got.float().abs().max()) > 0
    _close(act, got, want)


def test_init_names_and_counts_match_jax(weights):
    """Flat ``layers.{g * n_self + j}`` and ``cross_layers.{g}`` with the
    reference's shapes and count; the gates start at zero."""
    jcfg, tcfg = _cfgs()
    model = TM.init(tcfg, 0, device="cpu")
    sd = params_from_jax(weights, tcfg)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        {n: tuple(t.shape) for n, t in sd.items()}
    assert len(model.layers) == 4 and len(model.cross_layers) == 2
    assert tuple(model.cross_layers[1].xattn.gate.shape) == ()
    assert all(float(c.xattn.gate.detach()) == 0
               for c in model.cross_layers)
    assert float(sd["cross_layers.1.xattn.gate"]) == pytest.approx(GATES[1])
    # JAX layers[g, j] is the port's layers.{g * n_self + j}
    np.testing.assert_array_equal(
        sd["layers.3.attn.wq"].numpy(), weights["layers"]["attn"]["wq"][1, 1])
    assert TM.param_count(model) == JM.param_count(
        jax.tree.map(jnp.asarray, weights))


@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_forward_logits_match_jax(weights, act):
    jcfg, tcfg = _cfgs(act)
    model = _model(weights, tcfg)
    tokens, img = _tokens((2, 12), 3), _images(2, tcfg, 3)
    jl, _ = JM.forward(jax.tree.map(jnp.asarray, weights), jcfg,
                       jnp.asarray(tokens), image_embeds=jnp.asarray(img))
    with torch.no_grad():
        tl, ta = TM.forward(model, tcfg, torch.from_numpy(tokens),
                            image_embeds=torch.from_numpy(img))
        for c in model.cross_layers:
            c.xattn.gate.zero_()
        t0, _ = TM.forward(model, tcfg, torch.from_numpy(tokens),
                           image_embeds=torch.from_numpy(img))
    assert tl.dtype == tcfg.activation_dtype and float(ta) == 0.0
    _close(act, tl, jl)
    assert not torch.allclose(t0.float(), tl.float(), atol=1e-2)
    with pytest.raises(ValueError, match="image_embeds"):
        TM.forward(model, tcfg, torch.from_numpy(tokens))


@pytest.mark.parametrize("remat", [False, True])
def test_train_loss_and_gradients_match_jax(weights, remat):
    """``train_loss_fn`` with the reference's ``image_embeds`` and the
    gradient of every leaf (the gates' included), f32, with and without
    remat (the self layers only)."""
    jcfg, tcfg = _cfgs(remat=remat)
    model = _model(weights, tcfg)
    tokens, img = _tokens((2, 16), 4), _images(2, tcfg, 4)
    jloss, jgrads = jax.value_and_grad(JSteps.train_loss_fn)(
        jax.tree.map(jnp.asarray, weights), jcfg, jnp.asarray(tokens),
        jnp.asarray(img))
    tloss = TSteps.train_loss_fn(model, tcfg, torch.from_numpy(tokens),
                                 torch.from_numpy(img))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL32)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL32)
    assert all(float(c.xattn.gate.grad.abs()) > 0 for c in model.cross_layers)


def test_init_cache_and_decode_step_match_jax(weights):
    """The self layers' rings, (n_groups, n_self, B, Kv, T, hd) as the
    reference's, then 8 teacher-forced decode steps with the images:
    logits and every ring slot, f32; and the steps against the forward."""
    jcfg, tcfg = _cfgs()
    model = _model(weights, tcfg)
    jparams = jax.tree.map(jnp.asarray, weights)
    jc = JM.init_cache(jcfg, batch=2, cache_len=8, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, batch=2, cache_len=8, dtype=torch.float32,
                       device="cpu")
    assert set(tc) == set(jc) == {"kv"}
    assert tuple(tc["kv"].k.shape) == jc["kv"].k.shape == \
        (2, 2, 2, tcfg.n_kv_heads, 8, tcfg.head_dim)
    tokens, img = _tokens((2, 8), 5), _images(2, tcfg, 5)
    steps = []
    for t in range(8):
        jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(tokens[:, t:t + 1]),
                                jc, jnp.asarray(t, jnp.int32),
                                image_embeds=jnp.asarray(img))
        with torch.no_grad():
            tl, tc = TM.decode_step(model, tcfg,
                                    torch.from_numpy(tokens[:, t:t + 1]), tc,
                                    t, image_embeds=torch.from_numpy(img))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL32)
        steps.append(tl)
    for a, b in ((tc["kv"].k, jc["kv"].k), (tc["kv"].v, jc["kv"].v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL32)
    with torch.no_grad():
        full, _ = TM.forward(model, tcfg, torch.from_numpy(tokens),
                             image_embeds=torch.from_numpy(img))
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError, match="image_embeds"):
        TM.decode_step(model, tcfg, torch.from_numpy(tokens[:, :1]), tc, 8)


def test_generate_with_images_follows_jax(weights):
    """``generate(image_embeds=)`` at temperature 0 (token by token, as
    the reference always prefills vlm) against JAX's: the top-2 gap of
    every sampled step is asserted above 1e-3 first (JAX's own logits,
    teacher-forced), then the tokens are equal."""
    jcfg, tcfg = _cfgs()
    model = _model(weights, tcfg)
    jparams = jax.tree.map(jnp.asarray, weights)
    prompts, img = _tokens((2, 8), 6), _images(2, tcfg, 6)
    plen, max_new = 8, 6
    want = np.array(jserve.generate(jcfg, jparams, jnp.asarray(prompts),
                                    max_new=max_new, cache_len=16,
                                    temperature=0.0, seed=0,
                                    image_embeds=jnp.asarray(img)))
    jc = JM.init_cache(jcfg, batch=2, cache_len=16, dtype=jnp.float32)
    gaps = []
    for t in range(plen + max_new - 1):
        jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(want[:, t:t + 1]),
                                jc, jnp.asarray(t, jnp.int32),
                                image_embeds=jnp.asarray(img))
        if t >= plen - 1:
            top2 = np.sort(np.asarray(jl[:, 0]), -1)[..., -2:]
            gaps.append(top2[..., 1] - top2[..., 0])
    assert (np.stack(gaps) > 1e-3).all()
    got = tserve.generate(tcfg, model, torch.from_numpy(prompts),
                          max_new=max_new, cache_len=16, temperature=0.0,
                          image_embeds=torch.from_numpy(img), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# training, converters, int8 scales, checkpoints, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("micro_batch", [None, 1])
def test_train_step_with_images_matches_jax(weights, micro_batch):
    """One DmSGD step on 4 nodes through ``build_trainer`` on both
    packages, the same (n, B, T, d) images injected in both batches;
    with ``micro_batch`` 1 each node's 2 rows and their images are split
    and the gradients accumulated in f32, as the reference's scan."""
    jcfg, tcfg = _cfgs()
    n = 4
    batch = {"tokens": _tokens((n, 2, 12), 7),
             "image_embeds": np.random.default_rng(7).standard_normal(
                 (n, 2, tcfg.n_image_tokens, tcfg.d_model)).astype(
                     np.float32)}
    losses, (jx, js, _), (tx, ts, _) = train_both(
        weights, jcfg, tcfg, n, [batch], micro_batch=micro_batch)
    (got, want), = losses
    np.testing.assert_allclose(got, want, **TOL32)
    _check_state(tcfg, TOL32, tx, ts, jx, js)


def test_converters_round_trip(weights):
    """``stacked_from_jax`` / ``stacked_to_jax`` and the train-state
    converters: (n, n_groups, n_self, ...) self leaves, (n, n_groups, ...)
    cross leaves and the (n, n_groups) gate, there and back, bit for
    bit."""
    _, tcfg = _cfgs()
    n = 3
    rng = np.random.default_rng(8)
    tree = jax.tree.map(lambda a: rng.standard_normal(
        (n,) + a.shape).astype(np.float32), weights)
    flat = stacked_from_jax(tree, tcfg)
    assert tuple(flat["cross_layers.1.xattn.gate"].shape) == (n,)
    np.testing.assert_array_equal(
        flat["layers.2.mlp.w_up"].numpy(),
        tree["layers"]["mlp"]["w_up"][:, 1, 0])
    back = stacked_to_jax(flat, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    mom = {k: torch.randn(v.shape) for k, v in flat.items()}
    p2, m2 = train_state_from_jax(train_state_to_jax(flat, mom, tcfg), tcfg)
    assert all(torch.equal(p2[k], flat[k]) and torch.equal(m2[k], mom[k])
               for k in flat)


def test_int8_scale_groups_of_vlm_leaves():
    """``layers.<g * n_self + j>.<rest>`` joins the doubly stacked JAX
    leaf ``layers.<rest>``, and ``cross_layers.<g>.<rest>`` joins
    ``cross_layers.<rest>``: one scale per (node, JAX leaf), the
    reference's bit for bit."""
    _int8_scales(ARCH)


@pytest.mark.parametrize("slots,mom_dtype", [("one", jnp.float32),
                                             ("mu_nu", jnp.bfloat16)])
def test_vlm_checkpoints_cross_read(tmp_path, slots, mom_dtype):
    """Leaves in JAX flatten order at JAX shapes: ``cross_layers`` sorts
    before ``embed``."""
    _port_ckpt_in_jax(tmp_path / "port", ARCH, slots, mom_dtype)
    _jax_ckpt_in_port(tmp_path / "jax", ARCH, slots, mom_dtype)


def test_paged_entry_points_refuse_vlm(weights):
    """vlm is not a paged family in the reference: forward_prefill and
    the engine raise, as there; generate serves it."""
    _, tcfg = _cfgs()
    model = _model(weights, tcfg)
    with pytest.raises(NotImplementedError, match="paged"):
        TM.forward_prefill(model, tcfg, torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="paged"):
        ServeEngine(tcfg, model, n_pages=8, device="cpu")
    with pytest.raises(NotImplementedError):
        JM.forward_prefill(jax.tree.map(jnp.asarray, weights),
                           _cfgs()[0], jnp.zeros((1, 4), jnp.int32))


def test_driver_trains_vlm_on_cpu():
    """The driver on the CPU: each step's images (n, B, 16, d) drawn from
    a generator seeded from (--seed, step), the same on a rerun; losses
    and consensus finite, with micro-batches."""
    argv = ["--arch", ARCH, "--device", "cpu", "--nodes", "4", "--steps",
            "3", "--batch", "2", "--seq", "8", "--log-every", "1",
            "--micro-batch", "1"]
    args = TTrain.parse_args(argv)
    a, b = (TTrain.prepare(args)["batches"] for _ in range(2))
    assert tuple(a[1]["image_embeds"].shape) == (4, 2, 16, 256)
    assert torch.equal(a[1]["image_embeds"], b[1]["image_embeds"])
    assert not torch.equal(a[0]["image_embeds"], a[1]["image_embeds"])
    out = TTrain.run(args)
    assert out["config"].family == "vlm"
    assert np.isfinite([h["loss"] for h in out["history"]]).all()
    assert np.isfinite([h["consensus"] for h in out["history"]]).all()
