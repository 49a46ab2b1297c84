"""PyTorch port parity: the dense model on reduced qwen3, with the JAX
weights carried across by ``params_from_jax``.  Prefill logits and k/v,
then paged decode logits and pool, against the JAX model with
``attention_impl="pallas"`` (its kernels in interpret mode)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models import model as TM

TOL = dict(rtol=2e-2, atol=2e-2)
TOL32 = dict(rtol=2e-4, atol=2e-4)
ACT = {"f32": (jnp.float32, torch.float32, TOL32),
       "bf16": (jnp.bfloat16, torch.bfloat16, TOL)}
PAGE = 4


@pytest.fixture(scope="module")
def jax_setup():
    cfg = jconfigs.reduced_config(jconfigs.get_config("qwen3-0.6b"))
    params = JM.init(cfg, jax.random.key(0))
    return cfg, params, jax.tree.map(np.asarray, params)


def _pair(jax_setup, act):
    jcfg, jparams, np_params = jax_setup
    jdt, tdt, tol = ACT[act]
    jcfg = dataclasses.replace(jcfg, attention_impl="pallas",
                               activation_dtype=jdt)
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config("qwen3-0.6b")),
        activation_dtype=tdt)
    model = TM.Model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg))
    return jcfg, jparams, tcfg, model, tol


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pool_from_prefill(k, v, table, dtype):
    """Scatter prefill k/v (L, B, S, Kv, hd) into a zeroed page pool
    (L, Kv, n_pages, PAGE, hd) through ``table``, as the engine does."""
    L, B, S, Kv, hd = k.shape
    shape = (L, Kv, int(table.max()) + 2, PAGE, hd)
    pk, pv = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for b in range(B):
        for t in range(S):
            pk[:, :, table[b, t // PAGE], t % PAGE] = k[:, b, t]
            pv[:, :, table[b, t // PAGE], t % PAGE] = v[:, b, t]
    return pk.astype(dtype), pv.astype(dtype)


def test_param_names_and_shapes_match_jax(jax_setup):
    jcfg, _, np_params = jax_setup
    tcfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-0.6b"))
    sd = params_from_jax(np_params, tcfg)
    model = TM.init(tcfg, 0, device="cpu")
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        {n: tuple(t.shape) for n, t in sd.items()}
    again = TM.init(tcfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))


def test_params_from_jax_keeps_bf16_bits(jax_setup):
    jcfg = dataclasses.replace(jax_setup[0], param_dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.key(1)))
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config("qwen3-0.6b")),
        param_dtype=torch.bfloat16)
    sd = params_from_jax(params, tcfg)
    assert sd["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(sd["embed"].view(torch.int16).numpy(),
                                  params["embed"].view(np.int16))
    np.testing.assert_array_equal(
        sd["layers.1.attn.wq"].view(torch.int16).numpy(),
        params["layers"]["attn"]["wq"][1].view(np.int16))


@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_prefill_and_paged_decode_match_jax(jax_setup, act):
    jcfg, jparams, tcfg, model, tol = _pair(jax_setup, act)
    rng = np.random.default_rng(0)
    B, S = 2, 16
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)

    # prefill: logits and the per-layer k/v the pool stores
    jl, (jk, jv) = JM.forward_prefill(jparams, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        tl, (tk, tv) = TM.forward_prefill(model, tcfg,
                                          torch.from_numpy(tokens))
        tl_fwd, _ = TM.forward(model, tcfg, torch.from_numpy(tokens))
    for got, want in ((tl, jl), (tk, jk), (tv, jv)):
        assert got.shape == want.shape
        assert got.dtype == tcfg.activation_dtype
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    # the train/eval forward takes the plain positions-masked attention, as
    # the JAX forward does with its default attention_impl="jnp"
    jl_fwd, _ = JM.forward(jparams, dataclasses.replace(
        jcfg, attention_impl="jnp"), jnp.asarray(tokens))
    np.testing.assert_allclose(_f32(tl_fwd), _f32(jl_fwd), **tol)
    np.testing.assert_allclose(_f32(tl_fwd), _f32(tl), **tol)

    # paged decode: 2 live rows at ragged positions + 2 trash-padded rows
    pages = 1 + rng.permutation(2 * 6).reshape(2, 6).astype(np.int32)
    table = np.zeros((4, 6), np.int32)
    table[:2] = pages
    pool_np = _pool_from_prefill(_f32(jk), _f32(jv), table[:2],
                                 np.float32)
    jpool = {"k": jnp.asarray(pool_np[0], jcfg.activation_dtype),
             "v": jnp.asarray(pool_np[1], jcfg.activation_dtype)}
    tpool = {"k": torch.from_numpy(pool_np[0]).to(tcfg.activation_dtype),
             "v": torch.from_numpy(pool_np[1]).to(tcfg.activation_dtype)}
    positions = np.array([S, S - 5, 0, 0], np.int32)
    token = np.zeros((4, 1), np.int32)
    token[:2, 0] = np.argmax(_f32(jl)[:, -1], -1)
    for _ in range(3):
        jlog, jpool = JM.decode_step_paged(
            jparams, jcfg, jnp.asarray(token), jpool, jnp.asarray(table),
            jnp.asarray(positions), page_size=PAGE)
        with torch.no_grad():
            tlog, tpool = TM.decode_step_paged(
                model, tcfg, torch.from_numpy(token), tpool,
                torch.from_numpy(table), torch.from_numpy(positions),
                page_size=PAGE)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), **tol)
        assert np.isfinite(_f32(tlog)).all()
        token[:2, 0] = np.argmax(_f32(jlog)[:2, 0], -1)
        positions[:2] += 1
    for name in ("k", "v"):             # page 0 is the trash page
        np.testing.assert_allclose(_f32(tpool[name])[:, :, 1:],
                                   _f32(jpool[name])[:, :, 1:], **tol)


@pytest.mark.parametrize("knobs", [{"broadcast_positions": True},
                                   {"gqa_layout": "flat"},
                                   {"broadcast_positions": True,
                                    "gqa_layout": "flat"}])
def test_layout_knobs_forward_matches_jax(jax_setup, knobs):
    """The train forward of reduced qwen3 in f32 under the dry run's two
    layout knobs (default positions one broadcast row; K/V repeated to H
    heads) against the reference's forward under the same knobs, 2e-4;
    the knobs change no value."""
    jcfg, jparams, tcfg, model, tol = _pair(jax_setup, "f32")
    tokens = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    jcfg = dataclasses.replace(jcfg, attention_impl="jnp", **knobs)
    want, _ = JM.forward(jparams, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = TM.forward(model, dataclasses.replace(tcfg, **knobs),
                            torch.from_numpy(tokens))
        base, _ = TM.forward(model, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    np.testing.assert_allclose(_f32(got), _f32(base), **tol)


def test_unsupported_family_raises():
    """Every family of the reference runs; one it does not have raises."""
    cfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config("musicgen-large")),
        family="encdec")
    assert set(TM.SUPPORTED_FAMILIES) == {
        "dense", "moe", "ssm", "hybrid", "vlm", "audio"} and not TM._LATER
    with pytest.raises(NotImplementedError, match="unknown family"):
        TM.init(cfg, 0, device="cpu")
