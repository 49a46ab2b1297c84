"""The dry run's step helpers (``repro_torch.launch.steps``: ``SHAPES``,
``shape_cfg``, ``input_specs``, ``cache_len_for``, ``cache_struct``,
``make_prefill_step``, ``make_serve_step``) against the JAX package's.

* ``input_specs`` and ``cache_struct`` give the reference's shapes and
  dtypes for all 10 archs x 4 shapes (train at the layout's ``nodes``),
  the port's on the meta device, the reference's from
  ``jax.eval_shape``: nothing is allocated or compiled.  The decode
  ``idx`` is the one difference: a Python int in the port.
* ``shape_cfg`` and ``cache_len_for`` match at every shape.
* ``make_prefill_step`` (the last position's logits, audio (B, K, V)) and
  three ``make_serve_step`` calls on reduced qwen3, mamba2 and musicgen,
  the weights carried across by ``params_from_jax``, f32 activations,
  within 2e-4 of the reference's max-abs (tests/test_kernels.py:16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as JSteps
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.launch import steps as TSteps
from repro_torch.models import model as TM
from test_torch_arch_smoke import ARCH_IDS

TOL = 2e-4
SHAPE_IDS = list(JSteps.SHAPES)


def _leaves(tree, path=""):
    """``{path: (shape, dtype name)}`` of a dict / NamedTuple tree of
    tensors or ShapeDtypeStructs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_leaves(v, f"{path}.{k}"))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def test_shapes_and_long_window():
    assert TSteps.SHAPES == JSteps.SHAPES
    assert TSteps.LONG_WINDOW == JSteps.LONG_WINDOW
    for arch in ARCH_IDS:
        for shape in SHAPE_IDS:
            j = JSteps.shape_cfg(jconfigs.get_config(arch), shape)
            t = TSteps.shape_cfg(tconfigs.get_config(arch), shape)
            assert t.attention_override_window == j.attention_override_window
            assert TSteps.cache_len_for(t, shape) == JSteps.cache_len_for(
                j, shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_cache_struct(arch):
    nodes = jconfigs.get_layout(arch)["nodes"]
    for shape in SHAPE_IDS:
        jcfg = JSteps.shape_cfg(jconfigs.get_config(arch), shape)
        tcfg = TSteps.shape_cfg(tconfigs.get_config(arch), shape)
        want = JSteps.input_specs(jcfg, shape, nodes=nodes)
        got = TSteps.input_specs(tcfg, shape, nodes=nodes)
        assert set(got) == set(want), (arch, shape)
        if "idx" in want:
            assert got.pop("idx") == JSteps.SHAPES[shape]["seq"] - 1
            assert want.pop("idx").shape == ()
        assert all(v.device.type == "meta" for v in got.values())
        assert _leaves(got) == _leaves(want), (arch, shape)
        if JSteps.SHAPES[shape]["kind"] == "decode":
            cache = TSteps.cache_struct(tcfg, shape)
            assert _leaves(cache) == _leaves(
                JSteps.cache_struct(jcfg, shape)), (arch, shape)


def _pair(arch):
    upd = dict(remat=False)
    jcfg = dataclasses.replace(jconfigs.reduced_config(
        jconfigs.get_config(arch)), activation_dtype=jnp.float32, **upd)
    tcfg = dataclasses.replace(tconfigs.reduced_config(
        tconfigs.get_config(arch)), activation_dtype=torch.float32, **upd)
    shapes = jax.eval_shape(lambda: JM.init(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(0)

    def draw(s):
        scale = s.shape[-2] ** -0.5 if len(s.shape) >= 2 else 0.1
        return (scale * rng.standard_normal(s.shape)).astype(s.dtype)

    np_params = jax.tree.map(draw, shapes)
    model = TM.Model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, np_params), model


def _close(got, want, what):
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-1.3b",
                                  "musicgen-large"])
def test_prefill_and_serve_steps_match_jax(arch):
    jcfg, tcfg, jparams, model = _pair(arch)
    B, S = 2, 16
    frame = (jcfg.n_codebooks,) if jcfg.family == "audio" else ()
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S) + frame).astype(np.int32)
    want = jax.jit(JSteps.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = TSteps.make_prefill_step(tcfg)(
            model, {"tokens": torch.from_numpy(tokens).long()})
    assert got.shape == ((B, jcfg.n_codebooks, jcfg.vocab_size) if frame
                         else (B, jcfg.vocab_size))
    _close(got, want, "prefill")

    jserve = jax.jit(JSteps.make_serve_step(jcfg))
    jcache = JM.init_cache(jcfg, B, 8, dtype=jnp.float32)
    tcache = TM.init_cache(tcfg, B, 8, dtype=torch.float32, device="cpu")
    for t in range(3):
        tok = tokens[:, t:t + 1]
        jl, jcache = jserve(jparams, jcache, {"token": jnp.asarray(tok),
                                              "idx": jnp.int32(t)})
        with torch.no_grad():
            tl, tcache = TSteps.make_serve_step(tcfg)(
                model, tcache, {"token": torch.from_numpy(tok).long(),
                                "idx": t})
        _close(tl, jl, f"serve step {t}")
