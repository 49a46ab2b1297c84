"""PyTorch port parity: ``repro_torch.launch.train_lm`` against the JAX
package's ``examples/train_lm.py``, on the CPU.

* ``PRESETS`` and ``make_cfg`` equal the reference's, and each preset's
  parameter count equals the reference's ``eval_shape`` count (the 100m
  preset: 128,995,584).
* ``train_one`` for 3 steps at a tiny config (2 layers, d_model 64, f32
  activations on both sides) on 2 nodes at seq 16, over one-peer, static
  exponential and parallel SGD: the reference's ``M.init`` is wrapped
  inside the test to capture its params, which the port's run then starts
  from (``convert.params_from_jax``); the batches are the same
  ``SyntheticLM`` draws (the port's copy is bit-identical).  The logged
  losses agree within f32 2e-4 (tests/test_kernels.py:16).
* At the 100m preset's widths cut to 2 layers, in f32, from the same
  weights, at lr 0.3 and 0.1: every step's loss agrees within 2e-4 up to
  the reference's blow-up (its loss past 3x step 0's, by step 7 and 17),
  and the port's blows up too.
* The CLI with ``--device cpu`` writes the reference's JSON keys and
  prints the Remark 7 gap line; without it, it needs a card."""
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.convert import params_from_jax
from repro_torch.launch import train_lm as tlm
from repro_torch.models import model as TM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "reference_train_lm", os.path.join(REPO, "examples", "train_lm.py"))
jlm = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jlm)

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256)


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_presets_and_configs_are_the_references():
    assert tlm.PRESETS == jlm.PRESETS
    port_fields = {f.name for f in dataclasses.fields(TM.ModelConfig)}
    for preset in jlm.PRESETS:
        jc, tc = jlm.make_cfg(preset), tlm.make_cfg(preset)
        shared = port_fields & {f.name for f in dataclasses.fields(jc)}
        assert len(shared) > 30
        for name in sorted(shared):
            a, b = getattr(tc, name), getattr(jc, name)
            if isinstance(a, torch.dtype):
                assert str(a).removeprefix("torch.") == jnp.dtype(b).name
            else:
                assert a == b, (preset, name, a, b)


@pytest.mark.parametrize("preset", list(jlm.PRESETS))
def test_param_counts_are_the_references(preset):
    cfg = jlm.make_cfg(preset)
    want = sum(x.size for x in jax.tree.leaves(
        jax.eval_shape(lambda: JM.init(cfg, jax.random.key(0)))))
    assert tlm.param_count(tlm.make_cfg(preset)) == want


@pytest.mark.parametrize("topname", ["one_peer_exp", "static_exp",
                                     "parallel"])
def test_train_one_matches_the_reference(topname, monkeypatch):
    jcfg = dataclasses.replace(jlm.make_cfg("small"), **TINY,
                               activation_dtype=jnp.float32)
    tcfg = dataclasses.replace(tlm.make_cfg("small"), **TINY,
                               activation_dtype=torch.float32)
    captured = {}
    j_init = JM.init

    def capture(cfg, key):
        captured["params"] = j_init(cfg, key)
        return captured["params"]

    monkeypatch.setattr(JM, "init", capture)
    kw = dict(nodes=2, steps=3, batch=2, seq=16, lr0=0.3, hetero=0.3,
              seed=0)
    want = jlm.train_one(jcfg, topname, **kw)

    sd = params_from_jax(jax.tree.map(np.asarray, captured["params"]), tcfg)

    def carried(cfg, seed, *, device):
        model = TM.Model(cfg, device=device)
        model.load_state_dict(sd)
        return model

    monkeypatch.setattr(TM, "init", carried)
    got = tlm.train_one(tcfg, topname, device="cpu", **kw)
    assert [k for k, _ in got["curve"]] == [k for k, _ in want] == [0, 2]
    np.testing.assert_allclose([v for _, v in got["curve"]],
                               [v for _, v in want], **TOL)
    assert got["losses"][0] == got["curve"][0][1]
    assert all(np.isfinite(got["losses"]))
    assert got["num_compiled"] == got["distinct"] == 1


# the fewest steps whose schedule keeps the full rate until the blow-up
# (the decay starts at 0.7 x steps): step 7 at lr 0.3, step 17 at lr 0.1
@pytest.mark.parametrize("lr0, steps", [(0.3, 11), (0.1, 25)])
def test_100m_widths_diverge_in_both_packages(lr0, steps, monkeypatch):
    """The 100m preset's widths (d 768, vocab 32,768, tied) cut to 2
    layers, 2 nodes, 1 x 16 tokens a node, f32 activations, from the same
    weights, at the reference's lr 0.3 and at 0.1: every step's loss of
    the two packages agrees within f32 2e-4 (tests/test_kernels.py:16) up
    to and including the first step where the reference's passes 3x its
    step-0 loss, and both packages pass it -- the divergence the 200-step
    runs at the full preset show on the card is the configuration's, not
    the port's update."""
    jcfg = dataclasses.replace(jlm.make_cfg("100m"), n_layers=2,
                               activation_dtype=jnp.float32)
    tcfg = dataclasses.replace(tlm.make_cfg("100m"), n_layers=2,
                               activation_dtype=torch.float32)
    captured, want = {}, []
    j_init, j_build = JM.init, jlm.build_trainer

    def capture(cfg, key):
        captured["params"] = j_init(cfg, key)
        return captured["params"]

    def recording(*args, **kw):
        # the reference logs every 10th step: record every step's loss
        opt, step_for = j_build(*args, **kw)

        def step_at(k):
            step = step_for(k)

            def run(*a):
                out = step(*a)
                want.append(float(out[2]))
                return out
            return run
        return opt, step_at

    monkeypatch.setattr(JM, "init", capture)
    monkeypatch.setattr(jlm, "build_trainer", recording)
    kw = dict(nodes=2, steps=steps, batch=1, seq=16, lr0=lr0, hetero=0.3,
              seed=0)
    jlm.train_one(jcfg, "one_peer_exp", **kw)
    sd = params_from_jax(jax.tree.map(np.asarray, captured["params"]), tcfg)

    def carried(cfg, seed, *, device):
        model = TM.Model(cfg, device=device)
        model.load_state_dict(sd)
        return model

    monkeypatch.setattr(TM, "init", carried)
    got = tlm.train_one(tcfg, "one_peer_exp", device="cpu", **kw)["losses"]
    assert len(got) == len(want) == steps
    want, got = np.asarray(want), np.asarray(got)
    blown = np.flatnonzero(~(want < 3 * want[0]))
    assert blown.size, want
    k = blown[0]
    np.testing.assert_allclose(got[:k + 1], want[:k + 1], **TOL)
    assert not np.all(got < 3 * got[0]), got


def test_cli_writes_the_references_json(tmp_path, capsys):
    out = tmp_path / "lm" / "train_lm.json"
    runs = tlm.main(["--device", "cpu", "--preset", "small", "--nodes", "2",
                     "--steps", "2", "--seq", "16", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert list(rec) == ["params_M", "curves", "args"]
    assert rec["params_M"] == tlm.param_count(tlm.make_cfg("small")) / 1e6
    assert set(rec["curves"]) == {"one_peer_exp", "static_exp"} == set(runs)
    ref_args = {"preset", "nodes", "steps", "batch", "seq", "lr", "hetero",
                "seed", "with_parallel", "tops", "out"}
    assert set(rec["args"]) == ref_args | {"device"}
    for curve in rec["curves"].values():
        assert [k for k, _ in curve] == [0, 1]
    assert "one-peer vs static final-loss gap" in capsys.readouterr().out


def test_cli_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.main(["--out", str(tmp_path / "x.json")])
