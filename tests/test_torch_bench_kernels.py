"""PyTorch port parity: ``repro_torch.benchmarks.bench_kernels`` against
the JAX package's ``benchmarks/bench_kernels.py``, on the CPU.

* The suite prints the reference's CSV row names, in its order, and every
  ``derived`` key the reference prints (``allclose``, ``ref_gflops``,
  ``shape``, ``ref_GBps``), with the reference's shape strings; on the
  CPU it says ``impl=plain`` and leaves the share of the card's bound
  and the library call's time unmeasured.
* The port's plain versions at the suite's three shapes equal the JAX
  package's refs on the same numpy inputs (``make_inputs``) within the
  reference's allclose tolerances: 2e-4 (attention), 2e-3 (SSD scan), 1e-5
  (gossip mix).
* ``benchmarks.run --only kernels`` runs the suite.
The kernels themselves run on the card only (tests/test_torch_cuda_kernels
.py, ``chip_smoke.py`` phase 17)."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from benchmarks import bench_kernels as jbk
from repro.kernels.flash_attention import ref as jfa_ref
from repro.kernels.gossip_mix import ref as jgm_ref
from repro.kernels.ssd_scan import ref as jssd_ref
from repro_torch.benchmarks import bench_kernels as tbk
from repro_torch.benchmarks import run as trun
from repro_torch.kernels.flash_attention import ref as tfa_ref
from repro_torch.kernels.gossip_mix import ref as tgm_ref
from repro_torch.kernels.ssd_scan import ref as tssd_ref


def _csv(lines) -> dict:
    """``name -> {key: value}`` of the ``derived`` column."""
    out = {}
    for ln in lines:
        name, _, derived = ln.split(",", 2)
        out[name] = dict(kv.split("=", 1) for kv in derived.split(";"))
    return out


def test_rows_and_derived_keys_are_the_references(capsys):
    jbk.run()
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    rows = tbk.run("cpu")
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert [ln.split(",")[0] for ln in got] == [ln.split(",")[0]
                                                for ln in want]
    assert [r["name"] for r in rows] == list(tbk.TOL)
    jrows, trows = _csv(want), _csv(got)
    for name, jd in jrows.items():
        td = trows[name]
        assert set(jd) <= set(td), (name, sorted(jd), sorted(td))
        assert td["allclose"] == jd["allclose"] == "True"
        if "shape" in jd:
            assert td["shape"] == jd["shape"]
        assert td["impl"] == "plain"
        assert td["bound_share"] == "not measured"
        assert td["library_us"] == "not measured"
        assert float(td["bound_us"]) > 0
    for r in rows:
        assert r["us"] == r["plain_us"] and r["kernel_calls"] == 1
        assert r["library_us"] is None


def _j(a):
    return jnp.asarray(a)


def test_plain_versions_match_the_references_at_the_suite_shapes():
    inp = tbk.make_inputs()
    tol = tbk.TOL

    q, k, v = inp["kernel_flash_attention"]
    got = tfa_ref.attention_ref(*map(torch.from_numpy, (q, k, v)))
    want = jfa_ref.attention_ref(_j(q), _j(k), _j(v))
    t = tol["kernel_flash_attention"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=t, atol=t)

    x, dt, A, Bm, Cm = inp["kernel_ssd_scan"]
    y, h = tssd_ref.ssd_ref(*map(torch.from_numpy, (x, dt, A, Bm, Cm)))
    jy, jh = jssd_ref.ssd_ref(*map(_j, (x, dt, A, Bm, Cm)))
    t = tol["kernel_ssd_scan"]
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=t, atol=t)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=t, atol=t)

    xg, rg = inp["kernel_gossip_mix"]
    got = tgm_ref.gossip_mix_ref(torch.from_numpy(xg),
                                 [torch.from_numpy(rg)], 0.5, (0.5,))
    want = jgm_ref.gossip_mix_ref(_j(xg), [_j(rg)], 0.5, (0.5,))
    t = tol["kernel_gossip_mix"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=t, atol=t)


@pytest.mark.parametrize("name,shape", [
    ("kernel_flash_attention", tbk.FLASH), ("kernel_ssd_scan", tbk.SSD)])
def test_inputs_have_the_reference_shapes(name, shape):
    arrays = tbk.make_inputs()[name]
    assert all(a.dtype == np.float32 for a in arrays)
    if name == "kernel_flash_attention":
        B, S, H, Kv, D = shape
        assert [a.shape for a in arrays] == [(B, S, H, D), (B, S, Kv, D),
                                             (B, S, Kv, D)]
    else:
        b, s, h, p, g, n = shape
        assert [a.shape for a in arrays] == [(b, s, h, p), (b, s, h), (h,),
                                             (b, s, g, n), (b, s, g, n)]
        assert (arrays[1] > 0).all() and (arrays[2] < 0).all()


def test_run_suite_kernels(capsys, monkeypatch):
    # the rows' timings are the other test's; here one call each
    monkeypatch.setattr(tbk, "time_fn", lambda fn, **kw: (fn(), 1.0)[1])
    trun.main(["--only", "kernels", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in out[1:]] == list(tbk.TOL)


def test_kernels_suite_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbk.main([])
