"""PyTorch port parity: the serving plane.  Allocator and scheduler units
mirrored from tests/test_serve_engine.py; the port engine's greedy tokens
and compile-cache counters against the JAX engine's (attention_impl=
"pallas") on the same prompts and weights; preemption, batch invariance
of sampled streams, and the Poisson-trace driver."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.serve import ServeEngine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.serve import (PageAllocator, Request, Scheduler, ServeEngine,
                               pages_needed)

PROMPT_LENS = (5, 9, 3, 12)


@pytest.fixture(scope="module")
def setup():
    """Reduced qwen3 in f32 activations (a bf16 near-tie could flip an
    argmax), JAX weights carried into the port."""
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config("qwen3-0.6b")),
        attention_impl="pallas", activation_dtype=jnp.float32)
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config("qwen3-0.6b")),
        activation_dtype=torch.float32)
    jparams = JM.init(jcfg, jax.random.key(0))
    model = TM.Model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          tcfg))
    return jcfg, jparams, tcfg, model


def _prompts(vocab, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (p,)) for p in lens]


def _engine(tcfg, model, **kw):
    kw = {"n_pages": 64, "page_size": 4, "max_seq": 64, "max_batch": 4,
          "prefill_token_budget": 32, "pool_dtype": torch.float32, **kw}
    return ServeEngine(tcfg, model, device="cpu", **kw)


# ---------------------------------------------------------------------------
# allocator / scheduler units
# ---------------------------------------------------------------------------

def test_allocator_all_or_nothing():
    a = PageAllocator(6)            # 5 usable (page 0 reserved)
    got = a.alloc(3)
    assert got is not None and len(got) == 3 and 0 not in got
    assert a.alloc(3) is None       # only 2 left: no partial grant
    assert a.free_pages == 2
    a.free(got)
    assert a.free_pages == 5 and a.peak_used == 3


def test_allocator_rejects_bad_free():
    a = PageAllocator(4)
    with pytest.raises(ValueError):
        a.free([0])                 # reserved trash page
    got = a.alloc(2)
    a.free(got)
    with pytest.raises(RuntimeError):
        a.free(got)                 # double free overflows the pool


def test_pages_needed():
    assert pages_needed(1, 4) == 1
    assert pages_needed(4, 4) == 1
    assert pages_needed(5, 4) == 2


def test_scheduler_admission_budget():
    a = PageAllocator(64)
    s = Scheduler(a, page_size=4, max_batch=8, prefill_token_budget=10)
    for rid, p in enumerate((8, 8, 3)):
        s.submit(Request(rid=rid, prompt=np.zeros(p, np.int32), max_new=4))
    plan = s.plan()
    assert [r.rid for r in plan.prefill] == [0]
    assert s.plan().prefill[0].rid == 1


def test_scheduler_lifo_preemption_and_resume():
    a = PageAllocator(7)            # 6 usable pages
    s = Scheduler(a, page_size=2, max_batch=4, prefill_token_budget=64)
    r0 = Request(rid=0, prompt=np.zeros(4, np.int32), max_new=8)
    r1 = Request(rid=1, prompt=np.zeros(4, np.int32), max_new=8)
    s.submit(r0)
    s.submit(r1)
    plan = s.plan()                 # both admitted: 2+2 pages
    assert len(plan.prefill) == 2
    r0.generated.append(1)
    r1.generated.append(1)
    held = a.alloc(a.free_pages)
    for _ in range(2):              # decode to both requests' page boundary
        plan = s.plan()
        for r in plan.decode:
            r.generated.append(1)
    assert r1.state == "waiting" and r1.pages == []   # LIFO victim
    assert r0.state == "running"                      # oldest kept
    assert s.waiting[0] is r1
    a.free(held)
    plan = s.plan()
    assert plan.prefill == [r1]
    assert r1.prefill_tokens().shape[0] == 4 + len(r1.generated) - 1


# ---------------------------------------------------------------------------
# engine end-to-end
# ---------------------------------------------------------------------------

def test_engine_greedy_and_compile_cache_match_jax(setup):
    jcfg, jparams, tcfg, model = setup
    prompts = _prompts(jcfg.vocab_size, 0, PROMPT_LENS)
    jeng = JaxEngine(jcfg, jparams, n_pages=64, page_size=4, max_seq=64,
                     max_batch=4, prefill_token_budget=32, temperature=0.0,
                     pool_dtype=jnp.float32)
    jreqs = [jeng.submit(p, max_new=5) for p in prompts]
    jeng.run()
    teng = _engine(tcfg, model)
    treqs = [teng.submit(p, max_new=5) for p in prompts]
    teng.run()
    assert len(teng.finished) == len(PROMPT_LENS)
    for a, b in zip(treqs, jreqs):
        assert [int(x) for x in a.generated] == [int(x) for x in b.generated]
    tcc, jcc = teng.compile_cache.stats(), jeng.compile_cache.stats()
    assert tcc == jcc
    st, jst = teng.stats(), jeng.stats()
    for key in ("steps", "decoded_tokens", "peak_pages", "peak_kv_bytes"):
        assert st[key] == jst[key], key
    # one prefill call per step that admitted, one decode per decoding step
    assert st["prefill_calls"] >= 1 and st["decode_calls"] >= 4


def test_engine_preemption_parity(setup):
    """A pool too small for the working set must preempt -- and still
    produce exactly the unpreempted greedy continuations."""
    _, _, tcfg, model = setup
    prompts = _prompts(tcfg.vocab_size, 1, (6, 7, 5))
    small = _engine(tcfg, model, n_pages=8, max_seq=32)
    reqs = [small.submit(p, max_new=8) for p in prompts]
    small.run(max_steps=300)
    assert small.stats()["preemptions"] > 0
    big = _engine(tcfg, model, max_seq=32)
    reqs2 = [big.submit(p, max_new=8) for p in prompts]
    big.run()
    for a, b in zip(reqs, reqs2):
        assert a.generated == b.generated


def test_engine_page_accounting(setup):
    _, _, tcfg, model = setup
    eng = _engine(tcfg, model, n_pages=32, max_seq=32)
    eng.submit(np.arange(6) % tcfg.vocab_size, max_new=4)
    eng.run()
    st = eng.stats()
    # 6 prompt + 4 new - 1 (last token never cached) = 9 tokens -> 3 pages
    assert st["peak_pages"] == pages_needed(9, 4)
    assert st["used_pages"] == 0 and st["free_pages"] == 31
    assert st["peak_kv_bytes"] > 0


def test_engine_compile_cache_bounded(setup):
    _, _, tcfg, model = setup
    eng = _engine(tcfg, model, n_pages=128, max_batch=8,
                  prefill_token_budget=64)
    lens = (3, 5, 7, 9, 11, 4, 6, 8)
    for p in _prompts(tcfg.vocab_size, 2, lens):
        eng.submit(p, max_new=3)
    eng.run()
    cc = eng.compile_cache.stats()
    assert cc["entries"] <= 8
    for p in _prompts(tcfg.vocab_size, 3, lens):
        eng.submit(p, max_new=3)
    eng.run()
    assert eng.compile_cache.stats()["misses"] == cc["misses"]


def test_engine_rejects_oversized_request(setup):
    _, _, tcfg, model = setup
    eng = _engine(tcfg, model, n_pages=16, max_seq=16)
    with pytest.raises(ValueError):
        eng.submit(np.zeros(14, np.int32), max_new=8)
    with pytest.raises(ValueError):
        eng.submit(np.zeros(4, np.int32), max_new=0)


def test_engine_sampled_stream_batch_invariant(setup):
    """temperature>0: a request's sample stream depends only on (seed,
    rid, step) -- co-batching must not change its tokens."""
    _, _, tcfg, model = setup
    prompts = _prompts(tcfg.vocab_size, 4, (5, 8))
    solo = _engine(tcfg, model, max_seq=32, temperature=0.8, seed=7)
    r_solo = solo.submit(prompts[0], max_new=4)
    solo.run()
    both = _engine(tcfg, model, max_seq=32, temperature=0.8, seed=7)
    r_both = both.submit(prompts[0], max_new=4)
    both.submit(prompts[1], max_new=4)
    both.run()
    assert r_solo.generated == r_both.generated
    other = _engine(tcfg, model, max_seq=32, temperature=0.8, seed=8)
    r_other = other.submit(prompts[0], max_new=4)
    other.run()
    assert len(r_other.generated) == 4


# ---------------------------------------------------------------------------
# Poisson-trace driver
# ---------------------------------------------------------------------------

def test_poisson_trace_matches_jax():
    a = tserve.poisson_trace(6, 3.0, 20, 5, 512, seed=9)
    b = jserve.poisson_trace(6, 3.0, 20, 5, 512, seed=9)
    assert [(t, m) for t, _, m in a] == [(t, m) for t, _, m in b]
    for (_, pa, _), (_, pb, _) in zip(a, b):
        np.testing.assert_array_equal(pa, pb)


def test_serve_trace_and_cli(setup, capsys):
    _, _, tcfg, model = setup
    eng = _engine(tcfg, model)
    trace = tserve.poisson_trace(5, 50.0, 6, 3, tcfg.vocab_size, seed=1)
    tserve.serve_trace(eng, trace)
    assert len(eng.finished) == 5
    lat = tserve.latency_summary(eng.finished)
    assert all(np.isfinite(v) and v >= 0 for v in lat.values())
    tserve.main(["--device", "cpu", "--n-requests", "3", "--mean-prompt",
                 "5", "--max-new", "3", "--max-seq", "32", "--pages", "32"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "compile cache" in out
