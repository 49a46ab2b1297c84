"""PyTorch port: the overlapped (delayed-mix) gossip pipeline.

Inside the port the pipelined recursion is held BIT-equal to the
sequential delayed recursion built from the synchronous pieces (the
construction of tests/test_overlap.py: mix step t-1's payload, update
locally with the gradients at the pre-mix iterate, emit step t's payload)
for dmsgd, dsgd, vanilla_dmsgd and d_adamw, with int8, every-k and the
warm-up phase, and through the driver's train step.  Against the JAX
package the same chains agree within 1e-6 (f32; rtol = atol).  Both
checkpoint modes resume bit-identically, a carry-buffer checkpoint is
read by each package from the other, the plan's keys and executable
counters equal the reference's, and the composition refusals are the
reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.checkpoint import ckpt as jckpt
from repro.core import flatbuf as JF, gossip as JG, optim as JO
from repro.core import topology as JT, transforms as JTR
from repro.core.plan import GossipPlan as JPlan
from repro.models import model as JM
from repro_torch import convert
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import flatbuf as TF, optim as TO, topology as TT
from repro_torch.core import transforms as TTR
from repro_torch.core.plan import GossipPlan, OverlapIO
from repro_torch.launch import steps as steps_mod, train as TTrain

TOL = dict(rtol=1e-6, atol=1e-6)


def _eq(a, b, tag=""):
    la, lb = TF.tree_flatten(a)[0], TF.tree_flatten(b)[0]
    assert len(la) == len(lb), tag
    for x, y in zip(la, lb):
        assert torch.equal(x, y), tag


def _np_params(n=4, d=12, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((n, d)).astype(np.float32),
            "b": rng.standard_normal((n, 3)).astype(np.float32)}


def _np_grads(params, T, seed=100):
    return [{k: np.random.default_rng(seed + t).standard_normal(v.shape)
             .astype(np.float32) for k, v in params.items()}
            for t in range(T)]


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _sequential_delayed_step(opt_s, sync_plan, t, lr):
    """Step ``t`` of the delayed recursion built only from the
    SYNCHRONOUS pieces: apply step t-1's mix to the carried payload, run
    the chain with an identity mix, emit the fresh payload."""
    names = opt_s._overlap_names()
    mix = sync_plan.mix(t - 1) if t > 0 else None

    def fn(p, s, g, pay):
        if mix is not None:
            mixed = mix(pay)
            vals = (mixed,) if len(names) == 1 else tuple(mixed)
            slots = dict(opt_s._slots_of(s))
            for w, v in zip(names, vals):
                if w == "x_next":
                    p = {k: v[k].to(p[k].dtype) for k in p}
                else:
                    slots[w[:-5]] = {k: v[k].to(slots[w[:-5]][k].dtype)
                                     for k in v}
            s = opt_s._state_of(slots, s.count)
        p2, s2 = opt_s.update_with_mix(p, s, g, lr, lambda t_: t_)
        slots2 = dict(opt_s._slots_of(s2))
        parts = tuple((p2 if w == "x_next" else slots2[w[:-5]])
                      for w in names)
        return p2, s2, parts[0] if len(parts) == 1 else parts

    return fn


def _run_pipelined(opt_o, plan, params, grads, lr, start=0, state=None):
    p = params
    s = opt_o.init(params) if state is None else state
    hist = []
    for i, g in enumerate(grads):
        t = start + i
        p, s = plan.step_fn(t, prime=(s.buf is None and t > 0))(p, s, g)
        hist.append((p, s))
    return p, s, hist


def _pipelined_plan(opt, lr, plan_cls=GossipPlan):
    return plan_cls.for_optimizer(
        opt, fn=lambda io, p, s, g: opt.update_pipelined(p, s, g, lr, io))


def _jax_pipelined(opt, params, grads, lr):
    plan = _pipelined_plan(opt, lr, JPlan)
    p, s, hist = params, opt.init(params), []
    for t, g in enumerate(grads):
        p, s = plan.step_fn(t)(p, s, _j(g))
        hist.append(p)
    return hist


@pytest.mark.parametrize("name", ["dmsgd", "dsgd", "vanilla_dmsgd",
                                  "d_adamw"])
def test_pipelined_bit_identical_to_sequential_delayed(name):
    """The pipelined step == the sequential delayed recursion, params AND
    state, every step, and the flush == one last synchronous mix; the
    JAX package's pipeline within 1e-6."""
    n, T, lr = 4, 9, 0.1
    top = TT.one_peer_exponential(n)
    npp = _np_params(n)
    params, grads = _t(npp), [_t(g) for g in _np_grads(npp, T)]
    opt_o = TO.make_optimizer(name, top, beta=0.9, overlap=True)
    opt_s = TO.make_optimizer(name, top, beta=0.9)
    assert opt_o.overlap and not opt_s.overlap

    plan = _pipelined_plan(opt_o, lr)
    pf, sf, hist = _run_pipelined(opt_o, plan, params, grads, lr)
    pf, sf = plan.flush_step_fn(T)(pf, sf)
    assert sf.buf is None

    sync_plan = GossipPlan.for_optimizer(opt_s)
    p, s, pay = params, opt_s.init(params), None
    for t in range(T):
        p, s, pay = _sequential_delayed_step(opt_s, sync_plan, t, lr)(
            p, s, grads[t], pay)
        _eq(p, hist[t][0], f"{name} params @ step {t}")
        _eq(s.momentum, hist[t][1].momentum, f"{name} momentum @ step {t}")
    mixed = sync_plan.mix(T - 1)(pay)
    vals = (mixed,) if len(opt_s._overlap_names()) == 1 else tuple(mixed)
    for w, v in zip(opt_s._overlap_names(), vals):
        if w == "x_next":
            _eq(v, pf, f"{name} flushed params")

    jopt = JO.make_optimizer(name, JT.one_peer_exponential(n), beta=0.9,
                             overlap=True)
    jhist = _jax_pipelined(jopt, _j(npp), _np_grads(npp, T), lr)
    for t in range(T):
        for k in npp:
            np.testing.assert_allclose(hist[t][0][k].numpy(),
                                       np.asarray(jhist[t][k]), **TOL,
                                       err_msg=f"{name} vs jax @ {t}")


def _chain(mod, top, kw, every, warmup, overlap):
    o = mod.chain(
        mod.trace_momentum(0.9),
        mod.scale_by_lr("m"),
        mod.quantize_int8() if kw else None,
        mod.gossip(where=("m_next", "x_next"), every=every, overlap=overlap),
        topology=top, name="t", beta=0.9)
    return mod.allreduce_warmup(warmup)(o) if warmup else o


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("every,warmup", [(1, 2), (2, 0)])
def test_pipelined_int8_and_every_and_warmup(int8, every, warmup):
    """The pipeline composes with int8 compression, gossip(every=k)
    Identity off-steps and the all-reduce warm-up: bit-identical to the
    sequential delayed reference.  Against the JAX pipeline: f32 within
    1e-6; int8 equal where the quantized codes agree, else off by at most
    one quantum (w x scale) -- the reference is itself one ulp unstable
    here (its own test of this case fails by one f32 ulp)."""
    n, T, lr = 4, 8, 0.05
    top = TT.one_peer_exponential(n)
    npp = _np_params(n, seed=3)
    params, grads = _t(npp), [_t(g) for g in _np_grads(npp, T, seed=50)]
    kw = {"compression": "int8"} if int8 else {}
    opt_o = _chain(TTR, top, kw, every, warmup, True)
    opt_s = _chain(TTR, top, kw, every, warmup, False)
    assert opt_o.compression == opt_s.compression == ("int8" if int8
                                                      else None)
    plan = _pipelined_plan(opt_o, lr)
    _, _, hist = _run_pipelined(opt_o, plan, params, grads, lr)
    sync_plan = GossipPlan.for_optimizer(opt_s)
    p, s, pay = params, opt_s.init(params), None
    for t in range(T):
        p, s, pay = _sequential_delayed_step(opt_s, sync_plan, t, lr)(
            p, s, grads[t], pay)
        _eq(p, hist[t][0], f"int8={int8} every={every} warmup={warmup} "
            f"step {t}")

    jopt = _chain(JTR, JT.one_peer_exponential(n), kw, every, warmup, True)
    jhist = _jax_pipelined(jopt, _j(npp), _np_grads(npp, T, seed=50), lr)
    for t in range(T):
        for k in npp:
            got, want = hist[t][0][k].numpy(), np.asarray(jhist[t][k])
            if not int8:
                np.testing.assert_allclose(got, want, **TOL)
                continue
            # f32 agreement where the codes agree; elsewhere (fewer than
            # 0.1 % of elements) at most one quantum of the largest scale
            quantum = 0.5 * np.abs(want).max() / 127.0 * 1.01
            d = np.abs(got - want)
            assert (d > 1e-6 + 1e-6 * np.abs(want)).sum() <= 1e-3 * d.size
            assert d.max() <= quantum + 1e-6


def test_delayed_exact_average_over_period():
    """With zero gradients the delayed one-peer pipeline still reaches the
    EXACT average after one period + the flush; every family keeps the
    global mean."""
    for top in (TT.one_peer_exponential(8), TT.one_peer_hypercube(8),
                TT.ceca(6), TT.bipartite_random_match(6, pool=2)):
        n = top.n
        params = _t(_np_params(n, d=7, seed=9))
        zero = [{k: torch.zeros_like(v) for k, v in params.items()}] * (
            top.period or 8)
        opt = TO.dsgd(top, overlap=True)
        plan = _pipelined_plan(opt, 0.0)
        p, s, _ = _run_pipelined(opt, plan, params, zero, 0.0)
        p, _ = plan.flush_step_fn(len(zero))(p, s)
        for k, x in p.items():
            if top.name in ("one_peer_exp", "one_peer_hypercube", "ceca"):
                want = params[k].mean(0, keepdim=True).expand_as(x)
                np.testing.assert_allclose(x.numpy(), want.numpy(),
                                           atol=1e-6)
            np.testing.assert_allclose(x.numpy().mean(0),
                                       params[k].numpy().mean(0), atol=1e-6)


def _dmsgd_pipeline(lr):
    n = 4
    top = TT.one_peer_exponential(n)
    npp = _np_params(n)
    opt = TO.dmsgd(top, beta=0.9, overlap=True)
    return (opt, _pipelined_plan(opt, lr), _t(npp),
            [_t(g) for g in _np_grads(npp, 8)])


def test_checkpoint_carry_buffer_resumes_bit_identically(tmp_path):
    """A checkpoint (repro_torch.checkpoint) holding the live in-flight
    buffer resumes bit-identically to never having stopped."""
    k, lr = 3, 0.1
    opt, plan, params, grads = _dmsgd_pipeline(lr)
    pu, su, _ = _run_pipelined(opt, plan, params, grads, lr)
    p, s, _ = _run_pipelined(opt, plan, params, grads[:k], lr)
    assert s.buf is not None
    tree = {"params": p, "momentum": s.momentum, "buf": s.buf}
    tckpt.save(str(tmp_path), k, tree)
    rest = tckpt.restore(str(tmp_path), k, tree)
    # the buffer's layout follows the params' key order: the restore
    # keeps it (leaves are written with the keys sorted)
    assert list(rest["params"]) == list(p) != sorted(p)
    state = TO.OptState(rest["momentum"], k, tuple(rest["buf"]))
    pr, sr, _ = _run_pipelined(opt, plan, rest["params"], grads[k:], lr,
                               start=k, state=state)
    _eq(pr, pu, "carry-buffer resumed params")
    _eq(sr.momentum, su.momentum, "carry-buffer resumed momentum")
    _eq(sr.buf, su.buf, "carry-buffer resumed in-flight buffer")


def test_checkpoint_flush_on_save_resumes_bit_identically(tmp_path):
    """Flush-on-save: the checkpoint holds the MIXED iterates and no
    buffer; the resume re-primes (step_fn(k, prime=True)) and equals the
    same flush + re-prime done in memory; a second flush is the
    identity."""
    k, lr = 3, 0.1
    opt, plan, params, grads = _dmsgd_pipeline(lr)
    p, s, _ = _run_pipelined(opt, plan, params, grads[:k], lr)
    fp, fs = plan.flush_step_fn(k)(p, s)
    assert fs.buf is None
    pm, sm, _ = _run_pipelined(opt, plan, fp, grads[k:], lr, start=k,
                               state=fs)
    tree = {"params": fp, "momentum": fs.momentum}
    tckpt.save(str(tmp_path), k, tree)
    rest = tckpt.restore(str(tmp_path), k, tree)
    state = TO.OptState(rest["momentum"], k, None)
    pr, sr, _ = _run_pipelined(opt, plan, rest["params"], grads[k:], lr,
                               start=k, state=state)
    _eq(pr, pm, "flush-on-save resumed params")
    _eq(sr.momentum, sm.momentum, "flush-on-save resumed momentum")
    fp2, fs2 = plan.flush_step_fn(k)(fp, fs)
    _eq(fp2, fp, "flush is idempotent")
    assert fs2.buf is None


def test_overlap_compile_keys_and_prime():
    """Keys carry the overlap phase; one in-flight realization reuses ONE
    executable; prime and flush executables are keyed apart; the
    executable count and the cache counters equal the reference's over
    the same run."""
    n = 4
    top, jtop = TT.one_peer_exponential(n), JT.one_peer_exponential(n)
    opt, jopt = TO.dmsgd(top, overlap=True), JO.dmsgd(jtop, overlap=True)
    plan, jplan = _pipelined_plan(opt, 0.1), _pipelined_plan(jopt, 0.1,
                                                              JPlan)
    assert plan.realization_key(0) == ("overlap", "prime")
    assert plan.realization_key(1)[0] == "overlap"
    assert plan.realization_key(1) == plan.realization_key(3)
    assert plan.realization_key(1) != plan.realization_key(2)
    for t in range(6):
        assert plan.realization_key(t) == jplan.realization_key(t)
    npp = _np_params(n)
    p, s = _t(npp), opt.init(_t(npp))
    jp, js = _j(npp), jopt.init(_j(npp))
    g = {k: torch.zeros_like(v) for k, v in p.items()}
    jg = {k: jnp.zeros_like(v) for k, v in jp.items()}
    for t in range(8):
        p, s = plan.step_fn(t)(p, s, g)
        jp, js = jplan.step_fn(t)(jp, js, jg)
        if t in (2, 5):
            plan.flush_step_fn(t + 1)(p, s)
            jplan.flush_step_fn(t + 1)(jp, js)
    assert plan.num_compiled == jplan.num_compiled == 5
    plan.flush_step_fn(8)(p, s)
    jplan.flush_step_fn(8)(jp, js)
    assert plan.num_compiled == jplan.num_compiled == 5
    assert plan.cache_stats() == jplan.cache_stats()
    io = plan.overlap_io(0)
    assert io.prime and plan.overlap_io(1).realization == top.realization(0)
    with pytest.raises(ValueError, match="priming"):
        io.delayed(p, ())
    with pytest.raises(ValueError, match="priming"):
        io.start(p, ())


def test_overlap_composition_is_validated():
    """The reference's refusals: overlapped gossip must be the chain's last
    applied transform (qg_dmsgd), one gossip per chain, known names, no
    mixing of sync and overlap, no time-varying dense stream, no runtime
    hook."""
    top = TT.one_peer_exponential(4)
    with pytest.raises(ValueError, match="AFTER the"):
        TO.qg_dmsgd(top, overlap=True)
    with pytest.raises(ValueError, match="no gossip payload"):
        TO.make_optimizer("parallel_msgd", top, overlap=True)
    with pytest.raises(ValueError, match="mixes overlapped and sync"):
        TTR.chain(
            TTR.trace_momentum(0.9),
            TTR.gossip(where=("m_next",), overlap=True),
            TTR.scale_by_lr("m"),
            TTR.gossip(where=("x_next",)),
            topology=top, name="bad")
    with pytest.raises(ValueError, match="neither"):
        TTR.chain(
            TTR.trace_momentum(0.9),
            TTR.scale_by_lr("m"),
            TTR.gossip(where=("qq",), overlap=True),
            topology=top, name="bad2")
    with pytest.raises(ValueError, match="time-varying dense"):
        GossipPlan(TT.base_k(12, 2), overlap=True)
    with pytest.raises(ValueError, match="runtime-valued"):
        TO.dmsgd(top, deadline=True, overlap=True)
    with pytest.raises(ValueError, match="scheduled=True"):
        GossipPlan(top, overlap=True, scheduled=True)


def test_overlap_io_roundtrip_equals_sync_mix():
    """OverlapIO.pack then .delayed (and .start, inline on the CPU) equal
    the synchronous mix of the same payload, for a Shifts round, a
    matching with a fixed point, int8, and Identity."""
    params = _t(_np_params(5, d=8, seed=2))
    rounds = [TT.one_peer_exponential(5).realization(0),
              TT.Matching((1, 0, 2, 4, 3), 0.3), TT.Identity()]
    from repro_torch.core import gossip as TG
    for r in rounds:
        for comp in ((None, "int8") if not isinstance(r, TT.Identity)
                     else (None,)):
            io = OverlapIO(r, comp)
            bufs = io.pack(params)
            want = TG.mix_realization(params, r, compression=comp)
            _eq(io.delayed(params, bufs), want, f"{r} {comp}")
            _eq(io.start(params, bufs).wait(), want, f"{r} {comp} start")


# ---------------------------------------------------------------------------
# The driver: the pipelined train step, and carry-buffer checkpoints
# ---------------------------------------------------------------------------

DRIVER = ["--device", "cpu", "--nodes", "4", "--steps", "4", "--batch",
          "1", "--seq", "16", "--log-every", "2", "--hetero", "0.5"]


class _Sequential:
    """The synchronous optimizer driven as the delayed recursion: at each
    step the previous payload is mixed synchronously (``mix`` is the sync
    plan's executor of step t-1, None at step 0) and lands on the params
    and slots, then the chain runs with an identity mix."""

    overlap = False
    has_runtime_gossip = False

    def __init__(self, opt):
        self.opt, self.payload = opt, None

    def update_with_mix(self, p, s, g, lr, mix, aux=None):
        opt = self.opt
        if mix is not None:
            p, slots = opt._land(mix(self.payload), p, opt._slots_of(s))
            s = opt._state_of(slots, s.count)
        p2, s2 = opt.update_with_mix(p, s, g, lr, lambda t: t)
        slots2 = opt._slots_of(s2)
        self.payload = tuple(
            {k: v.float() for k, v in (p2 if w == "x_next"
                                       else slots2[w[:-5]]).items()}
            for w in opt._overlap_names())
        if len(self.payload) == 1:
            self.payload = self.payload[0]
        return p2, s2


def _sequential_run(args):
    """The driver's run of ``args`` as the sequential delayed recursion;
    returns the flushed params and momentum."""
    start = TTrain.prepare(args)
    opt = TO.make_optimizer(args.optimizer, start["topology"],
                            beta=args.beta,
                            momentum_dtype=start["momentum_dtype"],
                            compression=args.compression)
    sync = GossipPlan.for_optimizer(opt)
    seq = _Sequential(opt)
    step = steps_mod.make_train_step(start["config"], seq)
    p, s = start["params"], opt.init(start["params"])
    for k in range(args.steps):
        p, s, _ = step(sync.mix(k - 1) if k else None, p, s,
                       start["batches"][k], start["lr_fn"](k))
    p, slots = opt._land(sync.mix(args.steps - 1)(seq.payload), p,
                         opt._slots_of(s))
    return p, opt._state_of(slots, s.count).momentum


@pytest.mark.parametrize("extra", [[], ["--compression", "int8"],
                                   ["--optimizer", "d_adamw",
                                    "--topology", "random_match"]])
def test_driver_pipelined_equals_sequential_delayed(extra):
    """launch.train --overlap (the pipelined train step: the delayed round
    started before the per-node backward) ends, flushed, bit-equal to the
    sequential delayed recursion driven through the same train step."""
    torch.set_num_threads(1)
    args = TTrain.parse_args(DRIVER + ["--overlap"] + extra)
    res = TTrain.run(args)
    assert res["state"].buf is None
    p, m = _sequential_run(args)
    _eq(res["params"], p, f"{extra} params")
    _eq(res["state"].momentum, m, f"{extra} momentum")


def test_carry_buffer_checkpoint_crosses_both_ways(tmp_path):
    """The driver's carry-buffer checkpoint (``gossip_buf``) is read by
    repro.checkpoint.ckpt.restore: its buffer is the JAX packing of the
    pre-mix payload it saved, and the reference's delayed round of it
    equals the port's flush within 1e-6.  The reverse: a JAX checkpoint
    of a packed payload, restored by the port and converted with
    gossip_buf_from_jax, is the port's packing of the same payload, bit
    for bit."""
    torch.set_num_threads(1)
    ck = tmp_path / "ck"
    args = TTrain.parse_args(DRIVER + ["--overlap", "--ckpt-dir", str(ck),
                                       "--ckpt-every", "2", "--steps", "3"])
    res = TTrain.run(args)
    cfg = res["config"]
    params = jax.eval_shape(lambda: JM.init(_jax_cfg(cfg),
                                            jax.random.key(0)))
    n = args.nodes
    stacked = jax.tree.map(lambda x: jnp.zeros((n,) + x.shape, x.dtype),
                           params)
    # the JAX layout of the payload fixes the buffer's width
    _, jb = JF.pack((stacked, stacked))
    like = {"params": stacked, "momentum": stacked,
            "gossip_buf": (jnp.zeros(jb[0].shape, jnp.float32),)}
    rest = jckpt.restore(str(ck), 2, like)
    _, want = JF.pack((rest["momentum"], rest["params"]))
    np.testing.assert_array_equal(np.asarray(rest["gossip_buf"][0]),
                                  np.asarray(want[0]))
    # the reference's delayed round of that buffer == the port's flush
    r = JT.one_peer_exponential(n).realization(2)
    jmix = JG.delayed_mix((rest["momentum"], rest["params"]),
                          rest["gossip_buf"], r)
    # replay the port to step 2 and flush there
    args2 = TTrain.parse_args(DRIVER + ["--overlap", "--steps", "3"])
    start = TTrain.prepare(args2)
    opt, step_for = TTrain.build_trainer(cfg, start["topology"], "dmsgd",
                                         0.9, overlap=True)
    p, s = start["params"], opt.init(start["params"])
    for k in range(3):
        p, s, _ = step_for(k)(p, s, start["batches"][k], start["lr_fn"](k))
    fp, fs = step_for.plan.flush_step_fn(3)(p, s)
    tm = convert.train_state_to_jax(fp, fs.momentum, cfg)
    for got, want in zip(jax.tree.leaves((tm["momentum"], tm["params"])),
                         jax.tree.leaves(jmix)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # the reverse: JAX writes, the port reads
    rng = np.random.default_rng(4)
    jpay = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape), jnp.float32), (stacked, stacked))
    _, jbufs = JF.pack(jpay)
    jckpt.save(str(tmp_path / "j"), 1, {"params": jpay[1],
                                        "momentum": jpay[0],
                                        "gossip_buf": tuple(jbufs)})
    tl = convert.train_state_to_jax(p, s.momentum, cfg)
    tlike = {"params": tl["params"], "momentum": tl["momentum"],
             "gossip_buf": (torch.zeros(tuple(jbufs[0].shape)),)}
    trest = tckpt.restore(str(tmp_path / "j"), 1, tlike)
    template = opt.payload_template(p, s)
    bufs = convert.gossip_buf_from_jax(trest["gossip_buf"], template, cfg)
    tpay = (convert.stacked_from_nested(trest["momentum"], cfg),
            convert.stacked_from_nested(trest["params"], cfg))
    tpay = tuple({k: part[k] for k in tpl} for part, tpl in
                 zip(tpay, template))
    _, want_bufs = TF.pack(tpay)
    _eq(tuple(want_bufs), bufs, "port packing of the JAX checkpoint")
    # and back again: the JAX packing, bit for bit
    back = convert.gossip_buf_to_jax(bufs, template, cfg)
    np.testing.assert_array_equal(back[0].numpy(), np.asarray(jbufs[0]))


def _jax_cfg(cfg):
    """The JAX package's reduced config of the port's ``cfg``."""
    return dataclasses.replace(
        JC.reduced_config(JC.get_config(cfg.name)), n_layers=cfg.n_layers)
