"""PyTorch port parity: the paper's figures (``repro_torch.benchmarks``)
and ``launch/topology_compare``, on the CPU at small sizes.

* The spectral functions equal the JAX package's within 1e-12, and the
  host-math suites (Fig. 3 / Table 5, Figs. 4/10/11) print the reference's
  CSV rows, derived column for derived column; every consensus residue
  row is within 1e-10.
* The problem data of bench_transient and bench_hetero are the
  reference's numpy draws, bit for bit.
* 100-step trajectories with the reference's JAX-key draws (minibatch
  indices, gradient noise) injected into the port agree within f32 2e-4
  (tests/test_kernels.py:16).  The JAX side runs the reference's own loop
  bodies with those draws; the full-size orderings are chip_smoke.py's.
* ``run.py``'s CSV header, its ``roofline`` suite reading a dry-run
  record from ``DRYRUN_DIR``, and ``topology_compare`` on a tiny grid.
* The serving benchmark: the port's ``check_serve_regression.compare``
  gives the reference's messages on the same records, and ``bench_serve
  --quick --device cpu`` writes the reference's JSON schema, which the
  reference's checker accepts.
Torch is pinned to one thread."""
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the reference's benchmarks/ package lives at the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from benchmarks import bench_consensus as jbc
from benchmarks import bench_spectral_gap as jbs, bench_transient as jbt
from benchmarks import check_serve_regression as jcsr
from repro.core import optim as JO, spectral as JSp, topology as JT
from repro_torch.benchmarks import bench_consensus as tbc
from repro_torch.benchmarks import bench_hetero as tbh
from repro_torch.benchmarks import bench_serve as tbsv
from repro_torch.benchmarks import check_serve_regression as tcsr
from repro_torch.benchmarks import bench_spectral_gap as tbs
from repro_torch.benchmarks import bench_transient as tbt
from repro_torch.benchmarks import run as trun
from repro_torch.core import spectral as TSp, topology as TT
from repro_torch.launch import topology_compare

TOL_TRAJ = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rows(capsys):
    """(name, derived) of every CSV row printed since the last read."""
    out = capsys.readouterr().out.splitlines()
    return [(ln.split(",")[0], ln.split(",", 2)[2]) for ln in out
            if ln.count(",") >= 2 and not ln.startswith("name,")]


def test_spectral_functions_match_jax():
    for name in ("ring", "grid", "torus", "static_exp", "star",
                 "half_random"):
        for n in (6, 8, 16):
            jW = JT.get_topology(name, n).weights(0)
            tW = TT.get_topology(name, n).weights(0)
            np.testing.assert_array_equal(tW, jW)
            assert abs(TSp.rho(tW) - JSp.rho(jW)) <= 1e-12
            assert abs(TSp.spectral_gap(tW) - JSp.spectral_gap(jW)) <= 1e-12
            assert abs(TSp.residual_norm(tW) - JSp.residual_norm(jW)) <= 1e-12
    for n in (1, 2, 7, 8, 48, 256):
        assert TSp.static_exp_gap_closed_form(n) == \
            JSp.static_exp_gap_closed_form(n)
    for gap in (0.5, 0.01):
        for het in (False, True):
            assert TSp.transient_iterations(32, gap, het) == \
                JSp.transient_iterations(32, gap, het)


@pytest.mark.parametrize("suite", ["spectral_gap", "consensus"])
def test_host_suites_print_the_reference_rows(suite, capsys):
    jmod, tmod = {"spectral_gap": (jbs, tbs),
                  "consensus": (jbc, tbc)}[suite]
    jmod.run()
    want = _rows(capsys)
    tmod.run()
    got = _rows(capsys)
    assert got == want
    assert all(v == "True" for _, d in got for kv in d.split(";")
               if "=" in kv and (v := kv.split("=")[1]) in ("True", "False"))


def test_consensus_residues_match_jax_for_every_row(n=32):
    steps = 3 * int(math.log2(n))
    jtops = {
        "one_peer_exp": JT.one_peer_exponential(n),
        "static_exp": JT.static_exponential(n),
        "random_match": JT.bipartite_random_match(n, seed=2),
        "one_peer_perm": JT.one_peer_exponential(n, schedule="random_perm"),
        "one_peer_unif": JT.one_peer_exponential(n, schedule="uniform"),
        "one_peer_n6": JT.one_peer_exponential(48),
        "base_k2": JT.base_k(n, 1),
        "base_k4": JT.base_k(n, 3),
        "ceca": JT.ceca(n),
        "ceca_n48": JT.ceca(48),
    }
    got = tbc.residues(n)
    assert set(got) == set(jtops)
    for k, top in jtops.items():
        want = JSp.consensus_residue_products(top, steps)
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-10)


def test_problem_data_is_bit_equal():
    jh, jy, jw = jbt._problem(8, d=10, M=200)
    th, ty, tw = tbt._problem(8, d=10, M=200)
    for t, j in ((th, jh), (ty, jy), (tw, jw)):
        assert t.dtype == np.float32
        np.testing.assert_array_equal(t, np.asarray(j))
    n, d, b, seed = 8, 10, 3.0, 0
    rng = np.random.default_rng(seed)   # the reference _run's draws
    A = jnp.asarray(rng.standard_normal((d, d)) * 0.3 + np.eye(d),
                    jnp.float32)
    yv = jnp.asarray(rng.standard_normal(d), jnp.float32)
    C = rng.standard_normal((n, d)).astype(np.float32)
    C -= C.mean(axis=0, keepdims=True)
    C = jnp.asarray(C * b)
    x_star = jnp.linalg.solve(A.T @ A, A.T @ yv)
    tA, tyv, tC, tx = tbh._problem(n, d, b, seed)
    for t, j in ((tA, A), (tyv, yv), (tC, C)):
        np.testing.assert_array_equal(t, np.asarray(j))
    np.testing.assert_allclose(tx, np.asarray(x_star), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("topname", tbt.TOPS)
def test_transient_curve_matches_jax_with_injected_indices(topname, n=8,
                                                           T=100):
    M = 200
    jh, jy, jw = jbt._problem(n, d=10, M=M)
    opt = (JO.parallel_msgd(n, beta=0.8) if topname == "parallel" else
           JO.make_optimizer("dmsgd", JT.get_topology(topname, n), beta=0.8))
    params = {"x": jnp.zeros((n, 10))}
    state = opt.init(params)
    key = jax.random.key(1)
    idx, want = [], []
    for k in range(T):     # the reference run()'s loop body
        key, sub = jax.random.split(key)
        idx.append(np.asarray(jax.random.randint(sub, (n, 8), 0, M)))
        g = {"x": jbt._grads(jh, jy, params["x"], sub)}
        params, state = opt.update(params, state, g, k,
                                   0.2 * (0.5 ** (k // 600)))
        if k % 25 == 0:
            want.append(float(jnp.mean(jnp.sum((params["x"] - jw) ** 2,
                                               -1))))
    h, y, w = (torch.from_numpy(a) for a in tbt._problem(n, d=10, M=M))
    got = tbt.curve(topname, n, h, y, w, T,
                    lambda k: torch.from_numpy(idx[k].astype(np.int64)))
    np.testing.assert_allclose(got, want, **TOL_TRAJ)


def _jax_noise(seed, shape, T):
    key = jax.random.key(seed + 1)
    out = []
    for _ in range(T):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape)))
    return out


@pytest.mark.parametrize("topname", ["parallel", "one_peer_exp", "ring"])
def test_hetero_run_matches_jax_with_injected_noise(topname, n=8, d=10,
                                                    T=100, b=1.0):
    lr, sigma, seed = 0.015, 0.3, 0
    noise = _jax_noise(seed, (n, d), T)
    A, yv, C, _ = (jnp.asarray(a) for a in tbh._problem(n, d, b, seed))
    x_star = jnp.linalg.solve(A.T @ A, A.T @ yv)
    opt = (JO.parallel_msgd(n, beta=0.8) if topname == "parallel" else
           JO.make_optimizer("dmsgd", JT.get_topology(topname, n), beta=0.8))
    params = {"x": jnp.zeros((n, d))}
    state = opt.init(params)
    tail = []
    for k in range(T):     # the reference _run's loop body
        r = jnp.einsum("ij,nj->ni", A, params["x"]) - yv[None]
        g = jnp.einsum("ij,ni->nj", A, r) + C
        g = g + sigma * noise[k]
        params, state = opt.update(params, state, {"x": g}, k, lr)
        tail.append(float(jnp.mean(jnp.sum((params["x"] - x_star[None])
                                           ** 2, -1))))
    got = tbh._run(n, d, topname, b, T=T, device="cpu",
                   noise=lambda k: torch.from_numpy(noise[k]))
    np.testing.assert_allclose(got, np.mean(tail), **TOL_TRAJ)


@pytest.mark.parametrize("mode", tbh.STRAGGLER_MODES)
def test_straggler_run_matches_jax_with_injected_noise(mode, n=8, d=10,
                                                       T=100):
    lr, sigma, seed, p_miss, slow = 0.02, 0.3, 0, 0.5, 4.0
    noise = _jax_noise(seed, (n, d), T)
    rng = np.random.default_rng(seed)      # the reference's draw order
    A = jnp.asarray(rng.standard_normal((d, d)) * 0.3 + np.eye(d),
                    jnp.float32)
    yv = jnp.asarray(rng.standard_normal(d), jnp.float32)
    x_star = jnp.linalg.solve(A.T @ A, A.T @ yv)
    straggler = np.zeros(n, bool)
    straggler[:2] = True
    deadline = mode != "wait"
    opt = JO.make_optimizer("dmsgd", JT.get_topology("one_peer_exp", n),
                            beta=0.8, deadline=deadline,
                            loss_aware=(mode == "skip+loss"))
    params = {"x": jnp.zeros((n, d))}
    state = opt.init(params)
    sim, tail = 0.0, []
    for k in range(T):     # the reference _run_straggler's loop body
        r = jnp.einsum("ij,nj->ni", A, params["x"]) - yv[None]
        g = jnp.einsum("ij,ni->nj", A, r) + sigma * noise[k]
        late = straggler & (rng.random(n) < p_miss)
        aux = None
        if deadline:
            sim += 1.0
            aux = {"loss": 0.5 * jnp.sum(r * r, axis=1),
                   "alive": jnp.asarray(~late)}
        else:
            sim += slow if late.any() else 1.0
        params, state = opt.update(params, state, {"x": g}, k, lr, aux=aux)
        tail.append(float(jnp.mean(jnp.sum((params["x"] - x_star[None])
                                           ** 2, -1))))
    row = tbh._run_straggler(n, d, "one_peer_exp", mode, T=T, device="cpu",
                             noise=lambda k: torch.from_numpy(noise[k]))
    assert row["sim_time"] == sim
    np.testing.assert_allclose(row["tail_mse"], np.mean(tail), **TOL_TRAJ)


def test_run_prints_csv_and_refuses_unported_suites(capsys, tmp_path,
                                                    tmp_path_factory,
                                                    monkeypatch):
    from repro_torch.launch import dryrun

    trun.main(["--only", "spectral_gap", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[1].startswith("spectral_gap_fig3,")
    assert all(len(ln.split(",", 2)) == 3 for ln in out)
    # roofline (refused, naming item 23, until the dry run was ported)
    # reads the dry run's records from DRYRUN_DIR: one CSV row a record
    records = tmp_path_factory.mktemp("dryrun")
    dryrun.run_one("qwen3-0.6b", "decode_32k", multi_pod=False,
                   out_dir=str(records), verbose=False)
    monkeypatch.setenv("DRYRUN_DIR", str(records))
    trun.main(["--only", "roofline", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived" and len(out) == 2
    name, us, derived = out[1].split(",", 2)
    assert name == "roofline_qwen3-0.6b_decode_32k_1pod" and float(us) > 0
    assert "dominant=" in derived and "useful_flops_ratio=" in derived
    assert trun.LATER == {}
    assert {"kernels", "comm", "roofline"} <= set(trun.SUITES)
    with pytest.raises(KeyError):
        trun.run_suites(["figure_99"], "cpu")
    merge = tmp_path / "hetero.json"
    tbh.main(["--quick", "--merge", str(merge), "--device", "cpu"])
    assert "skip_beats_wait_wallclock" in merge.read_text()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["hetero.json"]


def test_topology_compare_writes_its_csv(tmp_path, capsys):
    out = tmp_path / "tc" / "compare.csv"
    curves = topology_compare.main([
        "--device", "cpu", "--nodes", "8", "--steps", "60", "--tops",
        "parallel,one_peer_exp,ring,base_k", "--out", str(out)])
    lines = out.read_text().splitlines()
    assert lines[0] == "step,parallel,one_peer_exp,ring,base_k"
    assert len(lines) == 1 + 3 and set(curves) == {
        "parallel", "one_peer_exp", "ring", "base_k"}
    assert all(np.isfinite(m) for c in curves.values() for _, m in c)
    assert f"wrote {out}" in capsys.readouterr().out
    # --overlap (refused before the pipeline was ported): the delayed
    # curves, read from the flushed iterates
    ov = topology_compare.main([
        "--device", "cpu", "--nodes", "8", "--steps", "60", "--tops",
        "parallel,one_peer_exp", "--out", str(out), "--overlap"])
    assert set(ov) == {"parallel", "one_peer_exp"}
    assert ov["parallel"] == curves["parallel"]
    assert all(np.isfinite(m) for c in ov.values() for _, m in c)


# ---------------------------------------------------------------------------
# the serving benchmark and its gate
# ---------------------------------------------------------------------------

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serve_record(tps=100.0, p50=0.1, peak=1000, dense=4000):
    lat = {f: p50 for f in tcsr.LATENCY_FIELDS}
    return {"engine": {"tokens_per_s": tps, "peak_kv_bytes": peak,
                       "compile_cache": {"entries": 3, "hits": 9,
                                         "misses": 3, "evictions": 0},
                       **lat},
            "baseline": {"tokens_per_s": 50.0, "dense_kv_bytes": dense,
                         **lat},
            "speedup": tps / 50.0}


@pytest.mark.parametrize("new,n_fails", [
    (_serve_record(), 0),
    (_serve_record(tps=70.0), 1),             # a 30 % throughput drop
    (_serve_record(p50=float("nan")), 8),     # every latency NaN, both sides
    (_serve_record(peak=4000), 1),            # paged KV at the dense size
], ids=["pass", "throughput_drop", "nan_latency", "paged_kv_at_dense"])
def test_check_serve_regression_matches_reference(new, n_fails, capsys):
    base = _serve_record()
    got = tcsr.compare(base, new)
    out = capsys.readouterr().out
    want = jcsr.compare(base, new)
    assert got == want and out == capsys.readouterr().out
    assert len(got) == n_fails


def test_bench_serve_quick_writes_the_reference_schema(tmp_path, capsys):
    out = tmp_path / "bs.json"
    tbsv.main(["--quick", "--device", "cpu", "--out", str(out)])
    with open(out) as f:
        written = json.load(f)
    with open(os.path.join(_ROOT, "BENCH_serve.json")) as f:
        committed = json.load(f)

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in d.items()}

    assert keys(written) == keys(committed)
    assert written["config"] == committed["config"]
    eng, base = written["engine"], written["baseline"]
    assert eng["new_tokens"] == base["new_tokens"] == 12 * 8
    assert eng["preemptions"] == 0 and eng["peak_kv_bytes"] > 0
    assert jcsr.compare(written, written) == []
    assert tcsr.compare(written, written) == []
    assert "continuous batching speedup" in capsys.readouterr().out
