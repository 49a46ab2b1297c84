"""PyTorch port parity: ``repro_torch.benchmarks.bench_comm``,
``check_comm_regression`` and ``core.gossip.mix_shifts_per_leaf`` against
the JAX package's, on the CPU.

* ``mix_shifts_per_leaf`` on the reference's cases (tests/test_flatbuf.py:
  the neighbour-schedule topologies x {None, int8}, f32 and bf16 leaves):
  bit for bit the port's flat ``mix_shifts``, and bit for bit the
  reference's ``mix_shifts_per_leaf`` wherever every product of a weight
  and a value is exact (int8, and weights that are powers of two).  The
  port's uncompressed combine accumulates with one rounding per term
  (``add_(alpha=w)``, an FMA, as its CUDA kernel's ``fmaf``), the
  reference's rounds the product and the sum apart, so ring's 1/3 weights
  part by an f32 ulp (a bf16 ulp after the cast): held there to the
  gossip-mix tolerances, f32 1e-5 and bf16 2e-2 (tests/test_kernels.py:189
  and :15).
* The structural rows (``comm_table(time_mix=False)``, ``two_axis_rows``,
  ``runtime_rows``) equal the reference's field by field when both pad
  their flat buffers to 8 elements (NaN equals NaN; ``gap`` and
  ``transient`` within 1e-12 relative).  At the default pads (the port's
  8, the reference's 8,192) every wire-bytes field is the committed
  ``BENCH_comm.json``'s x 1,000,000 / 1,007,616 in exact integers, the
  runtime rows' metadata bytes unscaled.
* ``check_comm_regression``: the port's ``compare``, ``report_timings``
  and ``main`` give the reference's messages, output and exit codes on the
  committed record and mutated copies of it.
* ``bench_comm --quick`` on the CPU (its overlap pair at a reduced size)
  writes a record the REFERENCE's checker accepts against
  ``BENCH_comm.json``.  On the CPU there is no side stream, so the
  overlap speedup is not held to 1.0 here (``min_overlap_speedup=0``);
  the card's run is ``chip_smoke.py`` phase 17.
* The two-axis engine comparison runs on a CPU world of 8 ranks: the
  shard-native round one permute a rank, the global path 194
  all-gathers, the two bit for bit equal.
Torch is pinned to one thread."""
import copy
import functools
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's benchmarks/ package lives at the repo root
sys.path.insert(0, REPO)
from benchmarks import bench_comm as jbc
from benchmarks import check_comm_regression as jcc
from repro.core import flatbuf as JF, gossip as JG, topology as JT
from repro_torch.benchmarks import bench_comm as tbc
from repro_torch.benchmarks import check_comm_regression as tcc
from repro_torch.benchmarks import run as trun
from repro_torch.core import gossip as TG, topology as TT

BENCH = os.path.join(REPO, "BENCH_comm.json")
# elements a node of the table's 1M-f32 tree: the port's pad (8) and the
# reference's (its kernel's 8 x 1024 tile)
PORT_ELEMS, REF_ELEMS = 1_000_000, 1_007_616
# the gossip-mix tolerances, tests/test_kernels.py:189 (f32) and :15 (bf16)
GM_TOL = {np.dtype(np.float32): dict(rtol=1e-5, atol=1e-5),
          np.dtype(ml_dtypes.bfloat16): dict(rtol=2e-2, atol=2e-2)}

# tests/test_flatbuf.py:81-83
SCHED_TOPS = [("ring", {}), ("static_exp", {}), ("one_peer_exp", {}),
              ("one_peer_exp", {"schedule": "random_perm"}),
              ("one_peer_exp", {"schedule": "uniform"})]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(n, seed=0):
    """tests/test_flatbuf.py's tree (two f32 leaves, a bf16 leaf, a
    nested f32 leaf), drawn with numpy."""
    rng = np.random.default_rng(seed)

    def rn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"w": rn(n, 8, 16), "b": rn(n, 4),
            "h": rn(n, 3, 5).astype(ml_dtypes.bfloat16),
            "nested": {"v": rn(n, 2, 3, 2)}}


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:     # bf16 crosses as an int16 view
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _leaves(tree):
    return [tree["w"], tree["b"], tree["h"], tree["nested"]["v"]]


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _exact_products(self_w, shifts) -> bool:
    """Every weight a power of two: w * x is exact in f32, so an FMA and a
    rounded product give the same sum."""
    return all(w == 0 or math.frexp(w)[0] == 0.5
               for w in [self_w] + [w for _, w in shifts])


def _check_per_leaf(top, tree, steps, compression):
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = jax.tree.map(_torch, tree)
    for step in steps:
        r = top.realization(step)
        self_w, shifts = r.self_w, list(r.shifts)
        got = TG.mix_shifts_per_leaf(ttree, self_w, shifts, compression)
        flat = TG.mix_shifts(ttree, self_w, shifts, compression)
        want = JG.mix_shifts_per_leaf(jtree, self_w, shifts, compression)
        exact = compression == "int8" or _exact_products(self_w, shifts)
        for a, f, b in zip(_leaves(got), _leaves(flat), _leaves(want)):
            assert a.dtype == f.dtype
            np.testing.assert_array_equal(_np(a), _np(f))
            if exact:
                np.testing.assert_array_equal(_np(a), _np(b))
            else:
                np.testing.assert_allclose(_np(a), _np(b),
                                           **GM_TOL[np.asarray(b).dtype])


@pytest.mark.parametrize("name,kw", SCHED_TOPS)
@pytest.mark.parametrize("compression", [None, "int8"])
def test_per_leaf_mix_matches_flat_and_reference(name, kw, compression):
    top = JT.get_topology(name, 8, **kw)
    port = TT.get_topology(name, 8, **kw)
    for step in range(5):
        r, t = top.realization(step), port.realization(step)
        assert (t.self_w, t.shifts) == (r.self_w, r.shifts)
    _check_per_leaf(top, _tree(8, seed=5), range(5), compression)


@pytest.mark.parametrize("name", [t for t, _ in SCHED_TOPS[:3]])
@pytest.mark.parametrize("n", [4, 6, 8, 16])
def test_per_leaf_mix_over_node_counts(name, n):
    """tests/test_flatbuf.py's property test over n, at fixed draws."""
    top = JT.get_topology(name, n)
    _check_per_leaf(top, _tree(n, seed=n), (0, n - 1), None)


def test_per_leaf_mix_refuses_unknown_compression():
    tree = jax.tree.map(_torch, _tree(4))
    with pytest.raises(ValueError, match="compression"):
        TG.mix_shifts_per_leaf(tree, 0.5, [(1, 0.5)], "fp8")


# ---------------------------------------------------------------------------
# the structural rows
# ---------------------------------------------------------------------------

RELATIVE = ("gap", "transient")


def _same(a, b, key):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if key in RELATIVE and b is not None:
        return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)
    return a == b


def _rows_equal(got, want):
    assert [r["topology"] for r in got] == [r["topology"] for r in want]
    for g, w in zip(got, want):
        assert list(g) == list(w), (sorted(g), sorted(w))
        for key in w:
            assert _same(g[key], w[key], key), (g["topology"], key, g[key],
                                                w[key])


@pytest.fixture
def ref_pad8(monkeypatch):
    """The reference's benchmark functions with their flat buffers padded
    to 8 elements, the port's pad."""
    monkeypatch.setattr(JF, "layout_of",
                        functools.partial(JF.layout_of, pad_multiple=8))


def test_comm_table_equals_reference_at_equal_padding(ref_pad8):
    _rows_equal(tbc.comm_table(16, time_mix=False),
                jbc.comm_table(16, time_mix=False))


def test_two_axis_and_runtime_rows_equal_reference_at_equal_padding(
        ref_pad8):
    _rows_equal(tbc.two_axis_rows(16, fsdp=8), jbc.two_axis_rows(16, fsdp=8))
    _rows_equal(tbc.runtime_rows(16), jbc.runtime_rows(16))


def _scaled(port_bytes, ref_bytes) -> bool:
    """port x 1,007,616 == reference x 1,000,000, in exact integers."""
    return port_bytes * REF_ELEMS == ref_bytes * PORT_ELEMS


@pytest.fixture(scope="module")
def committed():
    with open(BENCH) as f:
        return json.load(f)


def test_wire_bytes_are_the_committed_record_without_its_padding(committed):
    rows = tbc.comm_table(16, time_mix=False)
    assert [r["topology"] for r in rows] == [r["topology"]
                                             for r in committed["rows"]]
    for g, w in zip(rows, committed["rows"]):
        assert _scaled(g["bytes_per_iter"], w["bytes_per_iter"]), g
        for key in w:
            if key not in ("bytes_per_iter", "us_per_mix"):
                assert _same(g[key], w[key], key), (g["topology"], key)
    two = tbc.two_axis_rows(16, fsdp=8)
    for g, w in zip(two, committed["two_axis"]["rows"], strict=True):
        for key in ("bytes_per_iter_per_node", "bytes_per_iter_per_shard"):
            assert _scaled(g[key], w[key]), (g["topology"], key)
        assert {k: g[k] for k in ("topology", "n", "fsdp", "kind",
                                  "collectives_per_step")} == \
            {k: w[k] for k in ("topology", "n", "fsdp", "kind",
                               "collectives_per_step")}
    for g, w in zip(tbc.runtime_rows(16), committed["runtime"]["rows"],
                    strict=True):
        assert g["meta_bytes_per_iter"] == w["meta_bytes_per_iter"]
        assert _scaled(g["bytes_per_iter"] - g["meta_bytes_per_iter"],
                       w["bytes_per_iter"] - w["meta_bytes_per_iter"])
        for key in ("topology", "n", "kind", "meta_cols",
                    "collectives_per_step"):
            assert g[key] == w[key]


# ---------------------------------------------------------------------------
# check_comm_regression
# ---------------------------------------------------------------------------

def _mutate(rec, how):
    new = copy.deepcopy(rec)
    if how == "bytes+25%":
        new["rows"][0]["bytes_per_iter"] = int(
            new["rows"][0]["bytes_per_iter"] * 1.25)
        new["two_axis"]["rows"][1]["bytes_per_iter_per_shard"] *= 2
    elif how == "runtime_collective":
        new["runtime"]["rows"][0]["collectives_per_step"] += 1
    elif how == "nan_us_per_mix":
        new["rows"][2]["us_per_mix"] = float("nan")
    elif how == "no_overlap":
        del new["overlap"]
    elif how == "speedup_0.9":
        new["overlap"]["speedup"] = 0.9
    elif how == "improved":
        new["rows"][3]["bytes_per_iter"] //= 2
        new["rows"].append(dict(new["rows"][0], topology="star"))
    return new


MUTATIONS = [None, "bytes+25%", "runtime_collective", "nan_us_per_mix",
             "no_overlap", "speedup_0.9", "improved"]


@pytest.mark.parametrize("how", MUTATIONS)
def test_checker_gives_the_references_messages(committed, how, capsys):
    new = _mutate(committed, how)
    want = jcc.compare(committed, new) + jcc.report_timings(committed, new)
    want_out = capsys.readouterr().out
    got = tcc.compare(committed, new) + tcc.report_timings(committed, new)
    assert got == want
    assert capsys.readouterr().out == want_out
    assert bool(got) == (how not in (None, "improved"))


@pytest.mark.parametrize("how", [None, "bytes+25%", "speedup_0.9"])
def test_checker_main_exit_codes(committed, how, tmp_path, monkeypatch,
                                 capsys):
    path = tmp_path / "new.json"
    path.write_text(json.dumps(_mutate(committed, how)))
    argv = ["--baseline", BENCH, "--new", str(path)]
    codes, outs = [], []
    for main in (lambda: tcc.main(argv), jcc.main):
        monkeypatch.setattr(sys, "argv", ["check_comm_regression"] + argv)
        try:
            main()
            codes.append(0)
        except SystemExit as e:
            codes.append(e.code)
        outs.append(capsys.readouterr().out)
    assert codes[0] == codes[1] == (0 if how is None else 1)
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the quick record, the engine comparison, the refusal
# ---------------------------------------------------------------------------

def test_quick_record_passes_the_references_checker(committed, tmp_path,
                                                    capsys):
    out = tmp_path / "BENCH_comm.new.json"
    tbc.run_quick(str(out), device="cpu", param_elems=120_000, steps=4)
    assert "wrote" in capsys.readouterr().out
    new = json.loads(out.read_text())
    assert list(new) == list(committed)
    assert list(new["overlap"]) == list(committed["overlap"])
    assert new["overlap"]["fsdp"] == 1
    for sec in ("rows",):
        assert [list(r) for r in new[sec]] == [list(r)
                                               for r in committed[sec]]
    assert all(r["us_per_mix"] > 0 for r in new["rows"])
    assert jcc.compare(committed, new) == []
    assert jcc.report_timings(committed, new, min_overlap_speedup=0) == []
    assert tcc.compare(committed, new) == []


def test_engine_compare_rows_and_two_axis_refusal(capsys):
    rows = tbc.engine_compare_spmd(device="cpu")
    assert [r["name"] for r in rows] == [
        "comm_engine_one_peer_exp_flat", "comm_engine_one_peer_exp_perleaf",
        "comm_engine_static_exp_flat", "comm_engine_static_exp_perleaf",
        "comm_engine_one_peer_hypercube_matching"]
    derived = [dict(kv.split("=") for kv in r["derived"].split(";"))
               for r in rows]
    assert all(d["leaves"] == "97" and d["n"] == "8" for d in derived)
    # rolls a round launches: one per shift per dtype group, or per leaf
    assert [d["permutes_per_step"] for d in derived] == ["1", "97", "3",
                                                         "291", "1"]
    assert all(r["us"] > 0 for r in rows)
    two = tbc.engine_compare_two_axis(device="cpu", iters=1)
    assert [r["name"] for r in two] == [
        "comm_engine2ax_one_peer_exp_shardnative",
        "comm_engine2ax_one_peer_exp_global"]
    d2 = [r["derived"] for r in two]
    assert "collectives={'permute': 1}" in d2[0]
    assert "coll_bytes_per_rank=2000000" in d2[0]     # half a node's 1M f32
    assert "equal_to_global=True" in d2[0]
    assert "collectives={'all_gather': 194}" in d2[1]  # 97 leaves x 2 axes


def test_run_suite_comm(capsys, monkeypatch):
    """``run --only comm`` prints the table, the flat-engine rows, then
    the two-axis comparison's.  That comparison's world of 8 ranks is
    test_engine_compare_rows_and_two_axis_refusal's; here a stand-in
    records that ``run`` calls it on the device and prints its rows."""
    calls = []

    def two_axis(device="cuda", **kw):
        calls.append(str(device))
        for tag in ("shardnative", "global"):
            tbc.emit(f"comm_engine2ax_one_peer_exp_{tag}", 1.0, "stand-in")

    monkeypatch.setattr(tbc, "engine_compare_two_axis", two_axis)
    trun.main(["--only", "comm", "--device", "cpu"])
    assert calls == ["cpu"]
    cap = capsys.readouterr()
    names = [ln.split(",")[0] for ln in cap.out.splitlines()[1:]]
    assert names[:len(jbc.TABLE_TOPOLOGIES)] == [
        f"comm_{t}" for t in jbc.TABLE_TOPOLOGIES]
    assert names[len(jbc.TABLE_TOPOLOGIES):][0] == \
        "comm_engine_one_peer_exp_flat"
    assert names[-2:] == ["comm_engine2ax_one_peer_exp_shardnative",
                          "comm_engine2ax_one_peer_exp_global"]
    assert "item 18" not in cap.err


def test_roofline_still_waits_and_comm_needs_a_card(tmp_path, monkeypatch,
                                                    capsys):
    """The roofline suite (it raised, naming item 23, until the dry run
    was ported) reads DRYRUN_DIR: a row per record, a missing-records row
    for an empty directory; ``bench_comm`` still needs a card."""
    from repro_torch.launch import dryrun

    monkeypatch.setenv("DRYRUN_DIR", str(tmp_path))
    trun.run_suites(["roofline"], "cpu")
    assert capsys.readouterr().out.startswith("roofline_missing,0.0,")
    dryrun.run_one("mamba2-1.3b", "decode_32k", multi_pod=True,
                   out_dir=str(tmp_path), verbose=False)
    seconds, failed = trun.run_suites(["roofline"], "cpu")
    assert failed == [] and set(seconds) == {"roofline"}
    rows = capsys.readouterr().out.splitlines()
    assert [r.split(",")[0] for r in rows] == [
        "roofline_mamba2-1.3b_decode_32k_2pod"]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbc.main(["--quick", "--out", os.devnull])
