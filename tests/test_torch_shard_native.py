"""The shard-native gossip engine (``repro_torch.core.gossip`` with
``mesh=``) on one CPU world of 8 spawned ranks, a (node 4, fsdp 2) mesh
over gloo (``repro_torch.launch.mesh_check.engine_rank``; a ``file://``
store under ``tmp_path``).

Each rank mixes its block of the reference test's ``{w, b, h}`` tree
(``tests/test_shard_native.py``: ``w`` and ``h`` sharded over fsdp, ``b``
replicated, ``h`` bf16) through every realization, and every block is
held against its slice of the port's global path and of the REFERENCE's
global path on the same numpy inputs: bit for bit where the reference's
own test holds its engine bit for bit (Shifts, Matching, int8 -- fixed
points included), within its 1e-5 (f32) / 1e-2 (bf16) elsewhere (Dense,
and rounds whose weights are not powers of two, where the port's FMA
combine parts from the reference's by an ulp).  The wire logs must equal
``gossip_spec``'s accounting, and no shard-native round gathers the
payload.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gossip as JG, topology as JT
from repro_torch.launch import mesh as MM, mesh_check as MC, sharding

NODES, FSDP = MC.NODES, MC.FSDP
STATIC = [name for name, _, _ in MC.static_rounds(NODES)]
RUNTIME = ["gated", "meta", "node_gate"]
GATHERED = ["gathered_shifts", "gathered_int8", "gathered_grid"]
# bit for bit against the reference: its own shard-native test's
# equalities (power-of-two weights, int8)
REF_EXACT = {"shifts", "hypercube", "matching", "shifts_int8",
             "matching_int8", "gathered_shifts", "gathered_int8"}


@pytest.fixture(scope="module")
def payload(tmp_path_factory):
    """The one world: ``engine_rank``'s rounds, then DmSGD's (m, x) of
    reduced qwen3 (specs from ``gossip_payload_spec_fn``), each rank's
    output handed back and compared in this process."""
    store = tmp_path_factory.mktemp("shard_native_store")
    return MC.payload_world("qwen3-0.6b", None, 0, (NODES, FSDP),
                            device="cpu", engine=True, store_dir=str(store),
                            timeout=300)


@pytest.fixture(scope="module")
def world(payload):
    return [r["engine"] for r in payload[0]]


def _jax_tree(n, seed):
    t = MC.wbh_tree(n, seed)
    return {"w": jnp.asarray(t["w"]), "b": jnp.asarray(t["b"]),
            "h": jnp.asarray(t["h"]).astype(jnp.bfloat16)}


def _jax_round(name, n):
    """The reference's global path for round ``name`` on its tree."""
    one_peer = JT.one_peer_exponential(n).realization(0)
    fixed = JT.Matching((1, 0) + tuple(range(2, n)))
    static = {"shifts": (one_peer, None),
              "hypercube": (JT.one_peer_hypercube(n).realization(0), None),
              "matching": (fixed, None),
              "static_exp": (JT.static_exponential(n).realization(0), None),
              "shifts_int8": (one_peer, "int8"),
              "matching_int8": (fixed, "int8"),
              "grid": (JT.grid_2d(n).realization(0), None),
              "full": (JT.full_averaging(n).realization(0), None)}
    if name in static:
        r, comp = static[name]
        return lambda t: JG.mix_realization(t, r, compression=comp)
    inputs = MC.runtime_inputs(n)
    alive = jnp.asarray(inputs["alive"])
    loss = jnp.asarray(inputs["loss"])
    m = JT.one_peer_hypercube(n).realization(0)

    def edge_weight(own, recv, w):
        return jnp.asarray(w, jnp.float32) * jnp.where(
            recv[:, 0] < own[:, 0], 1.5, 0.5)

    return {"gated": lambda t: JG.mix_realization(t, JT.Gated(one_peer,
                                                               alive)),
            "meta": lambda t: JG.mix_shifts(t, 0.5, list(one_peer.shifts),
                                            meta=loss,
                                            edge_weight=edge_weight),
            "node_gate": lambda t: JG.mix_matching(t, m.partner, 0.5,
                                                   node_gate=alive)}[name]


def _reference_blocks(name, coords):
    gathered = name.startswith("gathered_")
    n = 2 * NODES if gathered else NODES
    key = name[len("gathered_"):] if gathered else name
    out = _jax_round({"int8": "shifts_int8"}.get(key, key), n)(
        _jax_tree(n, 1 if gathered else 0))
    got = {k: torch.from_numpy(np.array(v, np.float32))
           for k, v in out.items()}
    specs = MC.WBH_SPECS
    if gathered:
        i = coords["node"]
        got = {k: v[2 * i:2 * i + 2] for k, v in got.items()}
        specs = {k: (None,) + s[1:] for k, s in specs.items()}
    mesh = MM.abstract_mesh((NODES, FSDP), ("node", "fsdp"))
    return {k: v.numpy() for k, v in
            sharding.local_shard(got, specs, mesh, coords).items()}


def _hold(got, want, exact, what):
    for k in want:
        if exact:
            np.testing.assert_array_equal(got[k], want[k], err_msg=what)
        else:
            tol = 1e-2 if k == "h" else 1e-5
            np.testing.assert_allclose(got[k], want[k], rtol=tol,
                                       atol=tol * 1e-1, err_msg=what)


@pytest.mark.parametrize("name", STATIC + RUNTIME + GATHERED)
def test_blocks_match_port_global_path(world, name):
    """Each rank's block equals its slice of the port's single-process
    global path: bit for bit but for Dense (another summation order)."""
    for res in world:
        want = MC.expected_blocks(name, NODES, 0, res["coords"])
        _hold(res["rounds"][name]["out"], want, not MC._dense(name),
              f"rank {res['rank']} {name}")


@pytest.mark.parametrize("name", STATIC + RUNTIME + GATHERED)
def test_blocks_match_reference_global_path(world, name):
    """... and its slice of the reference's global path on the same numpy
    inputs, bit for bit where the reference's own shard-native test is."""
    for res in world:
        _hold(res["rounds"][name]["out"],
              _reference_blocks(name, res["coords"]), name in REF_EXACT,
              f"rank {res['rank']} {name}")


@pytest.mark.parametrize("name", STATIC)
def test_wire_log_equals_gossip_spec(world, name):
    """One permute per shift per dtype group moving the local shard's
    exact bytes (int8: payload and scale row, plus one pmax per group);
    Dense: one permute per circulant distance class (exact averaging: one
    psum per group, no permute); never an all-gather of the payload."""
    exp = MC.wire_expectation(name, NODES, FSDP)
    for res in world:
        log = res["rounds"][name]["log"]
        assert {k: v["ops"] for k, v in log.items()} == exp["counts"]
        assert "all_gather" not in log
        fixed_point = name.startswith("matching") and \
            res["coords"]["node"] >= 2
        if exp["bytes"] is not None:
            sent = log["permute"]["bytes"]
            assert sent == (0 if fixed_point else exp["bytes"]), (
                res["rank"], sent)
    if name == "shifts":
        # the f32 leaves' share: w over fsdp, b replicated (the reference
        # test's 4 * ((16 * 8) // fsdp + 6)), the bf16 h over fsdp
        assert exp["bytes"] == 4 * ((16 * 8) // FSDP + 6) \
            + 2 * (8 * 4) // FSDP


def test_fixed_points_keep_their_value(world):
    """Matching fixed points (nodes 2 and 3) keep their block bit for bit,
    int8 included; the gathered path moves the payload (all-gathers)."""
    mesh = MM.abstract_mesh((NODES, FSDP), ("node", "fsdp"))
    full = MC.torch_tree(MC.wbh_tree(NODES, 0))
    for res in world:
        if res["coords"]["node"] < 2:
            continue
        mine = sharding.local_shard(full, MC.WBH_SPECS, mesh, res["coords"])
        for name in ("matching", "matching_int8"):
            for k, v in mine.items():
                np.testing.assert_array_equal(
                    res["rounds"][name]["out"][k], v.float().numpy())
    for res in world:
        for name in GATHERED:
            assert res["rounds"][name]["log"]["all_gather"]["ops"] == 2


@pytest.mark.parametrize("name", MC.DELAYED)
def test_delayed_halves_match_the_synchronous_round(world, name):
    """pack_payload then delayed_mix on the mesh is bit for bit the
    synchronous shard-native round (Identity, Dense and int8 too)."""
    assert all(res["delayed"][name] for res in world)


def test_runtime_rounds_ride_the_f32_permute(world):
    """Metadata and the alive flag ride the f32 group's permute: one
    permute per dtype group, 4 bytes a column more on the f32 one."""
    for res in world:
        base = res["rounds"]["shifts"]["log"]["permute"]
        for name, cols in (("gated", 1), ("meta", 1), ("node_gate", 1)):
            log = res["rounds"][name]["log"]
            assert set(log) == {"permute"} and log["permute"]["ops"] == 2
            assert log["permute"]["bytes"] == base["bytes"] + 4 * cols


@pytest.mark.parametrize("name", MC.PAYLOAD_ROUNDS)
def test_payload_blocks_match_global_path(payload, name):
    """DmSGD's (m, x) payload of reduced qwen3 at its specs
    (``gossip_payload_spec_fn``: fsdp-sharded leaves, a replicated
    embedding): every rank's block, returned through the exchange the
    card's phase uses, equals its slice of the port's global path (bit
    for bit; Dense within 1e-5), and each round logged one op a rank per
    permute or psum."""
    res, comps = payload
    for rank, (equal, err, close) in comps[name].items():
        assert (close if name in ("grid", "full") else equal), (rank, err)
    for r in res:
        log = r["rounds"][name]["log"]
        want = {"shifts": {"permute": 1}, "matching": {"permute": 1},
                "shifts_int8": {"permute": 2, "pmax": 1},
                "grid": {"permute": 3}, "full": {"psum": 1}}[name]
        assert {k: v["ops"] for k, v in log.items()} == want


def test_check_helper_agrees(world):
    """``mesh_check.check`` (what the CLI and the card's phase run) finds
    nothing to report on this world."""
    assert MC.check(world) == []
