"""The instance mesh across card slots (repro_torch.core.instance_mesh), on
the CPU.

The port places serving instance i on slot i % k of a list of devices, as
the reference's mesh_for pins instance i to jax.devices()[i]. On the CPU a
slot list is "cpu" listed k times, the port's counterpart of the
reference's --xla_force_host_platform_device_count: it runs every part of
the multi-slot logic (slot-crossing FETCH, per-slot origins and stamps,
the flows' placement) but the copy between two real cards and peer access,
which only a machine with two cards runs (chip_smoke.py phase 4e).

* The placement: i mod k, instance i on device i when k >= n (the
  reference's order), "cuda" = every visible card once, and the kept
  divergence: the port wraps where the reference raises.
* A mesh over ["cpu"] * 4 and * 3 against the one-slot mesh, bit for bit:
  the three collectives, fetch_chunk (the slot-crossing pull + in-place
  splice against the one-launch splice) and fetch_scattered_gather, the
  routes against the reference under shard_map on 4 forced host devices,
  and two steps of the mixed_congested and selection scenarios through
  ShardMapExecBackend, fused and serial, with StepStats equal to the
  analytic run's.
* InstanceMesh.seconds raises on stamps of two slots; a pair of cards
  without peer access raises, naming the pair.
* ShardMapIndexerService and ShardMapExecBackend share one placement, and
  the serve CLI prints it.
"""

import re

import jax
import numpy as np
import pytest
import torch

from repro.serving.backends.shard_map import mesh_for
from repro_torch.core import instance_mesh as IM
from repro_torch.core.instance_mesh import InstanceMesh, placement
from repro_torch.core.routing import route_fanout, route_pairwise, route_ring
from repro_torch.core.splice import fetch_chunk, fetch_scattered_gather
from repro_torch.launch import serve
from repro_torch.models.mla import absorbed_partial
from repro_torch.serving.backends import AnalyticBackend
from repro_torch.serving.backends.shard_map import (ShardMapExecBackend,
                                                   peer_flows)
from repro_torch.serving.backends.torch_exec import TINY_MLA, max_oracle_err
from repro_torch.serving.selection import (ReplaySelector, SelectionConfig,
                                           ShardMapIndexerService,
                                           selection_trace_payload)
from test_torch_backend import TORCH_SCENARIOS, _query_source
from test_torch_mesh import (NI, _partials_close, _same, _shards, _want,
                             jax_mesh)  # noqa: F401  (a module fixture)
from test_torch_selection import torch_selection_scenario

SLOTS = pytest.mark.parametrize("k", [3, 4])


def _cpu(k):
    return ["cpu"] * k


# ---------------------------------------------------------------------------
# The placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(8, 1), (8, 3), (8, 4), (4, 4), (3, 8)])
def test_instance_i_sits_on_slot_i_mod_k(n, k):
    mesh = InstanceMesh(n, _cpu(k))
    assert mesh.k == k and mesh.devices == [torch.device("cpu")] * k
    assert [mesh.slot_of(i) for i in range(n)] == [i % k for i in range(n)]
    assert all(mesh.device_of(i) == torch.device("cpu") for i in range(n))
    if k >= n:                       # the reference's order: i on device i
        assert [mesh.slot_of(i) for i in range(n)] == list(range(n))


def test_one_instance_per_device_in_the_references_order():
    """Where there are as many devices as instances, instance i sits on
    device i, as mesh_for pins instance i to jax.devices()[i]."""
    devs = jax.devices()
    _, ref = mesh_for(len(devs))
    mesh = InstanceMesh(len(devs), _cpu(len(devs)))
    assert [devs.index(d) for d in ref] == [mesh.slot_of(i)
                                            for i in range(len(devs))]


def test_the_port_wraps_where_the_reference_raises():
    """The kept divergence: with fewer devices than instances the
    reference's mesh_for raises; the port wraps instance i onto slot i % k
    (as it always put every instance on one card)."""
    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match="devices for the 'instance'"):
        mesh_for(n)
    mesh = InstanceMesh(n, _cpu(n - 1))
    assert mesh.slot_of(n - 1) == 0


def test_a_single_device_names_its_slots(monkeypatch):
    assert placement("cpu") == [torch.device("cpu")]
    assert InstanceMesh(3, "cpu").devices == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert placement("cuda") == [torch.device("cuda", i) for i in range(3)]
    assert placement("cuda:2") == [torch.device("cuda", 2)]
    assert placement(["cuda:0"] * 4) == [torch.device("cuda", 0)] * 4
    with pytest.raises(ValueError, match="mix the CPU and cards"):
        placement(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="unsupported device"):
        placement(["meta"])


def test_a_card_pair_without_peer_access_raises_naming_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: (a, b) != (1, 2))
    with pytest.raises(RuntimeError,
                       match="cuda:1 has no peer access to cuda:2"):
        InstanceMesh(4, ["cuda:0", "cuda:1", "cuda:2"])
    line = IM.describe_placement(4, placement(["cuda:0", "cuda:1",
                                               "cuda:2"]))
    assert "instance:card 0:cuda:0 1:cuda:1 2:cuda:2 3:cuda:0" in line
    assert "cuda:1[y-n]" in line and "cuda:0[-yy]" in line


def test_seconds_raises_on_stamps_of_two_slots():
    mesh = InstanceMesh(4, _cpu(2))
    origins = mesh.begin()
    a, b, c = mesh.stamp(0), mesh.stamp(1), mesh.stamp(2)
    assert a.slot == c.slot == 0 and b.slot == 1
    assert mesh.seconds(a, c) >= 0.0
    with pytest.raises(ValueError, match="stamps of slots 0 and 1"):
        mesh.seconds(a, b)
    # a stamp is timed from its own slot's origin
    assert origins.offsets() == [0.0, 0.0] and origins.skew() == 0.0
    assert origins.since(b) >= 0.0 and origins.since(c) >= origins.since(a)


# ---------------------------------------------------------------------------
# The mesh over k slots against the one-slot mesh, bit for bit
# ---------------------------------------------------------------------------

def _eq(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert torch.equal(a, b)


@SLOTS
def test_collectives_over_slots_equal_the_one_slot_mesh(k):
    rng = np.random.default_rng(1)
    x = [torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))
         for _ in range(NI)]
    y = [torch.from_numpy(rng.standard_normal((NI, 5)).astype(np.float32))
         for _ in range(NI)]
    x[2] = None
    one, many = InstanceMesh(NI, "cpu"), InstanceMesh(NI, _cpu(k))
    for m in (one, many):
        m.out = (m.ppermute(x, [(0, 2), (1, 3), (3, 0)])
                 + m.all_gather(x, to=[0, 3], fill=-1.0)
                 + m.all_to_all(y))
    for a, b in zip(one.out, many.out):
        _eq(a, b)


@SLOTS
@pytest.mark.parametrize("delta", [17, 0, None])
def test_fetch_across_slots_equals_the_one_launch_splice(k, delta):
    """Holder 2 and requester 1 sit on two slots: the chunk is pulled into
    the pool's rows and spliced there in place, the same bits as the
    one-slot mesh's one splice from the holder's rows."""
    rng = np.random.default_rng(2)
    d = TINY_MLA.d_qk
    chunk = torch.from_numpy(rng.standard_normal((16, d)).astype(np.float32))
    pool = torch.from_numpy(rng.standard_normal((32, d)).astype(np.float32))
    idx = torch.tensor([3, 0, 11, 7, 15])
    got = {}
    for name, mesh in (("one", InstanceMesh(NI, "cpu")),
                       ("many", InstanceMesh(NI, _cpu(k)))):
        assert (mesh.slot_of(2) != mesh.slot_of(1)) == (name == "many")
        a = fetch_chunk(mesh, pool.clone(), chunk, delta, 8, TINY_MLA, 2, 1)
        b = fetch_scattered_gather(mesh, pool.clone(), chunk, idx, 4,
                                   TINY_MLA, 2, 1)
        got[name] = (a, b)
    for a, b in zip(got["one"], got["many"]):
        assert torch.equal(a, b)
    assert not torch.equal(got["many"][0], pool)
    assert torch.equal(chunk, torch.from_numpy(
        np.random.default_rng(2).standard_normal((16, d)).astype(
            np.float32)))                  # the holder's rows untouched


@pytest.mark.parametrize("route", ["fanout", "ring", "pairwise"])
def test_routes_over_four_slots_match_shard_map(jax_mesh, route):
    """The reference's routes under shard_map on 4 forced host devices,
    against the port's mesh built over 4 slots."""
    inp, want = jax_mesh
    mesh = InstanceMesh(NI, _cpu(NI))
    q, c = _shards(inp["q"]), _shards(inp["ckv"])
    if route == "fanout":
        got = route_fanout(mesh, TINY_MLA, q, c, _shards(inp["valid"]))
    elif route == "ring":
        got = route_ring(mesh, TINY_MLA, q, c)
    else:
        got = route_pairwise(mesh, TINY_MLA, q, c,
                             absorbed_partial(TINY_MLA, q[0], c[0]),
                             holder=3, requester=0)[:1]
    for i, p in enumerate(got):
        _partials_close(p, want, route, i)


def test_collectives_over_four_slots_match_shard_map(jax_mesh):
    inp, want = jax_mesh
    mesh = InstanceMesh(NI, _cpu(NI))
    got = mesh.ppermute(_shards(inp["x"]), [(0, 2), (1, 3), (3, 0)])
    for i in range(NI):
        _same(got[i], _want(want["ppermute"], i))
    for i, g in enumerate(mesh.all_gather(_shards(inp["x"]))):
        _same(g, _want(want["all_gather"], i))
    for i, g in enumerate(mesh.all_to_all(_shards(inp["y"]))):
        _same(g, _want(want["all_to_all"], i))


# ---------------------------------------------------------------------------
# ShardMapExecBackend over k slots
# ---------------------------------------------------------------------------

def _dense(devices, fused):
    eng, steps = TORCH_SCENARIOS["mixed_congested"](ShardMapExecBackend(
        TINY_MLA, device="cpu", fused=fused, devices=devices))
    for reqs in steps:
        eng.schedule_step(reqs)
    return eng, steps


def _selection(devices, fused):
    source = _query_source(TINY_MLA)
    svc = ShardMapIndexerService(SelectionConfig(), TINY_MLA, device="cpu",
                                 query_source=source, devices=devices)
    eng, steps = torch_selection_scenario(ShardMapExecBackend(
        TINY_MLA, device="cpu", query_source=source, fused=fused,
        devices=devices), svc)
    for reqs in steps:
        eng.schedule_step(reqs)
    return eng, steps


def _analytic(name, eng):
    if name == "dense":
        ana, steps = TORCH_SCENARIOS["mixed_congested"](AnalyticBackend())
    else:
        svc = eng.selector
        ana, steps = torch_selection_scenario(
            AnalyticBackend(), ReplaySelector(selection_trace_payload(
                svc.log, svc.block_tokens, svc.d_index)))
    for reqs in steps:
        ana.schedule_step(reqs)
    return ana


@SLOTS
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "serial"])
@pytest.mark.parametrize("name", ["dense", "selection"])
def test_backend_over_slots_equals_the_one_slot_mesh(name, fused, k):
    """Two steps of mixed_congested (ROUTE, FETCH, LOCAL) and of the
    selection scenario: the outputs bit for bit the one-slot mesh's,
    StepStats equal to the analytic run's, every step within the oracle,
    and the flows that crossed slots reported as peer."""
    run = _dense if name == "dense" else _selection
    one, steps = run(None, fused)
    many, _ = run(_cpu(k), fused)
    assert many.backend.mesh.k == k and one.backend.mesh.k == 1
    ana = _analytic(name, many)
    assert [s.comparable() for s in many.stats] \
        == [s.comparable() for s in ana.stats] \
        == [s.comparable() for s in one.stats]
    for step, reqs in enumerate(steps, start=1):
        a, b = one.outputs_of(step), many.outputs_of(step)
        assert sorted(a) == sorted(b)
        for rid in a:
            for x, y in zip(a[rid], b[rid]):
                assert torch.equal(x, y)
        assert max_oracle_err(many, reqs, step) <= 1e-6
    peers = [peer_flows(r) for r in many.measured_reports]
    assert [peer_flows(r) for r in one.measured_reports] \
        == [0] * len(steps)
    assert sum(peers) > 0
    entries = [e for es in many.backend.stage_log.values() for e in es]
    assert {e["instance"] for e in entries} <= set(range(8))
    assert {e["placement"] for e in entries} <= {"same slot", "peer"}
    assert any(e["placement"] == "peer" for e in entries)
    assert all(s == 0.0 for s in many.backend.slot_skew.values())


def test_indexer_and_backend_share_one_placement(capsys):
    eng = serve.main(["--instances", "4", "--pods", "2", "--chunks", "6",
                      "--chunk-tokens", "256", "--agents", "6", "--steps",
                      "2", "--selection", "--selection-frac", "0.5",
                      "--selection-k", "128", "--backend", "shard_map",
                      "--device", "cpu", "--verify"], devices=_cpu(3))
    out = capsys.readouterr().out
    assert eng.backend.mesh.devices == eng.selector.mesh.devices \
        == [torch.device("cpu")] * 3
    assert ("[serve] placement: 4 instances over 3 slots on 1 device(s), "
            "instance:card 0:cpu 1:cpu 2:cpu 3:cpu; peer access none "
            "(one card)") in out
    errs = [float(x) for x in re.findall(r"max\|err\| (\S+)", out)]
    assert len(errs) == 2 and max(errs) <= 1e-6
    assert re.search(r"peer flows [1-9]\d*/\d+", out)
