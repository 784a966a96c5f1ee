"""The port's instance mesh (repro_torch.core.instance_mesh) and the
collective stages built on it (core.routing, core.splice, the mesh
indexer), on the CPU, against the JAX package.

* The collectives (ppermute, all_gather, all_to_all), route_fanout,
  route_pairwise, route_ring, fetch_chunk and fetch_scattered_gather are
  held against the JAX package's own under shard_map, on 4 forced host
  devices: a subprocess (started here, with a timeout) runs the reference
  on numpy inputs made from a seed and returns its outputs as numpy; the
  port runs the same inputs through an InstanceMesh(4, "cpu"). Copies are
  exact, and so are the spliced chunk's latent columns; its rotated band
  and the partials agree within 2e-6 absolute (o, m, the band) and
  relative (l), the reference kernels' f32 tolerance
  (tests/test_kernels.py:40; the band's cos/sin may differ by an f32 ulp
  between XLA and torch, as tests/test_torch_splice.py says). An instance
  that holds nothing is None in the port and zeros in the reference.
* route_pairwise_tpla is held against the single-instance absorbed_partial
  of the JAX package (its own TPLA program does not run under this jax:
  tests/progs/dist_routing_prog.py:153).
* check_instance_shards / check_route_shards raise the reference's
  messages, naming the shard and both shapes.
* ShardMapIndexerService picks exactly IndexerService's blocks, scoring
  on the holder's partition against one key tensor per (chunk, holder)
  and copying back only the (S,) pooled scores.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.routing import check_route_shards as jax_check_route
from repro.models import mla as JM
from repro.serving.backends.shard_map import \
    check_instance_shards as jax_check_instance
from repro_torch.core.instance_mesh import (InstanceMesh,
                                            check_instance_shards)
from repro_torch.core.merge import Partial
from repro_torch.core.routing import (check_route_shards, fanout_exchange,
                                      fanout_gather, pairwise_return,
                                      route_fanout, route_pairwise,
                                      route_pairwise_tpla, route_ring)
from repro_torch.core.splice import fetch_chunk, fetch_scattered_gather
from repro_torch.models.mla import absorbed_partial
from repro_torch.serving.backends.torch_exec import TINY_MLA
from repro_torch.serving.selection import (IndexerService, SelectionConfig,
                                           ShardMapIndexerService)
from test_torch_backend import _query_source
from test_torch_selection import torch_selection_scenario

TOL = 2e-6
NI, B, S_LOCAL, POOL = 4, 2, 16, 32
CFG_FIELDS = ("d_model", "n_heads", "kv_lora_rank", "qk_nope_head_dim",
              "qk_rope_head_dim", "v_head_dim")

# the reference side: its collectives and routes under shard_map on 4 host
# devices, inputs and outputs as numpy
JAX_PROG = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core.merge import Partial
from repro.core.routing import route_fanout, route_pairwise, route_ring
from repro.core.splice import fetch_chunk, fetch_scattered_gather
from repro.models.mla import MLAConfig, absorbed_partial

inp = dict(np.load(sys.argv[1]))
cfg = MLAConfig(*(int(v) for v in inp["cfg"]))
mesh = jax.make_mesh((4,), ("instance",))
PS = P("instance")
PART = Partial(o=PS, m=PS, l=PS)


def run(body, in_specs, out_specs, *args):
    return jax.jit(compat.shard_map(body, mesh=mesh, in_specs=in_specs,
                                    out_specs=out_specs))(*args)


out = {
    "ppermute": run(lambda t: lax.ppermute(t, "instance",
                                           [(0, 2), (1, 3), (3, 0)]),
                    (PS,), PS, inp["x"]),
    "all_gather": run(lambda t: lax.all_gather(t, "instance"), (PS,), PS,
                      inp["x"]),
    "all_to_all": run(lambda t: lax.all_to_all(t, "instance", 0, 0), (PS,),
                      PS, inp["y"]),
    "fetch": run(lambda p, c: fetch_chunk(p, c, 17, 8, cfg, 2, 1,
                                          "instance"),
                 (PS, PS), PS, inp["pool"], inp["ckv"]),
    "gather": run(lambda p, c, ix: fetch_scattered_gather(
        p, c, ix, 4, cfg, 2, 1, "instance"), (PS, PS, P()), PS,
        inp["pool"], inp["ckv"], inp["idx"]),
}
q, c, v = inp["q"], inp["ckv"], inp["valid"]
routes = {
    "fanout": run(lambda q, c, v: route_fanout(cfg, q, c, v, "instance"),
                  (PS, PS, PS), PART, q, c, v),
    "ring": run(lambda q, c: route_ring(cfg, q, c, c[:, 0] == c[:, 0],
                                        "instance"), (PS, PS), PART, q, c),
    "pairwise": run(lambda q, c: route_pairwise(
        cfg, q, c, absorbed_partial(cfg, q, c), holder=3, requester=0,
        axis="instance"), (PS, PS), PART, q, c),
}
for name, p in routes.items():
    for k in ("o", "m", "l"):
        out[f"{name}_{k}"] = getattr(p, k)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("JAX-MESH-OK")
'''


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    """(inputs, the reference's outputs): one subprocess per module."""
    rng = np.random.default_rng(0)
    d = TINY_MLA.d_qk
    inp = {
        "cfg": np.array([getattr(TINY_MLA, f) for f in CFG_FIELDS]),
        "x": rng.standard_normal((NI * 2, 3)).astype(np.float32),
        "y": rng.standard_normal((NI * NI, 5)).astype(np.float32),
        "q": rng.standard_normal((NI * B, TINY_MLA.n_heads, d))
        .astype(np.float32),
        "ckv": rng.standard_normal((NI * S_LOCAL, d)).astype(np.float32),
        "valid": rng.random(NI * S_LOCAL) < 0.6,
        "pool": rng.standard_normal((NI * POOL, d)).astype(np.float32),
        "idx": np.array([3, 0, 11, 7, 15]),
    }
    tmp = tmp_path_factory.mktemp("jax_mesh")
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(sys.path))
    res = subprocess.run([sys.executable, "-c", JAX_PROG,
                          str(tmp / "in.npz"), str(tmp / "out.npz")],
                         capture_output=True, text=True, timeout=240,
                         env=env)
    assert res.returncode == 0 and "JAX-MESH-OK" in res.stdout, res.stderr
    return inp, dict(np.load(tmp / "out.npz"))


def _shards(a, n=NI):
    """A global array split into n per-instance torch shards."""
    return list(torch.from_numpy(np.ascontiguousarray(a)).chunk(n))


def _want(a, i, n=NI):
    return np.split(a, n)[i]


def _same(got, want):
    if got is None:
        np.testing.assert_array_equal(want, np.zeros_like(want))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_collectives_match_shard_map(jax_mesh):
    inp, want = jax_mesh
    mesh = InstanceMesh(NI, "cpu")
    got = mesh.ppermute(_shards(inp["x"]), [(0, 2), (1, 3), (3, 0)])
    for i in range(NI):
        _same(got[i], _want(want["ppermute"], i))
    assert got[1] is None
    for i, g in enumerate(mesh.all_gather(_shards(inp["x"]))):
        _same(g, _want(want["all_gather"], i))
    for i, g in enumerate(mesh.all_to_all(_shards(inp["y"]))):
        _same(g, _want(want["all_to_all"], i))


def _partials_close(got: Partial, want, name, i):
    np.testing.assert_allclose(got.o.numpy(), _want(want[f"{name}_o"], i),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(got.m.numpy(), _want(want[f"{name}_m"], i),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(got.l.numpy(), _want(want[f"{name}_l"], i),
                               atol=0, rtol=TOL)


@pytest.mark.parametrize("route", ["fanout", "ring", "pairwise"])
def test_routes_match_shard_map(jax_mesh, route):
    inp, want = jax_mesh
    mesh = InstanceMesh(NI, "cpu")
    q, c = _shards(inp["q"]), _shards(inp["ckv"])
    if route == "fanout":
        got = route_fanout(mesh, TINY_MLA, q, c, _shards(inp["valid"]))
    elif route == "ring":
        got = route_ring(mesh, TINY_MLA, q, c)
    else:
        got = route_pairwise(mesh, TINY_MLA, q, c,
                             absorbed_partial(TINY_MLA, q[0], c[0]),
                             holder=3, requester=0)
        assert [g is None for g in got] == [False, True, True, True]
        got = got[:1]
    for i, p in enumerate(got):
        _partials_close(p, want, route, i)


def test_fetch_primitives_match_shard_map(jax_mesh):
    inp, want = jax_mesh
    mesh = InstanceMesh(NI, "cpu")
    c = _shards(inp["ckv"])
    for name, run in (
            ("fetch", lambda pool: fetch_chunk(mesh, pool, c[2], 17, 8,
                                               TINY_MLA, 2, 1)),
            ("gather", lambda pool: fetch_scattered_gather(
                mesh, pool, c[2], torch.as_tensor(inp["idx"]), 4, TINY_MLA,
                2, 1))):
        pool = _shards(inp["pool"])[1].clone()
        assert run(pool) is pool
        expect = _want(want[name], 1)
        d_c = TINY_MLA.kv_lora_rank
        np.testing.assert_array_equal(pool[:, :d_c].numpy(),
                                      expect[:, :d_c])
        np.testing.assert_allclose(pool[:, d_c:].numpy(), expect[:, d_c:],
                                   atol=TOL, rtol=1e-5)
        untouched = np.ones(POOL, bool)
        untouched[8:8 + S_LOCAL] = name != "fetch"
        untouched[4:4 + len(inp["idx"])] &= name != "gather"
        np.testing.assert_array_equal(pool[untouched].numpy(),
                                      expect[untouched])
    # delta None elides the rotation: a copy of the holder's rows
    pool = torch.zeros((POOL, TINY_MLA.d_qk))
    fetch_chunk(mesh, pool, c[2], None, 3, TINY_MLA, 2, 1)
    assert torch.equal(pool[3:3 + S_LOCAL], c[2])
    assert not pool[:3].any() and not pool[3 + S_LOCAL:].any()


def test_tpla_rank_pairing_matches_single_instance_partial(jax_mesh):
    """Four TP ranks each ship their [latent_r | rope_r] column slice; the
    holder sums the slices' partial logits; the rank slices of o, joined,
    are the single-instance partial over the holder's chunk."""
    inp, _ = jax_mesh
    n_tp, d_c, d_r = 4, TINY_MLA.kv_lora_rank, TINY_MLA.qk_rope_head_dim
    q, ckv = inp["q"][:B], inp["ckv"][S_LOCAL:2 * S_LOCAL]

    def rank_slices(a):
        lat = np.split(a[..., :d_c], n_tp, axis=-1)
        rope = np.split(a[..., d_c:], n_tp, axis=-1)
        return [torch.from_numpy(np.ascontiguousarray(
            np.concatenate([la, ro], axis=-1))) for la, ro in zip(lat, rope)]
    mesh = InstanceMesh(2, "cpu")
    got = route_pairwise_tpla(mesh, TINY_MLA, rank_slices(q),
                              rank_slices(ckv), holder=1, requester=0)
    jcfg = JM.MLAConfig(*(getattr(TINY_MLA, f) for f in CFG_FIELDS))
    want = JM.absorbed_partial(jcfg, jnp.asarray(q), jnp.asarray(ckv))
    np.testing.assert_allclose(got.o.numpy(), np.asarray(want.o), atol=TOL)
    np.testing.assert_allclose(got.m.numpy(), np.asarray(want.m), atol=TOL)
    np.testing.assert_allclose(got.l.numpy(), np.asarray(want.l), rtol=TOL)
    assert got.o.shape == (B, TINY_MLA.n_heads, d_c)
    assert all(r.shape[-1] == (d_c + d_r) // n_tp for r in rank_slices(q))


# ---------------------------------------------------------------------------
# The mesh itself
# ---------------------------------------------------------------------------

def test_transports_land_in_buffers_the_destination_owns():
    mesh = InstanceMesh(3, "cpu")
    x = torch.arange(6.0).reshape(2, 3)
    out = mesh.ppermute([x, None, None], [(0, 2)])
    assert out[0] is None and out[1] is None
    assert torch.equal(out[2], x) and out[2].data_ptr() != x.data_ptr()
    x.add_(100.0)                          # the source's later writes stay
    assert float(out[2].max()) == 5.0      # on the source
    gathered = mesh.all_gather([x, None, x + 1], to=[1], fill=-1.0)
    assert gathered[0] is None and gathered[2] is None
    assert torch.equal(gathered[1][1], torch.full((2, 3), -1.0))
    exchanged = mesh.all_to_all([None, torch.ones(3, 4), None],
                                to=[0, 2], fill=float("-inf"))
    assert exchanged[1] is None
    assert torch.equal(exchanged[2][1], torch.ones(4))
    assert bool(torch.isinf(exchanged[2][0]).all())


def test_mesh_refuses_bad_pairs_devices_and_empty_sets():
    mesh = InstanceMesh(3, "cpu")
    x = torch.zeros(2)
    with pytest.raises(ValueError, match="repeat a source or a destination"):
        mesh.ppermute([x, x, None], [(0, 2), (1, 2)])
    with pytest.raises(ValueError, match="outside the mesh"):
        mesh.ppermute([x, x, None], [(0, 5)])
    with pytest.raises(ValueError, match="every shard is empty"):
        mesh.all_gather([None, None, None])
    with pytest.raises(ValueError, match="2 shards for a mesh of 3"):
        mesh.all_to_all([x, x])
    with pytest.raises(ValueError, match="unsupported device"):
        InstanceMesh(2, "meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InstanceMesh(2)


def test_partials_ship_o_in_the_wire_dtype():
    """wire_dtype=bf16 rounds o once on the wire and widens it back, in
    the fanout exchange and the pairwise return."""
    mesh = InstanceMesh(2, "cpu")
    g = torch.Generator().manual_seed(0)
    part = Partial(o=torch.randn(2, 3, 8, generator=g),
                   m=torch.randn(2, 3, generator=g),
                   l=torch.rand(2, 3, generator=g))
    full = fanout_exchange(mesh, [part, None])
    wire = fanout_exchange(mesh, [part, None], wire_dtype=torch.bfloat16)
    for i in range(2):
        assert wire[i].o.dtype == torch.float32
        assert torch.equal(wire[i].o[0],
                           part.o[i].to(torch.bfloat16).float())
        assert torch.equal(full[i].o[0], part.o[i])
        assert torch.equal(wire[i].m, full[i].m)
        assert torch.equal(wire[i].o[1], torch.zeros(3, 8))
        assert bool(torch.isinf(wire[i].m[1]).all())
    gathered = fanout_gather(mesh, [torch.ones(2, 8), None])
    assert gathered[1].shape == (2, 2, 8) and not gathered[1][1].any()
    back = pairwise_return(mesh, [None, part], 1, 0,
                           wire_dtype=torch.bfloat16)
    assert back[1] is None and back[0].o.dtype == torch.float32
    assert torch.equal(back[0].o, part.o.to(torch.bfloat16).float())
    assert torch.equal(back[0].l, part.l)


# ---------------------------------------------------------------------------
# Shape checks: the reference's messages
# ---------------------------------------------------------------------------

INSTANCE_CASES = {
    "ragged": ({0: (4, 3), 2: (5, 3)}, (4, 3), 4),
    "outside": ({7: (4, 3)}, (4, 3), 4),
    "ragged_width": ({1: (4, 2)}, (4, 3), None),
}


@pytest.mark.parametrize("case", sorted(INSTANCE_CASES))
def test_check_instance_shards_raises_the_reference_message(case):
    parts, per, n = INSTANCE_CASES[case]
    with pytest.raises(ValueError) as want:
        jax_check_instance({i: np.zeros(s) for i, s in parts.items()}, per,
                           n)
    with pytest.raises(ValueError) as got:
        check_instance_shards({i: torch.zeros(s) for i, s in parts.items()},
                              per, n)
    assert str(got.value) == str(want.value)
    assert "shard" in str(got.value) and str(per) in str(got.value) \
        or "outside" in str(got.value)


ROUTE_CASES = {
    "q_rank": ((24,), (16, 24), None),
    "ckv_rank": ((2, 2, 24), (1, 16, 24), None),
    "d_qk": ((2, 2, 24), (16, 20), None),
    "valid": ((2, 2, 24), (16, 24), (12,)),
}


@pytest.mark.parametrize("shard", [None, 3])
@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_check_route_shards_raises_the_reference_message(case, shard):
    q, c, v = ROUTE_CASES[case]
    args = [np.zeros(q), np.zeros(c), None if v is None else np.zeros(v)]
    with pytest.raises(ValueError) as want:
        jax_check_route("instance", *args, shard=shard)
    with pytest.raises(ValueError) as got:
        check_route_shards("instance", *(None if a is None
                                         else torch.from_numpy(a)
                                         for a in args), shard=shard)
    assert str(got.value) == str(want.value)
    assert (shard is None) or f"shard {shard}" in str(got.value)


def test_mesh_collectives_reject_ragged_shards():
    mesh = InstanceMesh(4, "cpu")
    with pytest.raises(ValueError, match=r"shard 2 has shape \(3, 3\) but "
                                         r"the mesh-wide per-shard shape is "
                                         r"\(2, 3\)"):
        mesh.all_gather([torch.zeros(2, 3), None, torch.zeros(3, 3), None])
    with pytest.raises(ValueError, match="lead with the mesh size 4"):
        mesh.all_to_all([torch.zeros(3, 3)] * 4)
    with pytest.raises(ValueError, match="local_valid covers"):
        route_fanout(mesh, TINY_MLA, [torch.zeros(2, 2, 24)] * 4,
                     [torch.zeros(16, 24)] * 4,
                     [torch.ones(12, dtype=torch.bool)] * 4)


# ---------------------------------------------------------------------------
# The mesh indexer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_tokens", [64, 32])
def test_mesh_indexer_picks_the_host_services_blocks(block_tokens):
    source = _query_source(TINY_MLA)
    sel_cfg = SelectionConfig(block_tokens=block_tokens)
    host = IndexerService(sel_cfg, TINY_MLA, device="cpu",
                          query_source=source)
    mesh = ShardMapIndexerService(sel_cfg, TINY_MLA, device="cpu",
                                  query_source=source)
    h_eng, steps = torch_selection_scenario(selector=host)
    m_eng, _ = torch_selection_scenario(selector=mesh)
    n = 0
    for step, reqs in enumerate(steps, start=1):
        for rq in reqs:
            if rq.k_selected is None:
                continue
            got = mesh.select_request(m_eng.store, rq, step)
            want = host.select_request(h_eng.store, rq, step)
            assert got.blocks == want.blocks
            for cid in rq.chunk_ids:
                np.testing.assert_array_equal(got.masks[cid],
                                              want.masks[cid])
                assert mesh.measured_index_s[(step, rq.req_id, cid)] > 0
            n += 1
    assert n == 4
    assert mesh.obs_counts == host.obs_counts
    assert mesh.mesh.n == m_eng.store.n_instances


def test_mesh_indexer_keeps_keys_on_the_holder_and_returns_only_pooled(
        monkeypatch):
    """One device key tensor per (chunk, holder), the store's sidecar bytes;
    each scoring call copies back one (S,) f32 vector and nothing else."""
    from repro_torch.serving.selection import service
    copies = []

    def spy(t):
        copies.append((tuple(t.shape), t.dtype))
        return t.cpu().numpy()
    monkeypatch.setattr(service, "_to_host", spy)
    mesh = ShardMapIndexerService(SelectionConfig(), TINY_MLA, device="cpu",
                                  query_source=_query_source(TINY_MLA))
    eng, steps = torch_selection_scenario(selector=mesh)
    calls = []
    for step, reqs in enumerate(steps, start=1):
        for rq in reqs:
            if rq.k_selected is None:
                continue
            mesh.select_request(eng.store, rq, step)
            calls += [eng.store.lookup(cid).length for cid in rq.chunk_ids]
    assert copies == [((n,), torch.float32) for n in calls]
    want = {(cid, eng.store.lookup(cid).holder)
            for reqs in steps for rq in reqs if rq.k_selected is not None
            for cid in rq.chunk_ids}
    assert set(mesh.device_keys) == want
    for (cid, _), keys in mesh.device_keys.items():
        assert keys.dtype == torch.float32
        np.testing.assert_array_equal(keys.numpy(),
                                      eng.store.lookup(cid).index_keys)
