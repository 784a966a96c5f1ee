"""The sharded serving form of the GQA, Mamba2 and hybrid families on gloo,
on the CPU, against the unsharded port and the JAX package: the Zamba2
(hybrid: Mamba2 groups and the shared attention block), Mamba2 and Qwen3
(dense GQA) smoke configs in f32, each on one weight tree
(torch_parity.numpy_weights, carried across by convert.py), a prefill of
B x S tokens, the decode state laid out by decode_state_shardings (the
K/V cache's SEQUENCE over `model`, the SSM state's heads over `model`) and
STEPS decode steps at slots S, S + 1, ... of a cache of SLOTS slots: on
(1, 4) ("data", "model") the slots lie on model rank 2 and rank 3 attends
unwritten zeros; on (2, 2) on rank 1; one batch row on (2, 2) takes the
long-context layout, the sequence over both mesh dims, its prefill run
sharded too under sp_policy(...).for_batch(1) (the batch whole, the heads
over `model`).

Each mesh shape runs in a subprocess of its own (python <this file>
--prog <mesh> <dir>), 4 ranks on a file rendezvous in <dir>, with a
timeout; rank 0 saves what they computed, gathered whole, and the tests
read it. The parameters, the batch, the decode state and the decode
inputs take the dry run's placements (param_shardings,
train_batch_shardings, decode_state_shardings, decode_input_shardings)
under sp_policy, with the KERNELS ops (their plain versions on the CPU's
local tensors), each op recording the shapes it was called at: the
prefill's ssd_chunk on each rank's local heads (models.ssm.serving_intra),
the GQA decode per sequence shard (attention.decode_partial), the partials
gathered and merged with softmax_merge (sharding.local_seq_partials over
the (k, v) tuple).

Limits: the unsharded port at 1e-5 (the same ops; the decode's softmax
summed per shard and merged), the reference at tests/test_torch_model.py's
1e-4. The unit cases hold decode_partial merged over 1 to 4 splits of the
cache against _sdpa at 1e-6, local_seq_partials over a DTensor (k, v)
split 2 and 4 ways against the one call, and ssd_intra_chunk's refusal of
a DTensor.
"""

import dataclasses
import os
import pickle
import signal
import subprocess
import sys
import tempfile

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TIMEOUT = 150
ARCHS = ("zamba2-7b", "mamba2-370m", "qwen3-32b")
B, S, SLOTS, STEPS = 2, 16, 32, 3
# case -> (mesh shape, batch rows); one subprocess per mesh shape
CASES = {"1x4": ((1, 4), B), "2x2": ((2, 2), B), "2x2-one-row": ((2, 2), 1)}
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
PORT_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)       # tests/test_torch_model.py's
UNIT_TOL = 1e-6
UNIT_SPLITS = (1, 2, 3, 4)


# ---------------------------------------------------------------------------
# the prog (run in the subprocess's ranks; imports no JAX)
# ---------------------------------------------------------------------------

def _laid_out(tree, shardings):
    """A tree of whole tensors distributed leaf by leaf as a tree of
    NamedShardings says."""
    from repro_torch.distributed import sharding as SH
    if isinstance(tree, dict):
        return {k: _laid_out(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_laid_out(v, s) for v, s in zip(tree, shardings))
    return SH.distribute(tree, shardings.mesh, shardings.spec)


def _whole(tree):
    """Every DTensor leaf of a tree gathered whole, as numpy (a collective:
    every rank calls it)."""
    from repro_torch.distributed import sharding as SH
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_whole(v) for v in tree)
    if tree is None:
        return None
    return (tree.full_tensor() if SH.is_dtensor(tree) else tree).numpy()


def _recording(ops, calls):
    """ops whose ssd_intra_chunk and softmax_merge append the shapes of
    their tensor arguments to calls["ssd_chunk"] / calls["softmax_merge"]
    and pass every call on."""
    import torch

    def rec(name, fn):
        def call(*args, **kw):
            ts = [a for a in args if torch.is_tensor(a)]
            calls[name].append([tuple(t.shape) for t in ts])
            return fn(*args, **kw)
        return call
    return dataclasses.replace(
        ops, ssd_intra_chunk=rec("ssd_chunk", ops.ssd_intra_chunk),
        softmax_merge=rec("softmax_merge", ops.softmax_merge))


def _sharded_run(mesh, arch, tree, inputs, b):
    """Prefill, the state filled and STEPS decode steps of the first b
    batch rows on mesh (KERNELS ops): every result whole, as numpy, and
    the shapes the kernels were called at."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ShapeSpec, get_smoke_config
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.distributed import policy as POL
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import input_specs as IS
    from repro_torch.models import model as MD
    cfg = get_smoke_config(arch)
    params = model_params_from_numpy(tree, cfg, device="cpu")
    SH.shard_params(params, SH.param_shardings(params, mesh))
    tokens = torch.tensor(inputs["tokens"][:b])
    calls = {"ssd_chunk": [], "softmax_merge": []}
    ops = _recording(MD.KERNELS, calls)
    with POL.use_policy(POL.sp_policy(mesh).for_batch(b)), \
            implicit_replication(), torch.no_grad():
        spec = SH.fit_spec(IS.train_batch_shardings(
            {"tokens": tokens}, mesh)["tokens"].spec, tokens.shape, mesh)
        logits, caches = MD.prefill(
            params, cfg, {"tokens": SH.distribute(tokens, mesh, spec)},
            ops=ops)
        prefill_calls = {k: list(v) for k, v in calls.items()}
        state = MD.fill_decode_state(cfg, _laid_out(
            MD.init_decode_state(cfg, b, SLOTS, dtype=torch.float32,
                                 device="cpu"),
            IS.decode_state_shardings(cfg, ShapeSpec("decode", SLOTS, b,
                                                     "decode"), mesh)),
            caches)
        tok_sh, pos_sh, _ = IS.decode_input_shardings(mesh, b)
        decode = []
        for i in range(STEPS):
            lg, state = MD.decode_step(
                params, cfg, state,
                SH.distribute(torch.tensor(inputs["steps"][i][:b]), mesh,
                              tok_sh.spec),
                SH.distribute(torch.full((b, 1), S + i, dtype=torch.int32),
                              mesh, pos_sh.spec), S + i, ops=ops)
            decode.append(_whole(lg))
        return {"prefill": _whole(logits), "caches": _whole(caches),
                "decode": decode, "state": _whole(state),
                "prefill_calls": prefill_calls,
                "decode_calls": {k: v[len(prefill_calls[k]):]
                                 for k, v in calls.items()}}


def _unit_partials(mesh, inputs, b):
    """local_seq_partials (decode_partial per shard, softmax_merge across)
    over a DTensor (k, v) of the first b rows laid out as
    decode_state_shardings lays out a K/V cache: the batch over `data`
    and the sequence over `model`, or, for one row, the sequence over
    both mesh dims (data major); whole."""
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels.softmax_merge import softmax_merge
    from repro_torch.models import attention as A
    q, k, v = (torch.tensor(inputs[n][:b]) for n in ("unit_q", "unit_k",
                                                      "unit_v"))
    one = b == 1
    kv_spec = (None, ("data", "model")) if one else ("data", "model")
    part = SH.local_seq_partials(
        lambda ql, kv: A.decode_partial(inputs["unit_cfg"], ql, *kv),
        softmax_merge, SH.distribute(q, mesh, () if one else ("data",)),
        (SH.distribute(k, mesh, kv_spec), SH.distribute(v, mesh, kv_spec)))
    return [t.full_tensor().numpy() for t in part]


def _refusal(mesh):
    """The message of the TypeError ssd_intra_chunk raised given DTensors,
    or None."""
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels.ssd_chunk import ssd_intra_chunk
    g = torch.Generator().manual_seed(3)
    d = lambda *shape: SH.distribute(torch.randn(*shape, generator=g), mesh,
                                     ("data",))
    try:
        ssd_intra_chunk(d(2, 2, 8, 4, 8), d(2, 2, 8, 4).abs(),
                        -SH.distribute(torch.ones(4), mesh, ()),
                        d(2, 2, 8, 16), d(2, 2, 8, 16))
    except TypeError as e:
        return str(e)
    return None


def prog(rank, world, name, tmp):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, f"rdv_{name}"),
        rank=rank, world_size=world)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    mesh = make_mesh(MESHES[name], ("data", "model"))
    out = {}
    for case, (shape, b) in CASES.items():
        if shape != MESHES[name]:
            continue
        out[case] = {arch: _sharded_run(mesh, arch, inputs["trees"][arch],
                                        inputs, b) for arch in ARCHS}
        out[case]["unit"] = _unit_partials(mesh, inputs, b)
    out["refusal"] = _refusal(mesh)
    if rank == 0:
        with open(os.path.join(tmp, f"sharded_{name}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the pytest side
# ---------------------------------------------------------------------------

def _inputs():
    """The weight trees in the reference's layout, the prompt, the decode
    tokens and the unit case's query and (k, v), as numpy."""
    from repro import configs as JC
    from repro_torch.models import attention as A
    from torch_parity import numpy_weights
    jcfgs = {a: JC.get_smoke_config(a) for a in ARCHS}
    rng = np.random.default_rng(1)
    vocab = min(c.vocab for c in jcfgs.values())
    h, hkv, hd = 4, 2, 8
    return jcfgs, {
        "trees": {a: numpy_weights(c, seed=len(a)) for a, c in jcfgs.items()},
        "tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
        "steps": rng.integers(0, vocab, (STEPS, B, 1)).astype(np.int32),
        "unit_q": rng.standard_normal((B, 1, h, hd)).astype(np.float32),
        "unit_k": rng.standard_normal((B, SLOTS, hkv, hd)).astype(np.float32),
        "unit_v": rng.standard_normal((B, SLOTS, hkv, hd)).astype(np.float32),
        "unit_cfg": A.AttnConfig(h * hd, h, hkv, hd)}


def _reference(jcfg, tree, inputs):
    """The JAX package's prefill and decode steps on the whole batch
    (numpy)."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JMm
    from torch_parity import ref_fill_decode_state
    params = jax.tree.map(jnp.asarray, tree)
    logits, caches = jax.jit(JMm.prefill, static_argnums=1)(
        params, jcfg, {"tokens": jnp.asarray(inputs["tokens"])})
    state = ref_fill_decode_state(
        jcfg, JMm.init_decode_state(jcfg, B, SLOTS, dtype=jnp.float32),
        caches)
    dec = jax.jit(JMm.decode_step, static_argnums=1)
    decode = []
    for i in range(STEPS):
        lg, state = dec(params, jcfg, state, jnp.asarray(inputs["steps"][i]),
                        jnp.full((B, 1), S + i, jnp.int32), S + i)
        decode.append(np.asarray(lg))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return {"prefill": np.asarray(logits), "caches": np_tree(caches),
            "decode": decode, "state": np_tree(state)}


def _port(arch, tree, inputs):
    """The port's prefill and decode steps, unsharded, on the whole
    batch."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.models import model as MD
    cfg = get_smoke_config(arch)
    params = model_params_from_numpy(tree, cfg, device="cpu")
    with torch.no_grad():
        logits, caches = MD.prefill(params, cfg, {
            "tokens": torch.tensor(inputs["tokens"])})
        out = {"prefill": logits.numpy(), "caches": _whole(caches)}
        state = MD.fill_decode_state(cfg, MD.init_decode_state(
            cfg, B, SLOTS, dtype=torch.float32, device="cpu"), caches)
        out["decode"] = []
        for i in range(STEPS):
            lg, state = MD.decode_step(
                params, cfg, state, torch.tensor(inputs["steps"][i]),
                torch.full((B, 1), S + i), S + i)
            out["decode"].append(lg.numpy())
        out["state"] = _whole(state)
    return out


def _leaves(tree, path=""):
    """[(path, array)] of a tree of dicts and tuples, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _leaves(v,
                                                               f"{path}/{i}")]
    return [] if tree is None else [(path, np.asarray(tree))]


def _batch_dim(path: str) -> int:
    """The batch dim of a result leaf: 0 for logits, past the layer axes
    for a cache or state leaf (two for the hybrid's group states, (ng, g),
    one elsewhere)."""
    if path.startswith(("/prefill", "/decode")):
        return 0
    return 2 if path.startswith(("/caches/groups/0", "/state/groups")) \
        else 1


def _rows(run, b):
    """A whole-batch run's leaves ({path: array}), each cut to its first b
    batch rows."""
    return {p: a[(slice(None),) * _batch_dim(p) + (slice(0, b),)]
            for p, a in _leaves(run)}


@pytest.fixture(scope="module")
def case():
    jcfgs, inputs = _inputs()
    with tempfile.TemporaryDirectory(prefix="sharded_families_") as tmp:
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as fh:
            pickle.dump(inputs, fh)
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
                   os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
        procs = {name: subprocess.Popen(
            [sys.executable, __file__, "--prog", name, tmp],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, start_new_session=True) for name in MESHES}
        try:
            # the references meanwhile
            ref = {a: _reference(jcfgs[a], inputs["trees"][a], inputs)
                   for a in ARCHS}
            port = {a: _port(a, inputs["trees"][a], inputs) for a in ARCHS}
            outs = {name: p.communicate(timeout=TIMEOUT)
                    for name, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:         # the ranks with it
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        sharded = {}
        for name, p in procs.items():
            out, err = outs[name]
            assert p.returncode == 0 and f"PROG-OK {name}" in out, \
                out[-3000:] + err[-3000:]
            with open(os.path.join(tmp, f"sharded_{name}.pkl"), "rb") as fh:
                sharded[name] = pickle.load(fh)
    runs = {c: sharded["1x4" if shape == (1, 4) else "2x2"][c]
            for c, (shape, _) in CASES.items()}
    return inputs, runs, port, ref, sharded["2x2"]["refusal"]


def _held(got, want, b, tol):
    got = {p: a for p, a in _leaves(got) if p.split("/")[1] in (
        "prefill", "decode", "caches", "state")}
    want = _rows(want, b)
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for p in got:
        np.testing.assert_allclose(got[p], want[p], err_msg=p, **tol)


PAIRS = [(c, a) for c in CASES for a in ARCHS]
PAIR_IDS = [f"{c}-{a}" for c, a in PAIRS]


@pytest.mark.parametrize("name,arch", PAIRS, ids=PAIR_IDS)
def test_sharded_serve_equals_unsharded_port(case, name, arch):
    """Prefill logits, every prefill cache leaf, each decode step's logits
    and every leaf of the state after them."""
    got = case[1][name][arch]
    _held(got, case[2][arch], CASES[name][1], PORT_TOL)


@pytest.mark.parametrize("name,arch", PAIRS, ids=PAIR_IDS)
def test_sharded_serve_matches_reference(case, name, arch):
    got = case[1][name][arch]
    _held(got, case[3][arch], CASES[name][1], TOL)


@pytest.mark.parametrize("name,arch", [p for p in PAIRS
                                       if p[1] != "qwen3-32b"],
                         ids=[i for i, p in zip(PAIR_IDS, PAIRS)
                              if p[1] != "qwen3-32b"])
def test_prefill_runs_ssd_chunk_on_local_heads(case, name, arch):
    """Every Mamba2 layer's ssd_chunk call takes this rank's batch rows
    and its share of the heads (x (b / data, nc, Q, H / model, P), A (H /
    model,)), B and C whole: 7 layers of Zamba2, 2 of Mamba2."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    (data, model), b = CASES[name]
    s = cfg.ssm
    rows = b // data if b % data == 0 and b > 1 else b
    nc = S // s.chunk
    want = [(rows, nc, s.chunk, s.n_heads // model, s.head_dim),
            (rows, nc, s.chunk, s.n_heads // model), (s.n_heads // model,),
            (rows, nc, s.chunk, s.d_state), (rows, nc, s.chunk, s.d_state)]
    calls = case[1][name][arch]["prefill_calls"]["ssd_chunk"]
    assert [list(map(tuple, c)) for c in calls] == [want] * cfg.n_layers


@pytest.mark.parametrize("name,arch", [p for p in PAIRS
                                       if p[1] != "mamba2-370m"],
                         ids=[i for i, p in zip(PAIR_IDS, PAIRS)
                              if p[1] != "mamba2-370m"])
def test_gqa_decode_merges_the_sequence_shards(case, name, arch):
    """Each decode step's GQA attention (every Qwen3 layer, every Zamba2
    group's shared block) merges M partials with softmax_merge, M the
    ranks that split the cache's sequence (model, or the whole mesh for one
    row), each (M, b / data, 1, H, hd); the prefill merges none."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    (data, model), b = CASES[name]
    m = data * model if b == 1 else model
    rows = b if b == 1 else b // data
    a = cfg.attn_cfg
    n = cfg.n_layers // cfg.hybrid_group if cfg.family == "hybrid" \
        else cfg.n_layers
    run = case[1][name][arch]
    assert run["prefill_calls"]["softmax_merge"] == []
    o = (m, rows, 1, a.n_heads, a.hd)
    assert [c[0] for c in run["decode_calls"]["softmax_merge"]] == \
        [o] * (n * STEPS)


@pytest.mark.parametrize("splits", UNIT_SPLITS)
def test_gqa_partials_merged_equal_sdpa(case, splits):
    """decode_partial over `splits` contiguous splits of the cache's rows
    (3: 11, 11 and 10 rows), merged by softmax_merge, against _sdpa over all of them (plain
    tensors); local_seq_partials on plain tensors is that one call."""
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels.softmax_merge import softmax_merge
    from repro_torch.models import attention as A
    inputs = case[0]
    cfg = inputs["unit_cfg"]
    q, k, v = (torch.tensor(inputs[n]) for n in ("unit_q", "unit_k",
                                                 "unit_v"))
    want = A._sdpa(cfg, q, k, v, None)
    parts = [A.decode_partial(cfg, q, kp, vp) for kp, vp in zip(
        torch.tensor_split(k, splits, dim=1),
        torch.tensor_split(v, splits, dim=1))]
    got = softmax_merge(*(torch.stack([p[j] for p in parts])
                          for j in range(3)))
    np.testing.assert_allclose(got.o.numpy(), want.numpy(), atol=UNIT_TOL,
                               rtol=UNIT_TOL)
    one = SH.local_seq_partials(lambda ql, kv: A.decode_partial(cfg, ql, *kv),
                                softmax_merge, q, (k, v))
    whole = A.decode_partial(cfg, q, k, v)
    for a, b in zip(one, whole):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_local_seq_partials_over_a_kv_tuple(case, name):
    """local_seq_partials over a DTensor (k, v) split over `model` (4 ways
    on (1, 4), 2 on (2, 2)) and, for one row, over both dims of (2, 2),
    against the one decode_partial call on the whole cache."""
    import torch
    from repro_torch.models import attention as A
    inputs = case[0]
    b = CASES[name][1]
    whole = A.decode_partial(inputs["unit_cfg"], *(
        torch.tensor(inputs[n][:b]) for n in ("unit_q", "unit_k", "unit_v")))
    for got, want in zip(case[1][name]["unit"], whole):
        np.testing.assert_allclose(got, want.numpy(), atol=UNIT_TOL,
                                   rtol=UNIT_TOL)


def test_ssd_intra_chunk_refuses_a_dtensor(case):
    msg = case[4]
    assert msg is not None and "DTensor" in msg and "serving_intra" in msg, \
        msg


def _main():
    import torch.multiprocessing as mp
    name, tmp = sys.argv[2], sys.argv[3]
    mp.spawn(prog, args=(4, name, tmp), nprocs=4, join=True)
    print(f"PROG-OK {name}", flush=True)


if __name__ == "__main__" and "--prog" in sys.argv:
    sys.path.insert(0, SRC)
    _main()
