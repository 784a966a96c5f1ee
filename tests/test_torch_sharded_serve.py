"""The sharded serving form of the MLA family on gloo, on the CPU, against
the unsharded port and the JAX package: the DeepSeek smoke config in f32 on
one weight tree (numpy_weights, carried across by convert.py), a prefill of
B x S tokens, the decode state laid out by decode_state_shardings (the
latent cache's SEQUENCE over `model`) and STEPS decode steps at slots S,
S + 1, ... of a cache of SLOTS slots, which lie on a non-zero `model`
rank: on (1, 4) ("data", "model") the slots are on rank 2 and rank 3
attends unwritten zeros; on (2, 2) they are on rank 1. One batch row on
(2, 2) and on (1, 4) takes the long-context layout, the sequence over
both mesh dims: its slots lie on the third of four sequence shards. After
the STEPS dense steps, SEL_STEPS selection steps (selection_k SEL_KS) run
through local_seq_selected: each shard scores its rows, one all-gather of
the shards' candidates picks the global top k, each shard attends the
chosen rows it holds with sparse_select and the partials merge.

The sharded steps run in a subprocess (python <this file> --prog serve4
<dir>) that spawns 4 ranks, which meet through a file in <dir> (no TCP
port to pick), with a timeout; rank 0 saves what they computed, gathered
whole, and the tests read it. The parameters, the
prefill batch, the decode state and the decode inputs take the dry run's
placements (param_shardings, train_batch_shardings,
decode_state_shardings, decode_input_shardings) under sp_policy, with
the KERNELS ops (their plain versions on the CPU's local tensors): the
prefill's attention per (batch row, head) shard (local_heads), the decode
attention per sequence shard, the partials gathered and merged
(local_seq_partials).

The unsharded side runs the batch as the mesh's data shards dispatch it:
(1, 4) the whole batch, (2, 2) each row on its own, for the expert-parallel
MoE takes each data shard's tokens with that shard's capacity (1.25 x its
tokens x top_k / experts, 1 at a decode step), as the reference's EP form
does: two rows picking one expert at capacity 1 drop a pair that two
shards keep.

Each case runs a second time with every MoE layer pinned to the
unsharded port's routes on the same rows (prefill(pinned=...),
decode_step(pinned=...): the expert-parallel form takes each data
shard's rows of them, as DTensors on the (2, 2) meshes' decode steps),
held against the unsharded port pinned to the same routes; those routes
equal the sharded run's own, so the pinned run is also held bit for bit
against the unpinned one, and the unsharded port pinned to its own
routes bit for bit against itself.

Limits: the unsharded port at 1e-5 (the same ops, the decode's softmax
summed per shard and merged), the reference at tests/test_torch_model.py's
TOL, the MoE routes and every layer's chosen set equal. The unit cases
hold local_seq_partials over a cache split 2 and 4 ways against the one
call and the reference's absorbed_partial at 2e-6, and the global top-k
split 1 to 4 ways against top_k_lowest_first and lax.top_k; each kernel
wrapper refuses a DTensor with a TypeError that names the helper to use. A
second subprocess (--prog fake) holds the dry run's count of both
helpers' all-gathers on a fake group of 4 (distributed.step_costs, meta
tensors) and builds the V2-Lite decode_32k and long_500k cells at 2
layers on (2, 2).
"""

import contextlib
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
ARCH, SEED = "deepseek-v2-lite", 0
B, S, SLOTS, STEPS = 2, 16, 32, 3
MESHES = ((1, 4), (2, 2))
# one batch row: decode_state_shardings splits the latent cache's
# sequence over both mesh dims (on (1, 4) the data dim of 1 too: one row
# is never split, sharding.splits), the slots S.. on shard 2 of 4
ROW0 = slice(0, 1)
ONE_ROWS = {"2x2 one row": (2, 2), "1x4 one row": (1, 4)}
CASES = MESHES + tuple(ONE_ROWS)
IDS = ["1x4", "2x2", "2x2-one-row", "1x4-one-row"]
PORT_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)       # tests/test_torch_model.py's
UNIT_TOL = 2e-6
# selection decode steps after the dense ones, at slots S + STEPS, ...: the
# first picks 8 of the 32 slots, the second reaches past the written
# slots' positive scores into the unwritten slots, which all score 0
# exactly, so it takes some of those tied zeros (the lowest slots first)
# and not others, across a shard boundary
SEL_KS = (8, 16)
SEL_STEPS = len(SEL_KS)
SPLITS = (1, 2, 3, 4)                  # the global top-k's unit case
UNIT_META = (8, 16, 64, 576, 512)      # the fake group's B, H, S, D, d_v
# the fake group's selection: long_500k's one row, its 524 288 slots and
# selection_k (configs.SHAPES, launch/dryrun.py), V2-Lite's heads
SEL_META = (1, 16, 524288, 576, 512, 2048)     # B, H, S, D, d_v, k


# ---------------------------------------------------------------------------
# the prog (run in the subprocess's ranks; imports no JAX)
# ---------------------------------------------------------------------------

def _by_call(pinned, n_calls, wrap=lambda t: t):
    """A run's routes (numpy, one (T, k) a MoE layer call, prefill first)
    as one list a model call: the prefill's, then each decode step's, each
    entry a tensor through wrap. None without pinned."""
    import torch
    if pinned is None:
        return [None] * n_calls
    n = len(pinned) // n_calls
    return [[wrap(torch.tensor(r)) for r in pinned[i * n:(i + 1) * n]]
            for i in range(n_calls)]


def _sharded_run(mesh, params, cfg, inputs, rows=slice(0, B),
                 prefill_params=None, pinned=None):
    """Prefill, the state filled and STEPS decode steps of the batch rows
    `rows` on mesh (KERNELS ops): every result whole, as numpy, and the
    sequence shard that wrote the decode slots (its index over every mesh
    dim that splits the cache's sequence). With prefill_params (the same
    weights unsharded) the prefill runs unsharded on each rank and its
    caches enter the state replicated: the long-context form, a decode
    cell alone (long_500k), whose one row the data axis does not split.
    pinned: the unsharded port's routes on the same rows, every MoE layer
    held on them (prefill(pinned=...), decode_step(pinned=...)); on a
    mesh with a data dim of 2 the decode steps' entries go in as
    replicated DTensors, which the EP form redistributes to its tokens'
    placements, elsewhere as plain tensors."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed import policy as POL
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import input_specs as IS
    from repro_torch.models import model as MD
    b = rows.stop - rows.start
    shape = ShapeSpec("decode", SLOTS, b, "decode")
    tokens = torch.tensor(inputs["tokens"][rows])
    routes = []
    as_dt = (lambda t: SH.distribute(t, mesh, ())) if mesh.shape[0] == 2 \
        else (lambda t: t)
    pins = _by_call(pinned, 1 + STEPS + SEL_STEPS)
    steps_pinned = _by_call(pinned, 1 + STEPS + SEL_STEPS, as_dt)[1:]
    with POL.use_policy(POL.sp_policy(mesh)), implicit_replication(), \
            torch.no_grad():
        if prefill_params is None:
            bsh = IS.train_batch_shardings({"tokens": tokens}, mesh)
            logits, caches = MD.prefill(
                params, cfg, {"tokens": SH.distribute(tokens, mesh,
                                                      bsh["tokens"].spec)},
                routes=routes, pinned=pins[0])
        else:
            with POL.use_policy(None):
                logits, caches = MD.prefill(prefill_params, cfg,
                                            {"tokens": tokens}, routes=routes,
                                            pinned=pins[0])
            caches = {k: SH.distribute(v, mesh, ()) for k, v in
                      caches.items()}
        st_sh = IS.decode_state_shardings(cfg, shape, mesh)
        state = MD.init_decode_state(cfg, b, SLOTS, dtype=torch.float32,
                                     device="cpu")
        state = MD.fill_decode_state(cfg, {
            k: SH.distribute(v, mesh, st_sh[k].spec)
            for k, v in state.items()}, caches)
        tok_sh, pos_sh, _ = IS.decode_input_shardings(mesh, b)
        step = lambda c, tok, i: MD.decode_step(
            params, c, state, SH.distribute(torch.tensor(tok[rows]), mesh,
                                            tok_sh.spec),
            SH.distribute(torch.full((b, 1), S + i, dtype=torch.int32), mesh,
                          pos_sh.spec), S + i, routes=routes,
            pinned=steps_pinned[i])
        decode = []
        for i in range(STEPS):
            lg, state = step(cfg, inputs["steps"][i], i)
            decode.append(lg.full_tensor().numpy())
        np1 = lambda t: (t.full_tensor() if SH.is_dtensor(t) else t).numpy()
        whole = lambda t: {k: np1(v) for k, v in t.items()}
        dense_state = whole(state)
        select, chosen = [], []
        with _chosen_ids(chosen):
            for j, k in enumerate(SEL_KS):
                lg, state = step(dataclasses.replace(cfg, selection_k=k),
                                 inputs["sel_steps"][j], STEPS + j)
                select.append(lg.full_tensor().numpy())
        local = state["blocks"].to_local()
        _, off, n = SH._seq_shard(state["blocks"], 2)
        wrote = off <= S and S + STEPS <= off + n and \
            bool(local[:, :, S - off:S - off + STEPS].abs().sum() > 0)
        writers = [None] * mesh.size()
        torch.distributed.all_gather_object(writers,
                                            off // n if wrote else None)
        by_rank = [None] * mesh.size()
        torch.distributed.all_gather_object(
            by_rank, (mesh.get_coordinate()[0], chosen))
        return {"prefill": np1(logits), "caches": whole(caches),
                "decode": decode, "state": dense_state,
                "select": select, "select_state": whole(state),
                "chosen_by_rank": by_rank,
                "routes": [np1(r) for r in routes],
                "writers": sorted({w for w in writers if w is not None})}


@contextlib.contextmanager
def _chosen_ids(out):
    """While active, each call of sharding.global_top_k appends (this
    rank's first row offset, its row count, the chosen global ids) to out,
    as numpy."""
    from repro_torch.distributed import sharding as SH
    real = SH.global_top_k

    def record(scores, k, *a, **kw):
        ids = real(scores, k, *a, **kw)
        off = a[2] if len(a) > 2 else kw.get("off", 0)
        out.append((off, scores.shape[-1], ids.numpy()))
        return ids
    SH.global_top_k = record
    try:
        yield
    finally:
        SH.global_top_k = real


def _unit_partials(mesh, inputs, rows=slice(0, B)):
    """local_seq_partials (mla_decode per shard, softmax_merge across)
    over a DTensor cache of the batch rows `rows` laid out as
    decode_state_shardings lays out the latent cache: the batch over
    `data` and the sequence over `model`, or, for one row, the sequence
    over both mesh dims (data major); whole."""
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels.mla_decode import mla_decode
    from repro_torch.kernels.softmax_merge import softmax_merge
    q, ckv = (torch.tensor(inputs[k][rows]) for k in ("unit_q", "unit_ckv"))
    one = rows.stop - rows.start == 1
    part = SH.local_seq_partials(
        lambda ql, cl: mla_decode(ql, cl, None, d_v=inputs["unit_dv"],
                                  scale=inputs["unit_scale"]),
        softmax_merge, SH.distribute(q, mesh, () if one else ("data",)),
        SH.distribute(ckv, mesh, (None, ("data", "model")) if one
                      else ("data", "model")))
    return [t.full_tensor().numpy() for t in part]


def _refusals(mesh):
    """{what: the message of the TypeError it raised, or None}: each kernel
    wrapper given a DTensor."""
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.mla_decode import mla_decode
    from repro_torch.kernels.softmax_merge import softmax_merge
    from repro_torch.kernels.sparse_select import sparse_select
    g = torch.Generator().manual_seed(3)
    d = lambda *shape: SH.distribute(torch.randn(*shape, generator=g), mesh,
                                     ("data",))
    calls = {
        "mla_decode": lambda: mla_decode(d(2, 4, 40), d(2, 32, 40), d_v=32),
        "sparse_select": lambda: sparse_select(
            d(2, 4, 40), d(2, 32, 40),
            SH.distribute(torch.zeros(2, 1, dtype=torch.int32), mesh,
                          ("data",)), d_v=32, block_tokens=8),
        "flash_prefill": lambda: flash_prefill(d(2, 8, 4, 40), d(2, 8, 40),
                                               d_v=32),
        "softmax_merge": lambda: softmax_merge(d(2, 2, 4, 32), d(2, 2, 4),
                                               d(2, 2, 4).abs())}
    out = {}
    with torch.no_grad():
        for name, fn in calls.items():
            try:
                fn()
                out[name] = None
            except TypeError as e:
                out[name] = str(e)
    return out


def prog_serve4(rank, world, tmp):
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "rdv"), rank=rank, world_size=world)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    cfg = get_smoke_config(ARCH)
    out = {}
    for shape in MESHES:
        mesh = make_mesh(shape, ("data", "model"))
        params = model_params_from_numpy(inputs["tree"], cfg, device="cpu")
        SH.shard_params(params, SH.param_shardings(params, mesh))
        out[shape] = _sharded_run(mesh, params, cfg, inputs)
        out[shape]["pinned"] = _sharded_run(mesh, params, cfg, inputs,
                                            pinned=inputs["pinned"][shape])
        out[shape]["unit"] = _unit_partials(mesh, inputs)
        if shape == (2, 2):
            out["refusals"] = _refusals(mesh)
        for name in (n for n, m in ONE_ROWS.items() if m == shape):
            whole = model_params_from_numpy(inputs["tree"], cfg, device="cpu")
            out[name] = _sharded_run(mesh, params, cfg, inputs, ROW0, whole)
            out[name]["pinned"] = _sharded_run(
                mesh, params, cfg, inputs, ROW0, whole,
                pinned=inputs["pinned"][name])
            out[name]["unit"] = _unit_partials(mesh, inputs, ROW0)
    if rank == 0:
        with open(os.path.join(tmp, "sharded.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    dist.destroy_process_group()


def prog_fake():
    """On a fake group of 4 ranks, on meta tensors, as the dry run counts
    a step (distributed.step_costs): local_seq_partials over a (2, 2)
    mesh's cache and local_seq_selected over one row's cache split over
    both mesh dims (long_500k's shapes), their collectives; the V2-Lite
    decode_32k and long_500k (selection_k 2048) cells at 2 layers on that
    mesh, built and analysed."""
    import json

    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import step_costs
    from repro_torch.kernels.mla_decode import mla_decode_ref
    from repro_torch.kernels.softmax_merge import softmax_merge_ref
    from repro_torch.kernels.sparse_select import sparse_select_ref
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    b, h, s, d, d_v = UNIT_META
    with D.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        meta = lambda *shape: torch.zeros(shape, device="meta")
        q = SH.distribute(meta(b, h, d), mesh, ("data",))
        ckv = SH.distribute(meta(b, s, d), mesh, ("data", "model"))
        costs = step_costs.count(lambda: SH.local_seq_partials(
            lambda ql, cl: mla_decode_ref(ql, cl, None, d_v, 1.0),
            softmax_merge_ref, q, ckv))
        sb, sh, ss, sd, sdv, sk = SEL_META
        one = lambda *shape: SH.distribute(
            torch.zeros(shape, device="meta", dtype=torch.bfloat16), mesh,
            ())
        sel_costs = step_costs.count(lambda: SH.local_seq_selected(
            lambda ql, cl, ids, kb: sparse_select_ref(ql, cl, ids, kb, None,
                                                      sdv, 1, 1.0),
            softmax_merge_ref, one(sb, sh, sd), one(sb, 1, sdv),
            SH.distribute(torch.zeros((sb, ss, sd), device="meta",
                                      dtype=torch.bfloat16), mesh,
                          (None, ("data", "model"))), sk))
        step, info = D.build_step("deepseek-v2-lite", "decode_32k", mesh,
                                  n_layers=2)
        rec = D.analyse(step, mesh, info)
        step, info = D.build_step("deepseek-v2-lite", "long_500k", mesh,
                                  n_layers=2)
        sel = D.analyse(step, mesh, info)
        cache = [t for t in step.args if t.ndim == 4][0]
    print("FAKE " + json.dumps({
        "counts": dict(costs.collective_counts),
        "result_bytes": costs.collective_result_bytes,
        "wire_bytes": costs.collective_wire_bytes,
        "helper": {"counts": dict(sel_costs.collective_counts),
                   "wire_bytes": sel_costs.collective_wire_bytes},
        "cell": {"kind": rec["kind"], "flops": rec["flops"],
                 "counts": rec["collectives"]["counts"]},
        "selection": {"kind": sel["kind"], "n_layers": sel["n_layers"],
                      "counts": sel["collectives"]["counts"],
                      "wire_bytes": sel["collectives"]["wire_bytes"],
                      "cache": list(cache.shape),
                      "placements": [str(p) for p in cache.placements],
                      "itemsize": cache.element_size()}}), flush=True)


# ---------------------------------------------------------------------------
# the pytest side
# ---------------------------------------------------------------------------

def _inputs():
    """The weight tree in the reference's layout, the prompt, the decode
    tokens and the unit case's query and cache, as numpy."""
    from repro import configs as JC
    from torch_parity import numpy_weights
    jcfg = JC.get_smoke_config(ARCH)
    rng = np.random.default_rng(1)
    mcfg = jcfg.mla
    return jcfg, {
        "tree": numpy_weights(jcfg, seed=SEED),
        "tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32),
        "steps": rng.integers(0, jcfg.vocab, (STEPS, B, 1)).astype(np.int32),
        "sel_steps": rng.integers(0, jcfg.vocab, (SEL_STEPS, B, 1)).astype(
            np.int32),
        "unit_q": rng.standard_normal((B, mcfg.n_heads, mcfg.d_qk)).astype(
            np.float32),
        "unit_ckv": rng.standard_normal((B, SLOTS, mcfg.d_qk)).astype(
            np.float32),
        "unit_dv": mcfg.kv_lora_rank, "unit_scale": float(mcfg.scale)}


def _reference(jcfg, inputs, rows):
    """The JAX package's prefill and decode steps on the batch rows `rows`
    (numpy): last-token logits, caches, decode logits, the state after."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JMm
    from torch_parity import ref_fill_decode_state
    params = jax.tree.map(jnp.asarray, inputs["tree"])
    b = rows.stop - rows.start
    logits, caches = jax.jit(JMm.prefill, static_argnums=1)(
        params, jcfg, {"tokens": jnp.asarray(inputs["tokens"][rows])})
    state = ref_fill_decode_state(
        jcfg, JMm.init_decode_state(jcfg, b, SLOTS, dtype=jnp.float32),
        caches)
    dec = jax.jit(JMm.decode_step, static_argnums=1)
    decode = []
    for i in range(STEPS):
        lg, state = dec(params, jcfg, state,
                        jnp.asarray(inputs["steps"][i][rows]),
                        jnp.full((b, 1), S + i, jnp.int32), S + i)
        decode.append(np.asarray(lg))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    dense_state = np_tree(state)
    select = []
    for j, k in enumerate(SEL_KS):
        lg, state = dec(params, dataclasses.replace(jcfg, selection_k=k),
                        state, jnp.asarray(inputs["sel_steps"][j][rows]),
                        jnp.full((b, 1), S + STEPS + j, jnp.int32),
                        S + STEPS + j)
        select.append(np.asarray(lg))
    return {"prefill": np.asarray(logits), "caches": np_tree(caches),
            "decode": decode, "state": dense_state, "select": select,
            "select_state": np_tree(state)}


def _port(inputs, rows, pinned=None):
    """The port's prefill and decode steps, unsharded, on the rows; with
    pinned (a run's routes), every MoE layer held on them."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.models import model as MD
    cfg = get_smoke_config(ARCH)
    params = model_params_from_numpy(inputs["tree"], cfg, device="cpu")
    b = rows.stop - rows.start
    routes = []
    pins = _by_call(pinned, 1 + STEPS + SEL_STEPS)
    with torch.no_grad():
        logits, caches = MD.prefill(
            params, cfg, {"tokens": torch.tensor(inputs["tokens"][rows])},
            routes=routes, pinned=pins[0])
        state = MD.fill_decode_state(cfg, MD.init_decode_state(
            cfg, b, SLOTS, dtype=torch.float32, device="cpu"), caches)
        decode = []
        for i in range(STEPS):
            lg, state = MD.decode_step(
                params, cfg, state, torch.tensor(inputs["steps"][i][rows]),
                torch.full((b, 1), S + i), S + i, routes=routes,
                pinned=pins[1 + i])
            decode.append(lg.numpy())
        whole = lambda t: {k: v.numpy().copy() for k, v in t.items()}
        dense_state = whole(state)
        select, chosen = [], []
        with _chosen_ids(chosen):
            for j, k in enumerate(SEL_KS):
                lg, state = MD.decode_step(
                    params, dataclasses.replace(cfg, selection_k=k), state,
                    torch.tensor(inputs["sel_steps"][j][rows]),
                    torch.full((b, 1), S + STEPS + j), S + STEPS + j,
                    routes=routes, pinned=pins[1 + STEPS + j])
                select.append(lg.numpy())
    return {"prefill": logits.numpy(), "caches": whole(caches),
            "decode": decode, "state": dense_state, "select": select,
            "select_state": whole(state),
            "chosen": [ids for _, _, ids in chosen],
            "routes": [r.numpy() for r in routes]}


def _joined(runs):
    """Runs on consecutive row sets as one run over the batch: every array
    joined on its batch dim (the caches' and states' dim 1), the routes
    (the MoE layers' (tokens, k)) call by call."""
    cat = lambda xs, d: np.concatenate(xs, axis=d)
    first = runs[0]
    out = {"prefill": cat([r["prefill"] for r in runs], 0),
           "decode": [cat([r["decode"][i] for r in runs], 0)
                      for i in range(STEPS)],
           "select": [cat([r["select"][i] for r in runs], 0)
                      for i in range(SEL_STEPS)]}
    for k in ("caches", "state", "select_state"):
        out[k] = {n: cat([r[k][n] for r in runs], 1) for n in first[k]}
    if "chosen" in first:
        out["chosen"] = [cat([r["chosen"][i] for r in runs], 0)
                         for i in range(len(first["chosen"]))]
    if "routes" in first:
        out["routes"] = [cat([r["routes"][i] for r in runs], 0)
                         for i in range(len(first["routes"]))]
    return out


def _row_sets(shape):
    """The batch rows each data shard dispatches."""
    n = shape[0]
    return [slice(i * B // n, (i + 1) * B // n) for i in range(n)]


@pytest.fixture(scope="module")
def case():
    jcfg, inputs = _inputs()
    # the unsharded port first: its routes pin the sharded runs' second
    # pass, each case on the rows its data shards dispatch
    sets = {(r.start, r.stop): r for shape in MESHES
            for r in _row_sets(shape)}
    port = {k: _port(inputs, r) for k, r in sets.items()}
    row0 = (ROW0.start, ROW0.stop)
    inputs["pinned"] = {shape: _joined([port[(r.start, r.stop)]
                                        for r in _row_sets(shape)])["routes"]
                        for shape in MESHES}
    inputs["pinned"].update({name: port[row0]["routes"]
                             for name in ONE_ROWS})
    with tempfile.TemporaryDirectory(prefix="sharded_serve_") as tmp:
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as fh:
            pickle.dump(inputs, fh)
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
                   os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
        proc = subprocess.Popen([sys.executable, __file__, "--prog",
                                 "serve4", tmp],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env,
                                start_new_session=True)
        try:
            # the references meanwhile: each row set's, run once, and the
            # port pinned to its own routes
            ref = {k: _reference(jcfg, inputs, r) for k, r in sets.items()}
            pinned = {k: _port(inputs, r, port[k]["routes"])
                      for k, r in sets.items()}
            out, err = proc.communicate(timeout=TIMEOUT)
        finally:
            if proc.poll() is None:          # the ranks with it
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        assert proc.returncode == 0 and "PROG-OK serve4" in out, \
            out[-3000:] + err[-3000:]
        with open(os.path.join(tmp, "sharded.pkl"), "rb") as fh:
            sharded = pickle.load(fh)
    by_mesh = {}
    for shape in MESHES:
        keys = [(r.start, r.stop) for r in _row_sets(shape)]
        by_mesh[shape] = (sharded[shape], _joined([port[k] for k in keys]),
                          _joined([ref[k] for k in keys]),
                          _joined([pinned[k] for k in keys]))
    for name in ONE_ROWS:
        by_mesh[name] = (sharded[name], port[row0], ref[row0], pinned[row0])
    return inputs, by_mesh, sharded["refusals"]


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _held(got, want, tol):
    _close(got["prefill"], want["prefill"], tol, "prefill logits")
    for i in range(STEPS):
        _close(got["decode"][i], want["decode"][i], tol, f"decode step {i}")
    for k in ("caches", "state"):
        assert sorted(got[k]) == sorted(want[k])
        for n in got[k]:
            _close(got[k][n], want[k][n], tol, f"{k} {n}")


@pytest.mark.parametrize("shape", CASES, ids=IDS)
def test_sharded_serve_equals_unsharded_port(case, shape):
    got, port, _, _ = case[1][shape]
    _held(got, port, PORT_TOL)
    assert len(got["routes"]) == len(port["routes"]) > 0
    for a, b in zip(got["routes"], port["routes"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", CASES, ids=IDS)
def test_sharded_serve_matches_reference(case, shape):
    got, _, ref, _ = case[1][shape]
    _held(got, ref, TOL)


def _pinned_held(got, want, tol):
    """_held, then the selection steps' logits and state, routes and (for a
    sharded run, from its ranks' records) every layer's chosen set."""
    _held(got, want, tol)
    for i in range(SEL_STEPS):
        _close(got["select"][i], want["select"][i], tol,
               f"selection step {i}")
    for n in got["select_state"]:
        _close(got["select_state"][n], want["select_state"][n], tol,
               f"state after the selection steps, {n}")
    assert len(got["routes"]) == len(want["routes"]) > 0
    for a, b in zip(got["routes"], want["routes"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", CASES, ids=IDS)
def test_pinned_sharded_serve_equals_pinned_unsharded_port(case, shape):
    """The sharded prefill, dense and selection steps pinned to the
    unsharded port's routes (the EP form takes each data shard's rows of
    them) against the unsharded port pinned to the same routes: 1e-5,
    every layer's chosen set equal."""
    got, _, _, want = case[1][shape]
    got = got["pinned"]
    _pinned_held(got, want, PORT_TOL)
    chosen, _ = _chosen_whole(got["chosen_by_rank"], _batch(shape))
    assert len(chosen) == len(want["chosen"]) > 0
    for a, b in zip(chosen, want["chosen"]):
        np.testing.assert_array_equal(np.sort(a, -1), np.sort(b, -1))


@pytest.mark.parametrize("shape", CASES, ids=IDS)
def test_pinning_own_routes_is_bit_for_bit(case, shape):
    """A run pinned to its own routes is that run, bit for bit: the
    unsharded port on its routes, and the sharded run on the same routes
    (its own: test_sharded_serve_equals_unsharded_port holds them equal,
    and so does this test first)."""
    got, port, _, pinned = case[1][shape]
    exact = dict(atol=0, rtol=0)
    _pinned_held(pinned, port, exact)
    for a, b in zip(got["routes"], port["routes"]):
        np.testing.assert_array_equal(a, b)
    _pinned_held(got["pinned"], got, exact)
    for a, b in zip(got["pinned"]["chosen_by_rank"], got["chosen_by_rank"]):
        assert a[0] == b[0] and len(a[1]) == len(b[1])
        for (oa, na, ia), (ob, nb, ib) in zip(a[1], b[1]):
            assert (oa, na) == (ob, nb)
            np.testing.assert_array_equal(ia, ib)


@pytest.mark.parametrize("shape", CASES, ids=IDS)
def test_decode_writes_on_a_nonzero_model_rank(case, shape):
    """Slots S .. S + STEPS - 1 are written on one sequence shard, not the
    first, at their local index; the slots past them stay zero."""
    got = case[1][shape][0]
    rows_per_rank = SLOTS // (4 if shape in ONE_ROWS else shape[1])
    assert got["writers"] == [S // rows_per_rank] != [0]
    state = got["state"]["blocks"]
    assert np.all(np.abs(state[:, :, S:S + STEPS]).sum(-1) > 0)
    assert not np.any(state[:, :, S + STEPS:])


@pytest.mark.parametrize("shape", CASES, ids=IDS)
def test_local_seq_partials_merge_equals_one_call(case, shape):
    """local_seq_partials over a cache split over `model` (4 shards on
    (1, 4), 2 on (2, 2)), and for one row over both dims of (2, 2) (4
    shards, gathered the minor dim first), against the one mla_decode
    call on the whole cache (the helper on plain tensors, bit for bit that
    call) and the reference's absorbed_partial, batch row by batch row."""
    import jax.numpy as jnp
    import torch
    from repro.models import mla as JMLA
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels.mla_decode import mla_decode
    from repro_torch.kernels.softmax_merge import softmax_merge
    from repro import configs as JC
    inputs = case[0]
    q, ckv = (torch.tensor(inputs[k]) for k in ("unit_q", "unit_ckv"))
    attend = lambda ql, cl: mla_decode(ql, cl, None, d_v=inputs["unit_dv"],
                                       scale=inputs["unit_scale"])
    one = attend(q, ckv)
    plain = SH.local_seq_partials(attend, softmax_merge, q, ckv)
    for a, b in zip(plain, one):
        assert torch.equal(a, b)
    mcfg = JC.get_smoke_config(ARCH).mla
    for i in range(B):
        ref = JMLA.absorbed_partial(mcfg, jnp.asarray(inputs["unit_q"][i]),
                                    jnp.asarray(inputs["unit_ckv"][i]))
        for a, b in zip(one, ref):
            np.testing.assert_allclose(a[i].numpy(), np.asarray(b),
                                       atol=UNIT_TOL, rtol=UNIT_TOL)
    rows = ROW0 if shape in ONE_ROWS else slice(0, B)
    for got, want in zip(case[1][shape][0]["unit"], one):
        np.testing.assert_allclose(got, want[rows].numpy(), atol=UNIT_TOL,
                                   rtol=UNIT_TOL)


@pytest.fixture(scope="module")
def fake():
    import json
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, __file__, "--prog", "fake"],
                         capture_output=True, text=True, timeout=TIMEOUT,
                         env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("FAKE ")]
    assert line, res.stdout[-3000:]
    return json.loads(line[-1][5:])


def test_dry_run_counts_the_partials_all_gather(fake):
    """One all-gather of the packed (o, m, l) over the 2-wide model axis:
    2 ranks x the batch shard's rows x every head x (d_v + 2) f32, half of
    it sent (the ring model); the query and the cache move nowhere."""
    b, h, _, _, d_v = UNIT_META
    result = 2 * (b // 2) * h * (d_v + 2) * 4
    assert fake["counts"] == {"all_gather_into_tensor": 1.0}
    assert fake["result_bytes"] == result
    assert fake["wire_bytes"] == result / 2


def test_the_mla_decode_cell_builds_with_the_gather(fake):
    cell = fake["cell"]
    assert cell["kind"] == "decode" and cell["flops"] > 0
    assert cell["counts"].get("all_gather_into_tensor", 0) >= 2   # a layer


def test_dry_run_counts_the_selection_gathers(fake):
    """local_seq_selected over one row's cache split over both mesh dims of
    (2, 2) (M = 4 shards): one all-gather a mesh dim of the candidates
    (each shard's top k scores' bits and ids, int32) and one of the packed
    partials, each sending (M - 1) x a rank's payload (the ring model, the
    minor dim first); the cache moves nowhere, far below one gather of it."""
    b, h, s, d, d_v, k = SEL_META
    m = 4
    cand = 2 * b * min(k, s // m) * 4
    part = b * h * (d_v + 2) * 4
    assert fake["helper"]["counts"] == {"all_gather_into_tensor": 4.0}
    assert fake["helper"]["wire_bytes"] == (m - 1) * (cand + part)
    assert fake["helper"]["wire_bytes"] < 1e-3 * s * d * 2


def test_the_selection_cell_builds_without_gathering_the_cache(fake):
    """The V2-Lite long_500k cell at 2 layers on (2, 2): one row, the
    latent cache's sequence over both mesh dims; its whole decode step
    (the weights' gathers included) sends less than one gather of one
    layer's cache would (the parent's DTensor selection sent two a layer)
    and counts the helper's four all-gathers in every layer."""
    sel = fake["selection"]
    assert sel["kind"] == "decode" and sel["n_layers"] == 2
    L, b, s, d = sel["cache"]
    assert (b, s) == (1, 524288) and sel["placements"] == ["S(2)", "S(2)"]
    layer_gather = b * s * d * sel["itemsize"] * 3 / 4
    assert sel["wire_bytes"] < layer_gather
    assert sel["counts"]["all_gather_into_tensor"] >= 4 * L


@pytest.mark.parametrize("what,names", [
    ("mla_decode", "local_seq_partials"),
    ("softmax_merge", "local_seq_partials"),
    ("flash_prefill", "local_heads"),
    ("sparse_select", "local_seq_selected")])
def test_kernel_wrappers_refuse_a_dtensor(case, what, names):
    msg = case[2][what]
    assert msg is not None and "DTensor" in msg and names in msg, msg


def _chosen_whole(by_rank, b):
    """Each global_top_k call's chosen ids over the b batch rows, from every
    rank's record ((data coordinate, [(offset, rows, ids)])): the ranks of
    one data shard must agree; a batch the data dim splits is joined in
    data order. Also each call's smallest count of chosen ids one rank
    holds (0: some rank attended none)."""
    n_calls = {len(c) for _, c in by_rank}
    assert len(n_calls) == 1
    whole, least = [], []
    for i in range(n_calls.pop()):
        by_data = {}
        held = []
        for data, calls in by_rank:
            off, n, ids = calls[i]
            if data in by_data:
                np.testing.assert_array_equal(by_data[data], ids)
            by_data[data] = ids
            held.append(int(((ids >= off) & (ids < off + n)).sum(-1).min()))
        parts = [by_data[k] for k in sorted(by_data)]
        if parts[0].shape[0] == b:
            for p in parts:
                np.testing.assert_array_equal(p, parts[0])
            whole.append(parts[0])
        else:
            whole.append(np.concatenate(parts, 0))
        least.append(min(held))
    return whole, least


def _batch(shape):
    return 1 if shape in ONE_ROWS else B


@pytest.mark.parametrize("shape", CASES, ids=IDS)
def test_sharded_selection_equals_unsharded_port(case, shape):
    """The selection steps (global top-k over the shards, sparse_select on
    each shard's chosen rows, softmax_merge) against the unsharded port:
    logits and the state after them at 1e-5, every layer's chosen set
    equal."""
    got, port, _, _ = case[1][shape]
    for i in range(SEL_STEPS):
        _close(got["select"][i], port["select"][i], PORT_TOL,
               f"selection step {i}")
    for n in got["select_state"]:
        _close(got["select_state"][n], port["select_state"][n], PORT_TOL,
               f"state after the selection steps, {n}")
    chosen, _ = _chosen_whole(got["chosen_by_rank"], _batch(shape))
    assert len(chosen) == len(port["chosen"]) > 0
    for a, b in zip(chosen, port["chosen"]):
        np.testing.assert_array_equal(np.sort(a, -1), np.sort(b, -1))


@pytest.mark.parametrize("shape", CASES, ids=IDS)
def test_sharded_selection_matches_reference(case, shape):
    got, _, ref, _ = case[1][shape]
    for i in range(SEL_STEPS):
        _close(got["select"][i], ref["select"][i], TOL,
               f"selection step {i}")
    for n in got["select_state"]:
        _close(got["select_state"][n], ref["select_state"][n], TOL,
               f"state after the selection steps, {n}")


@pytest.mark.parametrize("shape", CASES, ids=IDS)
def test_sharded_selection_splits_ties_and_empties_a_shard(case, shape):
    """The data reach the cases the global top-k must get right: in some
    layer of the second step the chosen set holds some of the unwritten
    slots (tied at exactly 0) and not others, the lowest taken; and in
    some call a shard holds none of the chosen rows (kb = 0)."""
    got = case[1][shape][0]
    chosen, least = _chosen_whole(got["chosen_by_rank"], _batch(shape))
    first_free = S + STEPS + SEL_STEPS
    unwritten = np.arange(first_free, SLOTS)
    split = []
    for ids in chosen[len(chosen) // SEL_STEPS:]:
        for row in ids:
            took = np.isin(unwritten, row)
            if 0 < took.sum() < len(unwritten):
                split.append(bool(took[:took.sum()].all()))
    assert split and all(split)
    assert min(least) == 0


@pytest.mark.parametrize("split", SPLITS)
def test_global_top_k_over_shards(split):
    """shard_candidates on each of `split` shards and choose_candidates
    over them, gathered in either order (the ids travel with the scores),
    give top_k_lowest_first over the whole vector, ties included (integer scores; a zero tail; a tail of -9, of which k = 18
    takes the lowest six), and at k = 12 the last shard, all -9, holds
    none; and that equals lax.top_k's choice."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro_torch.distributed import sharding as SH
    rng = np.random.default_rng(5)
    s = 24
    scores = rng.integers(-2, 3, (3, s)).astype(np.float32)
    scores[1, s // 2:] = 0.0
    scores[2, s // 2:] = -9.0
    t = torch.tensor(scores)
    n = s // split
    for k in (1, 5, 12, s - 6, s):
        want = SH.top_k_lowest_first(t, k)
        np.testing.assert_array_equal(
            want.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(scores), k)[1]))
        cands = [SH.shard_candidates(t[:, r * n:(r + 1) * n], k, r * n)
                 for r in range(split)]
        for order in (cands, cands[::-1]):     # any gather order
            vals, ids = zip(*order)
            got = SH.choose_candidates(torch.cat(vals, -1),
                                       torch.cat(ids, -1), k)
            assert torch.equal(got, want), (k, got, want)
        assert torch.equal(SH.global_top_k(t, k), want)
    if split > 1:
        last = SH.top_k_lowest_first(t, s // 2)[2]
        assert not ((last >= s - n) & (last < s)).any()


def _main():
    import torch.multiprocessing as mp
    mp.spawn(prog_serve4, args=(4, sys.argv[3]), nprocs=4, join=True)
    print("PROG-OK serve4", flush=True)


if __name__ == "__main__" and "--prog" in sys.argv:
    sys.path.insert(0, SRC)
    if sys.argv[-1] == "fake":
        prog_fake()
    else:
        _main()
