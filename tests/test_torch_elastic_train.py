"""The fault-tolerant train loop driven by a sharded step, the elastic
restart onto another mesh, a sharded save and a step's collectives, on 4
gloo ranks on the CPU: the counterpart of chip_smoke.py's 5e (f1), (f2)
and (f5) at the DeepSeek-V2-Lite smoke config's widths, in f32. The prog
runs in a subprocess of its own (python <this file> --prog <directory>)
that spawns its ranks, which meet through a file in that fresh temporary
directory (no TCP port), with a timeout; the weights (the reference's
layout, from numpy) and the batches go in as a pickle there, and rank 0
leaves the results beside it. While the prog runs, the pytest side runs
the JAX package's train_loop on the same weights and batches.

Every step is train_step(param_shardings=...) under sp_policy and
implicit_replication, the batch laid out with batch_sharding, ep_axis
"model", AdamWConfig(), wrapped as train_loop takes a step (the wrapper
records each step's routes, keyed by the optimizer's step count):

* (f1) on (1, 4) at n_micro 2: train_loop runs STEPS steps with
  ckpt_every 2, once unbroken and once with a fault_hook raising on every
  rank at step 3 (the step-2 snapshot's write may still be in flight; the
  loop finishes it before choosing). Held: every logged loss and gradient
  norm and every parameter and moment after the last step equal, bit for
  bit; one "restored" event, at step 2; the same snapshot steps on disk;
  in a save from DTensors, ranks 1-3 make no host copy (a spy on
  Tensor.to) and rank 0 one a leaf; the unbroken run's last snapshot is
  its state bit for bit and the JAX package's CheckpointManager restores
  it so.
* (f2) a new job on (2, 2) with fresh weights (init_sharded, another
  seed) runs train_loop on a directory holding the broken run's snapshots
  of steps <= 4: the loop's own warm start restores step 4 in place into
  the (2, 2) DTensors, then runs steps 4 and 5 at n_micro 1, pinned to the
  routes the unbroken run recorded there (each EP capacity group holds the
  rows of one (1, 4) microbatch). Held: the restored parameters and
  moments equal the unbroken run's step-4 snapshot bit for bit, each on
  param_shardings' (2, 2) placements; the recorded routes are the pinned
  ones; the losses within rtol 1e-5 of the unbroken run's (chip_smoke.py's
  rule); every parameter after step 5 within 1e-4 x its leaf's max.
* (f5) one step on each mesh ((2, 2) at n_micro 1 is (f2)'s step 4,
  (1, 4) at n_micro 2 the unbroken run's step 0): the collectives the
  process group issued in it, read from its flight recorder
  (distributed.flight, not step_costs' dispatch mode), against
  step_costs.measure of the same step on meta tensors over launch.dryrun's
  fake_group (build_step with this config, batch and dtype), counts by
  kind equal and result bytes by kind within 1%. The dry run counts the
  cards' collectives (its mesh takes the cards' device type); gloo has
  neither a reduce-scatter nor an all-to-all: it all-reduces the whole
  input of the one and all-gathers the input of the other (n times the
  result each), so the meta count is held in that form. On its own, a
  Shard(0) -> Shard(1) redistribute on the dry run's mesh counts as the
  one all-to-all NCCL logs for it on four H100s (5e (f5)).

Held against the JAX package: the unbroken sharded loop's logged losses
against its train_loop (unsharded, make_train_step at n_micro 2, the same
weights and batches) at rtol 1e-4 (tests/test_torch_train.py's limit).
"""

import os
import pickle
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TIMEOUT = 120          # seconds, the prog
WORLD = 4
ARCH = "deepseek-v2-lite"
STEPS, CKPT_EVERY, FAULT_AT = 6, 2, 3
ELASTIC_FROM = 4       # the (2, 2) job's warm start
MICRO = {(1, 4): 2, (2, 2): 1}
B, S = 8, 16


# ---------------------------------------------------------------------------
# the prog (run in the subprocess's ranks; imports no JAX)
# ---------------------------------------------------------------------------

class _Batches:
    """A pipeline for train_loop: batch_at(step) is the step's batch."""

    def __init__(self, batches):
        self.batches = batches

    def batch_at(self, step):
        return self.batches[step]


def _sharded_step(cfg, mesh, params, n_micro, routes, pinned=None,
                  window=None, windows=None, first=None):
    """A train step as train_loop calls it: the batch laid out with
    batch_sharding, then train_step(param_shardings=...) under sp_policy
    and implicit_replication. routes[i] gets step i's routes (whole), i
    the optimizer's step count before the step; pinned[i], where given,
    pins step i; at step `window` the collectives the step issued go into
    windows[window] (distributed.flight.by_kind); first(params, opt) runs
    before the first step."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import flight
    from repro_torch.distributed import policy as POL
    from repro_torch.distributed import sharding as SH
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainConfig, make_train_step
    step = make_train_step(cfg, AdamWConfig(),
                           TrainConfig(n_micro=n_micro, ep_axis="model"),
                           param_shardings=SH.param_shardings(params, mesh))
    spec = SH.batch_sharding(mesh).spec
    pending = [first]

    def train_step(params, opt, batch):
        i = int(opt["step"])
        if pending[0] is not None:
            pending.pop()(params, opt)
            pending.append(None)
        with POL.use_policy(POL.sp_policy(mesh)), implicit_replication():
            placed = {k: SH.distribute(v, mesh, spec)
                      for k, v in batch.items()}
            own = []
            mark = flight.last_id() if i == window else None
            out = step(params, opt, placed, routes=own,
                       pinned=None if pinned is None else pinned[i])
            if mark is not None:
                windows[i] = flight.by_kind(flight.since(mark))
        routes[i] = [[r.full_tensor() for r in lst] for lst in own]
        return out
    return train_step


def _state(params, opt):
    """Every parameter, then every first and second moment, gathered
    whole (a collective), then the step count, as numpy."""
    whole = [p.detach().full_tensor() for p in params.parameters()]
    whole += [t.full_tensor() for t in opt["m"] + opt["v"]]
    return [t.numpy().copy() for t in whole] + [opt["step"].numpy().copy()]


def _joined(routes, k):
    """A step's lists (one a microbatch) joined k at a time, layer by
    layer: a step's whose microbatch holds k of these microbatches'
    rows."""
    import torch
    return [[torch.cat([routes[i * k + h][j] for h in range(k)])
             for j in range(len(routes[0]))]
            for i in range(len(routes) // k)]


def _host_copies(params, tmp):
    """A blocking save of the sharded parameters with a spy on Tensor.to:
    the host copies (to("cpu", copy=True)) this rank made."""
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    seen, real = [0], torch.Tensor.to

    def spy(self, *a, **k):
        if k.get("copy") and "cpu" in [str(x) for x in a]:
            seen[0] += 1
        return real(self, *a, **k)

    torch.Tensor.to = spy
    try:
        CheckpointManager(os.path.join(tmp, "spy")).save(
            1, params, blocking=True)
    finally:
        torch.Tensor.to = real
    return seen[0]


def prog_elastic(rank, world, tmp):
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.distributed import flight
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.module import trainable
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.loop import LoopConfig, train_loop
    torch.set_num_threads(1)
    flight.enable()
    dist.init_process_group("gloo",
                            init_method="file://" + os.path.join(tmp, "rdv"),
                            rank=rank, world_size=world)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    cfg = get_smoke_config(ARCH)
    pipe = _Batches([{k: torch.from_numpy(v) for k, v in b.items()}
                     for b in inputs["batches"]])
    mesh14 = make_mesh((1, 4), ("data", "model"))
    windows = {}

    def f1_run(name, fault_hook=None):
        params = trainable(model_params_from_numpy(inputs["tree"], cfg,
                                                   device="cpu"))
        SH.shard_params(params, SH.param_shardings(params, mesh14))
        opt = adamw_init(params, AdamWConfig())
        routes = {}
        step = _sharded_step(cfg, mesh14, params, MICRO[(1, 4)], routes,
                             window=0 if fault_hook is None else None,
                             windows=windows)
        ckpt = CheckpointManager(os.path.join(tmp, name))
        params, opt, log = train_loop(
            step, params, opt, pipe, ckpt,
            LoopConfig(total_steps=STEPS, ckpt_every=CKPT_EVERY,
                       log_every=1), fault_hook=fault_hook)
        return params, opt, log, routes, ckpt.all_steps()

    # (f1) unbroken, then broken at FAULT_AT
    p_u, o_u, log_u, routes_u, steps_u = f1_run("unbroken")
    fired = []

    def fault(step):
        if step == FAULT_AT and not fired:
            fired.append(step)
            raise RuntimeError(f"induced fault at step {step}")

    p_b, o_b, log_b, _, steps_b = f1_run("broken", fault)
    state_u, state_b = _state(p_u, o_u), _state(p_b, o_b)
    copies = [None] * world
    dist.all_gather_object(copies, _host_copies(p_u, tmp))
    f14 = windows.pop(0)

    # (f2) a new job on (2, 2) from the broken run's snapshots <= 4
    elastic = os.path.join(tmp, "elastic")
    if rank == 0:
        for s in steps_b:
            if s <= ELASTIC_FROM:
                shutil.copytree(os.path.join(tmp, "broken", f"step_{s:08d}"),
                                os.path.join(elastic, f"step_{s:08d}"))
    dist.barrier()
    mesh22 = make_mesh((2, 2), ("data", "model"))
    params = trainable(SH.init_sharded(
        cfg, mesh22, torch.Generator().manual_seed(7), device="cpu",
        dtype=torch.float32))
    shard22 = SH.param_shardings(params, mesh22)
    opt = adamw_init(params, AdamWConfig())
    k = MICRO[(1, 4)] // MICRO[(2, 2)]
    pinned = {i: _joined(r, k) for i, r in routes_u.items()}
    restored, routes_e = {}, {}

    def first(params, opt):
        restored["state"] = _state(params, opt)
        restored["placed"] = all(
            p.device_mesh == mesh22
            and tuple(p.placements) == tuple(shard22[n].placements)
            for n, p in params.named_parameters())

    step = _sharded_step(cfg, mesh22, params, MICRO[(2, 2)], routes_e,
                         pinned=pinned, window=ELASTIC_FROM,
                         windows=windows, first=first)
    params, opt, log_e = train_loop(
        step, params, opt, pipe, CheckpointManager(elastic),
        LoopConfig(total_steps=STEPS, ckpt_every=STEPS + 1, log_every=1))
    after_e = _state(params, opt)
    f22 = windows.pop(ELASTIC_FROM)
    if rank == 0:
        np_routes = lambda rs: {i: [[t.numpy() for t in lst] for lst in r]
                                for i, r in rs.items()}
        out = {"log_unbroken": log_u, "log_broken": log_b,
               "steps_unbroken": steps_u, "steps_broken": steps_b,
               "state_unbroken": state_u, "state_broken": state_b,
               "host_copies": copies,
               "restored": restored["state"],
               "restored_placed": restored["placed"],
               "log_elastic": log_e, "after_elastic": after_e,
               "routes_elastic": np_routes(routes_e),
               "pinned": np_routes(pinned),
               "n_params": len(list(params.parameters())),
               "flight": {(1, 4): f14, (2, 2): f22}}
        with open(os.path.join(tmp, "elastic.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    dist.destroy_process_group()


def meta_costs():
    """step_costs' count of one step of each mesh of MICRO, on meta over a
    fake group: {mesh: {kind: {group size: [count, result bytes]}}}."""
    import torch
    from repro_torch.configs import ShapeSpec, get_smoke_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    cfg = get_smoke_config(ARCH)
    out = {}
    for shape, n in MICRO.items():
        with D.fake_group(WORLD):
            mesh = make_mesh(shape, ("data", "model"))
            step, meta = D.build_step(
                ARCH, "train", mesh, n_micro=n, cfg=cfg,
                shape=ShapeSpec("elastic", S, B, "train"),
                dtype=torch.float32)
            costs = D.step_costs.measure(step.micro, step.n_micro,
                                         step.update)
        out[shape] = {k: {g: list(v) for g, v in by_n.items()}
                      for k, by_n in costs.collective_groups.items()}
    return out


# ---------------------------------------------------------------------------
# the JAX package's loop (pytest side)
# ---------------------------------------------------------------------------

class _JaxBatches:
    def __init__(self, batches):
        self.batches = batches

    def batch_at(self, step):
        import jax.numpy as jnp
        return {k: jnp.asarray(v) for k, v in self.batches[step].items()}


def _reference_loop(tree, batches, tmp):
    """The JAX package's train_loop, unsharded, make_train_step at the
    (1, 4) run's n_micro: its log."""
    import jax
    import jax.numpy as jnp
    from repro import configs as JC
    from repro.checkpoint.manager import CheckpointManager as JCkpt
    from repro.optim import adamw as JA
    from repro.train import loop as JL
    from repro.train import step as JS
    jcfg = JC.get_smoke_config(ARCH)
    params = jax.tree.map(jnp.asarray, tree)
    ocfg = JA.AdamWConfig()
    step = jax.jit(JS.make_train_step(
        jcfg, ocfg, JS.TrainConfig(n_micro=MICRO[(1, 4)])))
    _, _, log = JL.train_loop(
        step, params, JA.adamw_init(params, ocfg), _JaxBatches(batches),
        JCkpt(tmp), JL.LoopConfig(total_steps=STEPS,
                                  ckpt_every=STEPS + 1, log_every=1))
    return log


# ---------------------------------------------------------------------------
# the tests (pytest side)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def elastic():
    """(the prog's results, the JAX package's log, the unbroken run's
    snapshot directory's step-4 and last leaves, the JAX package's restore
    of the last snapshot)."""
    from repro import configs as JC
    from torch_parity import numpy_weights
    jcfg = JC.get_smoke_config(ARCH)
    rng = np.random.default_rng(1)
    inputs = {"tree": numpy_weights(jcfg, seed=3),
              "batches": [{k: rng.integers(0, jcfg.vocab, (B, S)).astype(
                  np.int32) for k in ("tokens", "targets")}
                  for _ in range(STEPS)]}
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory(prefix="gloo_elastic_") as tmp:
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as fh:
            pickle.dump(inputs, fh)
        proc = subprocess.Popen([sys.executable, __file__, "--prog", tmp],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
        try:
            ref = _reference_loop(inputs["tree"], inputs["batches"],
                                  os.path.join(tmp, "jax"))
            out, err = proc.communicate(timeout=TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0, out[-3000:] + err[-3000:]
        assert "PROG-OK elastic" in out, out[-3000:]
        with open(os.path.join(tmp, "elastic.pkl"), "rb") as fh:
            got = pickle.load(fh)
        with open(os.path.join(tmp, "meta.pkl"), "rb") as fh:
            got["meta"] = pickle.load(fh)
        snaps = {s: _snapshot(os.path.join(tmp, "unbroken"), s)
                 for s in (ELASTIC_FROM, STEPS)}
        jax_back = _jax_restore(os.path.join(tmp, "unbroken"), STEPS)
    return got, ref, snaps, jax_back


def _snapshot(directory, step):
    """A snapshot's leaves, as numpy arrays of their dtypes and shapes."""
    import json
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as fh:
        man = json.load(fh)
    with np.load(os.path.join(path, "leaves.npz")) as data:
        return [data[f"leaf_{i}"].view(np.dtype(d)).reshape(s)
                for i, (d, s) in enumerate(zip(man["dtypes"],
                                               man["shapes"]))]


def _jax_restore(directory, step):
    """The JAX package's CheckpointManager.restore of a port snapshot
    into a flat list of zeros of its shapes and dtypes."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.manager import CheckpointManager as JCkpt
    leaves = _snapshot(directory, step)
    back = JCkpt(directory).restore(step, [jnp.zeros(a.shape, a.dtype)
                                           for a in leaves])
    return [np.asarray(x) for x in jax.tree.leaves(back)]


def _bits_equal(got, want):
    return len(got) == len(want) and all(
        a.dtype == b.dtype and a.shape == b.shape
        and np.array_equal(a.reshape(-1).view(np.uint8),
                           b.reshape(-1).view(np.uint8))
        for a, b in zip(got, want))


def _as_saved(state, n):
    """_state's leaves in the snapshot's order: the tree {"params", "opt":
    {"m", "step", "v"}} flattens in sorted-key order."""
    return state[n:2 * n] + [state[-1]] + state[2 * n:3 * n] + state[:n]


def _steps(log):
    return [e for e in log if "event" not in e]


def test_fault_replays_logged_losses_and_norms_bit_for_bit(elastic):
    got = elastic[0]
    want = [(e["step"], e["loss"], e["grad_norm"])
            for e in got["log_unbroken"]]
    assert [e["step"] for e in _steps(got["log_unbroken"])] == \
        list(range(STEPS))
    replayed = {e["step"]: (e["step"], e["loss"], e["grad_norm"])
                for e in _steps(got["log_broken"])}
    assert [replayed[s] for s in range(STEPS)] == want
    # the step before the fault ran twice, and gave the same bits
    twice = [e for e in _steps(got["log_broken"]) if e["step"] == 2]
    assert len(twice) == 2 and twice[0]["loss"] == twice[1]["loss"]


def test_fault_replays_every_parameter_and_moment_bit_for_bit(elastic):
    got = elastic[0]
    assert _bits_equal(got["state_broken"], got["state_unbroken"])


def test_fault_restores_once_at_the_last_snapshot(elastic):
    got = elastic[0]
    events = [e for e in got["log_broken"] if "event" in e]
    assert [(e["event"], e["step"]) for e in events] == [("restored", 2)]
    assert got["steps_broken"] == got["steps_unbroken"] == [2, 4, 6]


def test_sharded_save_keeps_one_host_copy_on_rank_0(elastic):
    """Ranks 1-3 join each leaf's gather and keep none of it: no host copy;
    rank 0 makes one a leaf."""
    got = elastic[0]
    assert got["host_copies"] == [got["n_params"], 0, 0, 0]


def test_sharded_snapshot_is_the_state_and_the_reference_reads_it(elastic):
    got, _, snaps, jax_back = elastic
    saved = _as_saved(got["state_unbroken"], got["n_params"])
    assert _bits_equal(snaps[STEPS], saved)
    assert _bits_equal(jax_back, saved)


def test_elastic_restore_onto_2x2_is_bit_for_bit(elastic):
    got, _, snaps, _ = elastic
    assert got["restored_placed"]
    assert _bits_equal(_as_saved(got["restored"], got["n_params"]),
                       snaps[ELASTIC_FROM])
    events = [e for e in got["log_elastic"] if "event" in e]
    assert events == []
    assert [e["step"] for e in got["log_elastic"]] == \
        list(range(ELASTIC_FROM, STEPS))


def test_elastic_steps_record_the_pinned_routes(elastic):
    got = elastic[0]
    assert sorted(got["routes_elastic"]) == list(range(ELASTIC_FROM, STEPS))
    for i, step in got["routes_elastic"].items():
        assert len(step) == 1 and len(step[0]) > 0
        for a, b in zip(step[0], got["pinned"][i][0]):
            np.testing.assert_array_equal(a, b)


def test_elastic_losses_match_the_unbroken_run(elastic):
    got = elastic[0]
    want = {e["step"]: e["loss"] for e in got["log_unbroken"]}
    for e in got["log_elastic"]:
        np.testing.assert_allclose(e["loss"], want[e["step"]], rtol=1e-5,
                                   atol=0)


def test_elastic_parameters_after_the_last_step_match(elastic):
    got = elastic[0]
    n = got["n_params"]
    for a, b in zip(got["after_elastic"][:n], got["state_unbroken"][:n]):
        assert float(np.abs(a - b).max()) <= 1e-4 * float(np.abs(b).max())


def test_unbroken_loop_losses_match_the_reference_loop(elastic):
    got, ref = elastic[0], elastic[1]
    assert [e["step"] for e in ref] == list(range(STEPS))
    np.testing.assert_allclose([e["loss"] for e in got["log_unbroken"]],
                               [e["loss"] for e in ref], rtol=1e-4)


# what gloo issues for a collective it lacks: the collective it issues
# in its place, whose result is n times the result
GLOO_FORM = {"reduce_scatter_tensor": "all_reduce",
             "all_to_all_single": "all_gather_into_tensor"}


def gloo_form(meta):
    """The meta count as gloo issues it (GLOO_FORM). {kind: [count,
    result bytes]}."""
    out = {}
    for k, by_n in meta.items():
        for n, (c, b) in by_n.items():
            kind, b = (GLOO_FORM[k], b * n) if k in GLOO_FORM else (k, b)
            o = out.setdefault(kind, [0.0, 0.0])
            o[0] += c
            o[1] += b
    return out


@pytest.mark.parametrize("shape", list(MICRO), ids=["1x4", "2x2"])
def test_step_collectives_match_step_costs(elastic, shape):
    """One sharded step's collectives as the gloo group's flight recorder
    logged them, by kind, against step_costs' count of the same step on
    meta tensors: counts equal, result bytes within 1%."""
    got = elastic[0]
    card = got["flight"][shape]
    want = gloo_form(got["meta"][shape])
    assert sorted(card) == sorted(want)
    for k, (count, nbytes) in want.items():
        assert card[k]["count"] == count, k
        assert abs(card[k]["result_bytes"] - nbytes) <= 0.01 * nbytes, k


def test_step_costs_counts_the_cards_all_to_all(elastic):
    """The dry run counts a Shard(i) -> Shard(j) redistribute as the
    all-to-all the cards issue (15 in (2, 2)'s step at V2-Lite's width,
    where the host's device type counted 15 all-gathers of twice the
    bytes), here in the (2, 2) step and on its own: one all-to-all whose
    result is the redistributed local tensor."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed import step_costs
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    assert elastic[0]["meta"][(2, 2)]["all_to_all_single"]
    with D.fake_group(WORLD):
        mesh = make_mesh((2, 2), ("data", "model"))
        x = DTensor.from_local(torch.zeros(8, 16, device="meta"), mesh,
                               [Shard(0), Replicate()])
        costs = step_costs.count(lambda: x.redistribute(
            mesh, [Shard(1), Replicate()]))
    assert dict(costs.collective_counts) == {"all_to_all_single": 1}
    # the local (16, 8) f32 result of a (16, 16) tensor over data's 2
    assert costs.collective_result_bytes == 16 * 8 * 4


def _main():
    import torch.multiprocessing as mp
    ctx = mp.start_processes(prog_elastic, args=(WORLD, sys.argv[2]),
                             nprocs=WORLD, join=False, start_method="spawn")
    meta = meta_costs()              # on a fake group, beside the ranks
    with open(os.path.join(sys.argv[2], "meta.pkl"), "wb") as fh:
        pickle.dump(meta, fh)
    while not ctx.join():
        pass
    print("PROG-OK elastic", flush=True)


if __name__ == "__main__" and "--prog" in sys.argv:
    _main()
