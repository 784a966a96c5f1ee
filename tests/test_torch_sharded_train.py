"""The sharded train step of the DeepSeek-V2-Lite smoke config on 4 gloo
ranks on the CPU, pinned through the step's route hook
(train_step(..., pinned=...), one list a microbatch) to the routes of the
unsharded step, and held against the unsharded port and the JAX package.
The prog runs in a subprocess of its own (python <this file> --prog
<directory>) that spawns its ranks, which meet through a file in that
fresh temporary directory (no TCP port), with a timeout; the weights (the
reference's layout, from numpy) and the batches go in as a pickle there,
and rank 0 leaves the results beside it. While the prog runs, the pytest
side runs the JAX package's make_train_step on the same weights and
batches.

Two meshes, ("data", "model"), each with param_shardings, sp_policy and
the expert-parallel MoE over "model" (ep_axis), 3 steps of 8 x 16 tokens
in f32, n_micro 2, each against the unsharded step with the same
microbatch rows:
* (2, 2) against the unsharded step at n_micro 4: the EP form dispatches
  each data shard with its own capacity, so sharded microbatch i holds the
  rows of unsharded microbatches 2i and 2i + 1, and its pinned list for a
  layer is their two lists joined;
* (1, 4) against the unsharded step at n_micro 2.
Rank 0 runs the unsharded port, recording its routes through the hook,
and broadcasts them; every rank pins its steps to them (plain tensors,
every shard's whole list, which the EP form cuts to each data shard's
tokens).

Held against the unsharded port: the losses at rtol 1e-5; the first
step's gradients within 1e-5 x their leaf's max; every parameter within
1e-4 x its leaf's max after the three steps; the routes the sharded steps
record equal to the pinned ones. The parameters after the first sharded
step are held elementwise at rtol 1e-6 (and atol 1e-6 x lr, where the
step takes an element near zero) against adamw_update applied unsharded
to the sharded run's own first-step gradients (the rule chip_smoke.py's
5e (d) holds on the card).

The same ranks hold sharding.init_sharded (the weights drawn and laid out
leaf by leaf) against init_model's tree drawn whole and sharded by
shard_params, bit for bit, in f32, in f32 cast to f64 and in bf16.

Held against the JAX package (make_train_step at the unsharded port's
n_micro, unpinned, the sharded step's counterpart on one device): first
its routes (the top-k of its own router at every MoE layer, each
microbatch, each step) equal to those the sharded port recorded, so the
pinned run is one the reference makes too; then the losses at rtol 1e-4
and the first step's gradients within 1e-4 x their leaf's max and rtol
1e-4, the limits of tests/test_torch_train.py, which holds the unsharded
step so. As there, the parameters after AdamW are not held against the
reference: AdamW's first step moves an element by lr g / (|g| + eps), so
an element whose gradient is near eps (1e-8) moves apart by a good part of
lr where the two packages' gradients differ in their last bits. (Both
decay the same tensors: tests/test_torch_optim_data_ckpt.py holds the
port's decay_mask against the reference's stacked tree.)
"""

import functools
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TIMEOUT = 240          # seconds, the prog (~25 s alone on 8 CPU cores)
WORLD = 4
ARCH = "deepseek-v2-lite"
MESHES = {(2, 2): 4, (1, 4): 2}   # mesh -> the unsharded twin's n_micro
N_MICRO, STEPS, B, S = 2, 3, 8, 16


# ---------------------------------------------------------------------------
# the prog (run in the subprocess's ranks; imports no JAX)
# ---------------------------------------------------------------------------

def _params(cfg, tree):
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.models.module import trainable
    return trainable(model_params_from_numpy(tree, cfg, device="cpu"))


def _numpy(tensors):
    return [t.detach().numpy().copy() for t in tensors]


def _unsharded(cfg, tree, batches, n_micro):
    """STEPS unsharded train steps, each recording its routes: (losses,
    the first step's gradients, the parameters after the steps, each
    step's routes: one list a microbatch)."""
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import (TrainConfig, loss_and_grads,
                                        make_train_step)
    params = _params(cfg, tree)
    ocfg, tcfg = AdamWConfig(), TrainConfig(n_micro=n_micro)
    opt = adamw_init(params, ocfg)
    _, grads = loss_and_grads(params, cfg, batches[0], tcfg)
    step = make_train_step(cfg, ocfg, tcfg)
    losses, routes = [], []
    for b in batches:
        routes.append([])
        params, opt, mets = step(params, opt, b, routes=routes[-1])
        losses.append(float(mets["loss"]))
    return losses, _numpy(grads), _numpy(params.parameters()), routes


def _joined(routes, k):
    """An unsharded step's lists (one a microbatch) joined k at a time,
    layer by layer: the lists of a sharded step whose microbatch holds k
    of the unsharded ones' rows."""
    import torch
    return [[torch.cat([routes[i * k + h][j] for h in range(k)])
             for j in range(len(routes[0]))]
            for i in range(len(routes) // k)]


def _sharded(mesh, cfg, tree, batches, pinned):
    """STEPS sharded train steps on mesh, pinned to `pinned` (each step's
    lists), each recording its routes: (losses, the first step's gradients
    whole, the parameters whole after one step and after STEPS, each
    step's routes whole)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import policy as POL
    from repro_torch.distributed import sharding as SH
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import (TrainConfig, loss_and_grads,
                                        make_train_step)
    params = _params(cfg, tree)
    shard = SH.param_shardings(params, mesh)
    SH.shard_params(params, shard)
    ocfg = AdamWConfig()
    opt = adamw_init(params, ocfg)
    tcfg = TrainConfig(n_micro=N_MICRO, ep_axis="model")
    step = make_train_step(cfg, ocfg, tcfg, param_shardings=shard)
    bs = SH.batch_sharding(mesh)
    place = lambda b: {k: SH.distribute(v, mesh, bs.spec)
                       for k, v in b.items()}
    losses, routes = [], []
    with POL.use_policy(POL.sp_policy(mesh)), implicit_replication():
        _, grads = loss_and_grads(params, cfg, place(batches[0]), tcfg,
                                  shard, pinned=pinned[0])
        grads = [g.full_tensor() for g in grads]
        for b, pin in zip(batches, pinned):
            routes.append([])
            params, opt, mets = step(params, opt, place(b),
                                     routes=routes[-1], pinned=pin)
            losses.append(float(mets["loss"].full_tensor()))
            if len(routes) == 1:       # a replicated leaf's own storage
                one = [p.full_tensor().clone() for p in params.parameters()]
        whole = [p.full_tensor() for p in params.parameters()]
    routes = [[[t.full_tensor() for t in lst] for lst in r] for r in routes]
    return losses, _numpy(grads), _numpy(one), _numpy(whole), routes


# the leaf-by-leaf sharded init's cases: name -> (init_model's dtype, the
# cast of each leaf), torch dtype names
INIT_CASES = {"f32": ("float32", None), "f32_to_f64": ("float32", "float64"),
              "bf16": ("bfloat16", None)}


def _init_equal(mesh, cfg):
    """{case: whether init_sharded's parameters equal those of init_model's
    tree (cast) sharded by shard_params, bit for bit, local shards and
    placements, on this rank}."""
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.model import init_model
    out = {}
    for case, (dtype, cast) in INIT_CASES.items():
        dtype, cast = getattr(torch, dtype), cast and getattr(torch, cast)
        gen = lambda: torch.Generator().manual_seed(0)
        got = SH.init_sharded(cfg, mesh, gen(), device="cpu", dtype=dtype,
                              cast=cast)
        want = init_model(cfg, gen(), device="cpu", dtype=dtype)
        if cast is not None:
            want = want.to(cast)
        SH.shard_params(want, SH.param_shardings(want, mesh))
        pairs = list(zip(got.named_parameters(), want.named_parameters()))
        out[case] = len(pairs) > 0 and all(
            a == b and x.placements == y.placements and x.dtype == y.dtype
            and torch.equal(x.to_local(), y.to_local())
            for (a, x), (b, y) in pairs)
    return out


def prog_train4(rank, world, tmp):
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo",
                            init_method="file://" + os.path.join(tmp, "rdv"),
                            rank=rank, world_size=world)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    cfg = get_smoke_config(ARCH)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in inputs["batches"]]
    out = {}
    for shape, n_twin in MESHES.items():
        mesh = make_mesh(shape, ("data", "model"))
        box = [None]
        if rank == 0:
            ref = _unsharded(cfg, inputs["tree"], batches, n_twin)
            box = [[_joined(r, n_twin // N_MICRO) for r in ref[3]]]
        dist.broadcast_object_list(box, src=0)
        pinned = box[0]
        losses, grads, one, whole, routes = _sharded(
            mesh, cfg, inputs["tree"], batches, pinned)
        init = [None] * world
        dist.all_gather_object(init, _init_equal(mesh, cfg))
        if rank == 0:
            out[shape] = {
                "losses": losses, "grads": grads, "one_step": one,
                "params": whole, "init_equal": init,
                "routes": [[[t.numpy() for t in lst] for lst in r]
                           for r in routes],
                "pinned": [[[t.numpy() for t in lst] for lst in r]
                           for r in pinned],
                "unsharded": {"losses": ref[0], "grads": ref[1],
                              "params": ref[2]}}
    if rank == 0:
        with open(os.path.join(tmp, "train4.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX package's step (pytest side)
# ---------------------------------------------------------------------------

def _reference(jcfg, tree, batches, n_micro):
    """The JAX package's make_train_step, STEPS steps at n_micro from
    tree: losses, the first step's gradients (the microbatches' mean of
    jax.grad of loss_fn) in the port's parameters() order, and each step's
    routes, one list a microbatch (test_torch_train._ref_routes on the
    step's parameters)."""
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw as JA
    from repro.train import step as JS
    from repro_torch import configs as TC
    from repro_torch.convert import model_params_from_numpy
    from test_torch_train import _ref_routes
    tcfg = TC.get_smoke_config(ARCH)
    port = lambda t: [p.detach().numpy() for p in model_params_from_numpy(
        jax.tree.map(np.asarray, t), tcfg, device="cpu").parameters()]
    params = jax.tree.map(jnp.asarray, tree)
    ocfg = JA.AdamWConfig()
    state = JA.adamw_init(params, ocfg)
    jstep = jax.jit(JS.make_train_step(jcfg, ocfg,
                                       JS.TrainConfig(n_micro=n_micro)))
    rows = B // n_micro
    micro = lambda b: [{k: jnp.asarray(v[i * rows:(i + 1) * rows])
                        for k, v in b.items()} for i in range(n_micro)]
    gfn = _grad_fn()
    grads = jax.tree.map(lambda *gs: sum(gs) / n_micro,
                         *[gfn(params, jcfg, mb) for mb in
                           micro(batches[0])])
    losses, routes = [], []
    for b in batches:
        routes.append([[np.asarray(r) for r in _ref_routes(
            jcfg, params, mb["tokens"])] for mb in micro(b)])
        params, state, mets = jstep(params, state,
                                    jax.tree.map(jnp.asarray, b))
        losses.append(float(mets["loss"]))
    return {"losses": losses, "grads": port(grads), "routes": routes}


@functools.lru_cache(maxsize=None)
def _grad_fn():
    import jax
    from repro.models import model as JMm
    return jax.jit(jax.grad(JMm.loss_fn), static_argnums=1)


# ---------------------------------------------------------------------------
# the tests (pytest side)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train4():
    """(the prog's results by mesh, the JAX package's by the unsharded
    twin's n_micro, the weights)."""
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
    with tempfile.TemporaryDirectory(prefix="gloo_train4_") as tmp:
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as fh:
            pickle.dump(inputs, fh)
        proc = subprocess.Popen([sys.executable, __file__, "--prog", tmp],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
        try:
            ref = {n: _reference(jcfg, inputs["tree"], inputs["batches"], n)
                   for n in sorted(set(MESHES.values()))}
            out, err = proc.communicate(timeout=TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0, out[-3000:] + err[-3000:]
        assert "PROG-OK train4" in out, out[-3000:]
        with open(os.path.join(tmp, "train4.pkl"), "rb") as fh:
            got = pickle.load(fh)
    return got, ref, inputs["tree"]


MESH_IDS = [f"{a}x{b}" for a, b in MESHES]


def _rel(got, want):
    """The worst leaf's max|got - want| over its max|want|."""
    return max(float(np.abs(a - b).max() / np.abs(b).max())
               for a, b in zip(got, want))


@pytest.mark.parametrize("shape", list(MESHES), ids=MESH_IDS)
def test_pinned_sharded_losses_match_unsharded(train4, shape):
    run = train4[0][shape]
    assert len(run["losses"]) == STEPS
    np.testing.assert_allclose(run["losses"], run["unsharded"]["losses"],
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("shape", list(MESHES), ids=MESH_IDS)
def test_pinned_sharded_first_step_grads_match_unsharded(train4, shape):
    run = train4[0][shape]
    assert _rel(run["grads"], run["unsharded"]["grads"]) <= 1e-5


@pytest.mark.parametrize("shape", list(MESHES), ids=MESH_IDS)
def test_pinned_sharded_params_after_three_steps_match_unsharded(train4,
                                                                 shape):
    run = train4[0][shape]
    assert _rel(run["params"], run["unsharded"]["params"]) <= 1e-4


@pytest.mark.parametrize("shape", list(MESHES), ids=MESH_IDS)
def test_sharded_one_step_params_are_adamw_of_their_gradients(train4,
                                                             shape):
    """The parameters after the first sharded step, elementwise within
    rtol 1e-6 (the optimizer's own tolerance) of adamw_update applied
    unsharded, from the same weights, to the sharded run's first-step
    gradients gathered whole: the sharded optimizer applies AdamW to the
    gradients it has. The global norm sums in another order (an ulp of
    the clip scale, an ulp of an element's step), so an element that the
    step takes near zero is held to 1e-6 of a step instead: atol 1e-6 x
    lr."""
    import torch
    from repro_torch import configs as TC
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         adamw_update, decay_mask)
    run = train4[0][shape]
    params = model_params_from_numpy(train4[2], TC.get_smoke_config(ARCH),
                                     device="cpu")
    ocfg = AdamWConfig()
    adamw_update(params, [torch.from_numpy(g) for g in run["grads"]],
                 adamw_init(params, ocfg), ocfg, decay=decay_mask(params))
    for (k, want), got in zip(params.named_parameters(), run["one_step"]):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-6,
                                   atol=1e-6 * ocfg.lr, err_msg=k)


@pytest.mark.parametrize("case", list(INIT_CASES))
@pytest.mark.parametrize("shape", list(MESHES), ids=MESH_IDS)
def test_init_sharded_equals_the_whole_tree_sharded(train4, shape, case):
    """sharding.init_sharded (each leaf laid out as it is drawn) against
    init_model's tree drawn whole from the same seed, cast, then
    shard_params: every rank's local shards and placements bit for bit."""
    assert [r[case] for r in train4[0][shape]["init_equal"]] == \
        [True] * WORLD


@pytest.mark.parametrize("shape", list(MESHES), ids=MESH_IDS)
def test_sharded_step_records_the_pinned_routes(train4, shape):
    """Each sharded step records one list a microbatch, one (T, k) tensor
    a MoE layer, equal to the unsharded lists it was pinned to."""
    run = train4[0][shape]
    assert [len(r) for r in run["routes"]] == [N_MICRO] * STEPS
    assert len(run["routes"][0][0]) > 0
    for got, want in zip(run["routes"], run["pinned"]):
        for x, y in zip(got, want):
            assert len(x) == len(y)
            for a, b in zip(x, y):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", list(MESHES), ids=MESH_IDS)
def test_reference_routes_equal_the_sharded_steps_routes(train4, shape):
    """The JAX package's own routes, each step and microbatch joined as
    the sharded microbatches hold them, are the ones the sharded port
    recorded: the pinned run is the reference's unpinned one."""
    got, ref = train4[0][shape], train4[1][MESHES[shape]]
    k = MESHES[shape] // N_MICRO
    for step, want in zip(got["routes"], ref["routes"]):
        for i, lst in enumerate(step):
            for j, a in enumerate(lst):
                np.testing.assert_array_equal(a, np.concatenate(
                    [want[i * k + h][j] for h in range(k)]))


@pytest.mark.parametrize("shape", list(MESHES), ids=MESH_IDS)
def test_sharded_losses_match_reference(train4, shape):
    got, ref = train4[0][shape], train4[1][MESHES[shape]]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)


@pytest.mark.parametrize("shape", list(MESHES), ids=MESH_IDS)
def test_sharded_first_step_grads_match_reference(train4, shape):
    got, ref = train4[0][shape], train4[1][MESHES[shape]]
    for a, b in zip(got["grads"], ref["grads"]):
        np.testing.assert_allclose(a, b, atol=1e-4 * float(np.abs(b).max()),
                                   rtol=1e-4)


def _main():
    import torch.multiprocessing as mp
    mp.spawn(prog_train4, args=(WORLD, sys.argv[2]), nprocs=WORLD,
             join=True)
    print("PROG-OK train4", flush=True)


if __name__ == "__main__" and "--prog" in sys.argv:
    _main()
