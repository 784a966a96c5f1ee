"""Multi-rank checks of the port's distribution substrate on gloo, on the
CPU: each prog runs in a subprocess of its own (python <this file> --prog
<name> <rendezvous file>) that spawns its ranks, which meet through a file
in a fresh temporary directory (no TCP port to pick, so no other process
can take it first), with a timeout; the tests read the lines it prints. The counterparts of tests/progs/dist_substrate_prog.py:

pod8 (8 ranks, one "pod" mesh dim):
* int8 error-feedback compressed DP on a toy regression, 300 steps,
  against full-precision DP (all_reduce of f32 means): final loss < 1e-3
  in both modes, |w_compressed - w_full| < 0.05; the summed payload is
  int32 holding int8 values (all in [-127, 127]) and the scale an
  all-reduce MAX;
* the collective matmul: overlapped = barrier = x @ w at 2e-5, the
  overlapped form passing blocks point to point (batch_isend_irecv, P - 1
  passes) with no all-gather, the barrier form one all_gather_into_tensor.

mesh4 (4 ranks, a (2, 2) ("data", "model") mesh):
* the elastic checkpoint: saved from a DTensor sharded over a (4,) mesh,
  restored onto the (2, 2) mesh with another sharding, bit for bit;
* the MoE expert-parallel form (ep_axis over "model", via the model's
  sharding policy) against the unsharded moe_apply on each data shard's
  tokens (the reference's EP form dispatches per data shard, with that
  shard's capacity, and averages aux over the data shards): outputs at
  1e-6, routes equal, aux at 1e-6;
* one EP train step pinned to the routes it recorded
  (loss_fn(pinned_routes=...), the DTensor routes brought to each data
  shard's tokens): loss and every gradient bit for bit the unpinned step;
* three sharded train steps (param_shardings, sp_policy, ep_axis "model",
  n_micro 2) of the V2-Lite smoke config in f32 against the same steps
  unsharded with n_micro 2 x 2: data parallelism over 2 shards with the
  per-shard MoE dispatch is gradient accumulation over 2 x n_micro
  microbatches of the same rows. Losses at rtol 1e-5, the first step's
  gradients within 1e-5 x their max, every parameter within 1e-4 x its
  max after the three steps, every MoE route equal.

uneven4 (4 ranks, the same (2, 2) mesh), the sharded path where a dim does
not divide its mesh axis:
* three sharded train steps (param_shardings, sp_policy) of the Qwen3
  smoke config (qk-norm) with 9 query and 3 KV heads (head_dim 16), which
  do not divide the model axis of 2 while H * hd does, against the same
  steps unsharded: at n_micro 2 (4 rows a microbatch) and at n_micro 4 (1
  row a microbatch, fewer rows than the data axis). The same limits as
  mesh4's: losses at rtol 1e-5, the first step's gradients within 1e-5 x
  their max, every parameter within 1e-4 x its max after the three steps.
  In f64: in f32 one element of the first layer's q has a first-step
  gradient of 3.4e-9 (its f64 value), inside f32's rounding of the sum,
  and AdamW (eps 1e-8) turns that rounding into steps of 0.1-0.3 lr of
  either sign, 1.7e-4 of the leaf's max after three steps whatever the
  layout. For the same reason not Qwen2.5's QKV biases in f32: zero at
  init, the unsharded step against itself at n_micro 1 and 2 already
  differs by 1.5e-4 of the key bias's max. The same for the Mamba2 smoke
  config with a vocab of 255, which the model axis does not divide (the
  tied table's lookup and head gradients), its SSD train form on local
  tensors (its products in f32 whatever the parameters' dtype);
* mamba2_decode on a state laid out as decode_state_shardings lays out a
  decode state (batch 1: the batch whole, the heads over model where they
  divide), with 5 heads (they do not divide) and 4, and at batch 2 (the
  batch over data) with 5, and on a (4, 1) mesh with 6 heads (over the
  1-wide model axis, not dividing the 4-wide data axis: the form of the
  multi-pod zamba2-7b long_500k fault), against the plain call: the
  output and the new state within 1e-6 x max(1, their max), the state
  returned on the layout it came in on.
"""

import os
import re
import subprocess
import sys
import tempfile

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TIMEOUT = {"pod8": 120, "mesh4": 150, "uneven4": 150}


# ---------------------------------------------------------------------------
# the progs (run in the subprocess's ranks)
# ---------------------------------------------------------------------------

def _init(rank, world, rdv):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)


def _say(rank, msg):
    if rank == 0:
        print(msg, flush=True)


def prog_pod8(rank, world, rdv):
    import warnings

    import torch
    import torch.distributed as dist
    from repro_torch.distributed import collective_matmul as CM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import compress
    # torch 2.13 renames the collective the barrier form names
    warnings.filterwarnings(
        "ignore", message=r".*all_gather_into_tensor.* is deprecated",
        category=FutureWarning)
    _init(rank, world, rdv)
    mesh = make_mesh((world,), ("pod",))
    group = mesh.get_group("pod")

    # -- compressed DP parity (the reference's toy regression) -------------
    g = torch.Generator().manual_seed(0)
    X = torch.randn(64, 16, generator=g)
    y_true = X @ torch.randn(16, 1, generator=g)
    rows = slice(rank * 8, (rank + 1) * 8)
    xb, yb = X[rows], y_true[rows]
    seen = []
    real_all_reduce = dist.all_reduce

    def spy(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        seen.append((t.dtype, op, int(t.abs().max()) if not
                     t.is_floating_point() else None))
        return real_all_reduce(t, op=op, group=group, async_op=async_op)

    def loss_of(w, xx, yy):
        return torch.mean(torch.square(xx @ w - yy))

    ws = {}
    for mode in (False, True):
        w, e = torch.zeros(16, 1), torch.zeros(16, 1)
        dist.all_reduce = spy if mode else real_all_reduce
        for _ in range(300):
            wg = w.clone().requires_grad_(True)
            (gr,) = torch.autograd.grad(loss_of(wg, xb, yb), wg)
            if mode:
                (gr,), (e,) = compress.compressed_psum_with_feedback(
                    [gr], [e], group)
            else:
                dist.all_reduce(gr, group=group)
                gr = gr / world
            w = w - 0.05 * gr
        dist.all_reduce = real_all_reduce
        ws[mode] = w
        _say(rank, f"DP compressed={mode} final_loss "
             f"{float(loss_of(w, X, y_true)):.9f}")
    _say(rank, f"DP max|w_c - w_f| "
         f"{float((ws[True] - ws[False]).abs().max()):.9f}")
    sums = [s for s in seen if s[1] == dist.ReduceOp.SUM]
    maxes = [s for s in seen if s[1] == dist.ReduceOp.MAX]
    ok = all(d == torch.int32 and m <= 127 for d, _, m in sums)
    _say(rank, f"DP payload int32-int8 {ok and len(sums) == 300} "
         f"scale-max {len(maxes) == 300 and all(d == torch.float32 for d, _, _ in maxes)}")

    # -- collective matmul ------------------------------------------------
    m, d, n = 32, 16, 64
    g = torch.Generator().manual_seed(2)
    x = torch.randn(m, d, generator=g)
    wt = torch.randn(d, n, generator=g)
    nb = n // world
    xs, wb = x[rank * (m // world):(rank + 1) * (m // world)], \
        wt[:, rank * nb:(rank + 1) * nb]
    calls = {"p2p": 0, "all_gather": 0}
    real_p2p, real_ag = dist.batch_isend_irecv, dist.all_gather_into_tensor

    def p2p(ops):
        calls["p2p"] += 1
        return real_p2p(ops)

    def ag(*a, **k):
        calls["all_gather"] += 1
        return real_ag(*a, **k)

    dist.batch_isend_irecv, dist.all_gather_into_tensor = p2p, ag
    want = x @ wt
    errs = {}
    for fn in (CM.allgather_matmul_overlapped, CM.allgather_matmul_barrier):
        before = dict(calls)
        got = fn(xs, wb, group)
        full = [torch.empty_like(got) for _ in range(world)]
        real_ag_list = dist.all_gather
        real_ag_list(full, got.contiguous())
        errs[fn.__name__] = (float((torch.cat(full) - want).abs().max()),
                             {k: calls[k] - before[k] for k in calls})
    dist.batch_isend_irecv, dist.all_gather_into_tensor = real_p2p, real_ag
    for name, (err, c) in errs.items():
        _say(rank, f"CM {name} err {err:.3e} p2p {c['p2p']} "
             f"all_gather {c['all_gather']}")
    dist.destroy_process_group()


def _sharded_steps(rank, mesh, cfg, batches, n_micro):
    """Three train steps of cfg from seed 0 on mesh (param_shardings,
    sp_policy, ep_axis "model"); returns (losses, first step's gradients
    whole, the parameters whole, the routes of the first step whole)."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import policy as POL
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as MD
    from repro_torch.models.module import trainable
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import (TrainConfig, loss_and_grads,
                                        make_train_step)
    params = trainable(MD.init_model(cfg, torch.Generator().manual_seed(0),
                                     device="cpu", dtype=torch.float32))
    shard = SH.param_shardings(params, mesh)
    SH.shard_params(params, shard)
    ocfg = AdamWConfig()
    opt = adamw_init(params, ocfg)
    tcfg = TrainConfig(n_micro=n_micro, ep_axis="model")
    step = make_train_step(cfg, ocfg, tcfg, param_shardings=shard)
    bs = SH.batch_sharding(mesh)
    dist_batch = lambda b: {k: SH.distribute(v, mesh, bs.spec)
                            for k, v in b.items()}
    losses = []
    with POL.use_policy(POL.sp_policy(mesh)), implicit_replication():
        _, grads = loss_and_grads(params, cfg, dist_batch(batches[0]), tcfg,
                                  shard)
        grads = [g.full_tensor() for g in grads]
        routes = []                  # each microbatch's, layer by layer
        for mb in range(n_micro):
            rows = batches[0]["tokens"].shape[0] // n_micro
            MD.loss_fn(params, cfg, dist_batch(
                {k: v[mb * rows:(mb + 1) * rows]
                 for k, v in batches[0].items()}), routes=routes)
        routes = [r.full_tensor() for r in routes]
        for b in batches:
            params, opt, mets = step(params, opt, dist_batch(b))
            losses.append(float(mets["loss"].full_tensor()))
        whole = [p.detach().full_tensor() for p in params.parameters()]
    return losses, grads, whole, routes


def _pinned_train_step(mesh, cfg, batch):
    """One EP train step of cfg from seed 0 on mesh (param_shardings,
    sp_policy, ep_axis "model"): the loss and every gradient unpinned, its
    routes recorded (DTensors over the batch), then pinned to those routes
    (loss_fn(pinned_routes=...)). Returns (loss equal, every gradient
    equal, bit for bit; the MoE layers pinned)."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import policy as POL
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as MD
    from repro_torch.models.module import trainable
    params = trainable(MD.init_model(cfg, torch.Generator().manual_seed(0),
                                     device="cpu", dtype=torch.float32))
    SH.shard_params(params, SH.param_shardings(params, mesh))
    leaves = list(params.parameters())
    bs = SH.batch_sharding(mesh)
    b = {k: SH.distribute(v, mesh, bs.spec) for k, v in batch.items()}
    routes = []
    with POL.use_policy(POL.sp_policy(mesh)), implicit_replication():
        loss = MD.loss_fn(params, cfg, b, routes=routes, ep_axis="model")
        grads = torch.autograd.grad(loss, leaves)
        pinned = MD.loss_fn(params, cfg, b, pinned_routes=routes,
                            ep_axis="model")
        pinned_grads = torch.autograd.grad(pinned, leaves)
        same = lambda a, c: torch.equal(a.full_tensor(), c.full_tensor())
        return (same(loss, pinned),
                all(same(a, c) for a, c in zip(grads, pinned_grads)),
                len(routes))


def prog_mesh4(rank, world, rdv):
    import dataclasses
    import tempfile

    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import policy as POL
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as MD
    from repro_torch.models import moe as MOE
    from repro_torch.models.module import Tree, trainable
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import (TrainConfig, loss_and_grads,
                                        make_train_step)
    _init(rank, world, rdv)
    mesh = make_mesh((2, 2), ("data", "model"))

    # -- elastic checkpoint ------------------------------------------------
    flat = make_mesh((world,), ("data",))
    w = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    w_a = SH.distribute(w, flat, ("data",))
    tmp = [tempfile.mkdtemp(prefix="elastic_")] if rank == 0 else [None]
    torch.distributed.broadcast_object_list(tmp, src=0)
    cm = CheckpointManager(tmp[0])
    cm.save(1, {"w": w_a}, blocking=True)
    back = cm.restore(1, {"w": w_a}, shardings={
        "w": SH.NamedSharding(mesh, ("data", "model"))})["w"]
    ok = (isinstance(back, DTensor) and back.device_mesh is mesh
          and tuple(back.to_local().shape) == (32, 16)
          and torch.equal(back.full_tensor(), w))
    _say(rank, f"CKPT elastic {ok}")

    # -- MoE expert-parallel form ------------------------------------------
    cfg = get_smoke_config("deepseek-v2-lite")
    mcfg = cfg.moe
    p = Tree(MOE.init_moe(torch.Generator().manual_seed(3), mcfg,
                          dtype=torch.float32, device="cpu"))
    x = torch.randn(4, 8, mcfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    want_r = []
    want = [MOE.moe_apply(p, mcfg, x[i * 2:(i + 1) * 2], want_r)
            for i in range(2)]
    want_y = torch.cat([y for y, _ in want])
    want_aux = (want[0][1] + want[1][1]) / 2
    sp = Tree({k: v.detach().clone() for k, v in p.named_parameters()})
    shard = {k: SH.NamedSharding(mesh, SH.spec_for(
        ax, v.shape, mesh)) for (k, v), ax in zip(
        sp.named_parameters(), [("embed", None), ("expert", "embed", None),
                                ("expert", "embed", None),
                                ("expert", None, "embed"),
                                ("embed", "mlp"), ("embed", "mlp"),
                                ("mlp", "embed")])}
    SH.shard_params(sp, shard)
    routes = []
    with POL.use_policy(POL.sp_policy(mesh)), implicit_replication():
        xd = SH.distribute(x, mesh, ("data",))
        y, aux = MD._moe_call(sp, cfg, xd, routes, ep_axis="model")
        y, aux = y.full_tensor(), aux.full_tensor()
        got_r = routes[0].full_tensor()
    _say(rank, f"MOE y_err {float((y - want_y).abs().max()):.3e} within "
         f"{torch.allclose(y, want_y, rtol=1e-6, atol=1e-6)} aux_err "
         f"{float((aux - want_aux).abs()):.3e} routes_equal "
         f"{torch.equal(got_r, torch.cat(want_r))}")

    # -- sharded train steps -----------------------------------------------
    g = torch.Generator().manual_seed(1)
    B, S = 8, 16
    batches = [{"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                        dtype=torch.int32),
                "targets": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                         dtype=torch.int32)}
               for _ in range(3)]
    loss_eq, grads_eq, n_pinned = _pinned_train_step(mesh, cfg, batches[0])
    _say(rank, f"PINNED loss_equal {loss_eq} grads_equal {grads_eq} "
         f"n_pinned {n_pinned}")
    losses, grads, whole, routes = _sharded_steps(rank, mesh, cfg, batches, 2)
    # unsharded: the same rows as 2 data shards x 2 microbatches
    ref = trainable(MD.init_model(cfg, torch.Generator().manual_seed(0),
                                  device="cpu", dtype=torch.float32))
    ocfg = AdamWConfig()
    opt = adamw_init(ref, ocfg)
    tcfg = TrainConfig(n_micro=4)
    _, g0 = loss_and_grads(ref, cfg, batches[0], tcfg)
    r0 = []
    for i in range(4):
        mb = {k: v[i * 2:(i + 1) * 2] for k, v in batches[0].items()}
        MD.loss_fn(ref, cfg, mb, routes=r0)
    # the sharded microbatch i holds the unsharded 2i and 2i + 1
    n_moe = len(r0) // 4
    want_routes = [torch.cat([r0[(2 * i + h) * n_moe + j] for h in (0, 1)])
                   for i in range(2) for j in range(n_moe)]
    step = make_train_step(cfg, ocfg, tcfg)
    ref_losses = []
    for b in batches:
        ref, opt, mets = step(ref, opt, b)
        ref_losses.append(float(mets["loss"]))
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    _say(rank, "TRAIN losses " + " ".join(
        f"{a:.9f}/{b:.9f}" for a, b in zip(losses, ref_losses)))
    _say(rank, f"TRAIN grad_rel {max(rel(a, b) for a, b in zip(grads, g0)):.3e}"
         f" param_rel {max(rel(a, b.detach()) for a, b in zip(whole, ref.parameters())):.3e}"
         f" routes_equal {all(torch.equal(a, b) for a, b in zip(routes, want_routes))}"
         f" n_routes {n_moe}")
    torch.distributed.destroy_process_group()


def _train_steps(mesh, cfg, batches, n_micro, dtype):
    """Three train steps of cfg from seed 0 with its parameters in dtype,
    on mesh (param_shardings, sp_policy) or, with mesh None, unsharded;
    returns (losses, the first step's gradients, the parameters after the
    steps), whole."""
    import contextlib

    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import policy as POL
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as MD
    from repro_torch.models.module import trainable
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import (TrainConfig, loss_and_grads,
                                        make_train_step)
    params = trainable(MD.init_model(cfg, torch.Generator().manual_seed(0),
                                     device="cpu", dtype=dtype))
    shard, place, whole = None, (lambda b: b), (lambda t: t)
    ctx = contextlib.nullcontext()
    if mesh is not None:
        shard = SH.param_shardings(params, mesh)
        SH.shard_params(params, shard)
        bs = SH.batch_sharding(mesh)
        place = lambda b: {k: SH.distribute(v, mesh, bs.spec)
                           for k, v in b.items()}
        whole = lambda t: t.full_tensor()
        ctx = contextlib.ExitStack()
        ctx.enter_context(POL.use_policy(POL.sp_policy(mesh)))
        ctx.enter_context(implicit_replication())
    ocfg = AdamWConfig()
    opt = adamw_init(params, ocfg)
    tcfg = TrainConfig(n_micro=n_micro)
    step = make_train_step(cfg, ocfg, tcfg, param_shardings=shard)
    losses = []
    with ctx:
        _, grads = loss_and_grads(params, cfg, place(batches[0]), tcfg, shard)
        grads = [whole(g) for g in grads]
        for b in batches:
            params, opt, mets = step(params, opt, place(b))
            losses.append(float(whole(mets["loss"])))
        params = [whole(p.detach()) for p in params.parameters()]
    return losses, grads, params


def prog_uneven4(rank, world, rdv):
    import copy
    import dataclasses

    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ShapeSpec, get_smoke_config
    from repro_torch.distributed import policy as POL
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import input_specs as IS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as MD
    from repro_torch.models import ssm as SSM
    from repro_torch.models.module import Tree
    _init(rank, world, rdv)
    mesh = make_mesh((2, 2), ("data", "model"))
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())

    # -- GQA heads and a vocab that do not divide the model axis -----------
    gqa = dataclasses.replace(get_smoke_config("qwen3-32b"), n_heads=9,
                              n_kv_heads=3, head_dim=16)
    ssm = dataclasses.replace(get_smoke_config("mamba2-370m"), vocab=255)
    g = torch.Generator().manual_seed(5)
    for name, cfg, B, n_micro in (("GQA", gqa, 8, 2), ("GQA", gqa, 4, 4),
                                  ("SSM-vocab", ssm, 8, 2)):
        batches = [{k: torch.randint(0, cfg.vocab, (B, 16), generator=g,
                                     dtype=torch.int32)
                    for k in ("tokens", "targets")} for _ in range(3)]
        losses, grads, whole = _train_steps(mesh, cfg, batches, n_micro,
                                            torch.float64)
        ref_losses, g0, ref = _train_steps(None, cfg, batches, n_micro,
                                           torch.float64)
        _say(rank, f"{name} rows {B // n_micro} losses " + " ".join(
            f"{a:.12f}/{b:.12f}" for a, b in zip(losses, ref_losses)))
        _say(rank, f"{name} rows {B // n_micro} grad_rel "
             f"{max(rel(a, b) for a, b in zip(grads, g0)):.3e} param_rel "
             f"{max(rel(a, b) for a, b in zip(whole, ref)):.3e}")

    # -- the SSM decode over a sharded state -------------------------------
    # (4, 1): 6 heads over `model` (1 wide) and not dividing the 4-wide
    # data axis, the small form of zamba2-7b's 112 heads on the 32-wide
    # (pod x data) axis, where DTensor's own einsums split the heads
    # unevenly over `data`
    narrow = make_mesh((4, 1), ("data", "model"))
    for mesh, B, d_model in ((mesh, 1, 40), (mesh, 1, 32), (mesh, 2, 40),
                             (narrow, 1, 48)):
        mcfg = SSM.Mamba2Config(d_model=d_model, d_state=16, head_dim=16,
                                expand=2, chunk=8)
        mdl = MD.ModelConfig(name="ssm-uneven", family="ssm", n_layers=1,
                             d_model=d_model, vocab=256, attn_type="none",
                             d_ff=0, ssm=mcfg)
        g = torch.Generator().manual_seed(B * d_model)
        p = Tree(SSM.init_mamba2(g, mcfg, dtype=torch.float32,
                                 device="cpu"))
        x = torch.randn(B, 1, d_model, generator=g)
        h = torch.randn(1, B, mcfg.n_heads, mcfg.head_dim, mcfg.d_state,
                        generator=g)
        conv = torch.randn(1, B, mcfg.d_conv - 1,
                           mcfg.d_inner + 2 * mcfg.d_state, generator=g)
        with torch.no_grad():
            y0, (h0, c0) = SSM.mamba2_decode(p, mcfg, x, (h[0], conv[0]))
        sp = copy.deepcopy(p)
        SH.shard_params(sp, SH.param_shardings(sp, mesh))
        sh_h, sh_c = IS.decode_state_shardings(
            mdl, ShapeSpec("decode", 8, B, "decode"), mesh)["blocks"]
        hs = SH.distribute(h, mesh, sh_h.spec)
        cs = SH.distribute(conv, mesh, sh_c.spec)
        xd = SH.distribute(x, mesh, IS.decode_input_shardings(mesh, B)[0]
                           .spec)
        with POL.use_policy(POL.sp_policy(mesh)), implicit_replication(), \
                torch.no_grad():
            y, (h1, c1) = SSM.mamba2_decode(sp, mcfg, xd, (hs[0], cs[0]))
            same = h1.placements == hs[0].placements
            y, h1, c1 = y.full_tensor(), h1.full_tensor(), c1.full_tensor()
        err = max(float((a - b).abs().max() / max(1.0, b.abs().max()))
                  for a, b in ((y, y0), (h1, h0), (c1, c0)))
        _say(rank, f"SSM mesh {tuple(mesh.shape)} batch {B} heads "
             f"{mcfg.n_heads} state_spec {sh_h.spec} err {err:.3e} "
             f"same_layout {same}")
    torch.distributed.destroy_process_group()


PROGS = {"pod8": (prog_pod8, 8), "mesh4": (prog_mesh4, 4),
         "uneven4": (prog_uneven4, 4)}


# ---------------------------------------------------------------------------
# the tests (pytest side)
# ---------------------------------------------------------------------------

def _run(name: str) -> str:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory(prefix=f"gloo_{name}_") as tmp:
        res = subprocess.run([sys.executable, __file__, "--prog", name,
                              os.path.join(tmp, "rdv")], capture_output=True,
                             text=True, timeout=TIMEOUT[name], env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert f"PROG-OK {name}" in res.stdout, res.stdout[-3000:]
    return res.stdout


@pytest.fixture(scope="module")
def pod8():
    return _run("pod8")


@pytest.fixture(scope="module")
def mesh4():
    return _run("mesh4")


@pytest.fixture(scope="module")
def uneven4():
    return _run("uneven4")


def _floats(pattern, out):
    return [float(v) for v in re.findall(pattern, out)]


def test_compressed_dp_converges_like_full_precision(pod8):
    losses = _floats(r"DP compressed=\w+ final_loss (\S+)", pod8)
    assert len(losses) == 2 and all(v < 1e-3 for v in losses), losses
    (gap,) = _floats(r"DP max\|w_c - w_f\| (\S+)", pod8)
    assert gap < 0.05


def test_compressed_dp_payload_is_int8_in_int32(pod8):
    assert "DP payload int32-int8 True scale-max True" in pod8


@pytest.mark.parametrize("fn,p2p,gathers", [
    ("allgather_matmul_overlapped", 7, 0),
    ("allgather_matmul_barrier", 0, 1)])
def test_collective_matmul(pod8, fn, p2p, gathers):
    m = re.search(rf"CM {fn} err (\S+) p2p (\d+) all_gather (\d+)", pod8)
    assert m, pod8
    assert float(m.group(1)) <= 2e-5 * 8     # |x @ w| ~ 8: rtol 2e-5
    assert (int(m.group(2)), int(m.group(3))) == (p2p, gathers)


def test_elastic_checkpoint_restores_onto_another_mesh(mesh4):
    assert "CKPT elastic True" in mesh4


def test_moe_expert_parallel_form(mesh4):
    m = re.search(r"MOE y_err (\S+) within (\w+) aux_err (\S+) "
                  r"routes_equal (\w+)", mesh4)
    assert m, mesh4
    assert m.group(2) == "True" and float(m.group(3)) <= 1e-6
    assert m.group(4) == "True"


def test_sharded_train_steps_equal_unsharded(mesh4):
    pairs = re.findall(r"(\S+)/(\S+)", re.search(r"TRAIN losses (.*)",
                                                 mesh4).group(1))
    assert len(pairs) == 3
    for got, want in pairs:
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    m = re.search(r"TRAIN grad_rel (\S+) param_rel (\S+) routes_equal "
                  r"(\w+) n_routes (\d+)", mesh4)
    assert m, mesh4
    assert float(m.group(1)) <= 1e-5 and float(m.group(2)) <= 1e-4
    assert m.group(3) == "True" and int(m.group(4)) > 0


def test_ep_train_step_pinned_to_its_own_routes(mesh4):
    """The (2, 2) EP train step pinned to the routes it recorded (DTensors
    over the batch, brought to each data shard's tokens) is the unpinned
    step: loss and every gradient bit for bit."""
    m = re.search(r"PINNED loss_equal (\w+) grads_equal (\w+) n_pinned "
                  r"(\d+)", mesh4)
    assert m, mesh4
    assert m.group(1) == m.group(2) == "True" and int(m.group(3)) > 0


@pytest.mark.parametrize("name,rows", [("GQA", 4), ("GQA", 1),
                                       ("SSM-vocab", 4)])
def test_sharded_steps_with_uneven_heads_equal_unsharded(uneven4, name,
                                                         rows):
    """GQA: 9 query and 3 KV heads on a model axis of 2; rows 1: a
    microbatch of fewer rows than the data axis. SSM-vocab: the Mamba2
    smoke config with a vocab of 255, which the model axis does not divide
    (the tied table's two gradients), its SSD train form on local
    tensors."""
    pairs = re.findall(r"(\S+)/(\S+)", re.search(
        rf"{name} rows {rows} losses (.*)", uneven4).group(1))
    assert len(pairs) == 3
    for got, want in pairs:
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    m = re.search(rf"{name} rows {rows} grad_rel (\S+) param_rel (\S+)",
                  uneven4)
    assert m, uneven4
    assert float(m.group(1)) <= 1e-5 and float(m.group(2)) <= 1e-4


@pytest.mark.parametrize("mesh,batch,heads,spec", [
    ("2, 2", 1, 5, "(None, None, None, None, None)"),
    ("2, 2", 1, 4, "(None, None, 'model', None, None)"),
    ("2, 2", 2, 5, "(None, 'data', None, None, None)"),
    ("4, 1", 1, 6, "(None, None, 'model', None, None)")])
def test_ssm_decode_on_a_sharded_state(uneven4, mesh, batch, heads, spec):
    m = re.search(rf"SSM mesh \({mesh}\) batch {batch} heads {heads} "
                  rf"state_spec (.*) err (\S+) same_layout (\w+)", uneven4)
    assert m, uneven4
    assert m.group(1) == spec
    assert float(m.group(2)) <= 1e-6 and m.group(3) == "True"


def _main():
    import torch.multiprocessing as mp
    name, rdv = sys.argv[2], sys.argv[3]
    fn, world = PROGS[name]
    mp.spawn(fn, args=(world, rdv), nprocs=world, join=True)
    print(f"PROG-OK {name}", flush=True)


if __name__ == "__main__" and "--prog" in sys.argv:
    _main()
