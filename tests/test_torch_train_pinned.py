"""The train step's route hook (repro_torch.train.step: train_step(...,
routes=, pinned=), loss_and_grads(..., routes=, pinned=)) on the CPU, for
the DeepSeek-V2-Lite smoke config in f32 at n_micro 1 and 2, three steps
of 4 x 16 tokens drawn from a seed with numpy:

* a step with neither argument is loss_fn's loss and gradients, averaged
  over the microbatches in f32 accumulators, then adamw_update with the
  model's decay_mask: bit for bit, the step as it was before the hook;
* a step that records its routes is bit for bit the plain step (loss,
  every gradient, every parameter after AdamW);
* a step pinned to the routes it recorded is bit for bit the unpinned
  step, and records the pinned routes again;
* `routes` holds one list a microbatch, each one (T, k) tensor a MoE
  layer, the microbatch's own (loss_fn(routes=...) on its rows);
* `pinned` with another count of lists than microbatches raises;
* TrainConfig(accum_dtype=...) sets the accumulators' dtype.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.models import model as MD
from repro_torch.models.module import trainable
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     decay_mask)
from repro_torch.train.step import (TrainConfig, loss_and_grads,
                                    make_train_step)

B, S, STEPS = 4, 16, 3
CFG = TC.get_smoke_config("deepseek-v2-lite")
N_MOE = CFG.n_layers - CFG.first_k_dense


def _batches():
    rng = np.random.default_rng(7)
    return [{k: torch.from_numpy(rng.integers(0, CFG.vocab, (B, S),
                                              dtype=np.int32))
             for k in ("tokens", "targets")} for _ in range(STEPS)]


def _params():
    return trainable(MD.init_model(CFG, torch.Generator().manual_seed(0),
                                   device="cpu", dtype=torch.float32))


def _run(n_micro, record=False, pinned=None):
    """STEPS train steps from seed 0: (losses, the first step's gradients,
    the parameters after the steps, each step's recorded routes or
    None)."""
    params, ocfg = _params(), AdamWConfig()
    opt, tcfg = adamw_init(params, ocfg), TrainConfig(n_micro=n_micro)
    _, grads = loss_and_grads(params, CFG, _batches()[0], tcfg,
                              routes=[] if record else None,
                              pinned=None if pinned is None else pinned[0])
    step = make_train_step(CFG, ocfg, tcfg)
    losses, routes = [], []
    for i, b in enumerate(_batches()):
        kw = {}
        if record:
            kw["routes"] = []
            routes.append(kw["routes"])
        if pinned is not None:
            kw["pinned"] = pinned[i]
        params, opt, mets = step(params, opt, b, **kw)
        losses.append(mets["loss"])
    return (losses, grads, [p.detach() for p in params.parameters()],
            routes if record else None)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


@pytest.fixture(scope="module", params=[1, 2], ids=lambda n: f"n_micro{n}")
def runs(request):
    n = request.param
    plain = _run(n)
    recorded = _run(n, record=True)
    pinned = _run(n, record=True, pinned=recorded[3])
    return n, plain, recorded, pinned


def test_plain_step_is_loss_fn_accumulated_then_adamw(runs):
    """With neither argument, the step is loss_fn over the microbatches,
    the gradients summed into f32 accumulators and divided by n_micro,
    then adamw_update with the model's decay_mask: the arithmetic it had
    before the hook."""
    n, (losses, _, after, _) = runs[0], runs[1]
    params, ocfg = _params(), AdamWConfig()
    opt = adamw_init(params, ocfg)
    leaves = list(params.parameters())
    want = []
    for b in _batches():
        m = B // n
        mbs = [{k: v[i * m:(i + 1) * m] for k, v in b.items()}
               for i in range(n)]
        if n == 1:
            loss = MD.loss_fn(params, CFG, b)
            grads, loss = list(torch.autograd.grad(loss, leaves)), \
                loss.detach()
        else:
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            ls = []
            for mb in mbs:
                loss = MD.loss_fn(params, CFG, mb)
                for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
                    a.add_(g)
                ls.append(loss.detach())
            grads, loss = [a.div_(n) for a in acc], torch.stack(ls).mean()
        params, opt, _ = adamw_update(params, grads, opt, ocfg, None,
                                      decay_mask(params))
        want.append(loss)
    assert _equal(losses, want)
    assert _equal(after, [p.detach() for p in params.parameters()])


@pytest.mark.parametrize("what", ["losses", "first_step_grads", "params"])
def test_recording_routes_changes_no_bit(runs, what):
    i = ["losses", "first_step_grads", "params"].index(what)
    assert _equal(runs[2][i], runs[1][i])


@pytest.mark.parametrize("what", ["losses", "first_step_grads", "params"])
def test_pinned_to_own_routes_is_the_unpinned_step(runs, what):
    i = ["losses", "first_step_grads", "params"].index(what)
    assert _equal(runs[3][i], runs[1][i])


def test_pinned_step_records_the_pinned_routes(runs):
    for got, want in zip(runs[3][3], runs[2][3]):
        assert all(_equal(a, b) for a, b in zip(got, want))


def test_routes_hold_one_list_a_microbatch(runs):
    """Each step's routes: n_micro lists of N_MOE (T, k) tensors, each the
    microbatch's own (loss_fn(routes=...) on its rows, from the step's
    parameters)."""
    n, routes = runs[0], runs[2][3]
    assert len(routes) == STEPS
    assert all(len(step) == n for step in routes)
    m = B // n
    for lists in routes:
        assert all(len(r) == N_MOE for r in lists)
        assert all(tuple(t.shape) == (m * S, CFG.moe.top_k)
                   for r in lists for t in r)
    params, b = _params(), _batches()[0]
    for i, lst in enumerate(routes[0]):
        own = []
        MD.loss_fn(params, CFG, {k: v[i * m:(i + 1) * m]
                                 for k, v in b.items()}, routes=own)
        assert _equal(lst, own)


@pytest.mark.parametrize("n_micro,lists", [(1, 2), (2, 1), (2, 3)])
def test_pinned_needs_one_list_a_microbatch(n_micro, lists):
    params = _params()
    with pytest.raises(ValueError, match="route lists"):
        loss_and_grads(params, CFG, _batches()[0],
                       TrainConfig(n_micro=n_micro), pinned=[[]] * lists)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_accum_dtype_sets_the_accumulators(dtype):
    """TrainConfig(accum_dtype=...) at n_micro 2: each microbatch's f32
    gradients added into accumulators of that dtype and divided by 2, bit
    for bit."""
    params, b = _params(), _batches()[0]
    leaves = list(params.parameters())
    _, got = loss_and_grads(params, CFG, b,
                            TrainConfig(n_micro=2, accum_dtype=dtype))
    acc = [torch.zeros_like(p, dtype=dtype) for p in leaves]
    for i in range(2):
        loss = MD.loss_fn(params, CFG, {k: v[i * 2:(i + 1) * 2]
                                        for k, v in b.items()})
        for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
            a.add_(g)
    assert all(g.dtype == dtype for g in got)
    assert _equal(got, [a.div_(2) for a in acc])
