"""Train step: grad-accumulation microbatching + AdamW, the counterpart of
repro.train.step.

The batch's leading axis splits into n_micro microbatches; each one's
gradient (autograd through models.model.loss_fn, the train form) is added
into accumulators in tcfg.accum_dtype (f32 unless set) and the sum divided
by n_micro; the loss is the mean
over microbatches. Then lr_fn(step), with the optimizer's step before its
increment, and adamw_update, in place, decaying the parameters the
reference decays (optim.adamw.decay_mask of the model's tree).

On a mesh the parameters are DTensors (distributed.sharding.shard_params)
and the step runs under a sharding policy (distributed.policy.use_policy,
installed by the caller). param_shardings (param_shardings' map) pins every
gradient, and at n_micro > 1 the accumulators, to the parameters'
placements: a gradient leaves autograd as a partial sum over the data
shards, and pinning reduce-scatters it once per microbatch into the
parameter's layout, where the accumulators live. ep_axis names the mesh
dim the MoE experts split over (None: "model").

A checking hook, as prefill / decode_step(pinned=...) are: `routes` (a
list) gets one list a microbatch, in microbatch order, each holding one
(T, k) top-k tensor a MoE layer in layer order, as loss_fn(routes=...)
records them (on a mesh DTensors over the batch, as _moe_call appends
them); `pinned`, such lists from another run (plain tensors: every shard's
whole list, or DTensors), makes each microbatch's MoE layers take them
(loss_fn(pinned_routes=...)). With both None the step is the plain one.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Callable, Optional

import torch

from repro_torch.distributed import policy as POL
from repro_torch.models import model as MD
from repro_torch.optim.adamw import AdamWConfig, adamw_update, decay_mask


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_micro: int = 1                 # grad-accumulation microbatches
    ep_axis: Optional[str] = None
    accum_dtype: torch.dtype = torch.float32


def _microbatches(batch, n: int):
    """The n contiguous slices of every batch entry along its leading axis.
    A DTensor entry is gathered once, sliced, and each slice split again to
    the entry's own placements (a local chunk, no transfer): microbatch i
    holds the same rows as it does unsharded. Where a slice's rows do not
    divide the mesh dims that split the batch (16 rows on a 32-wide data
    axis), the slice is whole on those dims instead (replicated, where
    GSPMD would pad it)."""
    from torch.distributed.tensor import DTensor, Replicate

    def slices(v):
        m = v.shape[0] // n
        if not isinstance(v, DTensor):
            return list(v.reshape((n, m) + v.shape[1:]))
        mesh, rep = v.device_mesh, [Replicate()] * v.device_mesh.ndim
        full = v.redistribute(mesh, rep).to_local()
        split = [i for i, p in enumerate(v.placements) if p.is_shard(0)]
        pl = [Replicate() if i in split and m % math.prod(
            mesh.size(j) for j in split) else p
            for i, p in enumerate(v.placements)]
        return [DTensor.from_local(full[i * m:(i + 1) * m], mesh, rep,
                                   run_check=False)
                .redistribute(mesh, pl) for i in range(n)]

    split = {k: slices(v) for k, v in batch.items()}
    return [{k: s[i] for k, s in split.items()} for i in range(n)]


def _pinner(params, param_shardings):
    """grads (in parameters() order) -> each on its parameter's sharding
    (no-op without param_shardings)."""
    names = [k for k, _ in params.named_parameters()]

    def pin(grads):
        if param_shardings is None:
            return list(grads)
        return [g.redistribute(param_shardings[k].mesh,
                               param_shardings[k].placements)
                for k, g in zip(names, grads)]
    return pin


def _loss(params, cfg: MD.ModelConfig, batch, tcfg: TrainConfig,
          routes=None, pinned=None):
    """loss_fn of batch, under the caller's sharding policy as it applies
    to the batch's rows (policy.ShardingPolicy.for_batch: a microbatch of
    fewer rows than the data axes keeps its batch whole, as _microbatches
    lays it out); routes and pinned: one microbatch's lists."""
    kw = dict(routes=routes, pinned_routes=pinned, ep_axis=tcfg.ep_axis)
    pol = POL.current()
    if pol is None:
        return MD.loss_fn(params, cfg, batch, **kw)
    with POL.use_policy(pol.for_batch(batch["tokens"].shape[0])):
        return MD.loss_fn(params, cfg, batch, **kw)


def _grads(loss, leaves) -> list:
    """The gradient of loss for each leaf; a leaf that the loss does not
    reach gets zeros of its shape and placements, as jax.grad returns for
    it (the hybrid's shared block in a model shallower than one group)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def accumulate(params, cfg: MD.ModelConfig, mb, acc: list,
               tcfg: TrainConfig = TrainConfig(), param_shardings=None, *,
               routes=None, pinned=None):
    """One microbatch: its loss (detached) and its gradients, pinned and
    added into the accumulators acc (in parameters() order); routes and
    pinned: the microbatch's lists (_loss)."""
    leaves = list(params.parameters())
    loss = _loss(params, cfg, mb, tcfg, routes, pinned)
    grads = _pinner(params, param_shardings)(_grads(loss, leaves))
    for a, g in zip(acc, grads):
        a.add_(g)
    return loss.detach()


def _route_lists(routes, pinned, n: int):
    """([the list each microbatch records into, or None], [each
    microbatch's pinned list, or None]); routes gets the former."""
    if pinned is not None and len(pinned) != n:
        raise ValueError(f"pinned holds {len(pinned)} route lists for "
                         f"{n} microbatches")
    own = [None] * n if routes is None else [[] for _ in range(n)]
    if routes is not None:
        routes.extend(own)
    return own, [None] * n if pinned is None else list(pinned)


def loss_and_grads(params, cfg: MD.ModelConfig, batch,
                   tcfg: TrainConfig = TrainConfig(), param_shardings=None,
                   *, routes=None, pinned=None):
    """(loss, [gradient of each of params.parameters()]): with n_micro 1
    the gradients in the parameters' dtype, else the mean of the
    microbatches' gradients in tcfg.accum_dtype; with param_shardings,
    each on its parameter's placements. routes, pinned: one list a
    microbatch (the module's docstring)."""
    leaves = list(params.parameters())
    pin = _pinner(params, param_shardings)
    n = tcfg.n_micro
    own, fixed = _route_lists(routes, pinned, n)
    if n == 1:
        loss = _loss(params, cfg, batch, tcfg, own[0], fixed[0])
        return loss.detach(), pin(_grads(loss, leaves))
    acc = pin([torch.zeros_like(p, dtype=tcfg.accum_dtype) for p in leaves])
    losses = [accumulate(params, cfg, mb, acc, tcfg, param_shardings,
                         routes=r, pinned=f)
              for mb, r, f in zip(_microbatches(batch, n), own, fixed)]
    return torch.stack(losses).mean(), [a.div_(n) for a in acc]


def make_train_step(cfg: MD.ModelConfig, opt_cfg: AdamWConfig,
                    tcfg: TrainConfig = TrainConfig(),
                    lr_fn: Optional[Callable] = None,
                    param_shardings=None):
    """Returns train_step(params, opt_state, batch, *, routes=None,
    pinned=None) -> (params, opt_state, metrics), updating params and
    opt_state in place; metrics holds "loss", "grad_norm" and "lr" as 0-d
    tensors (lr a float without lr_fn); routes and pinned as
    loss_and_grads takes them. The parameters must take gradients
    (module.trainable). Each model's decay mask is read from its tree
    once, on its first step."""
    masks = weakref.WeakKeyDictionary()

    def train_step(params, opt_state, batch, *, routes=None, pinned=None):
        loss, grads = loss_and_grads(params, cfg, batch, tcfg,
                                     param_shardings, routes=routes,
                                     pinned=pinned)
        lr = lr_fn(opt_state["step"]) if lr_fn is not None else None
        if params not in masks:
            masks[params] = decay_mask(params)
        params, opt_state, mets = adamw_update(params, grads, opt_state,
                                               opt_cfg, lr, masks[params])
        mets["loss"] = loss
        return params, opt_state, mets

    return train_step
