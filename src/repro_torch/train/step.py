"""Train step: grad-accumulation microbatching + AdamW, the counterpart of
repro.train.step.

The batch's leading axis splits into n_micro microbatches; each one's
gradient (autograd through models.model.loss_fn, the train form) is added
into f32 accumulators and the sum divided by n_micro; the loss is the mean
over microbatches. Then lr_fn(step), with the optimizer's step before its
increment, and adamw_update, in place.

On a mesh the parameters are DTensors (distributed.sharding.shard_params)
and the step runs under a sharding policy (distributed.policy.use_policy,
installed by the caller). param_shardings (param_shardings' map) pins every
gradient, and at n_micro > 1 the accumulators, to the parameters'
placements: a gradient leaves autograd as a partial sum over the data
shards, and pinning reduce-scatters it once per microbatch into the
parameter's layout, where the accumulators live. ep_axis names the mesh
dim the MoE experts split over (None: "model").
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.models import model as MD
from repro_torch.optim.adamw import AdamWConfig, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_micro: int = 1                 # grad-accumulation microbatches
    accum_dtype = torch.float32
    ep_axis: Optional[str] = None


def _microbatches(batch, n: int):
    """The n contiguous slices of every batch entry along its leading axis.
    A DTensor entry is gathered once, sliced, and each slice split again to
    the entry's own placements (a local chunk, no transfer): microbatch i
    holds the same rows as it does unsharded."""
    from torch.distributed.tensor import DTensor, Replicate

    def slices(v):
        m = v.shape[0] // n
        if not isinstance(v, DTensor):
            return list(v.reshape((n, m) + v.shape[1:]))
        mesh, rep = v.device_mesh, [Replicate()] * v.device_mesh.ndim
        full = v.redistribute(mesh, rep).to_local()
        return [DTensor.from_local(full[i * m:(i + 1) * m], mesh, rep,
                                   run_check=False)
                .redistribute(mesh, v.placements) for i in range(n)]

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


def accumulate(params, cfg: MD.ModelConfig, mb, acc: list,
               tcfg: TrainConfig = TrainConfig(), param_shardings=None):
    """One microbatch: its loss (detached) and its gradients, pinned and
    added into the accumulators acc (in parameters() order)."""
    leaves = list(params.parameters())
    loss = MD.loss_fn(params, cfg, mb, ep_axis=tcfg.ep_axis)
    grads = _pinner(params, param_shardings)(
        torch.autograd.grad(loss, leaves))
    for a, g in zip(acc, grads):
        a.add_(g)
    return loss.detach()


def loss_and_grads(params, cfg: MD.ModelConfig, batch,
                   tcfg: TrainConfig = TrainConfig(), param_shardings=None):
    """(loss, [gradient of each of params.parameters()]): with n_micro 1
    the gradients in the parameters' dtype, else the mean of the
    microbatches' gradients in tcfg.accum_dtype; with param_shardings,
    each on its parameter's placements."""
    leaves = list(params.parameters())
    pin = _pinner(params, param_shardings)
    n = tcfg.n_micro
    if n == 1:
        loss = MD.loss_fn(params, cfg, batch, ep_axis=tcfg.ep_axis)
        return loss.detach(), pin(torch.autograd.grad(loss, leaves))
    acc = pin([torch.zeros_like(p, dtype=tcfg.accum_dtype) for p in leaves])
    losses = [accumulate(params, cfg, mb, acc, tcfg, param_shardings)
              for mb in _microbatches(batch, n)]
    return torch.stack(losses).mean(), [a.div_(n) for a in acc]


def make_train_step(cfg: MD.ModelConfig, opt_cfg: AdamWConfig,
                    tcfg: TrainConfig = TrainConfig(),
                    lr_fn: Optional[Callable] = None,
                    param_shardings=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating params and opt_state in place; metrics holds "loss",
    "grad_norm" and "lr" as 0-d tensors (lr a float without lr_fn). The
    parameters must take gradients (module.trainable)."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, cfg, batch, tcfg,
                                     param_shardings)
        lr = lr_fn(opt_state["step"]) if lr_fn is not None else None
        params, opt_state, mets = adamw_update(params, grads, opt_state,
                                               opt_cfg, lr)
        mets["loss"] = loss
        return params, opt_state, mets

    return train_step
