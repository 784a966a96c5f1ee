"""Train step: grad-accumulation microbatching + AdamW, the counterpart of
repro.train.step.

The batch's leading axis splits into n_micro microbatches; each one's
gradient (autograd through models.model.loss_fn, the train form) is added
into f32 accumulators and the sum divided by n_micro; the loss is the mean
over microbatches. Then lr_fn(step), with the optimizer's step before its
increment, and adamw_update, in place. The expert-parallel axis and the
parameter shardings of the reference belong to the distribution substrate
(ROADMAP A.12).
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


def loss_and_grads(params, cfg: MD.ModelConfig, batch,
                   tcfg: TrainConfig = TrainConfig()):
    """(loss, [gradient of each of params.parameters()]): with n_micro 1
    the gradients in the parameters' dtype, else the mean of the
    microbatches' gradients in tcfg.accum_dtype."""
    leaves = list(params.parameters())
    n = tcfg.n_micro
    if n == 1:
        loss = MD.loss_fn(params, cfg, batch)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))
    acc = [torch.zeros(p.shape, dtype=tcfg.accum_dtype, device=p.device)
           for p in leaves]
    losses = []
    for i in range(n):
        mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
              for k, v in batch.items()}
        loss = MD.loss_fn(params, cfg, mb)
        for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
            a.add_(g)
        losses.append(loss.detach())
    return torch.stack(losses).mean(), [a.div_(n) for a in acc]


def make_train_step(cfg: MD.ModelConfig, opt_cfg: AdamWConfig,
                    tcfg: TrainConfig = TrainConfig(),
                    lr_fn: Optional[Callable] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating params and opt_state in place; metrics holds "loss",
    "grad_norm" and "lr" as 0-d tensors (lr a float without lr_fn). The
    parameters must take gradients (module.trainable)."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, cfg, batch, tcfg)
        lr = lr_fn(opt_state["step"]) if lr_fn is not None else None
        params, opt_state, mets = adamw_update(params, grads, opt_state,
                                               opt_cfg, lr)
        mets["loss"] = loss
        return params, opt_state, mets

    return train_step
