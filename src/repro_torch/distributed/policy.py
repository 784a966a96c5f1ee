"""Activation-sharding policy context, the counterpart of
repro.distributed.policy: the model code asks for constraints at named
points (the residual stream between blocks); the launcher installs a
policy for the active mesh. Keeps model code mesh-agnostic while enabling
sequence-parallel residuals (Megatron-SP style) on the wide archs.

Where the reference places a with_sharding_constraint, constrain here
redistributes a DTensor to the policy's placements, and its gradient back
to the DTensor's own (_Constrain); a plain tensor (no mesh, or a block run
on local tensors) passes as it is.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from repro_torch.distributed.sharding import (_axis_size, dp_entry, fit_spec,
                                              placements)

_POLICY: contextvars.ContextVar = contextvars.ContextVar("policy",
                                                         default=None)


class _Constrain(torch.autograd.Function):
    """x redistributed to placements; its gradient redistributed back to
    x's own placements (a partial sum's as replicated). DTensor's own
    redistribute may hand a gradient back in the layout it arrived in,
    e.g. sharded over the sequence to a branch whose products view (batch,
    sequence) as one dim, which torch 2.11's DTensor refuses."""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        from torch.distributed.tensor import Replicate
        ctx.mesh = mesh
        ctx.src = [Replicate() if p.is_partial() else p
                   for p in x.placements]
        return x.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.src), None, None


class ShardingPolicy:
    """kind -> spec map, applied by redistributing DTensors."""

    def __init__(self, mesh, specs: dict):
        self.mesh = mesh
        self.specs = specs

    def constrain(self, x, kind: str):
        from torch.distributed.tensor import DTensor
        spec = self.specs.get(kind)
        if spec is None or not isinstance(x, DTensor):
            return x
        if x.shape[0] == 1 and spec[0] and _axis_size(self.mesh, (
                spec[0] if isinstance(spec[0], tuple) else (spec[0],))) == 1:
            spec = (None,) + spec[1:]       # one row over axes of size 1
                                            # stays whole (sharding.splits)
        if len(spec) > 2:
            # the sequence-parallel split only where the sequence divides
            # it: Whisper's 1500 encoder frames on a 16-wide model axis
            # stay whole (GSPMD pads them; an uneven shard gathers, under
            # torch 2.11, into a local tensor its products cannot view)
            spec = spec[:1] + (fit_spec(spec[1:2], x.shape[1:2], self.mesh)
                               or (None,)) + spec[2:]
        return _Constrain.apply(x, self.mesh, placements(spec, self.mesh))

    def for_batch(self, rows: int) -> "ShardingPolicy":
        """This policy for a batch of `rows`: a spec whose batch entry's
        mesh axes the rows do not divide keeps the batch whole (a
        microbatch of 16 rows on a 32-wide data axis; sharding.fit_spec),
        every other entry as it is. Itself where every batch entry
        divides."""
        specs = {k: spec and (fit_spec(spec[:1], (rows,), self.mesh)
                              or (None,)) + spec[1:]
                 for k, spec in self.specs.items()}
        if specs == self.specs:
            return self
        return ShardingPolicy(self.mesh, specs)


def sp_policy(mesh, seq_shard: bool = True) -> ShardingPolicy:
    """Residual stream (B, S, D): batch over (pod, data); with seq_shard,
    the sequence over model between blocks (SP). A block's normalised input
    ("block_in") has its sequence gathered before the projections (the
    all-gather of Megatron-SP, which GSPMD inserts by itself; DTensor's
    einsum would otherwise fold the sharded batch and sequence into one
    strided dim that its matmul strategies do not take). The logits put
    the vocab over model (the vocab-parallel cross-entropy)."""
    dp = dp_entry(mesh)
    return ShardingPolicy(mesh, {
        "residual": (dp, "model" if seq_shard else None, None),
        "block_in": (dp, None, None),
        "logits": (dp, None, "model"),
    })


def constrain(x, kind: str):
    pol = _POLICY.get()
    return pol.constrain(x, kind) if pol is not None else x


def current() -> Optional[ShardingPolicy]:
    return _POLICY.get()


@contextlib.contextmanager
def use_policy(policy: Optional[ShardingPolicy]):
    tok = _POLICY.set(policy)
    try:
        yield
    finally:
        _POLICY.reset(tok)
