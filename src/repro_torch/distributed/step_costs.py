"""Per-device costs of one step, counted while it runs on meta tensors on
a fake process group: the purpose of the reference's hlo_analysis.py and
hlo_costs.py (the roofline's inputs from the compiled program), without an
HLO parser. The step's DTensor ops are desugared by DTensor into local ops
and collectives on rank 0's shards; a dispatch mode below DTensor sees
those and counts, per device:

* flops — FlopCounterMode's formulas (torch.utils.flop_counter's
  registry: 2 * m * n * k for a product) applied to the local ops;
* traffic_bytes — the bytes each dispatched op reads and writes, its
  tensor operands and results (the reference's per-instruction HBM proxy,
  hlo_costs.py:1-20): views and allocations move nothing and are skipped;
  a gather or an index reads its slice (2 x its result), an indexed write
  its update (2 x the update), as the reference counts dynamic-slice,
  gather and dynamic-update-slice;
* collectives by kind (the same ops CommDebugMode counts, and DTensor's
  shard_dim_alltoall as the all-to-all it issues on the card) and their
  result bytes, in all and by kind and group size;
* ring-model wire bytes (hlo_analysis.py:53-74): all-gather, reduce-scatter
  and all-to-all B (n - 1) / n, all-reduce 2 B (n - 1) / n, a point-to-point
  transfer B, with B the collective's result bytes. n is the collective's
  own group size (the reference uses the whole mesh's device count for
  every collective).

Only ops on the step's device (meta) count: DTensor's own bookkeeping
(host tensors) and its shape inference (fake tensors of the global shapes,
run once per op signature) are not the step.

The reference scales a scanned body by its trip count (hlo_costs.py:200-
210); here the step is not compiled, so a train step is counted by running
ONE microbatch and multiplying its costs by n_micro, then adding the
optimizer update once (measure).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_aten = torch.ops.aten

# collective kind -> wire bytes per result byte, before the (n - 1) / n
# ring term; point-to-point kinds send their payload once
_RING = {"all_gather_into_tensor": 1.0, "reduce_scatter_tensor": 1.0,
         "all_to_all_single": 1.0, "all_reduce": 2.0}
_P2P = {"send", "recv_"}
_GATHERS = {_aten.index.Tensor, _aten.gather.default,
            _aten.index_select.default, _aten.embedding.default}
_UPDATES = {_aten.index_put.default, _aten.index_put_.default,
            _aten._index_put_impl_.default, _aten.index_copy.default,
            _aten.index_copy_.default}
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.detach.default,
         _aten.alias.default, _aten.lift_fresh.default}


def wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """The ring-model bytes a device sends for one collective of `kind`
    with `result_bytes` of result over a group of n."""
    if kind in _P2P:
        return float(result_bytes)
    return _RING[kind] * result_bytes * (n - 1) / max(1, n)


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _by_group():
    return defaultdict(lambda: defaultdict(lambda: [0.0, 0.0]))


@dataclasses.dataclass
class StepCosts:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_result_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    # {kind: {group size: [count, result bytes]}}
    collective_groups: Dict[str, Dict[int, list]] = dataclasses.field(
        default_factory=_by_group)

    def add(self, other: "StepCosts", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.traffic_bytes += other.traffic_bytes * mult
        self.collective_result_bytes += other.collective_result_bytes * mult
        self.collective_wire_bytes += other.collective_wire_bytes * mult
        for k, v in other.collective_counts.items():
            self.collective_counts[k] += v * mult
        for k, by_n in other.collective_groups.items():
            for n, (c, b) in by_n.items():
                mine = self.collective_groups[k][n]
                mine[0] += c * mult
                mine[1] += b * mult

    def by_kind(self) -> Dict[str, dict]:
        """{kind: {"count", "result_bytes", "wire_bytes"}}."""
        return {k: {"count": sum(c for c, _ in by_n.values()),
                    "result_bytes": sum(b for _, b in by_n.values()),
                    "wire_bytes": sum(wire_bytes(k, b, n)
                                      for n, (_, b) in by_n.items())}
                for k, by_n in self.collective_groups.items()}


class _Counter(TorchDispatchMode):
    """Counts the local ops on `device` (a DTensor op is left to DTensor,
    whose local ops come back through this mode)."""

    def __init__(self, device: str = "meta"):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.device = torch.device(device)
        self.costs = StepCosts()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if isinstance(func, torch._ops.OpOverload) and ins and \
                all(t.device == self.device for t in ins):
            self._count(func, args, kwargs, ins, _tensors(out))
        return out

    def _count(self, func, args, kwargs, ins, outs) -> None:
        c = self.costs
        name = func._overloadpacket.__name__
        if func.namespace == "_dtensor" and name == "shard_dim_alltoall":
            # DTensor's Shard(i) -> Shard(j) on a card's mesh: one
            # all-to-all on NCCL (on meta its fake form runs, which issues
            # nothing below it)
            name = "all_to_all_single"
        if func.namespace in ("_c10d_functional", "c10d", "_dtensor"):
            if name in _RING:
                res = _nbytes(outs)
                n = _group_size(args, kwargs)
            elif name in _P2P:
                res, n = _nbytes(ins), 2
            else:                           # wait_tensor and the like
                return
            c.collective_counts[name] += 1
            c.collective_groups[name][n][0] += 1
            c.collective_groups[name][n][1] += res
            c.collective_result_bytes += res
            c.collective_wire_bytes += wire_bytes(name, res, n)
            c.traffic_bytes += res + _nbytes(ins)
            return
        if func._overloadpacket in self.flop_registry:
            c.flops += self.flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=outs[0] if len(outs) == 1 else outs)
        if func.namespace == "prim" or func.is_view or func in _FREE:
            return
        if func in _GATHERS:
            c.traffic_bytes += 2 * _nbytes(outs)
        elif func in _UPDATES:
            upd = args[2] if len(args) > 2 else kwargs.get("values")
            c.traffic_bytes += 2 * _nbytes(_tensors(upd))
        else:
            c.traffic_bytes += _nbytes(outs) + _nbytes(ins)


def _group_size(args, kwargs) -> int:
    """The group size of a functional collective: the size of the group
    its name (its last string argument) resolves to."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in list(args) + list(kwargs.values())
             if isinstance(a, str)]
    return _resolve_process_group(names[-1]).size()


def count(fn: Callable[[], object], device: str = "meta") -> StepCosts:
    """Run fn once, counting its local ops on device."""
    counter = _Counter(device)
    with counter:
        fn()
    return counter.costs


def measure(micro: Callable[[], object], n_micro: int = 1,
            update: Optional[Callable[[], object]] = None,
            around=contextlib.nullcontext) -> StepCosts:
    """A step's per-device costs, counted inside around() (a memory
    tracker): micro (one microbatch, or the whole step) scaled by n_micro,
    update (the optimizer step) added once."""
    total = StepCosts()
    with around():
        total.add(count(micro), n_micro)
        if update is not None:
            total.add(count(update))
    return total
