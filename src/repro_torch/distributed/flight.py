"""The collectives a process group issued, as its flight recorder logged
them: a count of a step's collectives that does not go through
step_costs' dispatch mode, to hold that count against.

The recorder (ProcessGroupNCCL's, and ProcessGroupGloo's in newer torch)
keeps one entry a collective, with its kind, its input and output sizes
and dtypes and its group's name, in a ring of TORCH_FR_BUFFER_SIZE entries
(TORCH_NCCL_TRACE_BUFFER_SIZE in older torch); enable() sets both, and
must run before the process group is made. A window is the entries after
a mark:

    enable()
    dist.init_process_group(...)
    ...
    mark = last_id()
    step(...)
    rows = since(mark)
    kinds = by_kind(rows)

Each entry's kind is named as step_costs names the functional collective
(all_gather_into_tensor, reduce_scatter_tensor, all_reduce,
all_to_all_single, send, recv_); its result elements are those of the
functional collective's result, from the input and the group's size (an
all-gather's result is n inputs, a reduce-scatter's an n-th of one), since
gloo logs an all-gather's output with a leading 1 in place of n.
"""

from __future__ import annotations

import os
import pickle
from collections import defaultdict
from typing import Dict, List

import torch
import torch.distributed as dist

from repro_torch.distributed.step_costs import wire_bytes

BUFFER = 100_000             # entries kept (a few hundred a train step)

# the recorder's profiling names (after "nccl:" / "gloo:"), by the
# functional collective step_costs counts them as
_KINDS = (("reduce_scatter", "reduce_scatter_tensor"),
          ("all_gather", "all_gather_into_tensor"),
          ("allgather", "all_gather_into_tensor"),
          ("all_reduce", "all_reduce"), ("allreduce", "all_reduce"),
          ("all_to_all", "all_to_all_single"),
          ("alltoall", "all_to_all_single"),
          ("send", "send"), ("recv", "recv_"))

_RINGED = {k for _, k in _KINDS}

_DTYPES = {"Float": torch.float32, "Double": torch.float64,
           "BFloat16": torch.bfloat16, "Half": torch.float16,
           "Int": torch.int32, "Long": torch.int64, "Char": torch.int8,
           "Byte": torch.uint8, "Bool": torch.bool, "Short": torch.int16}


def enable(buffer: int = BUFFER) -> None:
    """Turn the recorder on for process groups made after this call."""
    os.environ["TORCH_FR_BUFFER_SIZE"] = str(buffer)
    os.environ["TORCH_NCCL_TRACE_BUFFER_SIZE"] = str(buffer)


def entries() -> List[dict]:
    """The recorder's entries, oldest first (no stack traces)."""
    from torch._C import _distributed_c10d as c10d
    dump = getattr(c10d, "_dump_fr_trace", None)
    if dump is None or (dist.is_initialized()
                        and dist.get_backend() == "nccl"
                        and hasattr(c10d, "_dump_nccl_trace")):
        dump = c10d._dump_nccl_trace
    return pickle.loads(dump(True, False, False)).get("entries", [])


def last_id() -> int:
    """The newest entry's record id (-1 where there is none): a mark."""
    rows = entries()
    return rows[-1]["record_id"] if rows else -1


def since(mark: int) -> List[dict]:
    """The entries recorded after mark."""
    return [e for e in entries() if e["record_id"] > mark]


def kind(entry: dict) -> str:
    """The entry's collective, named as step_costs names it (the
    recorder's own name where it has no counterpart there)."""
    name = entry["profiling_name"].partition(":")[2]
    for key, k in _KINDS:
        if key in name:
            return k
    return name


def _group_sizes() -> Dict[str, int]:
    from torch.distributed.distributed_c10d import _world
    return {name: pg.size() for pg, name in _world.pg_names.items()}


def by_kind(rows: List[dict]) -> Dict[str, dict]:
    """{kind: {"count", "elements" (the results'), "result_bytes",
    "wire_bytes" (step_costs' ring model at each group's size),
    "dtypes": {dtype: count}, "groups": {group size: [count, result
    bytes]}}}."""
    sizes = _group_sizes()
    out = defaultdict(lambda: {"count": 0, "elements": 0,
                               "result_bytes": 0, "wire_bytes": 0.0,
                               "dtypes": defaultdict(int),
                               "groups": defaultdict(lambda: [0, 0])})
    for e in rows:
        k = kind(e)
        n = sizes.get(e["process_group"][0], 1)
        elems = sum(int(torch.Size(s).numel()) for s in e["input_sizes"])
        if k == "all_gather_into_tensor":
            elems *= n
        elif k == "reduce_scatter_tensor":
            elems //= n
        dt = e["input_dtypes"][0] if e["input_dtypes"] else "Float"
        nbytes = elems * _DTYPES[dt].itemsize
        c = out[k]
        c["count"] += 1
        c["elements"] += elems
        c["result_bytes"] += nbytes
        c["wire_bytes"] += wire_bytes(k, nbytes, n) if k in _RINGED else 0.0
        c["dtypes"][dt] += 1
        c["groups"][n][0] += 1
        c["groups"][n][1] += nbytes
    return {k: dict(v, dtypes=dict(v["dtypes"]), groups=dict(v["groups"]))
            for k, v in out.items()}
