"""The instance mesh: serving instances as partitions of one card.

The JAX package runs each serving instance on a device of a mesh axis named
"instance" and moves data between them with collectives inside shard_map.
On one H100 an instance is a partition of the card with its own CUDA
stream: work of instance i is issued on stream i (``with mesh.on(i)``: the
kernels launch on the current stream), and a transport between instances
is a copy into a buffer that the destination owns — allocated on the
destination's stream and written there, after an event recorded on the
source's stream. One instance never hands another its tensor as a view.

A shard set is a list of n per-instance tensors; None stands for an
instance that holds nothing (the reference's zero shard). The three
collectives keep the reference's semantics: ppermute(shards, pairs),
all_gather (every instance's shard stacked, (M, ...), on each destination)
and all_to_all (slice m of each source's leading axis goes to instance m).
Destinations can be narrowed to the instances that read the result; the
others get None.

On the CPU the mesh holds no streams and everything runs in order; the
copies still land in new buffers, so the data flow is the card's.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

AXIS = "instance"

Shards = List[Optional[torch.Tensor]]


def check_instance_shards(parts: Dict[int, Any], per_shape: Tuple[int, ...],
                          n_instances: Optional[int] = None,
                          axis: str = AXIS) -> None:
    """Up-front per-instance shard validation: every supplied shard must
    match the mesh-wide per-shard shape. A ragged shard is rejected naming
    the axis, the offending shard and BOTH shapes."""
    per = tuple(per_shape)
    for inst, part in parts.items():
        if n_instances is not None and not 0 <= inst < n_instances:
            raise ValueError(
                f"instance shard on mesh axis {axis!r}: shard {inst} is "
                f"outside the mesh (axis size {n_instances})")
        got = tuple(part.shape)
        if got != per:
            raise ValueError(
                f"instance shards disagree on mesh axis {axis!r}: shard "
                f"{inst} has shape {got} but the mesh-wide per-shard "
                f"shape is {per}")


class InstanceMesh:
    """n serving instances on one device, one CUDA stream each (none on the
    CPU)."""

    def __init__(self, n_instances: int, device="cuda"):
        if n_instances < 1:
            raise ValueError(f"InstanceMesh needs >= 1 instance, got "
                             f"{n_instances}")
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "InstanceMesh: device 'cuda' requested but no CUDA "
                    "device is available; pass device='cpu' to run the "
                    "instances in order on the CPU")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            self._streams = [torch.cuda.Stream(device=dev)
                             for _ in range(n_instances)]
        elif dev.type == "cpu":
            self._streams = None
        else:
            raise ValueError(f"InstanceMesh: unsupported device {dev}")
        self.n = n_instances
        self.device = dev

    @property
    def on_card(self) -> bool:
        return self._streams is not None

    @contextlib.contextmanager
    def on(self, i: int, *reads: Optional[torch.Tensor]):
        """Issue the body's work on instance i. Each tensor in `reads` that
        another stream allocated is recorded on i's stream, so the caching
        allocator does not reuse its memory before i's reads are done."""
        if self._streams is None:
            yield
            return
        s = self._streams[i]
        for t in reads:
            if t is not None and t.device.type == "cuda":
                t.record_stream(s)
        with torch.cuda.stream(s):
            yield

    # -- ordering and time ------------------------------------------------

    def stamp(self, i: Optional[int] = None):
        """A point in instance i's issue order (the current stream when i is
        None): a timing CUDA event on the card, the host clock on the
        CPU, where every op has finished by the time it returns."""
        if self._streams is None:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device) if i is None
                  else self._streams[i])
        return ev

    def wait(self, i: int, stamp) -> None:
        """Instance i's later work waits for `stamp` (a no-op on the CPU)."""
        if self._streams is not None:
            self._streams[i].wait_event(stamp)

    def after(self, dst: int, src: int) -> None:
        """Instance dst's later work waits for everything src issued."""
        if self._streams is not None and dst != src:
            ev = torch.cuda.Event()
            ev.record(self._streams[src])
            self._streams[dst].wait_event(ev)

    @staticmethod
    def seconds(t0, t1) -> float:
        """Seconds from stamp t0 to stamp t1; on the card both must have
        completed (after synchronize)."""
        if isinstance(t0, float):
            return t1 - t0
        return t0.elapsed_time(t1) / 1e3

    def begin(self):
        """Open a step: every instance waits for the work issued so far on
        the current stream (the queries, the chunk arrays). Returns the
        step's origin stamp."""
        origin = self.stamp()
        if self._streams is not None:
            for s in self._streams:
                s.wait_event(origin)
        return origin

    def join(self) -> None:
        """The current stream waits for everything the instances issued."""
        if self._streams is not None:
            cur = torch.cuda.current_stream(self.device)
            for s in self._streams:
                ev = torch.cuda.Event()
                ev.record(s)
                cur.wait_event(ev)

    def synchronize(self, instances: Optional[Iterable[int]] = None) -> None:
        """Block the host until the instances' issued work has finished."""
        if self._streams is not None:
            for i in (range(self.n) if instances is None else instances):
                self._streams[i].synchronize()

    # -- transports -------------------------------------------------------

    def put(self, a, i: int) -> torch.Tensor:
        """A host array onto instance i, in a buffer i owns. On the card it
        is staged in pinned memory, so the copy is queued on i's stream
        without the host waiting for that stream first."""
        t = torch.as_tensor(a)
        if self._streams is None:
            return t.clone()
        with self.on(i):
            return t.pin_memory().to(self.device, non_blocking=True)

    def pull(self, x: torch.Tensor, src: int, dst: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Instance src's tensor x, copied into `out` (a buffer dst owns)
        or into a new buffer allocated on dst's stream, after everything
        src issued before. The copy is dst's work."""
        self.after(dst, src)
        with self.on(dst, x, out):
            if out is None:
                out = torch.empty(x.shape, dtype=x.dtype, device=self.device)
            out.copy_(x, non_blocking=True)
        return out

    def _check(self, shards: Sequence[Optional[torch.Tensor]],
               what: str) -> torch.Tensor:
        if len(shards) != self.n:
            raise ValueError(f"{what}: {len(shards)} shards for a mesh of "
                             f"{self.n} instances")
        present = {i: t for i, t in enumerate(shards) if t is not None}
        if not present:
            raise ValueError(f"{what}: every shard is empty")
        sample = next(iter(present.values()))
        check_instance_shards(present, tuple(sample.shape), self.n)
        return sample

    def ppermute(self, shards: Sequence[Optional[torch.Tensor]],
                 pairs: Sequence[Tuple[int, int]]) -> Shards:
        """lax.ppermute: for each (source, destination) pair, the source's
        shard lands on the destination. Destinations no pair names (or
        whose source holds nothing) get None."""
        if len(shards) != self.n:
            raise ValueError(f"ppermute: {len(shards)} shards for a mesh of "
                             f"{self.n} instances")
        srcs = [s for s, _ in pairs]
        dsts = [d for _, d in pairs]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise ValueError(f"ppermute: pairs {list(pairs)} repeat a source "
                             f"or a destination")
        out: Shards = [None] * self.n
        for s, d in pairs:
            if not (0 <= s < self.n and 0 <= d < self.n):
                raise ValueError(f"ppermute: pair ({s}, {d}) outside the "
                                 f"mesh of {self.n} instances")
            if shards[s] is not None:
                out[d] = self.pull(shards[s], s, d)
        return out

    def all_gather(self, shards: Sequence[Optional[torch.Tensor]],
                   to: Optional[Iterable[int]] = None,
                   fill: float = 0.0) -> Shards:
        """lax.all_gather: every instance's shard stacked, (M, ...), on each
        destination (all instances unless `to` narrows them); an empty
        shard's slot holds `fill`."""
        sample = self._check(shards, "all_gather")
        out: Shards = [None] * self.n
        for d in (range(self.n) if to is None else to):
            with self.on(d):
                buf = torch.full((self.n,) + tuple(sample.shape), fill,
                                 dtype=sample.dtype, device=self.device)
            for s, x in enumerate(shards):
                if x is not None:
                    self.pull(x, s, d, out=buf[s])
            out[d] = buf
        return out

    def all_to_all(self, shards: Sequence[Optional[torch.Tensor]],
                   to: Optional[Iterable[int]] = None,
                   fill: float = 0.0) -> Shards:
        """lax.all_to_all(split_axis=0, concat_axis=0): each shard is
        (M, ...); slice m of source s lands in slot s of instance m's
        (M, ...) result. Only the destinations in `to` (default all) are
        written; an empty source's slot holds `fill`."""
        sample = self._check(shards, "all_to_all")
        if sample.shape[0] != self.n:
            raise ValueError(f"all_to_all: shards must lead with the mesh "
                             f"size {self.n}, got {tuple(sample.shape)}")
        out: Shards = [None] * self.n
        for d in (range(self.n) if to is None else to):
            with self.on(d):
                buf = torch.full(tuple(sample.shape), fill,
                                 dtype=sample.dtype, device=self.device)
            for s, x in enumerate(shards):
                if x is not None:
                    self.pull(x[d], s, d, out=buf[s])
            out[d] = buf
        return out
