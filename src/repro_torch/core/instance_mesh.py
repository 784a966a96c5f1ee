"""The instance mesh: serving instances placed over the visible cards.

The JAX package runs each serving instance on a device of a mesh axis named
"instance" (instance i on device i) and moves data between them with
collectives inside shard_map. Here the mesh's placement is a list of card
slots, one torch device each, and instance i lives on slot i % k with a
CUDA stream of its own on that card: work of instance i is issued on
stream i (``with mesh.on(i)``: the kernels launch on the current stream of
their operands' card). A card may be listed in several slots, so a
k-card placement folds onto fewer cards (one H100 listed four times runs
every part of the multi-slot logic but the copy between two cards). A
transport between instances is a copy into a buffer that the destination
owns, allocated on the destination's card and stream: on one card it is
written on the destination's stream after an event recorded on the
source's; between two cards it is a peer copy (InstanceMesh.pull). One
instance never hands another its tensor as a view.

Times come from stamps (CUDA events) of one slot at a time: a timed window
records one origin per slot (InstanceMesh.begin) and a stamp is timed from
its own slot's origin (Origins.since).

A shard set is a list of n per-instance tensors; None stands for an
instance that holds nothing (the reference's zero shard). The three
collectives keep the reference's semantics: ppermute(shards, pairs),
all_gather (every instance's shard stacked, (M, ...), on each destination)
and all_to_all (slice m of each source's leading axis goes to instance m).
Destinations can be narrowed to the instances that read the result; the
others get None.

On the CPU the mesh holds no streams and everything runs in order; the
copies still land in new buffers, so the data flow is the card's. Listing
"cpu" k times gives k slots, the port's counterpart of the reference's
--xla_force_host_platform_device_count.
"""

from __future__ import annotations

import contextlib
import time
from typing import (Any, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

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


def placement(devices: Union[str, torch.device, Sequence] = "cuda"
              ) -> List[torch.device]:
    """The card slots of a mesh: one torch device per slot. A sequence is
    taken as it is (a card may be listed more than once: k slots folded
    onto fewer cards); a single device stands for "cuda" = every visible
    card once (cuda:0 ... cuda:{count-1}), "cuda:i" = that card, "cpu" =
    one CPU slot. Raises on a device type other than cuda and cpu, on a
    mix of the two, and on cuda where no card is visible."""
    if isinstance(devices, (str, torch.device)):
        dev = torch.device(devices)
        if dev.type == "cuda" and dev.index is None:
            _need_cuda()
            slots = [torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())]
        else:
            slots = [dev]
    else:
        slots = [torch.device(d) for d in devices]
    if not slots:
        raise ValueError("InstanceMesh: no device slots")
    bad = [d for d in slots if d.type not in ("cuda", "cpu")]
    if bad:
        raise ValueError(f"InstanceMesh: unsupported device {bad[0]}")
    kinds = {d.type for d in slots}
    if len(kinds) > 1:
        raise ValueError(f"InstanceMesh: slots mix the CPU and cards: "
                         f"{[str(d) for d in slots]}")
    if kinds == {"cuda"}:
        _need_cuda()
        slots = [d if d.index is not None
                 else torch.device("cuda", torch.cuda.current_device())
                 for d in slots]
    return slots


def _need_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "InstanceMesh: device 'cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run the instances in order on "
            "the CPU")


def peer_matrix(slots: Sequence[torch.device]) -> Dict[Tuple[int, int], bool]:
    """torch.cuda.can_device_access_peer for every ordered pair of distinct
    cards among the slots (empty on the CPU or on one card)."""
    cards = sorted({d.index for d in slots if d.type == "cuda"})
    return {(a, b): bool(torch.cuda.can_device_access_peer(a, b))
            for a in cards for b in cards if a != b}


def describe_placement(n_instances: int,
                       slots: Sequence[torch.device]) -> str:
    """One line: instance -> card for every instance, then the peer matrix
    of the cards (y: peer access, -: the card itself)."""
    slots = list(slots)
    where = " ".join(f"{i}:{slots[i % len(slots)]}"
                     for i in range(n_instances))
    peers = peer_matrix(slots)
    cards = sorted({a for a, _ in peers})
    matrix = ("none (one card)" if not cards else " ".join(
        f"cuda:{a}[" + "".join("-" if a == b else "yn"[not peers[(a, b)]]
                               for b in cards) + "]" for a in cards))
    return (f"placement: {n_instances} instances over {len(slots)} slots "
            f"on {len({str(d) for d in slots})} device(s), instance:card "
            f"{where}; peer access {matrix}")


class Stamp(NamedTuple):
    """A point in the issue order of one slot's card: a timing CUDA event
    there, the host clock on the CPU. Two stamps give a time only when
    they carry the same slot (InstanceMesh.seconds)."""
    slot: int
    at: Any


class Origins:
    """The origin stamps of a timed window, one per slot
    (InstanceMesh.begin). A stamp's time in the window is taken from the
    origin of its own slot, then moved onto slot 0's axis by that slot's
    offset: the seconds from slot 0's origin to its own, measured by two
    events where the slot lies on slot 0's card, and taken as 0 where it
    lies on another card (CUDA times no event pair across devices; the
    origins are recorded right after a barrier across the cards, and
    their skew there is not measured). Read after a synchronize."""

    def __init__(self, mesh: "InstanceMesh", stamps: List[Stamp]):
        self.mesh = mesh
        self.stamps = stamps
        self._offsets: Optional[List[Optional[float]]] = None

    def offsets(self) -> List[Optional[float]]:
        """Per slot, seconds from slot 0's origin to its own; None where
        the slot lies on another card than slot 0's."""
        if self._offsets is None:
            first = self.stamps[0]
            dev0 = self.mesh.devices[0]
            self._offsets = [
                (st.at - first.at if isinstance(first.at, float)
                 else first.at.elapsed_time(st.at) / 1e3)
                if self.mesh.devices[st.slot] == dev0 else None
                for st in self.stamps]
        return self._offsets

    def skew(self) -> Optional[float]:
        """The spread of the measured slot offsets (0.0 for one slot), or
        None where no two slots share slot 0's card but one."""
        known = [o for o in self.offsets() if o is not None]
        if len(self.stamps) > 1 and len(known) < 2:
            return None
        return max(known) - min(known)

    def since(self, stamp: Stamp) -> float:
        """Seconds from the window's origin to stamp: from its own slot's
        origin, plus that slot's offset (0 where not measured)."""
        off = self.offsets()[stamp.slot]
        return (off or 0.0) + InstanceMesh.seconds(self.stamps[stamp.slot],
                                                   stamp)


class InstanceMesh:
    """n serving instances over k card slots (InstanceMesh.devices):
    instance i on devices[i % k], with a CUDA stream of its own on that
    card (none on the CPU). With k >= n, instance i sits on device i, the
    reference's order (mesh_for); the reference raises where a mesh has
    fewer devices than instances, the port wraps instead. Every pair of
    distinct cards must have peer access: the mesh raises, naming the
    pair, where one has not (a copy never stages through the host)."""

    def __init__(self, n_instances: int,
                 devices: Union[str, torch.device, Sequence] = "cuda"):
        if n_instances < 1:
            raise ValueError(f"InstanceMesh needs >= 1 instance, got "
                             f"{n_instances}")
        self.devices = placement(devices)
        self.n = n_instances
        if self.devices[0].type == "cuda":
            missing = [pair for pair, ok in
                       sorted(peer_matrix(self.devices).items()) if not ok]
            if missing:
                a, b = missing[0]
                raise RuntimeError(
                    f"InstanceMesh: cuda:{a} has no peer access to cuda:{b} "
                    f"(torch.cuda.can_device_access_peer); the mesh moves "
                    f"data between its cards only peer to peer")
            self._streams = [torch.cuda.Stream(device=self.device_of(i))
                             for i in range(n_instances)]
        else:
            self._streams = None

    @property
    def k(self) -> int:
        """The number of card slots."""
        return len(self.devices)

    def slot_of(self, i: int) -> int:
        return i % len(self.devices)

    def device_of(self, i: int) -> torch.device:
        """The card instance i lives on."""
        return self.devices[i % len(self.devices)]

    @property
    def cards(self) -> List[torch.device]:
        """The distinct devices the slots span, in slot order."""
        return list(dict.fromkeys(self.devices))

    @property
    def on_card(self) -> bool:
        return self._streams is not None

    @contextlib.contextmanager
    def on(self, i: int, *reads: Optional[torch.Tensor]):
        """Issue the body's work on instance i (its stream current on its
        card). Each tensor in `reads` that another stream allocated is
        recorded on i's stream, so the caching allocator does not reuse
        its memory before i's reads are done; a read tensor must lie on
        i's card (a copy from another card is a pull)."""
        if self._streams is None:
            yield
            return
        s = self._streams[i]
        for t in reads:
            if t is not None and t.device.type == "cuda":
                if t.device != s.device:
                    raise ValueError(
                        f"InstanceMesh.on({i}): a read tensor lies on "
                        f"{t.device}, instance {i} on {s.device}: pull it")
                t.record_stream(s)
        with torch.cuda.stream(s):
            yield

    # -- ordering and time ------------------------------------------------

    def stamp(self, i: int) -> Stamp:
        """A point in instance i's issue order, stamped with i's slot: a
        timing CUDA event on the card, the host clock on the CPU, where
        every op has finished by the time it returns."""
        if self._streams is None:
            return Stamp(self.slot_of(i), time.perf_counter())
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._streams[i])
        return Stamp(self.slot_of(i), ev)

    def after(self, dst: int, src: int) -> None:
        """Instance dst's later work waits for everything src issued."""
        if self._streams is not None and dst != src:
            ev = torch.cuda.Event()
            ev.record(self._streams[src])
            self._streams[dst].wait_event(ev)

    @staticmethod
    def seconds(t0: Stamp, t1: Stamp) -> float:
        """Seconds from stamp t0 to stamp t1 of ONE slot; on the card both
        must have completed (after synchronize). Raises on stamps of two
        slots: their clocks are two cards' (Origins.since moves a stamp
        onto one axis)."""
        if t0.slot != t1.slot:
            raise ValueError(f"InstanceMesh.seconds: stamps of slots "
                             f"{t0.slot} and {t1.slot}; a time is taken "
                             f"between stamps of one slot")
        if isinstance(t0.at, float):
            return t1.at - t0.at
        return t0.at.elapsed_time(t1.at) / 1e3

    def begin(self, spin_cycles: int = 0) -> Origins:
        """Open a timed window: the current stream of every card waits for
        the work issued so far on the current streams of the others (the
        queries, the chunk arrays and their copies), spins spin_cycles
        GPU cycles when asked (to hide the host's issue of what follows),
        then records one origin per slot; every instance waits for every
        slot's origin. On one card this is one origin on the current
        stream that every instance waits for."""
        if self._streams is None:
            t = time.perf_counter()
            return Origins(self, [Stamp(s, t) for s in range(self.k)])
        cards = self.cards
        ready = {}
        if len(cards) > 1:
            for d in cards:
                ready[d] = torch.cuda.Event()
                ready[d].record(torch.cuda.current_stream(d))
        for d in cards:
            cur = torch.cuda.current_stream(d)
            for other, ev in ready.items():
                if other != d:
                    cur.wait_event(ev)
            if spin_cycles:
                with torch.cuda.device(d):
                    torch.cuda._sleep(spin_cycles)
        stamps = []
        for s, d in enumerate(self.devices):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(d))
            stamps.append(Stamp(s, ev))
        for st in self._streams:
            for o in stamps:
                st.wait_event(o.at)
        return Origins(self, stamps)

    def join(self) -> None:
        """The current stream of every card the mesh spans waits for
        everything the instances issued."""
        if self._streams is not None:
            evs = []
            for s in self._streams:
                ev = torch.cuda.Event()
                ev.record(s)
                evs.append(ev)
            for d in self.cards:
                cur = torch.cuda.current_stream(d)
                for ev in evs:
                    cur.wait_event(ev)

    def synchronize(self, instances: Optional[Iterable[int]] = None) -> None:
        """Block the host until the instances' issued work has finished."""
        if self._streams is not None:
            for i in (range(self.n) if instances is None else instances):
                self._streams[i].synchronize()

    # -- transports -------------------------------------------------------

    def put(self, a, i: int) -> torch.Tensor:
        """A host array onto instance i, in a buffer i owns on its card. On
        the card it is staged in pinned memory, so the copy is queued on
        i's stream without the host waiting for that stream first."""
        t = torch.as_tensor(a)
        if self._streams is None:
            return t.clone()
        with self.on(i):
            return t.pin_memory().to(self.device_of(i), non_blocking=True)

    def pull(self, x: torch.Tensor, src: int, dst: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Instance src's tensor x, copied into `out` (a buffer dst owns)
        or into a new buffer allocated on dst's card and stream, after
        everything src issued before. On one card the copy is dst's work.
        Between two cards torch issues a copy on the SOURCE card's current
        stream, behind a two-way barrier with the destination card's
        current stream (ATen's copy_device_to_device): so src's stream is
        made current on src's card and dst's on dst's card around it. The
        copy is then src's work, after everything src issued; dst's stream
        waits for it, and out (allocated on dst's stream) is not written
        before dst's earlier work is done."""
        src_dev, dst_dev = self.device_of(src), self.device_of(dst)
        if self._streams is None or src_dev == dst_dev:
            self.after(dst, src)
            with self.on(dst, x, out):
                if out is None:
                    out = torch.empty(x.shape, dtype=x.dtype, device=dst_dev)
                out.copy_(x, non_blocking=True)
            return out
        with self.on(dst, out):
            if out is None:
                out = torch.empty(x.shape, dtype=x.dtype, device=dst_dev)
            with self.on(src, x):
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
                                 dtype=sample.dtype,
                                 device=self.device_of(d))
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
                                 dtype=sample.dtype,
                                 device=self.device_of(d))
            for s, x in enumerate(shards):
                if x is not None:
                    self.pull(x[d], s, d, out=buf[s])
            out[d] = buf
        return out
