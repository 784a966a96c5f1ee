"""Partitioned canonical c^KV store (§1): provider-curated canonical chunks,
discoverable by canonical id across instances, forked copy-on-write by
concurrent sub-agents.

This is host-side control plane (replicated metadata); the cache bytes live
device-side, sharded over the instance axis. The serving engine consults the
store for residency, then the predicate for transport.

Chunks can BEAR their arrays: the exec-mode backend
(repro.serving.backends.jax_exec) materializes each chunk's canonical c^KV
entries as a real (length, d_qk) jax array in `Chunk.data`, and the spliced
copies its FETCH path produces in `Chunk.replica_data`. The control plane
stays array-free by default (the analytic backend never touches these), so
the store is importable — and the planner runnable — without jax arrays in
play; `data` is typed loosely for exactly that reason.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import constants as C

# pool_tokens is denominated in KV-cache tokens; sidecar arrays (index
# keys) are charged in token-equivalents at the all-layer c^KV
# byte rate so eviction pressure sees them (they used
# to ride free)
KV_TOKEN_BYTES = C.B_KV_TOKEN_LAYER * C.V2_LITE_LAYERS


def _sidecar_tokens(array: Any) -> int:
    nbytes = getattr(array, "nbytes", None)
    if nbytes is None:
        return 0
    return -(-int(nbytes) // KV_TOKEN_BYTES)          # ceil


@dataclasses.dataclass
class Chunk:
    chunk_id: str
    holder: int                 # instance index owning the canonical copy
    offset: int                 # offset in the holder's pool
    length: int                 # tokens
    position_base: int          # canonical position of token 0
    refcount: int = 0           # concurrent readers (agent fan-in, §6.3)
    replicas: List[int] = dataclasses.field(default_factory=list)
    immutable: bool = True
    last_access: int = 0        # engine step of last read (replica LRU)
    # exec mode: canonical c^KV entries (length, d_qk) and the per-instance
    # spliced copies backing the replicas; None / absent in analytic mode
    data: Optional[Any] = None
    replica_data: Dict[int, Any] = dataclasses.field(default_factory=dict)
    # selection regime: the index SIDECAR — per-token index keys
    # (length, d_index) materialized alongside c^KV (core.selection
    # latent_index_keys), with the same replica/eviction lifecycle as the
    # cache bytes; a holder scores its RESIDENT keys, never remote ones
    index_keys: Optional[Any] = None
    replica_index_keys: Dict[int, Any] = dataclasses.field(
        default_factory=dict)
    # token-equivalents charged against the owning pool for the sidecars
    # above (0 while no keys are attached)
    sidecar_tokens: int = 0
    replica_sidecar_tokens: Dict[int, int] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class Fork:
    """A sub-agent's copy-on-write view: shared immutable prefix + private
    suffix (the agentic workload of §1)."""
    fork_id: str
    base_chunk: str
    suffix_holder: int
    suffix_offset: int
    suffix_length: int = 0


class ChunkStore:
    """Canonical-id -> residency map. Replicated on every host (control
    plane); mutations are tiny and idempotent, so replication is by
    broadcast of the op log in a real deployment (single-process here)."""

    def __init__(self, n_instances: int, pool_tokens: int):
        self.n_instances = n_instances
        self.pool_tokens = pool_tokens
        self._chunks: Dict[str, Chunk] = {}
        self._forks: Dict[str, Fork] = {}
        self._alloc = [0] * n_instances          # bump allocator per instance
        self._fork_ids = itertools.count()
        # bumped on every residency mutation (register / replicate / evict /
        # fail-over / re-home) so readers can cache columnar snapshots
        self.version = 0
        # copy-retirement listeners: callables (chunk_id, instance)
        # notified when a copy on `instance` stops being attendable — replica
        # LRU eviction or holder death — so device-side caches keyed on the
        # (chunk, instance) pair (the shard_map backend's committed-copy
        # pool) retire in lockstep with the control plane
        self._evict_listeners: List = []
        # lifetime replica-promotion count (drop_holder fail-over); read by
        # the obs metrics registry alongside the evict-listener counters
        self.promotions = 0

    # -- allocation ---------------------------------------------------------
    # _alloc[i] tracks tokens in use on instance i. Offsets handed out are
    # the in-use watermark at allocation time — with free() they are logical
    # labels, not byte addresses (this is the control plane; the device-side
    # pool does its own placement).

    def allocate(self, instance: int, length: int) -> int:
        off = self._alloc[instance]
        if off + length > self.pool_tokens:
            raise MemoryError(
                f"instance {instance} pool exhausted "
                f"({off}+{length} > {self.pool_tokens})")
        self._alloc[instance] = off + length
        return off

    def free(self, instance: int, length: int) -> None:
        self._alloc[instance] = max(0, self._alloc[instance] - length)

    def used(self, instance: int) -> int:
        return self._alloc[instance]

    def capacity_left(self, instance: int) -> int:
        return self.pool_tokens - self._alloc[instance]

    def sidecar_tokens_used(self, instance: int) -> int:
        """Token-equivalents the index-key sidecars occupy on `instance`
        (canonical charge on the holder, replica charges where they ride).
        O(n_chunks) — an observability read, not a hot-path accessor."""
        total = 0
        for c in self._chunks.values():
            if c.holder == instance:
                total += c.sidecar_tokens
            total += c.replica_sidecar_tokens.get(instance, 0)
        return total

    def register(self, chunk_id: str, holder: int, length: int,
                 position_base: int = 0, data: Optional[Any] = None) -> Chunk:
        if chunk_id in self._chunks:
            raise KeyError(f"chunk {chunk_id} already registered")
        off = self.allocate(holder, length)
        c = Chunk(chunk_id, holder, off, length, position_base)
        self._chunks[chunk_id] = c
        if data is not None:
            try:
                self.attach_data(chunk_id, data)   # same length validation
            except ValueError:
                del self._chunks[chunk_id]        # no half-registered chunk
                self.free(holder, length)
                raise
        self.version += 1
        return c

    # -- array payloads (exec mode) --------------------------------

    def attach_data(self, chunk_id: str, array: Any) -> Chunk:
        """Bind the canonical c^KV array to a registered chunk. The leading
        axis must match the registered token length — the control plane's
        accounting and the device bytes must agree."""
        c = self._chunks[chunk_id]
        n = getattr(array, "shape", (c.length,))[0]
        if n != c.length:
            raise ValueError(
                f"{chunk_id}: array has {n} tokens, registered {c.length}")
        c.data = array
        return c

    def set_replica_data(self, chunk_id: str, instance: int,
                         array: Any) -> None:
        """Record the spliced copy backing a replica. Ignored for the
        canonical holder (its `data` is authoritative) and for instances
        the control plane does not list as replicas."""
        c = self._chunks[chunk_id]
        if instance in c.replicas:
            c.replica_data[instance] = array

    def array_on(self, chunk_id: str, instance: int) -> Optional[Any]:
        """The array `instance` would attend locally: its spliced replica
        copy if one was produced, else the canonical array when the chunk
        is resident there. None when nothing is materialized (analytic
        mode, or a replica whose bytes never moved through exec)."""
        c = self._chunks[chunk_id]
        if instance in c.replica_data:
            return c.replica_data[instance]
        if instance == c.holder:
            return c.data
        return None

    # -- index sidecar (selection regime) --------------------------

    def attach_index_keys(self, chunk_id: str, array: Any) -> Chunk:
        """Bind the per-token index keys to a registered chunk — same
        leading-axis validation as attach_data (one key per cached token)."""
        c = self._chunks[chunk_id]
        n = getattr(array, "shape", (c.length,))[0]
        if n != c.length:
            raise ValueError(
                f"{chunk_id}: {n} index keys, registered {c.length} tokens")
        # the sidecar occupies real pool bytes on the holder — charge (and
        # re-charge on replacement) so eviction pressure sees it
        tokens = _sidecar_tokens(array)
        self.free(c.holder, c.sidecar_tokens)
        self.allocate(c.holder, tokens)
        c.sidecar_tokens = tokens
        c.index_keys = array
        return c

    def set_replica_index_keys(self, chunk_id: str, instance: int,
                               array: Any) -> None:
        """Record the index keys riding along a replica (the sidecar moves
        with the cache bytes). Same guards as set_replica_data."""
        c = self._chunks[chunk_id]
        if instance in c.replicas:
            tokens = _sidecar_tokens(array)
            self.free(instance, c.replica_sidecar_tokens.get(instance, 0))
            self.allocate(instance, tokens)
            c.replica_sidecar_tokens[instance] = tokens
            c.replica_index_keys[instance] = array

    def index_keys_on(self, chunk_id: str, instance: int) -> Optional[Any]:
        """The index keys `instance` would score locally — replica sidecar
        first, canonical keys on the holder, None when nothing is
        materialized there (mirrors array_on)."""
        c = self._chunks[chunk_id]
        if instance in c.replica_index_keys:
            return c.replica_index_keys[instance]
        if instance == c.holder:
            return c.index_keys
        return None

    # -- discovery (cross-instance, by canonical id — §1: reuse that a local
    #    prefix tree cannot capture) --------------------------------------

    def lookup(self, chunk_id: str) -> Chunk:
        return self._chunks[chunk_id]

    def holders_of(self, chunk_id: str) -> List[int]:
        c = self._chunks[chunk_id]
        return [c.holder] + list(c.replicas)

    def resident_on(self, chunk_id: str, instance: int) -> bool:
        return instance in self.holders_of(chunk_id)

    def touch(self, chunk_id: str, step: int) -> None:
        """Record a read at engine step `step` (drives replica LRU)."""
        c = self._chunks[chunk_id]
        if step > c.last_access:
            c.last_access = step

    # -- replication (the amortised FETCH beyond the N~8 elbow, §6.3) -------

    def add_replica(self, chunk_id: str, instance: int) -> Chunk:
        c = self._chunks[chunk_id]
        if instance not in c.replicas and instance != c.holder:
            self.allocate(instance, c.length)
            c.replicas.append(instance)
            self.version += 1
        return c

    def replicas_on(self, instance: int) -> List[str]:
        """Chunk ids with a NON-canonical copy on `instance` — the retirable
        set under pool pressure (canonical copies never retire)."""
        return [c.chunk_id for c in self._chunks.values()
                if instance in c.replicas]

    def add_evict_listener(self, fn) -> None:
        """Register fn(chunk_id, instance), called whenever a copy on
        `instance` is retired (LRU replica eviction, holder death).
        Idempotent per callable."""
        if fn not in self._evict_listeners:
            self._evict_listeners.append(fn)

    def _notify_evicted(self, chunk_id: str, instance: int) -> None:
        for fn in self._evict_listeners:
            fn(chunk_id, instance)

    def evict_replica(self, chunk_id: str, instance: int) -> None:
        """Retire a replica and return its tokens to the pool. The canonical
        copy is not evictable this way."""
        c = self._chunks[chunk_id]
        if instance == c.holder:
            raise ValueError(
                f"{chunk_id}: instance {instance} holds the canonical copy")
        if instance in c.replicas:
            c.replicas.remove(instance)
            c.replica_data.pop(instance, None)
            c.replica_index_keys.pop(instance, None)
            # cache bytes AND the index-key sidecar return to the pool
            self.free(instance,
                      c.length + c.replica_sidecar_tokens.pop(instance, 0))
            self.version += 1
            self._notify_evicted(chunk_id, instance)

    def drop_holder(self, instance: int) -> List[str]:
        """Fault handling: instance died. Chunks whose only copy lived there
        must be re-prefilled (LOCAL) or restored from checkpoint; chunks with
        replicas promote one. Returns orphaned ids."""
        orphaned = []
        for c in self._chunks.values():
            if instance in c.replicas or c.holder == instance:
                # whichever copy lived on the dead instance is gone
                self._notify_evicted(c.chunk_id, instance)
            if c.holder == instance:
                if c.replicas:
                    c.holder = c.replicas.pop(0)
                    self.promotions += 1
                    # the promoted replica's spliced copy becomes canonical
                    # (the dead instance's array is unreachable) — index
                    # sidecar promotes with it, and its token charge stays
                    # on the promoted instance as the canonical charge
                    if c.holder in c.replica_data:
                        c.data = c.replica_data.pop(c.holder)
                    if c.holder in c.replica_index_keys:
                        c.index_keys = c.replica_index_keys.pop(c.holder)
                    c.sidecar_tokens = c.replica_sidecar_tokens.pop(
                        c.holder, 0)
                else:
                    orphaned.append(c.chunk_id)
        for f in self._forks.values():
            if f.suffix_holder == instance:
                orphaned.append(f.fork_id)
        self.version += 1
        return orphaned

    def rehome(self, chunk_id: str, instance: int) -> bool:
        """Move the canonical copy of an orphaned chunk to `instance` if it
        has pool room (the engine's LOCAL re-prefill path). Returns False
        when the pool cannot take it."""
        c = self._chunks[chunk_id]
        if self.capacity_left(instance) < c.length:
            return False
        self.allocate(instance, c.length)
        c.holder = instance
        self.version += 1
        return True

    # -- columnar residency snapshot (array planner) ----------------

    def residency_columns(self):
        """One columnar pass over the residency map: chunk ids in insertion
        order, their lengths, and a (n_chunks, 1 + max_replicas) holder
        matrix in [canonical] + replicas order, -1 padded. Consumers key
        their caches on `version`."""
        ids = tuple(self._chunks)
        chunks = [self._chunks[cid] for cid in ids]
        n = len(ids)
        width = 1 + max((len(c.replicas) for c in chunks), default=0)
        holders = np.full((n, width), -1, dtype=np.int64)
        length = np.zeros(n, dtype=np.int64)
        for i, c in enumerate(chunks):
            holders[i, 0] = c.holder
            if c.replicas:
                holders[i, 1:1 + len(c.replicas)] = c.replicas
            length[i] = c.length
        return ids, length, holders, chunks

    def residency_snapshot(self):
        """Canonical, order-independent view of where every chunk lives:
        ``{chunk_id: (holder, sorted replica tuple, length)}``. Bit-
        identity tests (pipelined vs lockstep) compare two
        engines' snapshots after identical workloads."""
        return {cid: (c.holder, tuple(sorted(c.replicas)), c.length)
                for cid, c in self._chunks.items()}

    # -- agentic CoW forks (§1, §6.3) ---------------------------------------

    def fork(self, chunk_id: str, agent_instance: int) -> Fork:
        c = self._chunks[chunk_id]
        c.refcount += 1
        f = Fork(f"fork{next(self._fork_ids)}", chunk_id, agent_instance,
                 self._alloc[agent_instance])
        self._forks[f.fork_id] = f
        return f

    def append_suffix(self, fork_id: str, n_tokens: int) -> Fork:
        f = self._forks[fork_id]
        self.allocate(f.suffix_holder, n_tokens)
        f.suffix_length += n_tokens
        return f

    def release(self, fork_id: str):
        f = self._forks.pop(fork_id)
        self._chunks[f.base_chunk].refcount -= 1

    def fan_in(self, chunk_id: str) -> int:
        """Concurrent readers of a chunk — the N of the §6.3 elbow."""
        return self._chunks[chunk_id].refcount
