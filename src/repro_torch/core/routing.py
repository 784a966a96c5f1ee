"""Cross-instance query routing — "move the query, not the cache" (§2, §3.3).

route_simulated attends an arbitrary partition of the cache shard by shard
and merges the partials; the online-softmax merge is associative and
commutative with an identity (core/merge.py), so the result equals
attention over the concatenated shards to float round-off.

The collective transports run over an InstanceMesh (core/instance_mesh.py:
instances placed over card slots, one stream each, every move an
InstanceMesh.pull), on per-instance shard lists (None: the instance holds
nothing), with the reference's three schedules:

* fanout  : all_gather(q) -> per-holder partial -> all_to_all(partials) ->
            local M-way merge (the scattered-selection regime, §5.4);
* pairwise: ppermute to a single holder and back (the §4 shape);
* ring    : the query and its merge accumulator circulate the ring, one
            attend + merge per hop;

plus the TPLA rank-paired pairwise route (§8). The bodies are split at
collective boundaries into stage functions (fanout_gather, fanout_exchange,
pairwise_ship, pairwise_return) so the mesh exec backend can time each
wire and compute stage. A holder's partial is absorbed_partial or
selected_partial — the mla_decode and sparse_select kernels on the card —
and merges are softmax_merge launches.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core.constants import NSA_BLOCK_TOKENS
from repro_torch.core.instance_mesh import AXIS, InstanceMesh
from repro_torch.core.merge import NEG_INF, Partial
from repro_torch.kernels.softmax_merge import (MAX_PARTS, softmax_merge,
                                               softmax_merge_parts)
from repro_torch.models.mla import (MLAConfig, absorbed_partial,
                                    selected_partial)

Blocks = Sequence[int]


def _shard_partial(cfg, q_abs, shard, mask, blocks, block_tokens) -> Partial:
    if blocks is not None:
        return selected_partial(cfg, q_abs, shard, blocks, block_tokens)
    return absorbed_partial(cfg, q_abs, shard, mask)


def route_simulated(cfg: MLAConfig, q_abs: torch.Tensor,
                    shards: Sequence[torch.Tensor],
                    masks: Optional[Sequence[torch.Tensor]] = None,
                    blocks: Optional[Sequence[Blocks]] = None,
                    block_tokens: int = NSA_BLOCK_TOKENS) -> Partial:
    """Merge partial attention over an arbitrary partition of the cache.

    q_abs (..., H, d_qk); shards: list of (S_i, d_qk) resident subsets.
    Under a selection each holder attends only its selected & resident
    entries: blocks[i] (ascending block ids of block_tokens rows — what the
    serving path passes, straight to sparse_select) or masks[i] (an
    (S_i,)-style token mask). Several shards merge in one softmax_merge
    launch (in place up to MAX_PARTS shards, stacked past it)."""
    parts = [_shard_partial(cfg, q_abs, shard,
                            None if masks is None else masks[i],
                            None if blocks is None else blocks[i],
                            block_tokens)
             for i, shard in enumerate(shards)]
    if len(parts) == 1:
        return parts[0]
    if len(parts) <= MAX_PARTS:           # read in place, no stack copies
        return softmax_merge_parts(parts)
    return softmax_merge(torch.stack([p.o for p in parts]),
                         torch.stack([p.m for p in parts]),
                         torch.stack([p.l for p in parts]))


def route_batched(cfg: MLAConfig, queries: Sequence[torch.Tensor],
                  holder_shards: Sequence[Sequence[torch.Tensor]],
                  masks: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                  blocks: Optional[Sequence[Sequence[Blocks]]] = None,
                  block_tokens: int = NSA_BLOCK_TOKENS) -> "list[Partial]":
    """Batched multi-holder routing, keyed by a dispatch plan: group g ships
    queries[g] (the plan's stacked requester rows, (m_q_total, H, d_qk)) to
    every holder in holder_shards[g] and returns the g-th merged Partial —
    one holder-side batched partial per holder (the §6.3 "batched partial
    is ~free" kernel shape), merged requester-side."""
    if len(queries) != len(holder_shards):
        raise ValueError(
            f"{len(queries)} query groups vs {len(holder_shards)} shard sets")
    return [route_simulated(cfg, q, shards,
                            None if masks is None else masks[g],
                            None if blocks is None else blocks[g],
                            block_tokens)
            for g, (q, shards) in enumerate(zip(queries, holder_shards))]


# ---------------------------------------------------------------------------
# Collective transports over an InstanceMesh. Per-instance shard lists in,
# per-instance lists out; every copy lands in a buffer its destination owns.
# ---------------------------------------------------------------------------

Parts = List[Optional[Partial]]


def check_route_shards(axis: str, q_abs: torch.Tensor,
                       local_ckv: torch.Tensor,
                       local_valid: Optional[torch.Tensor] = None,
                       shard: Optional[int] = None) -> None:
    """Up-front shard-shape validation: a per-shard B / S_local
    disagreement is rejected with the axis, the offending shard (when the
    caller knows it) and both shapes in the message."""
    where = f"mesh axis {axis!r}" + ("" if shard is None
                                     else f", shard {shard}")
    if q_abs.ndim < 2:
        raise ValueError(
            f"route shard on {where}: q_abs must be (..., B, H, d_qk), got "
            f"shape {tuple(q_abs.shape)}")
    if local_ckv.ndim != 2:
        raise ValueError(
            f"route shard on {where}: local_ckv must be (S_local, d_qk), "
            f"got shape {tuple(local_ckv.shape)}")
    if q_abs.shape[-1] != local_ckv.shape[-1]:
        raise ValueError(
            f"route shards disagree on {where}: q_abs has d_qk="
            f"{q_abs.shape[-1]} but local_ckv has d_qk={local_ckv.shape[-1]} "
            f"(shapes {tuple(q_abs.shape)} vs {tuple(local_ckv.shape)})")
    if local_valid is not None \
            and tuple(local_valid.shape) != (local_ckv.shape[0],):
        raise ValueError(
            f"route shards disagree on {where}: local_valid covers "
            f"S_local={local_valid.shape[0] if local_valid.ndim else '?'} "
            f"entries but local_ckv holds S_local={local_ckv.shape[0]} "
            f"(shapes {tuple(local_valid.shape)} vs "
            f"{tuple(local_ckv.shape)})")


def fanout_gather(mesh: InstanceMesh, q_shards, to=None):
    """Fanout wire stage 1 (transfer): every instance's query rows, (B, H,
    d) per shard, stacked (M, B, H, d) on each destination (all, or `to`:
    the holders that compute)."""
    return mesh.all_gather(q_shards, to=to)


def fanout_exchange(mesh: InstanceMesh, parts: Parts, wire_dtype=None,
                    to=None) -> Parts:
    """Fanout wire stage 2 (return): slice m of each holder's (M, ...)
    partial goes to instance m; an instance with no partial contributes
    the merge identity. wire_dtype=torch.bfloat16 ships o in bf16 (the
    paper's 1032-B partial row, §3.2) and widens it back to f32 on
    arrival; None keeps full precision."""
    os_, ms, ls = [], [], []
    for i, p in enumerate(parts):
        if p is None:
            os_.append(None), ms.append(None), ls.append(None)
            continue
        o = p.o
        if wire_dtype is not None:
            with mesh.on(i, o):
                o = o.to(wire_dtype)
        os_.append(o), ms.append(p.m), ls.append(p.l)
    o_ex = mesh.all_to_all(os_, to=to)
    m_ex = mesh.all_to_all(ms, to=to, fill=NEG_INF)
    l_ex = mesh.all_to_all(ls, to=to)
    out: Parts = [None] * mesh.n
    for d, o in enumerate(o_ex):
        if o is None:
            continue
        if o.dtype != torch.float32:
            with mesh.on(d):
                o = o.to(torch.float32)
        out[d] = Partial(o=o, m=m_ex[d], l=l_ex[d])
    return out


def merge_on(mesh: InstanceMesh, i: int, part: Partial) -> Partial:
    """Instance i's M-way merge of stacked partials (M, ...): one
    softmax_merge launch on its stream."""
    with mesh.on(i):
        return softmax_merge(part.o, part.m, part.l)


def route_fanout(mesh: InstanceMesh, cfg: MLAConfig, q_shards, ckv_shards,
                 valid_shards=None, wire_dtype=None) -> Parts:
    """Scattered multi-holder route (§5.4): every instance is requester
    and holder at once. Per-shard q (B, H, d_qk), ckv (S_local, d_qk) and
    valid (S_local,) bool (None: all resident); an instance without a
    cache shard computes nothing and contributes the identity. Returns
    each instance's fully merged Partial (B, H, .)."""
    valid_shards = valid_shards or [None] * mesh.n
    for i, (q, c) in enumerate(zip(q_shards, ckv_shards)):
        if q is not None and c is not None:
            check_route_shards(AXIS, q, c, valid_shards[i], shard=i)
    holders = [i for i, c in enumerate(ckv_shards) if c is not None]
    qs = fanout_gather(mesh, q_shards, to=holders)
    parts: Parts = [None] * mesh.n
    for i in holders:
        with mesh.on(i, ckv_shards[i], valid_shards[i]):
            parts[i] = absorbed_partial(cfg, qs[i], ckv_shards[i],
                                        valid_shards[i])
    homes = [i for i, q in enumerate(q_shards) if q is not None]
    ex = fanout_exchange(mesh, parts, wire_dtype, to=homes)
    return [None if p is None else merge_on(mesh, i, p)
            for i, p in enumerate(ex)]


def pairwise_ship(mesh: InstanceMesh, q_shards, holder: int,
                  requester: int):
    """Pairwise wire stage 1 (transfer): the requester's query rows move
    to the holder — one ppermute, the §4 put."""
    return mesh.ppermute(q_shards, [(requester, holder)])


def pairwise_return(mesh: InstanceMesh, parts: Parts, holder: int,
                    requester: int, wire_dtype=None) -> Parts:
    """Pairwise wire stage 2 (return): the holder's partial travels back
    (o in wire_dtype on the wire when given)."""
    part = parts[holder]
    out: Parts = [None] * mesh.n
    if part is None:
        return out
    o = part.o
    if wire_dtype is not None:
        with mesh.on(holder, o):
            o = o.to(wire_dtype)
    o, m, l = (mesh.pull(t, holder, requester) for t in (o, part.m, part.l))
    if o.dtype != torch.float32:
        with mesh.on(requester):
            o = o.to(torch.float32)
    out[requester] = Partial(o=o, m=m, l=l)
    return out


def route_pairwise(mesh: InstanceMesh, cfg: MLAConfig, q_shards, ckv_shards,
                   local_partial: Partial, holder: int, requester: int,
                   wire_dtype=None, valid_shards=None) -> Parts:
    """Single-holder route (§4 shape): the requester ships q to the holder,
    the holder computes the partial over its resident chunk (through its
    valid mask when the selection regime chose a subset), the partial
    returns, and the requester merges it with its own local partial.
    Returns the requester's merged Partial (None elsewhere)."""
    valid = None if valid_shards is None else valid_shards[holder]
    check_route_shards(AXIS, q_shards[requester], ckv_shards[holder], valid,
                       shard=requester)
    shipped = pairwise_ship(mesh, q_shards, holder, requester)
    parts: Parts = [None] * mesh.n
    with mesh.on(holder, ckv_shards[holder], valid):
        parts[holder] = absorbed_partial(cfg, shipped[holder],
                                         ckv_shards[holder], valid)
    back = pairwise_return(mesh, parts, holder, requester, wire_dtype)
    out: Parts = [None] * mesh.n
    with mesh.on(requester, *local_partial):
        out[requester] = softmax_merge_parts([local_partial, back[requester]])
    return out


def route_ring(mesh: InstanceMesh, cfg: MLAConfig, q_shards, ckv_shards,
               valid_shards=None) -> Parts:
    """Ring-scheduled route: each hop the holder attends the visiting
    query, merges the partial into the accumulator that travels with it,
    and both move one instance on (ppermute). After M hops every query is
    home with the full merge."""
    n = mesh.n
    valid_shards = valid_shards or [None] * n
    for i in range(n):
        check_route_shards(AXIS, q_shards[i], ckv_shards[i],
                           valid_shards[i], shard=i)
    perm = [(i, (i + 1) % n) for i in range(n)]
    q = list(q_shards)
    acc: Parts = []
    for i in range(n):
        with mesh.on(i):
            acc.append(Partial.identity(q[i].shape[:-1], cfg.kv_lora_rank,
                                        device=mesh.device_of(i)))
    for _ in range(n):
        for i in range(n):
            with mesh.on(i, ckv_shards[i], valid_shards[i]):
                part = absorbed_partial(cfg, q[i], ckv_shards[i],
                                        valid_shards[i])
                acc[i] = softmax_merge_parts([acc[i], part])
        q = mesh.ppermute(q, perm)
        moved = [mesh.ppermute([a[k] for a in acc], perm) for k in range(3)]
        acc = [Partial(*(moved[k][i] for k in range(3))) for i in range(n)]
    return acc


def route_pairwise_tpla(mesh: InstanceMesh, cfg: MLAConfig, q_slices,
                        ckv_slices, holder: int, requester: int) -> Partial:
    """TPLA rank-paired routing (§8): the latent is column-partitioned
    across N tensor-parallel ranks inside each instance. q_slices: the
    requester's N rank slices (B, H, d_qk/N), each [latent_r | rope_r];
    ckv_slices: the holder's N slices (S, d_qk/N) of the same columns.
    Rank r ships only its slice; inside the holder the rank slices'
    partial logits are summed (the reference's psum over the tp axis), and
    each rank computes its own d_c/N output slice, which returns. Returns
    the requester's Partial, o the rank slices joined (B, H, d_c)."""
    n_tp = len(q_slices)
    if len(ckv_slices) != n_tp:
        raise ValueError(f"route_pairwise_tpla: {n_tp} query slices vs "
                         f"{len(ckv_slices)} cache slices")
    shipped = [mesh.pull(q, requester, holder) for q in q_slices]
    d_cr = cfg.kv_lora_rank // n_tp
    with mesh.on(holder, *ckv_slices):
        logits = sum(torch.einsum("bhc,sc->bhs", q.to(torch.float32),
                                  c.to(torch.float32))
                     for q, c in zip(shipped, ckv_slices)) * cfg.scale
        m = torch.amax(logits, dim=-1)
        p = torch.exp(logits - m[..., None])
        l = torch.sum(p, dim=-1)
        w = p / l[..., None]
        o_slices = [torch.einsum("bhs,sd->bhd", w,
                                 c[:, :d_cr].to(torch.float32))
                    for c in ckv_slices]
    back = [mesh.pull(t, holder, requester) for t in o_slices + [m, l]]
    with mesh.on(requester):
        o = torch.cat(back[:n_tp], dim=-1)
    return Partial(o=o, m=back[n_tp], l=back[n_tp + 1])
