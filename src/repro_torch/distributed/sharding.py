"""Logical-axis -> mesh sharding rules (MaxText-style), the counterpart of
repro.distributed.sharding, with its divisibility fallback: a dim whose
size does not divide the mapped mesh axes is replicated instead (e.g. 40
attention heads on a 16-wide model axis, the Qwen-32B family), and the
re-layout that follows is left to DTensor's propagation.

A spec is mesh-independent: a tuple with one entry per leading tensor dim
(trailing unsharded dims dropped, as the reference's spec_for drops them),
each entry None, a mesh axis name, or a tuple of axis names (a dim sharded
over several axes, the major first). It compares with the reference's
PartitionSpec entry for entry (tuple(spec)). A mesh is a DeviceMesh with
named dims, or, where only its shape matters, a mapping {axis name: size}
in mesh order (the counterpart of jax's AbstractMesh). placements(spec,
mesh) turns a spec into DTensor placements on a DeviceMesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.models.module import param_axes, placing

Spec = Tuple

# logical axis -> mesh axes (tuple => combined). "fsdp" resolves to the
# data axis (+ pod when present).
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "embed": ("fsdp",),          # FSDP: params sharded over data(+pod)
    "mlp": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "layer": (),                 # a stack's index: never sharded
}


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh (named dims) or a mapping, in mesh
    order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if mesh.mesh_dim_names is None:
        raise ValueError("the mesh needs named dims")
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _fsdp_axes(mesh) -> Tuple[str, ...]:
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _axis_size(mesh, axes: Tuple[str, ...]) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes) if axes else 1


def splits(n: int, mesh, axes: Tuple[str, ...]) -> bool:
    """Whether a batch of n rows splits over the mesh axes `axes`: their
    size divides n and n > 1. One row is never split, not even over axes
    of size 1, where the split holds the same data: DTensor cannot view
    away a sharded dim of one (a one-row decode on a (1, n) mesh)."""
    return bool(axes) and n > 1 and n % _axis_size(mesh, axes) == 0


def dp_entry(mesh):
    """The spec entry of a dim sharded over the data-parallel axes: (pod,
    data), data, or None."""
    dp = _fsdp_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def resolve_rules(mesh, rules: Optional[dict] = None) -> dict:
    names = axis_sizes(mesh)
    out = {}
    for logical, axes in (rules or DEFAULT_RULES).items():
        resolved = []
        for a in axes:
            if a == "fsdp":
                resolved.extend(_fsdp_axes(mesh))
            elif a in names:
                resolved.append(a)
        out[logical] = tuple(resolved)
    return out


def spec_for(axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
             rules: Optional[dict] = None,
             no_fsdp_with: Sequence[str] = ()) -> Spec:
    """Logical axes + dim sizes -> spec, with the divisibility fallback.
    Each mesh axis is used at most once per spec.

    no_fsdp_with: if the tensor carries any of these logical axes, its
    fsdp-mapped dims are replicated instead (expert weights sharded over
    `model` only: no per-microbatch all-gather of the expert stacks over
    the data axis)."""
    rr = resolve_rules(mesh, rules)
    fsdp = set(_fsdp_axes(mesh))
    suppress_fsdp = any(a in no_fsdp_with for a in axes if a)
    used = set()
    entries = []
    for name, dim in zip(axes, shape):
        target = rr.get(name, ()) if name else ()
        if suppress_fsdp:
            target = tuple(a for a in target if a not in fsdp)
        target = tuple(a for a in target if a not in used)
        if target and dim % _axis_size(mesh, target) == 0:
            entries.append(target if len(target) > 1 else target[0])
            used.update(target)
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of jax's NamedSharding)."""
    mesh: object
    spec: Spec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def param_shardings(tree: nn.Module, mesh, rules: Optional[dict] = None,
                    no_fsdp_with: Sequence[str] = ()) -> Dict[str,
                                                              NamedSharding]:
    """{parameter path: NamedSharding} of every parameter of a model tree,
    from the logical axes its init noted (module.param_axes)."""
    shapes = {k: p.shape for k, p in tree.named_parameters()}
    return {k: NamedSharding(mesh, spec_for(axes, shapes[k], mesh, rules,
                                            no_fsdp_with))
            for k, axes in param_axes(tree).items()}


def state_shardings(tree: nn.Module, mesh, rules: Optional[dict] = None,
                    no_fsdp_with: Sequence[str] = ()) -> dict:
    """AdamW state shardings: m/v take the parameters' (in parameters()
    order, as adamw_init lists them); the step is replicated."""
    ps = param_shardings(tree, mesh, rules, no_fsdp_with)
    order = [ps[k] for k, _ in tree.named_parameters()]
    return {"m": order, "v": list(order),
            "step": NamedSharding(mesh, ())}


def batch_sharding(mesh) -> NamedSharding:
    """Token batches: leading batch dim over (pod, data)."""
    return NamedSharding(mesh, (dp_entry(mesh),))


def cache_spec(shape: Sequence[int], mesh, seq_dim: int = 2,
               batch_dim: int = 1) -> Spec:
    """Decode-cache sharding: batch over (pod, data), the SEQUENCE over
    model: the cache is a partitioned canonical store along the sequence
    axis (context-parallel serving), the paper's multi-holder residency.

    Falls back per dim on divisibility (e.g. batch=1 long_500k: batch
    replicated, sequence sharded)."""
    dp = _fsdp_axes(mesh)
    sizes = axis_sizes(mesh)
    entries: list = [None] * len(shape)
    if splits(shape[batch_dim], mesh, dp):
        entries[batch_dim] = dp if len(dp) > 1 else dp[0]
    if "model" in sizes and shape[seq_dim] % sizes["model"] == 0:
        entries[seq_dim] = "model"
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements(spec: Spec, mesh) -> list:
    """A spec -> DTensor placements on a DeviceMesh with named dims: Shard(d)
    on every mesh dim that tensor dim d is sharded over, Replicate on the
    others. A dim over several mesh dims is split major first by DTensor
    (in mesh-dim order), which is the spec's order only while the spec
    lists them in mesh order: anything else raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} used twice in "
                                 f"{spec}")
            out[i] = Shard(d)
    return out


def distribute(t, mesh, spec: Spec):
    """t (the whole tensor, on every rank) as a DTensor with spec's
    placements on mesh."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(spec, mesh))


def shard_params(tree: nn.Module,
                 shardings: Dict[str, NamedSharding]) -> nn.Module:
    """In place: every parameter of tree becomes a DTensor parameter with
    its sharding (param_shardings' map), keeping requires_grad; the module
    (and its logical axes) stays. Returns tree."""
    for path, p in list(tree.named_parameters()):
        owner_path, _, name = path.rpartition(".")
        sh = shardings[path]
        setattr(tree.get_submodule(owner_path), name, nn.Parameter(
            distribute(p.detach(), sh.mesh, sh.spec),
            requires_grad=p.requires_grad))
    return tree


def init_sharded(cfg, mesh, generator: Optional[torch.Generator] = None, *,
                 device, dtype, cast: Optional[torch.dtype] = None
                 ) -> nn.Module:
    """models.model.init_model(cfg, generator, device=device, dtype=dtype)
    with each parameter, as soon as it is drawn, cast to `cast` (None:
    kept) and laid out on mesh by param_shardings' rule, before the next
    is drawn: the whole model never sits on one device, only its largest
    leaf. Every rank draws every leaf (the generators stay in step) and
    distribute takes rank 0's. Equal bit for bit to shard_params of
    init_model's tree cast leaf by leaf (tree.to(cast)), by
    param_shardings(tree, mesh)."""
    from repro_torch.models.model import init_model

    def place(t, axes):
        if cast is not None:
            t = t.to(cast)
        return distribute(t, mesh, spec_for(axes, t.shape, mesh))
    with placing(place):
        return init_model(cfg, generator, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Blocks computed on local tensors (the reference's shard_map blocks)
# ---------------------------------------------------------------------------

def local_inputs(mesh, pairs) -> list:
    """Each (DTensor, spec) of pairs brought to spec's placements and taken
    as its local tensor, for a block computed on local tensors. The block
    is split over every mesh dim some spec shards: on such a dim a
    replicated input's gradient is a partial sum over the ranks (each used
    the input for its own part), a sharded input's is its shard; on the
    other dims the block repeats and every gradient is whole."""
    from torch.distributed.tensor import Partial, Replicate
    names = list(axis_sizes(mesh))
    split = {a for _, spec in pairs for e in spec if e is not None
             for a in (e if isinstance(e, tuple) else (e,))}
    out = []
    for t, spec in pairs:
        pl = placements(spec, mesh)
        grad = [Partial() if n in split and isinstance(p, Replicate) else p
                for n, p in zip(names, pl)]
        out.append(t.redistribute(mesh, pl).to_local(grad_placements=grad))
    return out


def local_heads(fn, args: Sequence, heads: Sequence[Optional[int]],
                out_heads=2):
    """fn(*args) for an attention core whose args are (B, ...) tensors,
    arg i with its head dim heads[i] (None: no head dim), and whose result
    is (B, S, H, ...) (out_heads: the result's head dim; a tuple of them
    for a block that returns a tuple, one per result). On DTensors it runs
    on local tensors: the batch over the data dims and the heads over
    `model`, each where it divides (else that dim repeats the block); each
    result a DTensor laid out so.
    The attention of one (batch row, head) needs no other, so the block
    has no collective. DTensor would otherwise fold the sharded batch and
    head dims into one strided batch dim, which torch 2.11's DTensor
    refuses and 2.13's lays out by a search that is slow on two mesh dims
    and does not end on three."""
    from torch.distributed.tensor import DTensor
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    sizes = axis_sizes(mesh)
    dp = _fsdp_axes(mesh)
    b_entry = dp_entry(mesh) if splits(args[0].shape[0], mesh, dp) else None
    h_entry = "model" if "model" in sizes and all(
        a.shape[h] % sizes["model"] == 0 for a, h in zip(args, heads)
        if h is not None) else None

    def spec(ndim, h):
        entries = [b_entry] + [None] * (ndim - 1)
        if h is not None:
            entries[h] = h_entry
        return tuple(entries)

    local = local_inputs(mesh, [(a, spec(a.ndim, h))
                                for a, h in zip(args, heads)])
    out = fn(*local)
    wrap = lambda t, h: DTensor.from_local(
        t, mesh, placements(spec(t.ndim, h), mesh), run_check=False)
    if isinstance(out_heads, tuple):
        return tuple(wrap(t, h) for t, h in zip(out, out_heads))
    return wrap(out, out_heads)


def _seq_shard(t, seq_dim: int) -> Tuple[list, int, int]:
    """(the mesh dims that split t's dim seq_dim, in mesh order; this
    rank's first row of that dim; its row count) for a DTensor t whose dim
    divides evenly over those mesh dims, split major first as DTensor
    splits it."""
    from torch.distributed.tensor import Shard
    mesh, n = t.device_mesh, t.shape[seq_dim]
    dims = [i for i, p in enumerate(t.placements) if p == Shard(seq_dim)]
    coord = mesh.get_coordinate()
    off = 0
    for i in dims:
        if n % mesh.shape[i]:
            raise ValueError(f"dim {seq_dim} of {tuple(t.shape)} does not "
                             f"divide over mesh dims {dims}")
        n //= mesh.shape[i]
        off += coord[i] * n
    return dims, off, n


def _batch_placements(t) -> list:
    """t's placements on the mesh dims that split its dim 0 (the batch),
    Replicate on every other."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if p == Shard(0) else Replicate() for p in t.placements]


def local_seq_partials(attend, merge, q, cache):
    """attend(q, cache) -> Partial (o (B, ..., d_v), m, l (B, ...)) for
    queries q (B, ...) over a cache (B, S, ...), every row attended: one
    tensor (the MLA latent cache) or a tuple of them split alike (GQA's
    (k, v)). On plain tensors it is that one call.

    On a DTensor cache (decode_state_shardings' layout: the batch over the
    data dims where it divides, the SEQUENCE over `model`, or over the
    whole mesh where the batch is one row) it is the paper's ROUTE at the
    scale of one model: the query moves, the cache stays. Each rank takes
    its own cache rows and the query rows of its batch shard with every
    head (q replicated over the sequence's mesh dims), attends them with
    attend on local tensors, and the ranks' partials (o, m, l), packed
    into one f32 tensor, are gathered over the sequence's mesh dims (one
    functional all-gather a dim, the op DTensor issues, which the dry
    run's step costs count) and merged with merge (o (M, B, ..., d_v), m,
    l (M, B, ...)), M the ranks that split the sequence. Every rank holds
    the merged result, a DTensor over the batch's mesh dims. The rows'
    global offset does not enter: every row is attended, written or not
    (ROADMAP C.1), and an exact merge does not depend on which rank holds
    which rows."""
    from torch.distributed.tensor import DTensor
    members = cache if isinstance(cache, tuple) else (cache,)
    if not isinstance(members[0], DTensor):
        return attend(q, cache)
    mesh = members[0].device_mesh
    pl = _batch_placements(members[0])
    seq_dims, _, _ = _seq_shard(members[0], 1)
    local = tuple(c.to_local() for c in members)
    part = attend(q.redistribute(mesh, pl).to_local().contiguous(),
                  local if isinstance(cache, tuple) else local[0])
    return _merged_partials(merge, part, mesh, seq_dims, pl)


def _gather_seq(buf, mesh, seq_dims):
    """buf (...) of every rank that splits the sequence over seq_dims,
    stacked (M, ...) in the order of the ranks' sequence offsets: one
    functional all-gather a mesh dim, the minor dim first."""
    buf = buf[None]
    c10d = torch.ops._c10d_functional
    for i in reversed(seq_dims):
        grp = mesh.get_group(i)
        buf = c10d.wait_tensor(c10d.all_gather_into_tensor(
            buf.contiguous(), grp.size(), grp.group_name))
    return buf


def _merged_partials(merge, part, mesh, seq_dims, pl):
    """This rank's Partial merged with those of the other ranks that split
    the sequence (their (o, m, l) packed into one f32 tensor, gathered and
    merged with merge), each leaf a DTensor laid out as pl."""
    from torch.distributed.tensor import DTensor
    if seq_dims:
        d_v = part.o.shape[-1]
        buf = _gather_seq(torch.cat([part.o, part.m[..., None],
                                     part.l[..., None]], dim=-1),
                          mesh, seq_dims)
        part = merge(buf[..., :d_v].contiguous(), buf[..., d_v].contiguous(),
                     buf[..., d_v + 1].contiguous())
    return type(part)(*(DTensor.from_local(t, mesh, pl, run_check=False)
                        for t in part))


def top_k_lowest_first(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis, ties broken
    toward the lower index (as lax.top_k breaks them)."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def shard_candidates(scores: torch.Tensor, k: int, off: int):
    """A sequence shard's candidates for a global top-k: its top min(k, n)
    scores (B, n) and their global ids off + i (int64), ordered by score
    descending, then id ascending. Every member of the global top-k is
    among its own shard's candidates under that order."""
    idx = top_k_lowest_first(scores, k)
    return scores.gather(-1, idx), idx + off


def choose_candidates(values: torch.Tensor, ids: torch.Tensor,
                      k: int) -> torch.Tensor:
    """The global ids (B, k) of the k best candidates (B, C) of all the
    shards: score descending, ties to the lower global id; equal to
    top_k_lowest_first over the whole score vector."""
    by_id = torch.argsort(ids, dim=-1)               # ids are distinct
    values, ids = values.gather(-1, by_id), ids.gather(-1, by_id)
    return ids.gather(-1, top_k_lowest_first(values, k))


def global_top_k(scores, k: int, mesh=None, seq_dims=(), off: int = 0):
    """top_k_lowest_first(scores, k) as global ids (int64). With seq_dims
    (mesh dims that split the sequence, this rank's rows starting at off)
    scores are this rank's (B, n) and the result the top k over every
    rank's, the same on each: each rank's candidates (shard_candidates),
    their scores' bits and ids packed into one integer tensor (the ids
    exact, never in a float), one all-gather over seq_dims, then
    choose_candidates."""
    if not seq_dims:
        return top_k_lowest_first(scores, k)
    values, ids = shard_candidates(scores, k, off)
    wide = values.dtype == torch.float64
    fdt, idt = ((torch.float64, torch.int64) if wide
                else (torch.float32, torch.int32))
    buf = _gather_seq(torch.stack([values.to(fdt).view(idt), ids.to(idt)]),
                      mesh, seq_dims)                # (M, 2, B, c)
    flat = lambda t: t.permute(1, 0, 2).reshape(t.shape[1], -1)
    return choose_candidates(flat(buf[:, 0].contiguous().view(fdt)),
                             flat(buf[:, 1]).to(torch.int64), k)


def local_seq_selected(select, merge, q, qi, cache, k: int):
    """Selection decode (the DSA regime, §5.4): qi (B, 1, dc), the
    mean-head query, scores every cache (B, S, D) row by its first dc
    columns, in the cache's dtype; select(q, cache, ids (B, k) int32, kb)
    -> Partial attends the rows of the top k (global_top_k), kb (B,) int32
    the count of ids that hold (None: all). On plain tensors that is the
    one call, kb None.

    On a DTensor cache laid out as local_seq_partials takes it, the query
    moves and the cache stays: each rank scores its own rows, the global
    top k is chosen from every rank's candidates (global_top_k), each rank
    attends the chosen rows it holds, in score order at their local index
    (kb = their count, 0 where it holds none: the merge identity), and the
    partials merge across the ranks as local_seq_partials merges them."""
    from torch.distributed.tensor import DTensor
    dc = qi.shape[-1]
    if not isinstance(cache, DTensor):
        scores = torch.einsum("bqc,bsc->bqs", qi, cache[..., :dc])[:, 0]
        sel = global_top_k(scores, k)
        return select(q, cache, sel.to(torch.int32).contiguous(), None)
    mesh = cache.device_mesh
    pl = _batch_placements(cache)
    seq_dims, off, n = _seq_shard(cache, 1)
    local = cache.to_local()
    qil = qi.redistribute(mesh, pl).to_local()
    scores = torch.einsum("bqc,bsc->bqs", qil, local[..., :dc])[:, 0]
    sel = global_top_k(scores, k, mesh, seq_dims, off)
    mine = (sel >= off) & (sel < off + n)
    order = torch.sort((~mine).to(torch.int8), dim=-1, stable=True).indices
    held = mine.gather(-1, order)
    ids = torch.where(held, sel.gather(-1, order) - off, 0)
    part = select(q.redistribute(mesh, pl).to_local().contiguous(), local,
                  ids.to(torch.int32).contiguous(),
                  held.sum(-1).to(torch.int32).contiguous())
    return _merged_partials(merge, part, mesh, seq_dims, pl)


def write_seq_row(cache, widx: int, entry) -> None:
    """cache[:, widx] = entry for a cache (B, S, ...) and its new entry (B,
    ...), in place. On a DTensor cache sharded over the sequence only the
    ranks that hold row widx write it, at their local index; every rank
    first takes the entry's rows of its batch shard (a collective where
    the entry's layout differs, so every rank takes part)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(cache, DTensor):
        cache[:, widx] = entry
        return
    rows = entry.redistribute(cache.device_mesh,
                              _batch_placements(cache)).to_local()
    _, off, n = _seq_shard(cache, 1)
    if off <= widx < off + n:
        cache.to_local()[:, widx - off] = rows


def copy_seq_prefix(dst, src, seq_dim: int) -> None:
    """dst's first src.shape[seq_dim] positions along seq_dim = src, in
    place. On a DTensor dst sharded over that dim each rank copies the
    positions its own rows cover from its copy of src, laid out as dst's
    batch and whole over the sequence: the layout prefill's caches come
    in (the block input's sequence is gathered before the projections), so
    nothing moves between ranks and no rank holds more of dst than its
    own rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dims, off, n = _seq_shard(dst, seq_dim) if isinstance(dst, DTensor) \
        else ((), 0, 0)
    if not dims:
        dst.narrow(seq_dim, 0, src.shape[seq_dim]).copy_(src)
        return
    pl = [Replicate() if p == Shard(seq_dim) else p for p in dst.placements]
    local = src.redistribute(dst.device_mesh, pl).to_local()
    hi = min(off + n, src.shape[seq_dim])
    if hi > off:
        dst.to_local().narrow(seq_dim, 0, hi - off).copy_(
            local.narrow(seq_dim, off, hi - off))


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local_product(fn, x, w):
    """fn(x, w) for a (B, ...) activation x and a weight w whose heads the
    divisibility fallback replicated (40 or 8 heads on a 16-wide model
    axis), on local tensors: x's batch over the data dims where it divides,
    w gathered whole; the result a DTensor laid out as x's batch, whole on
    every other dim (the heads repeat on `model`, as the weight's do).
    DTensor's own product splits the flat H * D dim over `model`, in the
    forward or in the gradient of w, and then refuses the view to (H, D)
    that would split a shard unevenly (GSPMD pads it instead)."""
    from torch.distributed.tensor import DTensor
    mesh = w.device_mesh
    dp = _fsdp_axes(mesh)
    spec = (dp_entry(mesh) if splits(x.shape[0], mesh, dp) else None,)
    xl, wl = local_inputs(mesh, [(x, spec), (w, ())])
    return DTensor.from_local(fn(xl, wl), mesh, placements(spec, mesh),
                              run_check=False)


def divides_model(w, n: int) -> bool:
    """False for a DTensor w on a mesh whose `model` axis does not divide
    n (w's heads or vocab kept whole there by the fallback); else True."""
    if not is_dtensor(w):
        return True
    return n % axis_sizes(w.device_mesh).get("model", 1) == 0


class _OwnLayoutGrad(torch.autograd.Function):
    """The identity on a DTensor, its gradient brought to the DTensor's own
    placements (a partial sum reduced)."""

    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements)


def grad_on_own_layout(t):
    """t, whose gradient comes back on t's own placements: a parameter
    used twice (the tied embedding table, its rows looked up on local
    tensors and its transpose in the head's product) then gets two
    gradients in one layout, which torch 2.11's DTensor needs to add them
    (it cannot take the head's shard to the lookup's partial sum)."""
    return _OwnLayoutGrad.apply(t)


def fit_spec(spec: Spec, shape: Sequence[int], mesh) -> Spec:
    """spec with every entry whose mesh axes do not divide its dim dropped
    (None), the divisibility fallback of spec_for applied to an
    activation's spec (a microbatch of 16 rows on a 32-wide data axis)."""
    out = [e if e is None or shape[d] % _axis_size(
        mesh, e if isinstance(e, tuple) else (e,)) == 0 else None
        for d, e in enumerate(spec)]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def vocab_parallel_embedding(table, tokens):
    """table[tokens] for a DTensor table (V, D), vocab-parallel (Megatron's
    row-parallel embedding) on local tensors: the table's rows over
    `model` (where V divides) and whole over the data dims, the tokens over
    the data dims (where the batch divides); each rank looks up the tokens
    its rows hold (zero elsewhere) and one all-reduce over `model` sums
    them. The result is (B, ..., D), batch over the data dims. DTensor's
    own lookup leaves a masked partial sum that its 2.13 reduction and its
    2.11 backward (an index_put) do not take on a two-dim mesh."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = table.device_mesh
    sizes = axis_sizes(mesh)
    dp = _fsdp_axes(mesh)
    b_entry = dp_entry(mesh) if splits(tokens.shape[0], mesh, dp) else None
    v_split = "model" in sizes and table.shape[0] % sizes["model"] == 0
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tab, tok = local_inputs(mesh, [
        (table, ("model" if v_split else None,)),
        (tokens, (b_entry,) + (None,) * (tokens.ndim - 1))])
    off = mesh.get_local_rank("model") * tab.shape[0] if v_split else 0
    mine = (tok >= off) & (tok < off + tab.shape[0])
    rows = tab[torch.where(mine, tok - off, 0)] * mine[..., None]
    spec = (b_entry,) + (None,) * tokens.ndim
    out = DTensor.from_local(rows, mesh, [
        Partial() if v_split and a == "model" else p
        for a, p in zip(sizes, placements(spec, mesh))], run_check=False)
    return out.redistribute(mesh, placements(spec, mesh))
