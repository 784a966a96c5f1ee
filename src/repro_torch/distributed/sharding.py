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

from repro_torch.models.module import param_axes

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
    if dp and shape[batch_dim] % _axis_size(mesh, dp) == 0:
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


def local_heads(fn, args: Sequence, heads: Sequence[Optional[int]]):
    """fn(*args) for an attention core whose args are (B, ...) tensors,
    arg i with its head dim heads[i] (None: no head dim), and whose result
    is (B, S, H, ...). On DTensors it runs on local tensors: the batch
    over the data dims and the heads over `model`, each where it divides
    (else that dim repeats the block); the result a DTensor laid out so.
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
    b_entry = dp_entry(mesh) if dp and \
        args[0].shape[0] % _axis_size(mesh, dp) == 0 else None
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
    return DTensor.from_local(out, mesh, placements(spec(out.ndim, 2), mesh),
                              run_check=False)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


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
    b_entry = dp_entry(mesh) if dp and \
        tokens.shape[0] % _axis_size(mesh, dp) == 0 else None
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
