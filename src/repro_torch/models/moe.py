"""Mixture-of-Experts: token-choice top-k router, shared + routed experts
(DeepSeek-V2 geometry), with the reference's expert-parallel form.

The dispatch is the reference's capacity-grouped sort (MaxText-style): the
(token, k) pairs are stable-sorted by expert, each pair's rank within its
expert group is its slot, and pairs past the expert's capacity are dropped —
the same pairs as the reference drops, so a prefill in which one expert is
over 1.25x its average load, or a decode in which two tokens pick the same
expert at capacity 1, gives the reference's result. Every shape is fixed by
(T, k, capacity) alone, as in the reference's _dispatch_compute: a pair that
is not kept (past capacity, or, in the expert-parallel form, an expert
another shard holds) goes to a trash row of the expert buffer and comes
back multiplied by 0. So the dispatch runs under FakeTensorMode (the dry
run) and traces without a host sync. The combine over k stays a fixed-order
sum of each pair's weighted output at its (token, k) place, where the
reference scatter-adds (a scatter-add on the card has no fixed order).

EP (ep_axis, the reference's shard_map form): activations are replicated
over the `model` (expert) mesh dim inside a data shard, so each expert
shard filters the pairs routed to its resident experts, computes them at
capacity, writes them back weighted, and a single all-reduce over the
expert dim combines the contributions (and the shared FFN's, whose width
is sharded over the same dim). No global sort, no all-to-all of
activations. models/model.py runs this form on local tensors under a
sharding policy (DTensor has no sharding rule for argsort or
searchsorted).

Under autograd the gradient flows as the reference's: through a kept pair's
gather into its expert slot and its weighted write-back (to the token, the
expert weights and the router's top-k weight), and through the aux term's
mean router probabilities. A pair that is not kept is multiplied by 0, so
it gets a zero gradient, as the reference's trash row does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.module import param


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_expert: int                  # per-expert FFN width (e.g. 1536)
    n_experts: int                 # routed experts
    top_k: int
    n_shared: int = 0              # always-on shared experts (DeepSeek)
    capacity_factor: float = 1.25
    router_dtype = torch.float32


def init_moe(gen, cfg: MoEConfig, *, dtype, device):
    """Router (f32), stacked routed experts (E, ...), shared experts of
    width n_shared * d_expert; drawn in the reference's order."""
    e, dm, dff = cfg.n_experts, cfg.d_model, cfg.d_expert
    mk = lambda shape, axes, dt=dtype: param(shape, gen, dtype=dt,
                                             device=device, axes=axes)
    p = {"router": mk((dm, e), ("embed", None), cfg.router_dtype),
         "gate": mk((e, dm, dff), ("expert", "embed", None)),
         "up": mk((e, dm, dff), ("expert", "embed", None)),
         "down": mk((e, dff, dm), ("expert", None, "embed"))}
    if cfg.n_shared:
        s = cfg.n_shared
        p["sh_gate"] = mk((dm, s * dff), ("embed", "mlp"))
        p["sh_up"] = mk((dm, s * dff), ("embed", "mlp"))
        p["sh_down"] = mk((s * dff, dm), ("mlp", "embed"))
    return p


def _router(p, cfg: MoEConfig, x, idx=None):
    """x (T, d) -> (indices (T, k), weights (T, k) in x.dtype, probs (T, E)
    in the router's dtype, cfg.router_dtype as initialised): softmax, then
    top-k (or the given indices), then renormalised (DeepSeek-V2 style)."""
    logits = x.to(p["router"].dtype) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    if idx is None:
        w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    else:
        w = torch.gather(probs, -1, idx)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return idx, w.to(x.dtype), probs


def _expert_ffn(gate, up, down, x_ecd):
    """x (E, cap, d) through the stacked SwiGLU experts."""
    g = torch.einsum("ecd,edf->ecf", x_ecd, gate)
    u = torch.einsum("ecd,edf->ecf", x_ecd, up)
    return torch.einsum("ecf,efd->ecd", F.silu(g) * u, down)


def dispatch_slots(idx: torch.Tensor, n_experts: int, capacity: int):
    """The capacity-grouped dispatch of (T, k) expert choices: the pairs
    stable-sorted by expert, as (token, expert, slot, kept, order). slot is
    a pair's rank within its expert; pairs at or past `capacity` are not
    kept. order indexes the flattened (T * k) pairs."""
    T, k = idx.shape
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // k                            # token of each sorted pair
    group_start = torch.searchsorted(
        se, torch.arange(n_experts, device=idx.device, dtype=se.dtype))
    slot = torch.arange(T * k, device=idx.device) - group_start[se]
    return st, se, slot, slot < capacity, order


@dataclasses.dataclass(frozen=True)
class ExpertAxis:
    """The expert-parallel mesh dim of a DeviceMesh (ep_axis): this shard
    holds experts [rank * n_local, (rank + 1) * n_local) of the stack, and
    the routed and shared outputs are summed over the dim's ranks."""
    mesh: object
    name: str = "model"

    def rank(self) -> int:
        return self.mesh.get_local_rank(self.name)

    def psum(self, y: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) of y over the expert dim; its gradient passes
        through (y is a partial sum whose total every rank uses)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        names = list(self.mesh.mesh_dim_names)
        part = [Partial() if n == self.name else Replicate() for n in names]
        dt = DTensor.from_local(y, self.mesh, part, run_check=False)
        return dt.redistribute(self.mesh, [Replicate()] * len(names)) \
            .to_local()


def _dispatch_compute(p, cfg: MoEConfig, x, idx, w, e_lo: int,
                      capacity: int):
    """Capacity-grouped dispatch for the resident experts p["gate"/"up"/
    "down"] (E_local, ...), global ids from e_lo. x (T, d); idx/w (T, k).
    Returns the weighted contribution (T, d): each pair's expert output
    times its weight (times 0 unless kept), summed over k in order."""
    n_local = p["gate"].shape[0]
    T, k = idx.shape
    st, se, slot, kept, order = dispatch_slots(idx, cfg.n_experts, capacity)
    local = (se >= e_lo) & (se < e_lo + n_local) & kept
    e_local = torch.where(local, se - e_lo, n_local)    # n_local = trash row
    c_local = torch.where(local, slot, 0)
    buf = torch.zeros((n_local + 1, capacity, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    buf[e_local, c_local] = torch.where(local[:, None], x[st], 0.0)
    out_ecd = _expert_ffn(p["gate"], p["up"], p["down"], buf[:n_local])
    sw = w.reshape(-1)[order] * local
    out = out_ecd[torch.where(local, e_local, 0), c_local] * sw[:, None]
    # each pair's weighted output at its (token, k) place, then the sum
    # over k: a fixed order, where a scatter-add on the card is not
    contrib = torch.zeros((T * k, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    contrib[order] = out.to(x.dtype)
    return contrib.reshape(T, k, x.shape[-1]).sum(dim=1)


def moe_apply(p, cfg: MoEConfig, x: torch.Tensor, routes=None, *,
              pinned=None, ep_axis: ExpertAxis = None):
    """x (..., d) -> ((..., d), aux load-balance term). When `routes` is a
    list, the top-k indices (T, k) are appended to it. `pinned` (T, k)
    takes the place of the router's top-k choice (each pair weighted by the
    router's own probabilities, renormalised): how a check holds two forms
    of the model on the same routes, where a near-tie would flip one.

    ep_axis: on local tensors of one shard (p's expert stacks and shared
    FFN width sharded over that mesh dim, x replicated over it), the
    shard's resident experts' contribution, summed over the dim."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    T = xt.shape[0]
    idx, w, probs = _router(p, cfg, xt, pinned)
    if routes is not None:
        routes.append(idx)
    capacity = int(max(1, cfg.capacity_factor * T * cfg.top_k
                       // max(1, cfg.n_experts)))
    e_lo = 0 if ep_axis is None else ep_axis.rank() * p["gate"].shape[0]
    y = _dispatch_compute(p, cfg, xt, idx, w, e_lo, capacity)
    if cfg.n_shared:
        # under ep_axis the shared FFN's width is sharded over the same
        # dim: its partial joins the routed sum (one collective)
        h = F.silu(xt @ p["sh_gate"]) * (xt @ p["sh_up"])
        y = y + (h @ p["sh_down"]).to(y.dtype)
    if ep_axis is not None:
        y = ep_axis.psum(y)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(idx[:, 0], cfg.n_experts).to(probs.dtype),
                    dim=0)
    aux = cfg.n_experts * torch.sum(me * ce)
    return y.reshape(shape), aux
