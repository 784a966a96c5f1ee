"""Mixture-of-Experts: token-choice top-k router, shared + routed experts
(DeepSeek-V2 geometry), in one process.

The dispatch is the reference's capacity-grouped sort (MaxText-style): the
(token, k) pairs are stable-sorted by expert, each pair's rank within its
expert group is its slot, and pairs past the expert's capacity are dropped —
the same pairs as the reference drops, so a prefill in which one expert is
over 1.25x its average load, or a decode in which two tokens pick the same
expert at capacity 1, gives the reference's result. The expert-parallel
shard_map form (ep_axis) comes with the distribution substrate.

Under autograd the gradient flows as the reference's: through a kept pair's
gather into its expert slot and its weighted write-back (to the token, the
expert weights and the router's top-k weight), and through the aux term's
mean router probabilities. A dropped pair is never written, so it gets no
gradient, as the reference's trash row gets none.
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
    mk = lambda shape, dt=dtype: param(shape, gen, dtype=dt, device=device)
    p = {"router": mk((dm, e), cfg.router_dtype),
         "gate": mk((e, dm, dff)), "up": mk((e, dm, dff)),
         "down": mk((e, dff, dm))}
    if cfg.n_shared:
        s = cfg.n_shared
        p["sh_gate"] = mk((dm, s * dff))
        p["sh_up"] = mk((dm, s * dff))
        p["sh_down"] = mk((s * dff, dm))
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


def moe_apply(p, cfg: MoEConfig, x: torch.Tensor, routes=None, *,
              pinned=None):
    """x (..., d) -> ((..., d), aux load-balance term). When `routes` is a
    list, the top-k indices (T, k) are appended to it. `pinned` (T, k)
    takes the place of the router's top-k choice (each pair weighted by the
    router's own probabilities, renormalised): how a check holds two forms
    of the model on the same routes, where a near-tie would flip one."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    T = xt.shape[0]
    idx, w, probs = _router(p, cfg, xt, pinned)
    if routes is not None:
        routes.append(idx)
    capacity = int(max(1, cfg.capacity_factor * T * cfg.top_k
                       // max(1, cfg.n_experts)))
    st, se, slot, kept, order = dispatch_slots(idx, cfg.n_experts, capacity)
    st, se, slot = st[kept], se[kept], slot[kept]
    sw = w.reshape(-1)[order][kept]
    buf = torch.zeros((cfg.n_experts, capacity, shape[-1]), dtype=x.dtype,
                      device=x.device)
    buf[se, slot] = xt[st]
    out_ecd = _expert_ffn(p["gate"], p["up"], p["down"], buf)
    # each kept pair's weighted output at its (token, k) place, then the sum
    # over k: a fixed order, where a scatter-add on the card is not
    contrib = torch.zeros((T * cfg.top_k, shape[-1]), dtype=x.dtype,
                          device=x.device)
    contrib[order[kept]] = (out_ecd[se, slot] * sw[:, None]).to(x.dtype)
    y = contrib.reshape(T, cfg.top_k, shape[-1]).sum(dim=1)
    if cfg.n_shared:
        h = F.silu(xt @ p["sh_gate"]) * (xt @ p["sh_up"])
        y = y + (h @ p["sh_down"]).to(y.dtype)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(idx[:, 0], cfg.n_experts).to(probs.dtype),
                    dim=0)
    aux = cfg.n_experts * torch.sum(me * ce)
    return y.reshape(shape), aux
