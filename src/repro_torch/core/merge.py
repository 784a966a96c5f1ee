"""Online-softmax partial-attention merge (paper §3.2, §3.3), in torch.

A *partial* is the triple (o, m, l):
    o : the holder's normalized attention output over its resident subset,
        shape (..., d_v)
    m : running max-logit, shape (...)
    l : softmax denominator sum(exp(logit - m)), shape (...)

The merge is exact (associative + commutative up to float round-off) and has
a zero-weight identity (l = 0, m = -inf), which is what makes multi-holder
fan-out partition-invariant (§3.3). These are the plain versions; the
kernels/softmax_merge CUDA kernel computes merge_stacked on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch


NEG_INF = float("-inf")


class Partial(NamedTuple):
    o: torch.Tensor      # (..., d_v) normalized partial output
    m: torch.Tensor      # (...,) running max logit
    l: torch.Tensor      # (...,) softmax denominator at m

    @staticmethod
    def identity(shape: tuple, d_v: int, dtype=torch.float32,
                 device=None) -> "Partial":
        """The zero-weight identity: merging it is a no-op."""
        shape = tuple(shape)
        return Partial(
            o=torch.zeros(shape + (d_v,), dtype=dtype, device=device),
            m=torch.full(shape, NEG_INF, dtype=dtype, device=device),
            l=torch.zeros(shape, dtype=dtype, device=device),
        )


def _finite_or_zero(m: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def merge2(a: Partial, b: Partial) -> Partial:
    """Merge two partials exactly.

    Guards: if both are identity (m = -inf), the result is identity without
    producing NaNs from (-inf) - (-inf)."""
    m = torch.maximum(a.m, b.m)
    m_safe = _finite_or_zero(m)
    wa = a.l * torch.exp(a.m - m_safe)
    wb = b.l * torch.exp(b.m - m_safe)
    l = wa + wb
    denom = torch.where(l > 0, l, torch.ones_like(l))
    o = (wa[..., None] * a.o + wb[..., None] * b.o) / denom[..., None]
    return Partial(o=o, m=torch.where(l > 0, m, torch.full_like(m, NEG_INF)),
                   l=l)


def merge_tree(partials: Sequence[Partial]) -> Partial:
    """M-way merge as a balanced tree (associativity makes any shape exact to
    round-off)."""
    ps = list(partials)
    if not ps:
        raise ValueError("merge_tree needs at least one partial")
    while len(ps) > 1:
        nxt = [merge2(ps[i], ps[i + 1]) for i in range(0, len(ps) - 1, 2)]
        if len(ps) % 2:
            nxt.append(ps[-1])
        ps = nxt
    return ps[0]


def merge_stacked(o: torch.Tensor, m: torch.Tensor,
                  l: torch.Tensor) -> Partial:
    """Merge M stacked partials: o (M, ..., d_v), m/l (M, ...).

    Single-pass fused form (what the softmax_merge kernel computes):
        m* = max_i m_i ;  w_i = l_i exp(m_i - m*) ;
        o* = sum_i w_i o_i / sum_i w_i
    """
    m_star = torch.amax(m, dim=0)
    safe_m = _finite_or_zero(m_star)
    w = l * torch.exp(m - safe_m[None])        # exp(-inf) = 0 covers identity
    l_star = torch.sum(w, dim=0)
    denom = torch.where(l_star > 0, l_star, torch.ones_like(l_star))
    o_star = torch.sum((w / denom[None])[..., None] * o, dim=0)
    return Partial(o=o_star,
                   m=torch.where(l_star > 0, m_star,
                                 torch.full_like(m_star, NEG_INF)),
                   l=l_star)


def partial_from_logits(logits: torch.Tensor, values: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> Partial:
    """Reference construction of a partial from raw attention logits over a
    resident subset: logits (..., S); values (..., S, d_v) per logit row, or
    shared by the trailing query axis ((S, d_v), or (B, S, d_v) for logits
    (B, R, S))."""
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    if logits.shape[-1] == 0:                 # empty resident set: identity
        m = torch.full(logits.shape[:-1], NEG_INF, dtype=torch.float32,
                       device=logits.device)
    else:
        m = torch.amax(logits, dim=-1)
    safe_m = _finite_or_zero(m)
    p = torch.exp(logits - safe_m[..., None])
    p = torch.where(torch.isfinite(logits), p, torch.zeros_like(p))
    l = torch.sum(p, dim=-1)
    denom = torch.where(l > 0, l, torch.ones_like(l))
    p = p / denom[..., None]
    values = values.to(torch.float32)
    if values.ndim == logits.ndim + 1:        # values per logit row
        o = torch.matmul(p.unsqueeze(-2), values).squeeze(-2)
    else:                                     # shared by the query rows
        o = torch.matmul(p, values)
    return Partial(o=o, m=m, l=l)
