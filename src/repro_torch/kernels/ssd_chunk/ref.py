"""Plain PyTorch version of the fused SSD intra-chunk kernel (the Mamba2
prefill hot-spot): the quadratic ("attention-like") term within each chunk,
the per-chunk output state and the cumulative decay."""

from __future__ import annotations

import torch


def ssd_intra_chunk_ref(x, dt, A, B, C):
    """x (b, nc, Q, H, P); dt (b, nc, Q, H) post-softplus; A (H,) negative;
    B, C (b, nc, Q, N).

    Returns (y_intra (b,nc,Q,H,P), states (b,nc,H,P,N), cum (b,nc,Q,H)),
    all f32. The decay exponent is masked to -inf above the diagonal before
    exp: those entries are positive and would overflow."""
    f32 = torch.float32
    Q = x.shape[2]
    x, dt, B, C = x.to(f32), dt.to(f32), B.to(f32), C.to(f32)
    cum = torch.cumsum(dt * A.to(f32)[None, None, None], dim=2)
    expo = cum[:, :, :, None] - cum[:, :, None]             # (b,nc,Q,Q,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    expo = expo.masked_fill(~causal[None, None, :, :, None], float("-inf"))
    G = torch.einsum("bcqn,bckn->bcqk", C, B)[..., None] * torch.exp(expo)
    y = torch.einsum("bcqkh,bckh,bckhp->bcqhp", G, dt, x)
    decay_out = torch.exp(cum[:, :, -1:] - cum)              # (b,nc,Q,H)
    states = torch.einsum("bckh,bckh,bckn,bckhp->bchpn", decay_out, dt, B, x)
    return y, states, cum
