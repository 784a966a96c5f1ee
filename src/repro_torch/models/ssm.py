"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) mixer.

Prefill form: the chunked SSD algorithm — the intra-chunk quadratic
("attention-like") term, through the ssd_chunk kernel on the card, plus the
inter-chunk recurrence over per-chunk states, a plain loop over chunks as in
the reference (which computes it outside its kernel too). O(S * Q) compute
for chunk size Q.

Train form: the same chunked algorithm with the intra-chunk term as the
reference's own inline einsums (ssd_intra_chunk_train, what its
ssd_chunked(use_kernel=False) computes), in plain PyTorch ops that autograd
differentiates; ssd_chunked takes it as its `intra` op.

Decode form: the O(1) recurrence  h_t = a_t h_{t-1} + dt_t * B_t x_t^T,
y_t = C_t h_t — the "cache" is a fixed-size state (H, hd, N) plus the last
d_conv - 1 conv inputs.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ssd_intra_chunk
from repro_torch.models import layers as L
from repro_torch.models.module import ones, param, tag, zeros


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 128          # N
    head_dim: int = 64          # P
    expand: int = 2
    d_conv: int = 4
    chunk: int = 64             # SSD chunk length Q

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def init_mamba2(gen, cfg: Mamba2Config, *, dtype, device):
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_heads
    # in_proj emits [z (di) | x (di) | B (n) | C (n) | dt (h)]
    f32 = torch.float32
    return {
        "in_proj": param((cfg.d_model, 2 * di + 2 * n + h), gen, dtype=dtype,
                         device=device, axes=("embed", "mlp")),
        "conv_w": param((cfg.d_conv, di + 2 * n), gen, dtype=dtype,
                        device=device, scale=0.5, axes=(None, "mlp")),
        "conv_b": zeros((di + 2 * n,), dtype=dtype, device=device,
                        axes=("mlp",)),
        "a_log": tag(torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                              device=device)), ("heads",)),
        "dt_bias": zeros((h,), dtype=f32, device=device, axes=("heads",)),
        "d_skip": ones((h,), dtype=f32, device=device, axes=("heads",)),
        "norm": L.init_rmsnorm(di, dtype=dtype, device=device),
        "out_proj": param((di, cfg.d_model), gen, dtype=dtype, device=device,
                          axes=("mlp", "embed")),
    }


def _split_proj(cfg: Mamba2Config, zxbcdt):
    di, n = cfg.d_inner, cfg.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    return z, xbc, dt


def _causal_conv(p, xbc, conv_state=None):
    """Depthwise causal conv over the sequence axis. xbc (B, S, C).
    conv_state (B, d_conv-1, C) carries the left context for decode."""
    w = p["conv_w"].to(torch.float32)                 # (K, C)
    K = w.shape[0]
    x = xbc.to(torch.float32)
    if conv_state is None:
        pad = torch.zeros_like(x[:, :K - 1])
    else:
        pad = conv_state.to(torch.float32)
    xp = torch.cat([pad, x], dim=1)                   # (B, S+K-1, C)
    out = w[0] * xp[:, 0:x.shape[1]]
    for i in range(1, K):
        out = out + w[i] * xp[:, i:i + x.shape[1]]
    out = F.silu(out + p["conv_b"].to(torch.float32))
    new_state = xp[:, -(K - 1):]
    return out.to(xbc.dtype), new_state.to(xbc.dtype)


def ssd_intra_chunk_train(x, dt, A, B, C):
    """The intra-chunk term in train form: x (b, nc, Q, H, P), dt (b, nc, Q,
    H), A (H,), B, C (b, nc, Q, N), f32 -> (y_intra (b, nc, Q, H, P),
    chunk states (b, nc, H, P, N), cum (b, nc, Q, H)).

        y_intra[t] = sum_{u<=t} C_t.B_u exp(cum_t - cum_u) dt_u x_u
        S_c = sum_u exp(seg - cum_u) dt_u B_u x_u^T

    The exponent is masked to -inf above the diagonal BEFORE exp: those
    entries are positive and overflow, and a mask applied after exp would
    leak NaN into the gradient."""
    Q = x.shape[2]
    cum = torch.cumsum(dt * A[None, None, None], dim=2)      # (b,nc,Q,h)
    expo = cum[:, :, :, None] - cum[:, :, None]              # (b,nc,Q,Q,h)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(expo.masked_fill(~causal[None, None, :, :, None],
                                      float("-inf")))
    G = torch.einsum("bcqn,bckn->bcqk", C, B)[..., None] * lmat
    y_intra = torch.einsum("bcqkh,bckh,bckhp->bcqhp", G, dt, x)
    decay_out = torch.exp(cum[:, :, -1:] - cum)              # (b,nc,Q,h)
    states = torch.einsum("bckh,bckh,bckn,bckhp->bchpn", decay_out, dt, B,
                          x)
    return y_intra, states, cum


def ssd_chunked(cfg: Mamba2Config, x, dt, A, B, C, h0=None, *,
                intra=ssd_intra_chunk):
    """Chunked SSD scan.

    x (b, s, h, p); dt (b, s, h) (post-softplus); A (h) negative decay;
    B, C (b, s, n). Returns (y (b, s, h, p), h_final (b, h, p, n)) in f32.

    intra is the intra-chunk op, (x, dt, A, B, C) over chunked f32 tensors
    -> (y_intra, chunk states, cum): the ssd_chunk kernel wrapper by
    default, its plain version, or the train form ssd_intra_chunk_train
    (the reference's use_kernel=False form, which training takes).
    """
    b, s, h, pdim = x.shape
    n = B.shape[-1]
    Q = cfg.chunk
    if s % Q:
        raise ValueError(f"ssd_chunked: sequence {s} is not a multiple of "
                         f"the chunk {Q}")
    nc = s // Q
    f32 = torch.float32
    xc = x.reshape(b, nc, Q, h, pdim).to(f32).contiguous()
    dtc = dt.reshape(b, nc, Q, h).to(f32).contiguous()
    Bc = B.reshape(b, nc, Q, n).to(f32).contiguous()
    Cc = C.reshape(b, nc, Q, n).to(f32).contiguous()
    y_intra, states, cum = intra(xc, dtc, A.to(f32).contiguous(), Bc, Cc)
    seg_sum = cum[:, :, -1]                                # (b, nc, h)

    # inter-chunk recurrence over chunk states; h_prefix is the state
    # BEFORE each chunk
    hprev = (torch.zeros((b, h, pdim, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    prefix = []
    for c in range(nc):
        prefix.append(hprev)
        hprev = hprev * torch.exp(seg_sum[:, c])[:, :, None, None] \
            + states[:, c]
    h_prefix = torch.stack(prefix, dim=1)                  # (b, nc, h, p, n)

    # inter-chunk contribution: y_inter[t] = C_t . (exp(cum_t) h_prefix)
    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cc, h_prefix,
                           torch.exp(cum))
    return (y_intra + y_inter).reshape(b, s, h, pdim), hprev


def mamba2_forward(p, cfg: Mamba2Config, x, h0=None, conv_state=None, *,
                   intra=ssd_intra_chunk):
    """Full-sequence form. x (B, S, D) -> (y (B, S, D), (h_final,
    conv_state)). The intra-chunk term runs through `intra` (the ssd_chunk
    kernel by default; the reference's own forward never takes its kernel)."""
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc, conv_state = _causal_conv(p, xbc, conv_state)
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_heads
    xs = xbc[..., :di].reshape(*x.shape[:2], h, cfg.head_dim)
    B = xbc[..., di:di + n]
    C = xbc[..., di + n:]
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    y, h_final = ssd_chunked(cfg, xs, dt, A, B, C, h0, intra=intra)
    y = y + p["d_skip"][None, None, :, None] * xs.to(torch.float32)
    y = y.reshape(*x.shape[:2], di).to(x.dtype)
    y = L.rmsnorm(p["norm"]["scale"], y * F.silu(z))
    return y @ p["out_proj"], (h_final, conv_state)


def mamba2_decode(p, cfg: Mamba2Config, x, state):
    """One-token recurrence. x (B, 1, D); state = (h (B,H,P,N), conv_state).
    Returns (y (B, 1, D), new state)."""
    h_prev, conv_state = state
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc, conv_state = _causal_conv(p, xbc, conv_state)
    di, n, hh = cfg.d_inner, cfg.d_state, cfg.n_heads
    f32 = torch.float32
    xs = xbc[..., :di].reshape(x.shape[0], 1, hh, cfg.head_dim)
    B = xbc[..., di:di + n]
    C = xbc[..., di + n:]
    dt = F.softplus(dt.to(f32) + p["dt_bias"])                   # (B,1,H)
    A = -torch.exp(p["a_log"])
    a_t = torch.exp(dt[:, 0] * A[None])                          # (B, H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], B[:, 0].to(f32),
                       xs[:, 0].to(f32))
    h_new = h_prev * a_t[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", C[:, 0].to(f32), h_new)
    y = y + p["d_skip"][None, :, None] * xs[:, 0].to(f32)
    y = y.reshape(x.shape[0], 1, di).to(x.dtype)
    y = L.rmsnorm(p["norm"]["scale"], y * F.silu(z))
    return y @ p["out_proj"], (h_new, conv_state)
