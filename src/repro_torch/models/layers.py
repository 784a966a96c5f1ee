"""Shared layers: norms, dense and MLPs (SwiGLU / squared-ReLU / GELU), the
tied embedding, RoPE. Each init_* returns a dict of tensors for
module.Tree; the apply functions index it as the reference's value trees.

Norms and RoPE compute in f32 from narrower inputs, as the reference does,
and in f64 from f64 inputs (compute_dtype): an f64 model is then f64 end to
end, which is how the card checks the f32 train form against it.

RoPE uses the NeoX half-split pairing. rope(p + delta) = R(delta) . rope(p)
per frequency pair — the composition property the FETCH delta-rotation
splice (paper §2.2) relies on.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.sharding import (divides_model,
                                              grad_on_own_layout, is_dtensor,
                                              local_product,
                                              vocab_parallel_embedding)
from repro_torch.models.module import ones, param, zeros


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the computations the reference runs in f32: f32 for f32
    and narrower floats, f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, *, dtype, device):
    return {"scale": ones((d,), dtype=dtype, device=device, axes=("embed",))}


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt, ct = x.dtype, compute_dtype(x.dtype)
    x = x.to(ct)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.to(ct)).to(dt)


def init_layernorm(d: int, *, dtype, device):
    return {"scale": ones((d,), dtype=dtype, device=device, axes=("embed",)),
            "bias": zeros((d,), dtype=dtype, device=device, axes=("embed",))}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt, ct = x.dtype, compute_dtype(x.dtype)
    x = x.to(ct)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    out = x * p["scale"].to(ct) + p["bias"].to(ct)
    return out.to(dt)


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------

def init_dense(gen, d_in: int, d_out: int, axes, *, bias: bool = False,
               dtype, device):
    """w (d_in, d_out) on the logical axes `axes`; b (d_out,) on axes[1]."""
    p = {"w": param((d_in, d_out), gen, dtype=dtype, device=device,
                    axes=axes)}
    if bias:
        p["b"] = zeros((d_out,), dtype=dtype, device=device, axes=axes[1:])
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., M) through a head projection w (M, H, D) -> (..., H, D): one
    product over (M, H * D), the einsum "...m,mhd->...hd". Written with the
    head dim outermost in every flattened pair, so a DTensor sharded over
    the heads keeps its layout through the views. Where the heads do not
    divide the model axis (the weight whole there), it runs on local
    tensors (sharding.local_product): the output's batch over the data
    axes, its heads whole on every rank of `model`."""
    def fn(x, w):
        return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])
    return fn(x, w) if divides_model(w, w.shape[1]) else \
        local_product(fn, x, w)


def merge_heads(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """o (..., H, D) through an output projection w (H, D, M) -> (..., M):
    one product over (H * D, M), the einsum "...hd,hdm->...m" (see
    project_heads, also for heads that do not divide the model axis)."""
    def fn(o, w):
        return o.flatten(-2) @ w.flatten(0, 1)
    return fn(o, w) if divides_model(w, w.shape[0]) else \
        local_product(fn, o, w)


def init_mlp(gen, d_model: int, d_ff: int, kind: str = "swiglu", *, dtype,
             device):
    """kind: swiglu (gate+up+down) | squared_relu (up+down) | gelu (up+down,
    with biases). Drawn in the reference's order: gate, up, down."""
    p = {}
    if kind == "swiglu":
        p["gate"] = init_dense(gen, d_model, d_ff, ("embed", "mlp"),
                               dtype=dtype, device=device)
        p["up"] = init_dense(gen, d_model, d_ff, ("embed", "mlp"),
                             dtype=dtype, device=device)
    else:
        p["up"] = init_dense(gen, d_model, d_ff, ("embed", "mlp"),
                             bias=(kind == "gelu"), dtype=dtype,
                             device=device)
    p["down"] = init_dense(gen, d_ff, d_model, ("mlp", "embed"),
                           bias=(kind == "gelu"), dtype=dtype, device=device)
    return p


def mlp(p, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    if kind == "swiglu":
        h = torch.nn.functional.silu(dense(p["gate"], x)) * dense(p["up"], x)
    elif kind == "squared_relu":
        h = torch.square(torch.relu(dense(p["up"], x)))
    elif kind == "gelu":
        h = torch.nn.functional.gelu(dense(p["up"], x), approximate="tanh")
    else:
        raise ValueError(kind)
    return dense(p["down"], h)


# ---------------------------------------------------------------------------
# Embedding (tied head)
# ---------------------------------------------------------------------------

def init_embed(gen, vocab: int, d_model: int, *, dtype, device):
    return {"table": param((vocab, d_model), gen, dtype=dtype, device=device,
                           scale=1.0, axes=("vocab", "embed"))}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows at tokens; a DTensor table's vocab-parallel
    (distributed.sharding.vocab_parallel_embedding)."""
    if is_dtensor(p["table"]):
        return vocab_parallel_embedding(p["table"], tokens)
    return p["table"][tokens]


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Tied head: the table is unit-scale for the input lookup, so the head
    side is scaled 1/sqrt(d) to keep initial logits O(1). A DTensor table
    whose vocab the model axis does not divide (kept whole there) takes
    its gradient here on its own placements, as the lookup's comes
    (sharding.grad_on_own_layout)."""
    d = x.shape[-1]
    table = p["table"]
    if not divides_model(table, table.shape[0]):
        table = grad_on_own_layout(table)
    return (x @ table.T) * (1.0 / np.sqrt(d))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0, dtype=torch.float32):
    """positions (...,) -> cos/sin (..., head_dim/2) in dtype (f32 unless
    an f64 model asks for f64)."""
    freqs = torch.tensor(rope_freqs(head_dim, theta), dtype=dtype,
                         device=positions.device)
    ang = positions.to(dtype)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., head_dim); cos/sin broadcastable (..., head_dim/2)."""
    d2 = x.shape[-1] // 2
    ct = torch.promote_types(compute_dtype(x.dtype), cos.dtype)
    xf1 = x[..., :d2].to(ct)
    xf2 = x[..., d2:].to(ct)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def delta_rotate(x: torch.Tensor, delta, head_dim: int,
                 theta: float = 10000.0) -> torch.Tensor:
    """Re-home a RoPE-encoded band from cached position p to p + delta: a
    purely positional rotation, independent of the token's own position."""
    cos, sin = rope_cos_sin(torch.as_tensor(delta, device=x.device),
                            head_dim, theta)
    return apply_rope(x, cos, sin)
