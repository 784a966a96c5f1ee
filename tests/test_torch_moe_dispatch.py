"""The MoE dispatch's fixed-size form (models/moe.py): every shape fixed by
(T, k, capacity), pairs not kept sent to a trash row and multiplied by 0.

* bit for bit the boolean-mask dispatch it replaced (kept below as
  _mask_moe_apply): outputs, aux and routes, f32 and bf16, on seeded
  inputs in which pairs run past capacity, with and without shared
  experts; the gradients too;
* it runs under FakeTensorMode and on the meta device (no host sync, no
  data-dependent shape)."""

import dataclasses

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.models import moe as MOE
from repro_torch.models.module import Tree

CFG = MOE.MoEConfig(d_model=24, d_expert=16, n_experts=8, top_k=2,
                    n_shared=1)


def _mask_moe_apply(p, cfg, x, routes=None):
    """The dispatch as it was before the fixed-size form: boolean masks
    select the kept pairs (shapes that depend on the data)."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    T = xt.shape[0]
    idx, w, probs = MOE._router(p, cfg, xt)
    if routes is not None:
        routes.append(idx)
    capacity = int(max(1, cfg.capacity_factor * T * cfg.top_k
                       // max(1, cfg.n_experts)))
    st, se, slot, kept, order = MOE.dispatch_slots(idx, cfg.n_experts,
                                                   capacity)
    st, se, slot = st[kept], se[kept], slot[kept]
    sw = w.reshape(-1)[order][kept]
    buf = torch.zeros((cfg.n_experts, capacity, shape[-1]), dtype=x.dtype)
    buf[se, slot] = xt[st]
    out_ecd = MOE._expert_ffn(p["gate"], p["up"], p["down"], buf)
    contrib = torch.zeros((T * cfg.top_k, shape[-1]), dtype=x.dtype)
    contrib[order[kept]] = (out_ecd[se, slot] * sw[:, None]).to(x.dtype)
    y = contrib.reshape(T, cfg.top_k, shape[-1]).sum(dim=1)
    if cfg.n_shared:
        h = F.silu(xt @ p["sh_gate"]) * (xt @ p["sh_up"])
        y = y + (h @ p["sh_down"]).to(y.dtype)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(idx[:, 0], cfg.n_experts).to(probs.dtype),
                    dim=0)
    return y.reshape(shape), cfg.n_experts * torch.sum(me * ce)


def _case(seed, dtype, n_shared):
    cfg = dataclasses.replace(CFG, n_shared=n_shared)
    g = torch.Generator().manual_seed(seed)
    p = MOE.init_moe(g, cfg, dtype=dtype, device="cpu")
    # a skewed router: a few experts take most pairs, past their capacity
    p["router"][:, :2] += 0.5
    x = torch.randn(3, 11, cfg.d_model, generator=g).to(dtype)
    return cfg, Tree(p), x


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fixed_size_dispatch_is_the_mask_dispatch_bit_for_bit(seed, dtype,
                                                               n_shared):
    cfg, p, x = _case(seed, dtype, n_shared)
    r_new, r_old = [], []
    y_new, aux_new = MOE.moe_apply(p, cfg, x, r_new)
    y_old, aux_old = _mask_moe_apply(p, cfg, x, r_old)
    T = x.shape[0] * x.shape[1]
    capacity = int(cfg.capacity_factor * T * cfg.top_k // cfg.n_experts)
    kept = MOE.dispatch_slots(r_new[0], cfg.n_experts, capacity)[3]
    assert not kept.all()                    # pairs past capacity
    assert torch.equal(r_new[0], r_old[0])
    assert torch.equal(y_new, y_old)
    assert torch.equal(aux_new, aux_old)


@pytest.mark.parametrize("seed", [0, 1])
def test_fixed_size_dispatch_gradients_equal_the_mask_dispatch(seed):
    cfg, p, x = _case(seed, torch.float32, 1)
    for t in p.parameters():
        t.requires_grad_(True)
    x.requires_grad_(True)
    leaves = [x] + list(p.parameters())
    grads = []
    for fn in (MOE.moe_apply, _mask_moe_apply):
        y, aux = fn(p, cfg, x)
        grads.append(torch.autograd.grad((y * y).sum() + aux, leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("where", ["fake", "meta"])
def test_dispatch_runs_on_fake_and_meta_tensors(where):
    """No shape depends on the data: the dispatch runs where nothing is
    computed (the dry run's meta tensors; FakeTensorMode)."""
    shapes = MOE.init_moe(None, CFG, dtype=torch.bfloat16, device="meta")
    if where == "fake":
        with FakeTensorMode():
            p = Tree({k: torch.empty(v.shape, dtype=v.dtype)
                      for k, v in shapes.items()})
            x = torch.empty(4, 64, CFG.d_model, dtype=torch.bfloat16)
            y, aux = MOE.moe_apply(p, CFG, x)
    else:
        p = Tree(shapes)
        x = torch.empty(4, 64, CFG.d_model, dtype=torch.bfloat16,
                        device="meta")
        y, aux = MOE.moe_apply(p, CFG, x)
        assert y.device.type == "meta"
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert aux.shape == () and aux.dtype == torch.float32
