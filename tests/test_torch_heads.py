"""The head projections and the activation specs of the sharded path on
plain tensors and abstract meshes: project_heads and merge_heads take the
one-product expression on plain tensors, bit for bit, whatever the head
count (the local form is for DTensors whose heads do not divide the model
axis: tests/test_torch_distributed.py holds it on gloo); fit_spec drops the
spec entries whose mesh axes do not divide their dim, as spec_for does for
parameters, and the sharding policy applies it to a short batch."""

import numpy as np
import pytest
import torch

from repro_torch.distributed.sharding import divides_model, fit_spec
from repro_torch.models import layers as L


@pytest.mark.parametrize("heads,hd", [(3, 16), (40, 8), (128, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_project_and_merge_heads_are_the_one_product(heads, hd, dtype):
    g = torch.Generator().manual_seed(heads)
    x = torch.randn(2, 5, 24, generator=g).to(dtype)
    wq = torch.randn(24, heads, hd, generator=g).to(dtype)
    wo = torch.randn(heads, hd, 24, generator=g).to(dtype)
    q = L.project_heads(x, wq)
    assert torch.equal(q, (x @ wq.flatten(1)).unflatten(-1, wq.shape[1:]))
    out = L.merge_heads(q, wo)
    assert torch.equal(out, q.flatten(-2) @ wo.flatten(0, 1))
    # the einsum it stands for
    np.testing.assert_allclose(
        q.float().numpy(),
        torch.einsum("bsm,mhd->bshd", x.double(), wq.double()).numpy(),
        rtol=1e-4 if dtype == torch.float32 else 2e-2,
        atol=1e-4 if dtype == torch.float32 else 2e-1)


def test_plain_weights_always_divide():
    assert divides_model(torch.zeros(4, 3, 2), 3)


@pytest.mark.parametrize("spec,shape,want", [
    (("data", "model", None), (16, 4096, 8), ("data", "model")),
    (("data", "model", None), (1, 1, 8), ()),
    ((("pod", "data"), None, "model"), (16, 64, 256), (None, None, "model")),
    ((("pod", "data"), None, "model"), (64, 64, 250), (("pod", "data"),)),
    ((None, "model"), (4, 40), (None, "model")),
    ((None, "model"), (4, 20), ()),
])
def test_fit_spec_drops_what_does_not_divide(spec, shape, want):
    mesh = {"pod": 2, "data": 16, "model": 8}
    assert fit_spec(spec, shape, mesh) == want


def test_policy_for_a_short_batch_keeps_the_batch_whole():
    """sp_policy's specs for a microbatch of 16 rows on a 32-wide data
    axis: every batch entry None, the rest as they were; a batch the data
    axis divides gets the policy itself."""
    from repro_torch.distributed.policy import sp_policy
    pol = sp_policy({"data": 32, "model": 16})
    assert pol.for_batch(64) is pol
    short = pol.for_batch(16)
    assert short.specs == {"residual": (None, "model", None),
                           "block_in": (None, None, None),
                           "logits": (None, None, "model")}
    assert pol.specs["residual"] == ("data", "model", None)
