"""Port parity of the train form (repro_torch.models.model.loss_fn under
autograd) of the eight smoke configs the port gained with GQA attention,
against jax.value_and_grad of the JAX package's loss_fn on the same numpy
weights and the reference pipeline's batch (its stub patch and frame
embeddings in f32), in f32 (torch_parity.train_case). The VLM's loss runs
over its text positions; the hybrid's Mamba2 layers take the train-form SSD
term; with cfg.remat every Mamba2 layer and attention block is recomputed in
backward, the hybrid's shared block excepted.

Tolerances (tests/test_torch_train.py's): the loss at rtol 1e-5; every
gradient leaf at atol 1e-4 x the leaf's max |grad| and rtol 1e-4."""

import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as JC
from repro_torch import configs as TC
from repro_torch.convert import model_params_from_numpy
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.models import model as TMm
from repro_torch.models.module import trainable
from torch_parity import FAMILY_ARCHS, numpy_weights, train_case


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def grads(request):
    return train_case(request.param)


def test_loss_matches_reference(grads):
    _, ref, port = grads
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)


def test_grads_match_reference_leaf_by_leaf(grads):
    cfg, ref, port = grads
    want = dict(ref["grads"].named_parameters())
    got = dict(port["params"].named_parameters())
    assert sorted(got) == sorted(want)
    for k, p in got.items():
        assert p.grad is not None and p.grad.dtype == torch.float32, k
        w = want[k].detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), w,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   rtol=1e-4, err_msg=f"{cfg.name} {k}")
    n_moe = cfg.n_layers if cfg.family == "moe" else 0
    assert len(port["routes"]) == n_moe       # once each, remat or not


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-large-v3",
                                  "llava-next-mistral-7b"])
def test_remat_changes_no_number(arch):
    """Each block under torch.utils.checkpoint gives the same loss and
    gradients, bit for bit, as the blocks kept whole: the hybrid's nested
    groups, the encoder-decoder's two stacks, the VLM's patch prefix."""
    tcfg = TC.get_smoke_config(arch)
    tree = numpy_weights(JC.get_smoke_config(arch), seed=6)
    batch = SyntheticPipeline.for_model(tcfg, 16, 2, device="cpu").batch_at(0)
    batch = {k: v.float() if v.is_floating_point() else v
             for k, v in batch.items()}
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = trainable(model_params_from_numpy(tree, cfg, device="cpu"))
        loss = TMm.loss_fn(params, cfg, batch)
        loss.backward()
        out[remat] = (loss.detach(), [p.grad for p in params.parameters()])
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))
