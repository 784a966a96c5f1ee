"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
V2-Lite-shaped tiny config and a numpy weight tree in the reference's
layout, which convert.model_params_from_numpy carries into the port."""

import pathlib

import jax
import numpy as np

from repro.models import model as JMm
from repro.models.module import split

ROOT = pathlib.Path(__file__).resolve().parents[1]


def tiny_v2_lite(mod):
    """V2-Lite's shape (direct q projection, 2 shared experts) at smoke
    width, in the given package's config classes."""
    return mod.model.ModelConfig(
        name="v2-lite-tiny", family="moe", n_layers=3, d_model=64,
        vocab=256, attn_type="mla", n_heads=4, n_kv_heads=4,
        mla=mod.mla.MLAConfig(d_model=64, n_heads=4, kv_lora_rank=32,
                              q_lora_rank=None, qk_nope_head_dim=16,
                              qk_rope_head_dim=8, v_head_dim=16),
        d_ff=128, first_k_dense=1,
        moe=mod.moe.MoEConfig(d_model=64, d_expert=32, n_experts=8, top_k=3,
                              n_shared=2))


def numpy_weights(jcfg, seed: int):
    """A value tree in the reference's layout (shapes from its init_model,
    stacked leaves with the layer axis), filled from a numpy generator:
    matrices N(0, 1/fan_in), norm scales and d_skip near 1, biases small,
    a_log over log [1, 16]."""
    abstract = jax.eval_shape(lambda k: split(JMm.init_model(jcfg, k))[0],
                              jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [k.key for k in path]
        shape = leaf.shape
        core = shape[1:] if names[0] in ("blocks", "dense_blocks") else shape
        n = rng.standard_normal(shape)
        last = names[-1]
        if last in ("scale", "d_skip"):
            v = 1.0 + 0.1 * n
        elif last in ("conv_b", "dt_bias", "bias", "b"):
            v = 0.1 * n
        elif last == "a_log":
            v = np.log(rng.uniform(1.0, 16.0, shape))
        elif last == "table":
            v = n
        elif last == "conv_w":
            v = 0.5 * n
        else:
            v = n / np.sqrt(core[0])
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, abstract)
