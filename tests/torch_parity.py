"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
V2-Lite-shaped tiny config and a numpy weight tree in the reference's
layout (every family's), which convert.model_params_from_numpy carries into
the port."""

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


# The leading layer axes of each stack of the reference's tree: one for a
# stack of layers, two for the hybrid's (n_groups, group) stack.
LAYER_AXES = {"blocks": 1, "dense_blocks": 1, "rem": 1, "enc_blocks": 1,
              "groups": 2}


def numpy_weights(jcfg, seed: int):
    """A value tree in the reference's layout (shapes from its init_model,
    stacked leaves with their layer axes), filled from a numpy generator:
    matrices N(0, 1/fan_in) with fan_in the first axis past the layer axes,
    norm scales and d_skip near 1, biases small, a_log over log [1, 16]."""
    abstract = jax.eval_shape(lambda k: split(JMm.init_model(jcfg, k))[0],
                              jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [k.key for k in path]
        shape = leaf.shape
        core = shape[LAYER_AXES.get(names[0], 0):]
        n = rng.standard_normal(shape)
        last = names[-1]
        if last in ("scale", "d_skip"):
            v = 1.0 + 0.1 * n
        elif last in ("conv_b", "dt_bias", "bias", "b", "q_b", "k_b", "v_b"):
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


# ---------------------------------------------------------------------------
# The model families: the eight smoke configs the port gained with GQA
# attention, and both packages' serving form run on one weight tree.
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("qwen1.5-32b", "qwen2.5-32b", "qwen3-32b", "nemotron-4-340b",
                "qwen3-moe-235b-a22b", "llava-next-mistral-7b", "zamba2-7b",
                "whisper-large-v3")


def family_batch(jcfg, batch: int, seq: int, seed: int):
    """{"tokens": (batch, seq) int32} and the family's stub inputs in f32
    ("patch_embeds" (batch, vlm_patches, d_model), "frame_embeds" (batch,
    enc_seq, d_model), 0.02 x N(0, 1)), as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, jcfg.vocab, (batch, seq)).astype(
        np.int32)}
    stub = {"vlm": ("patch_embeds", jcfg.vlm_patches),
            "audio": ("frame_embeds", jcfg.enc_seq)}.get(jcfg.family)
    if stub:
        out[stub[0]] = (0.02 * rng.standard_normal(
            (batch, stub[1], jcfg.d_model))).astype(np.float32)
    return out


def context_len(cfg, seq: int) -> int:
    """The positions a prefill of `seq` tokens fills: the VLM's patches
    come first."""
    return seq + (cfg.vlm_patches if cfg.family == "vlm" else 0)


def ref_fill_decode_state(jcfg, state, caches):
    """The reference's decode state with its prefill's caches copied in
    (jnp), as repro_torch.models.model.fill_decode_state does it."""
    import jax.numpy as jnp

    def put(dst, src, seq_axis):
        if seq_axis is None:
            return src
        idx = [slice(None)] * dst.ndim
        idx[seq_axis] = slice(0, src.shape[seq_axis])
        return dst.at[tuple(idx)].set(src)

    tmap = lambda f, *t: jax.tree.map(f, *t)
    if jcfg.family == "hybrid":
        states, kv = caches["groups"]
        out = {"groups": states,
               "shared_kv": tmap(lambda d, s: put(d, s, 2),
                                 state["shared_kv"], kv)}
        if "rem" in state:
            out["rem"] = caches["rem"]
        return out
    if jcfg.family == "audio":
        self_kv, cross_kv = caches["blocks"]
        return {"self": tmap(lambda d, s: put(d, s, 2), state["self"],
                             self_kv),
                "cross": cross_kv}
    if jcfg.family == "ssm":
        return {"blocks": caches["blocks"]}
    return {k: tmap(lambda d, s: put(d, s, 2), state[k], caches[k])
            for k in caches}


def serving_case(arch: str, *, batch: int = 2, seq: int = 16,
                 steps: int = 3, n_layers: int = 0):
    """Both packages' serving form of the smoke config of `arch` in f32 on
    one weight tree (numpy_weights) and one batch (family_batch): forward
    (every position's logits), prefill (last-token logits and caches) and
    `steps` decode steps of fixed random tokens on a cache of the
    context plus steps + 1 slots filled from the prefill. Returns (jcfg,
    tcfg, ref, port), ref and port holding numpy arrays: "forward",
    "prefill", "caches", "decode" (a list), "state" (after the steps), and
    the port's "routes" of its prefill. n_layers > 0 cuts both configs to
    that depth."""
    import dataclasses

    import jax.numpy as jnp
    import torch
    from repro import configs as JC
    from repro_torch import configs as TC
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.models import model as TMm

    jcfg, tcfg = JC.get_smoke_config(arch), TC.get_smoke_config(arch)
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    tree = numpy_weights(jcfg, seed=len(arch))
    data = family_batch(jcfg, batch, seq, seed=1)
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab, (steps, batch, 1)).astype(np.int32)
    ctx = context_len(jcfg, seq)
    slots = ctx + steps + 1

    jparams = jax.tree.map(jnp.asarray, tree)
    logits, caches, _ = jax.jit(
        lambda p, b: JMm.forward(p, jcfg, b, return_caches=True))(
            jparams, {k: jnp.asarray(v) for k, v in data.items()})
    ref = {"forward": np.asarray(logits),
           "prefill": np.asarray(logits[:, -1:]),
           "caches": jax.tree.map(np.asarray, caches), "decode": []}
    state = ref_fill_decode_state(
        jcfg, JMm.init_decode_state(jcfg, batch, slots, dtype=jnp.float32),
        caches)
    dec = jax.jit(JMm.decode_step, static_argnums=1)
    for i in range(steps):
        lg, state = dec(jparams, jcfg, state, jnp.asarray(toks[i]),
                        jnp.full((batch, 1), ctx + i, jnp.int32), ctx + i)
        ref["decode"].append(np.asarray(lg))
    ref["state"] = jax.tree.map(np.asarray, state)

    params = model_params_from_numpy(tree, tcfg, device="cpu")
    tdata = {k: torch.tensor(v) for k, v in data.items()}
    fwd, _, _ = TMm.forward(params, tcfg, tdata)
    routes = []
    logits, caches = TMm.prefill(params, tcfg, tdata, routes=routes)
    to_np = lambda t: jax.tree.map(lambda x: x.numpy().copy(), t)
    port = {"forward": fwd.numpy(), "prefill": logits.numpy(),
            "caches": to_np(caches), "routes": routes, "decode": []}
    state = TMm.fill_decode_state(
        tcfg, TMm.init_decode_state(tcfg, batch, slots, dtype=torch.float32,
                                    device="cpu"), caches)
    for i in range(steps):
        lg, state = TMm.decode_step(params, tcfg, state,
                                    torch.tensor(toks[i]),
                                    torch.full((batch, 1), ctx + i), ctx + i)
        port["decode"].append(lg.numpy())
    port["state"] = to_np(state)
    return jcfg, tcfg, ref, port


def train_case(arch: str, *, batch: int = 2, seq: int = 16):
    """Both packages' loss and gradients on the smoke config of `arch` in
    f32, on one weight tree and the reference pipeline's batch (its stub
    inputs in f32). Returns (tcfg, ref, port): ref {"loss", "grads" (the
    reference's gradient tree carried into the port's layout)}, port
    {"loss", "params" (their .grad filled by backward), "routes"}."""
    import jax.numpy as jnp
    import torch
    from repro import configs as JC
    from repro.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch import configs as TC
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.models import model as TMm
    from repro_torch.models.module import trainable

    jcfg, tcfg = JC.get_smoke_config(arch), TC.get_smoke_config(arch)
    tree = numpy_weights(jcfg, seed=len(arch) + 1)
    b = SyntheticPipeline(DataConfig(
        vocab=jcfg.vocab, seq_len=seq, global_batch=batch,
        family=jcfg.family, d_model=jcfg.d_model,
        vlm_patches=jcfg.vlm_patches, enc_seq=jcfg.enc_seq)).batch_at(0)
    data = {k: np.asarray(v, np.float32 if k.endswith("_embeds")
                          else np.int32) for k, v in b.items()}
    loss, g = jax.jit(jax.value_and_grad(JMm.loss_fn), static_argnums=1)(
        jax.tree.map(jnp.asarray, tree), jcfg,
        {k: jnp.asarray(v) for k, v in data.items()})
    ref = {"loss": float(loss),
           "grads": model_params_from_numpy(jax.tree.map(np.asarray, g),
                                            tcfg, device="cpu")}
    params = trainable(model_params_from_numpy(tree, tcfg, device="cpu"))
    routes = []
    lt = TMm.loss_fn(params, tcfg, {k: torch.tensor(v)
                                    for k, v in data.items()},
                     routes=routes)
    lt.backward()
    return tcfg, ref, {"loss": float(lt.detach()), "params": params,
                       "routes": routes}
