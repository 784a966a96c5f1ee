"""End-to-end training driver: a ~100M-param MLA+MoE transformer (the
paper's architecture family) trained for a few hundred steps with the full
production stack: deterministic pipeline, grad-accumulation train step,
AdamW, async checkpointing, fault-tolerant loop (one induced failure
mid-run proves restore+replay). On the card --full trains the ~100M config
as written; the train step launches no kernel of the repository (the
train form is plain PyTorch under autograd).

The weights are f32, where the reference draws them in its init's bf16.
The head is tied to the unit-scale embedding table, and in bf16 an AdamW
step, at most lr = 1e-3 (~2^-10) an entry, is below half an ulp of every
entry larger than 0.25 in magnitude (2^-9 at 0.5, 2^-8 at 1), about 80% of
them: the table, the only path to the bigram the corpus holds, cannot
move and the loss does not fall within the run; in f32 it does.

    PYTHONPATH=src python -m repro_torch.examples.train_mla_100m \
        [--steps 200] [--full] [--device cpu]
"""

import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.examples import device_of, parser
from repro_torch.models import model as MD
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.module import count_params, trainable
from repro_torch.optim.adamw import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import TrainConfig, make_train_step


def build_config(full: bool) -> MD.ModelConfig:
    """full=True: ~100M params (deepseek-v2-lite family scaled down), the
    example's own configuration. Default: a ~20M variant with the same
    architecture and stack."""
    if full:
        return MD.ModelConfig(
            name="mla-100m", family="moe", n_layers=8, d_model=512,
            vocab=32768, attn_type="mla", n_heads=8, n_kv_heads=8,
            mla=MLAConfig(d_model=512, n_heads=8, kv_lora_rank=128,
                          q_lora_rank=None, qk_nope_head_dim=64,
                          qk_rope_head_dim=32, v_head_dim=64),
            d_ff=2048, first_k_dense=1,
            moe=MoEConfig(d_model=512, d_expert=512, n_experts=8, top_k=2,
                          n_shared=1),
            loss_chunk=256,
        )
    return MD.ModelConfig(
        name="mla-20m", family="moe", n_layers=4, d_model=256,
        vocab=8192, attn_type="mla", n_heads=4, n_kv_heads=4,
        mla=MLAConfig(d_model=256, n_heads=4, kv_lora_rank=64,
                      q_lora_rank=None, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32),
        d_ff=1024, first_k_dense=1,
        moe=MoEConfig(d_model=256, d_expert=256, n_experts=8, top_k=2,
                      n_shared=1),
        loss_chunk=128,
    )


def run(device="cuda", steps: int = 200, seq: int = 128, batch: int = 4,
        full: bool = False, ckpt_dir: str = "") -> dict:
    dev = torch.device(device)
    cfg = build_config(full)
    params = trainable(MD.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=torch.float32))
    n_params = count_params(params)
    print(f"model: {cfg.name}, {n_params/1e6:.1f}M params")

    ocfg = AdamWConfig(lr=1e-3)
    opt_state = adamw_init(params, ocfg)
    lr_fn = cosine_schedule(1e-3, warmup=20, total=steps)
    train_step = make_train_step(cfg, ocfg, TrainConfig(n_micro=2), lr_fn)
    pipe = SyntheticPipeline.for_model(cfg, seq_len=seq, global_batch=batch,
                                       device=dev)
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="mla100m_")
    ckpt = CheckpointManager(ckpt_dir)

    # every step run, replays included, as (step, loss, wall s): the fault
    # hook sees each step's index before the step runs
    ran, at, fired = [], [0], []

    def induced_fault(step):
        at[0] = step
        if step == steps // 2 and not fired:
            fired.append(step)
            raise RuntimeError("induced mid-run node failure")

    def step_fn(p, o, b):
        t = time.perf_counter()
        p, o, mets = train_step(p, o, b)
        loss = float(mets["loss"])             # waits for the whole step
        ran.append((at[0], loss, time.perf_counter() - t))
        return p, o, mets

    t0 = time.time()
    params, opt_state, log = train_loop(
        step_fn, params, opt_state, pipe, ckpt,
        LoopConfig(total_steps=steps, ckpt_every=25, log_every=10),
        fault_hook=induced_fault)
    dt = time.time() - t0

    losses = [(e["step"], e["loss"]) for e in log if "loss" in e]
    events = [e for e in log if e.get("event")]
    print(f"\ntrained {steps} steps in {dt:.1f}s "
          f"({steps/dt:.2f} steps/s on {dev.type})")
    print(f"loss: {losses[0][1]:.3f} -> {losses[-1][1]:.3f} "
          f"(first -> last)")
    print(f"fault events: {events}")
    assert losses[-1][1] < losses[0][1], "loss must decrease"
    assert any(e.get("event") == "restored" for e in log), \
        "the induced failure must have triggered a restore"
    print(f"checkpoints at {ckpt_dir}: steps {ckpt.all_steps()}")
    return {"name": cfg.name, "params": n_params, "steps": steps,
            "tokens_per_step": batch * seq, "wall_s": dt,
            "steps_per_s": steps / dt, "losses": losses, "events": events,
            "ran": ran, "checkpoints": ckpt.all_steps()}


def main(argv=None) -> dict:
    ap = parser("train_mla_100m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="the ~100M config")
    ap.add_argument("--ckpt-dir", default="")
    args = ap.parse_args(argv)
    return run(device_of("train_mla_100m", args.device), args.steps,
               args.seq, args.batch, args.full, args.ckpt_dir)


if __name__ == "__main__":
    main()
