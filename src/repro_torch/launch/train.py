"""Training launcher, the counterpart of repro.launch.train --smoke.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
        --smoke --steps 50 [--seq 128 --batch 4 --ckpt-dir DIR] \
        [--device cpu]

--smoke trains the arch's reduced config end to end (data pipeline ->
grad-accumulation step -> AdamW -> asynchronous checkpoints ->
fault-tolerant loop), its weights drawn from seed 0 on --device (cuda by
default), for any arch id of repro_torch.configs: the VLM and the audio
model train on the pipeline's stub patch and frame embeddings. Without
--smoke the reference compiles the full config's train
step for the production mesh; that dry run belongs to the distribution
substrate (ROADMAP A.12), and the port refuses it.
"""

import argparse
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.models import model as MD
from repro_torch.models.module import count_params, trainable
from repro_torch.optim.adamw import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import TrainConfig, make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains; cuda needs a card")
    return ap


def main(argv=None) -> list:
    """Runs the CLI; returns the loop's log."""
    args = build_parser().parse_args(argv)
    if not args.smoke:
        raise SystemExit(
            "repro_torch.launch.train: only --smoke runs in the port; the "
            "full config's production-mesh dry run is ROADMAP A.12")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("repro_torch.launch.train: no CUDA device; pass "
                         "--device cpu to train on the CPU")
    dev = torch.device(args.device)
    cfg = get_smoke_config(args.arch)
    params = trainable(MD.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    print(f"[train] {cfg.name}: {count_params(params)/1e6:.2f}M params")
    ocfg = AdamWConfig(lr=args.lr)
    opt_state = adamw_init(params, ocfg)
    step = make_train_step(
        cfg, ocfg, TrainConfig(n_micro=args.n_micro),
        cosine_schedule(args.lr, warmup=args.steps // 10 + 1,
                        total=args.steps))
    pipe = SyntheticPipeline.for_model(cfg, args.seq, args.batch, device=dev)
    ckpt = CheckpointManager(args.ckpt_dir or
                             tempfile.mkdtemp(prefix=f"{cfg.name}_"))
    t0 = time.time()
    params, opt_state, log = train_loop(
        step, params, opt_state, pipe, ckpt,
        LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                   log_every=max(1, args.steps // 10)))
    losses = [e for e in log if "loss" in e]
    print(f"[train] {args.steps} steps in {time.time()-t0:.1f}s; "
          f"loss {losses[0]['loss']:.3f} -> {losses[-1]['loss']:.3f}; "
          f"checkpoints: {ckpt.all_steps()}")
    return log


if __name__ == "__main__":
    main()
