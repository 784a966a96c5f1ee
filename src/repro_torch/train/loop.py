"""Fault-tolerant training loop, the counterpart of repro.train.loop.

Periodic asynchronous checkpoints; on a step failure, restore the latest
snapshot and replay the data from its step index (the stateless pipeline
makes the resume exact); metrics logged every log_every steps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticPipeline


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    max_restores: int = 3
    log_every: int = 10


def train_loop(train_step: Callable, params, opt_state,
               pipeline: SyntheticPipeline, ckpt: CheckpointManager,
               cfg: LoopConfig,
               fault_hook: Optional[Callable[[int], None]] = None,
               log: Optional[List[dict]] = None) -> tuple:
    """Runs to cfg.total_steps, surviving up to max_restores induced or real
    step failures; warm-starts from the latest checkpoint in ckpt.
    fault_hook(step) may raise to simulate a node failure. After a failure
    the pending checkpoint write is finished before the latest snapshot is
    chosen (the reference chooses first, and a failure while the write is
    in flight finds no snapshot, or an older one); the restore copies it
    into params and opt_state in place. Returns (params, opt_state, log)."""
    log = log if log is not None else []
    start = ckpt.latest_step()
    step = 0
    if start is not None:       # warm start from an earlier run
        snap = ckpt.restore(start, {"params": params, "opt": opt_state})
        params, opt_state = snap["params"], snap["opt"]
        step = start
    restores = 0
    while step < cfg.total_steps:
        try:
            if fault_hook is not None:
                fault_hook(step)
            batch = pipeline.batch_at(step)
            params, opt_state, mets = train_step(params, opt_state, batch)
            if step % cfg.log_every == 0:
                log.append({"step": step,
                            "loss": float(mets["loss"]),
                            "grad_norm": float(mets["grad_norm"]),
                            "t": time.time()})
            step += 1
            if step % cfg.ckpt_every == 0:
                ckpt.save(step, {"params": params, "opt": opt_state})
        except Exception as err:          # a failed step: restore, replay
            restores += 1
            if restores > cfg.max_restores:
                raise
            # the snapshot still being written counts: finish it first
            ckpt.wait()
            latest = ckpt.latest_step()
            if latest is None:
                raise
            snap = ckpt.restore(latest, {"params": params, "opt": opt_state})
            params, opt_state = snap["params"], snap["opt"]
            step = latest
            log.append({"step": step, "event": "restored",
                        "restores": restores, "error": repr(err)})
    ckpt.wait()
    return params, opt_state, log
