"""Fault-tolerant training loop of the port.

  * resume-from-latest checkpoint with exact data-stream continuation
    (the pipeline is deterministic per (step, host), so no iterator state),
  * periodic async checkpoints off the critical path,
  * simulated-preemption recovery (run again with more ``steps``),
  * NaN-loss circuit breaker (drop the update + counter, abort after K in
    a row),
  * per-step metrics log (JSONL).

The step is eager PyTorch with a functional optimizer update: the old
params and optimizer state are still alive when a step's loss comes back
non-finite, so the breaker keeps them (the reference restores from the last
checkpoint, since its jitted step donates its input buffers).
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from .checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from .optimizer import AdamWConfig, init_opt_state
from .step import make_train_step


@dataclass
class TrainConfig:
    steps: int = 200
    checkpoint_every: int = 50
    checkpoint_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    keep_checkpoints: int = 3
    log_every: int = 10
    accum_steps: int = 1
    quant8_opt: bool = False
    seed: int = 0
    max_consecutive_nan: int = 5
    metrics_path: Optional[str] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(
    cfg: ModelConfig,
    data_cfg: DataConfig,
    train_cfg: TrainConfig,
    opt_cfg: Optional[AdamWConfig] = None,
    *,
    make_batch: Optional[Callable[[Dict[str, np.ndarray]], Dict[str, Any]]] = None,
    device=None,
) -> Dict[str, Any]:
    """Train (or resume) on ``device`` (default: the first card) and return
    summary metrics: the reference's keys, plus ``step_s`` (each finite
    step's wall time) and ``checkpoint`` (the last save's snapshot and write
    times, and how many saves ran)."""
    device = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=train_cfg.steps)
    model = build_model(cfg)
    step_fn = make_train_step(model, opt_cfg, accum_steps=train_cfg.accum_steps)

    gen = torch.Generator(device=device)
    gen.manual_seed(train_cfg.seed)
    params = model.init(gen, device)
    opt_state = init_opt_state(params, quant8=train_cfg.quant8_opt)

    # ---- resume ------------------------------------------------------------
    start_step = 0
    ckpt_dir = Path(train_cfg.checkpoint_dir)
    if latest_step(ckpt_dir) is not None:
        start_step, restored = restore_checkpoint(
            ckpt_dir, {"params": params, "opt": opt_state}
        )
        params, opt_state = restored["params"], restored["opt"]
        print(f"[train] resumed from step {start_step}")

    pipeline = make_pipeline(data_cfg, start_step=start_step)
    ckpt = AsyncCheckpointer(ckpt_dir, keep=train_cfg.keep_checkpoints)
    metrics_f = open(train_cfg.metrics_path, "a") if train_cfg.metrics_path else None

    losses, step_s = [], []
    nan_streak = 0
    saves, last_saved = 0, None
    t_start = time.perf_counter()
    try:
        for step in range(start_step, train_cfg.steps):
            batch = next(pipeline)
            if make_batch is not None:
                batch = make_batch(batch)
            t0 = time.perf_counter()
            new_params, new_opt, m = step_fn(params, opt_state, batch)
            loss = float(m["loss"])
            if math.isnan(loss) or math.isinf(loss):
                # NaN circuit breaker: drop the update, keep the old state
                del new_params, new_opt
                nan_streak += 1
                if nan_streak >= train_cfg.max_consecutive_nan:
                    raise FloatingPointError(
                        f"{nan_streak} consecutive non-finite losses"
                    )
                continue
            nan_streak = 0
            params, opt_state = new_params, new_opt
            _sync(device)
            step_s.append(time.perf_counter() - t0)
            losses.append(loss)
            if metrics_f and (step % train_cfg.log_every == 0):
                metrics_f.write(json.dumps({"step": step, "loss": loss}) + "\n")
                metrics_f.flush()
            if (step + 1) % train_cfg.checkpoint_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
                saves, last_saved = saves + 1, step + 1
        # the final state (the reference writes it again when the last step
        # was a checkpoint step; the same arrays, so once is enough)
        if last_saved != train_cfg.steps:
            ckpt.save(train_cfg.steps, {"params": params, "opt": opt_state})
            saves += 1
        ckpt.wait()
    finally:
        pipeline.stop()
        if metrics_f:
            metrics_f.close()

    wall = time.perf_counter() - t_start
    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "first_loss": losses[0] if losses else float("nan"),
        "steps_run": len(losses),
        "wall_s": wall,
        "params": params,
        "losses": losses,
        "step_s": step_s,
        "checkpoint": {"saves": saves, "snapshot_s": ckpt.snapshot_s, "write_s": ckpt.write_s},
    }
