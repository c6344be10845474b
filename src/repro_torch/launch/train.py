"""Training launcher CLI of the port, on the H100 (or the CPU with
``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 20 --checkpoint-every 10     # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 200 --smoke --device cpu     # reduced config

Run it again with more ``--steps`` and the same ``--checkpoint-dir`` to
resume after a preemption.  The model trains at its config's
``attention_impl`` (``chunked``): the hand-written kernels are forward-only,
and a ``pallas`` config is refused.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.loop import TrainConfig, train
from repro_torch.train.optimizer import AdamWConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--quant8-opt", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family (CPU-runnable)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains (cuda: the first card)")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (use --device cpu)")
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size,
        seq_len=args.seq_len,
        global_batch=args.global_batch,
    )
    train_cfg = TrainConfig(
        steps=args.steps,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        accum_steps=args.accum_steps,
        quant8_opt=args.quant8_opt,
        metrics_path=f"{args.checkpoint_dir}/metrics.jsonl",
    )
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    out = train(cfg, data_cfg, train_cfg, AdamWConfig(lr=args.lr, total_steps=args.steps),
                device=device)
    print(
        f"[train] {args.arch}: loss {out['first_loss']:.3f} -> "
        f"{out['final_loss']:.3f} over {out['steps_run']} steps "
        f"({out['wall_s']:.0f}s)"
    )
    return out


if __name__ == "__main__":
    main()
