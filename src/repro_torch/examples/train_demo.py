"""End-to-end training driver: train a ~100M-param llama on the synthetic
corpus for a few hundred steps with checkpoints; then kill/resume.

    PYTHONPATH=src python -m repro_torch.examples.train_demo [--steps 300] [--d-model 512]
    PYTHONPATH=src python -m repro_torch.examples.train_demo --device cpu

With d_model=512/12 layers this is the "≈100M params" run of the reference's
docstring; the defaults below are sized to finish in minutes on one CPU
core.  The loss curve is written to ``<--out>/metrics.jsonl`` and the
checkpoints to ``<--out>/ckpt``; run again with more ``--steps`` and the
same ``--out`` to resume.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from dataclasses import replace

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.examples import add_device_flag, devices_for
from repro_torch.train.loop import TrainConfig, train


def demo_config(*, layers, d_model, vocab):
    """llama3.2-1b's smoke config reshaped to the demo's widths."""
    return replace(
        get_config("llama3.2-1b").smoke(),
        n_layers=layers,
        d_model=d_model,
        n_heads=8,
        n_kv_heads=4,
        head_dim=d_model // 8,
        d_ff=4 * d_model,
        vocab_size=vocab,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument(
        "--out", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_demo"),
        help="where the checkpoints (ckpt/) and metrics.jsonl go",
    )
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = devices_for(args.device)[0]

    cfg = demo_config(layers=args.layers, d_model=args.d_model, vocab=args.vocab)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    train_cfg = TrainConfig(
        steps=args.steps,
        checkpoint_every=max(args.steps // 4, 10),
        checkpoint_dir=os.path.join(args.out, "ckpt"),
        metrics_path=os.path.join(args.out, "metrics.jsonl"),
        log_every=10,
    )
    os.makedirs(args.out, exist_ok=True)
    out = train(cfg, data_cfg, train_cfg, device=device)
    print(
        f"loss {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
        f"over {out['steps_run']} steps ({out['wall_s']:.0f}s)"
    )
    assert out["final_loss"] < out["first_loss"], "no learning happened?!"
    return out


if __name__ == "__main__":
    main()
