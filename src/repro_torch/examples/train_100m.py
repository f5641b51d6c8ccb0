"""Train a ~100M-parameter LM with checkpointing and an injected crash +
automatic restart (the training driver's example).

Counterpart of the repository's ``examples/train_100m.py``: the 8-layer,
d_model 512 "qwen2-100m" through ``repro_torch.launch.train.main``, which
crashes once at ``--crash-at-step`` (default the midpoint; -1 runs
straight through) and resumes from the latest checkpoint.

    python -m repro_torch.examples.train_100m [--steps 300]         # GPU
    python -m repro_torch.examples.train_100m --steps 20 --device cpu
"""
import argparse
import dataclasses
import shutil

from repro_torch import configs
from repro_torch.launch import train as train_launch
from repro_torch.models import build
from repro_torch.models.common import ModelConfig


def model_100m() -> ModelConfig:
    """~100M-parameter dense decoder (qwen2-family reduced)."""
    return dataclasses.replace(
        configs.get("qwen2-7b"),
        name="qwen2-100m",
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=1536, vocab_size=32_000, max_position=4096)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_100m")
    ap.add_argument("--crash-at-step", type=int, default=None,
                    help="step of the injected crash (default the "
                         "midpoint; -1 for none)")
    ap.add_argument("--device", default="cuda",
                    help='where the model trains ("cuda" or "cpu")')
    args = ap.parse_args(argv)

    cfg = model_100m()
    # register so the launcher can find it by name
    configs.ARCHS[cfg.name] = cfg
    n = build(cfg).n_params
    print(f"model: {cfg.name}, {n/1e6:.1f}M params")
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    crash_at = (args.steps // 2 if args.crash_at_step is None
                else args.crash_at_step)
    ckpt_every = max(min(50, args.steps // 4), 1)
    out = train_launch.main([
        "--arch", cfg.name, "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq-len", str(args.seq_len),
        "--lr", "3e-4", "--warmup", "20", "--device", args.device,
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", str(ckpt_every),
        "--log-every", "25",
        # exercise the fault-tolerance path: crash once mid-run, auto-resume
        "--crash-at-step", str(crash_at),
        "--max-restarts", "2",
    ])
    if args.steps >= 100:  # loss descent only meaningful at real length
        if not out["final_loss"] < out["first_loss"]:
            raise AssertionError("loss must descend")
    if crash_at >= 0:
        print(f"done: crash injected at step {crash_at}, training resumed "
              f"from checkpoint, run completed.")
    return out


if __name__ == "__main__":
    main()
