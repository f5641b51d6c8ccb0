"""Fault-tolerant training driver.

Counterpart of ``repro.launch.train``. Runs a training loop on one device
(``--device``, ``cuda`` unless the caller asks for the CPU) with:
  * periodic atomic checkpoints (params + optimizer + data cursor),
  * automatic crash-restart loop (--max-restarts) resuming from the
    latest checkpoint — the training-side fault-tolerance contract,
  * optional injected crash (--crash-at-step) to exercise the restart
    path end to end (used by tests/examples).

A resumed run reproduces the uninterrupted run bit for bit: the loader
cursor comes back from the checkpoint, and the loop runs under
``torch.use_deterministic_algorithms(True)`` (on CUDA the embedding and
cross-entropy backward passes otherwise accumulate with atomics in an
order that varies) with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless the
environment sets it.

Usage:
  python -m repro_torch.launch.train --arch qwen2-7b --smoke --steps 200
  python -m repro_torch.launch.train --smoke --device cpu --crash-at-step 5
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from repro_torch import configs
from repro_torch.data import TrainLoader, lm_tokens
from repro_torch.models import RunConfig, build
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import AdamW, warmup_cosine
from repro_torch.training.train_step import make_train_step


class InjectedCrash(RuntimeError):
    pass


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels for the block, restored after it. The cuBLAS
    workspace setting only takes effect before the process's first cuBLAS
    call; a process that made one already must have set it itself."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def train_once(args, crash_at: int = -1) -> dict:
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    model = build(cfg)
    run = RunConfig(remat=args.remat, microbatch=args.microbatch)
    opt = AdamW(schedule=warmup_cosine(args.lr, args.warmup, args.steps))

    toks = lm_tokens(args.batch * args.seq_len * max(args.steps // 4, 8) + 1,
                     cfg.vocab_size, seed=0)
    n_seq = (len(toks) - 1) // args.seq_len
    x = toks[:n_seq * args.seq_len].reshape(n_seq, args.seq_len)
    y = toks[1:n_seq * args.seq_len + 1].reshape(n_seq, args.seq_len)
    loader = TrainLoader(x, y, batch=args.batch, seed=0)

    device = torch.device(args.device)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed),
                        device)
    opt_state = opt.init(params)
    start_step = 0
    if checkpoint.latest_step(args.ckpt_dir) is not None:
        state, manifest = checkpoint.restore(
            args.ckpt_dir, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        loader.restore(manifest["extra"]["loader"])
        start_step = manifest["step"]
        print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(model, run, opt)
    t0 = time.time()
    losses = []
    for step in range(start_step, args.steps):
        batch = loader.next_batch()
        if step == crash_at:
            raise InjectedCrash(f"injected crash at step {step}")
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if (step + 1) % args.log_every == 0:
            dt = time.time() - t0
            tok_s = args.log_every * args.batch * args.seq_len / dt
            print(f"[train] step {step+1}/{args.steps} "
                  f"loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"{tok_s:,.0f} tok/s")
            t0 = time.time()
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            checkpoint.save(args.ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state},
                            extra={"loader": loader.state()})
    return {"final_loss": losses[-1] if losses else None,
            "first_loss": losses[0] if losses else None,
            "steps_run": args.steps - start_step,
            "params": params}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help='where the model trains ("cuda" or "cpu")')
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--crash-at-step", type=int, default=-1,
                    help="inject one crash to exercise restart")
    args = ap.parse_args(argv)

    crash_at = args.crash_at_step
    with deterministic():
        for attempt in range(args.max_restarts + 1):
            try:
                out = train_once(args, crash_at=crash_at)
                print(f"[train] done: loss {out['first_loss']:.4f} -> "
                      f"{out['final_loss']:.4f}")
                return out
            except InjectedCrash as e:
                print(f"[train] CRASH ({e}); restarting "
                      f"({attempt+1}/{args.max_restarts})")
                crash_at = -1  # only crash once
    raise SystemExit("exceeded max restarts")


if __name__ == "__main__":
    main()
