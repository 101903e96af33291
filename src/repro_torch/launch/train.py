"""Training launcher: end-to-end training with checkpoint/restart (port of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch llama3.2-1b --smoke --steps 200 --batch 8 --seq 128

It runs on the card (``--device cuda``, the default) and fails when no card
is visible; ``--device cpu`` runs it on the CPU. Params come from the port's
``init_params`` with a ``torch.Generator`` seeded 0 on that device (f32, as
the reference's launcher makes them).

Fault tolerance: checkpoints every --ckpt-every steps (atomic writes),
auto-resumes from the latest checkpoint, and the counter-based data
pipeline skips ahead exactly. A step-deadline watchdog (runtime/) flags
stragglers; on a real cluster the runner requeues the job and this script
resumes losslessly.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt import latest_step, restore, save
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset, make_labels
from repro_torch.models import init_params
from repro_torch.models.sharding import NO_SHARDING
from repro_torch.runtime.validate import TrainingDivergedError
from repro_torch.runtime.watchdog import StepWatchdog
from repro_torch.train import AdamWConfig, adamw_init, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--step-deadline-s", type=float, default=300.0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is visible; pass --device cpu to train on the CPU")

    cfg = get_config(args.arch, smoke=args.smoke)
    rules = NO_SHARDING
    opt_cfg = AdamWConfig(lr=args.lr)
    data = SyntheticLMDataset(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        device=args.device,
    )

    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    opt_state = adamw_init(params)
    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            (params, opt_state), _ = restore(
                args.ckpt_dir, last, (params, opt_state)
            )
            start = last
            print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, rules, opt_cfg, num_microbatches=args.microbatches)
    watchdog = StepWatchdog(deadline_s=args.step_deadline_s)

    t_last = time.time()
    for step in range(start, args.steps):
        batch = make_labels(data.get_batch(step))
        with watchdog.step(step):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % args.log_every == 0:
            loss = float(metrics["loss"])
            dt = (time.time() - t_last) / args.log_every
            t_last = time.time()
            print(f"step {step + 1}: loss={loss:.4f}  {dt * 1e3:.0f} ms/step")
            if not np.isfinite(loss):
                raise TrainingDivergedError(
                    f"loss diverged at step {step + 1}: {loss!r}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save(args.ckpt_dir, step + 1, (params, opt_state),
                 extra={"arch": args.arch})
    print("done")


if __name__ == "__main__":
    main()
