"""End-to-end driver on the PyTorch port: train a 41.5M-param llama-style
model for a few hundred steps with checkpoint/restart.

The port of examples/train_lm.py, whose docstring says "~100M"; its
``CONFIG_100M`` (8 layers, d_model 512, vocab 32k, tied embeddings) has
41.5M params, which both print. The same ``make_train_step`` / data /
checkpoint stack as ``repro_torch.launch.train``, with AdamW(lr 1e-3, 50
warm-up steps), in plain torch with autograd; checkpoints are byte for byte
the reference's layout, so a run resumes from either package's. Runs on the
card by default; --device cpu runs it on the CPU:

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300

The default --ckpt-dir lies in the temporary directory ($TMPDIR); run it
again with more --steps and it resumes from the latest checkpoint.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.ckpt import latest_step, restore, save
from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import NO_SHARDING, init_params
from repro_torch.train import AdamWConfig, adamw_init, make_train_step

# 41.5M params: 8 layers, d=512, vocab 32k (the reference calls it ~100M)
CONFIG_100M = ModelConfig(
    name="demo-100m",
    family="dense",
    num_layers=8,
    d_model=512,
    num_heads=8,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=32_000,
    head_dim=64,
    tie_embeddings=True,
)
OPT = AdamWConfig(lr=1e-3, warmup_steps=50)
LOG_EVERY = 20
CKPT_EVERY = 100


def pick_device(ap: argparse.ArgumentParser, name: str) -> torch.device:
    """The asked device; ``ap.error`` (exit 2) for a card that is not there."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is visible; pass --device cpu to run on the CPU")
    return device


def train(cfg, params, opt, data, start: int, steps: int, ckpt_dir: str | None = None,
          log=print):
    """Steps ``start`` .. ``steps`` - 1 on ``data``'s batches, params and
    moments updated in place; every LOG_EVERY steps the loss and tokens/s
    are logged (the host waits for the card there only), every CKPT_EVERY
    steps a checkpoint saved to ``ckpt_dir``. Returns (params, opt state,
    every step's loss)."""
    step = make_train_step(cfg, NO_SHARDING, OPT)
    tokens = data.global_batch * data.seq_len
    losses = []
    t0 = time.time()
    for s in range(start, steps):
        params, opt, m = step(params, opt, data.get_batch(s))
        losses.append(m["loss"].detach())
        if (s + 1) % LOG_EVERY == 0:
            loss = float(losses[-1])
            rate = tokens * LOG_EVERY / (time.time() - t0)
            t0 = time.time()
            log(f"step {s + 1:4d}  loss {loss:.4f}  {rate:,.0f} tok/s")
            assert np.isfinite(loss)
        if ckpt_dir is not None and (s + 1) % CKPT_EVERY == 0:
            save(ckpt_dir, s + 1, (params, opt))
            log(f"checkpoint @ {s + 1}")
    return params, opt, [float(x) for x in losses]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_demo_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = pick_device(ap, args.device)

    cfg = CONFIG_100M
    print(f"params: {cfg.param_count() / 1e6:.1f}M")
    data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=args.seq,
                              global_batch=args.batch, device=device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    opt = adamw_init(params)
    start = 0
    last = latest_step(args.ckpt_dir)
    if last is not None:
        (params, opt), _ = restore(args.ckpt_dir, last, (params, opt))
        start = last
        print(f"resumed from step {start}")
    train(cfg, params, opt, data, start, args.steps, args.ckpt_dir)
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
