"""Batched serving on the PyTorch port: prefill a prompt batch, then greedy
decode with static-shape KV caches (ring buffers on local-attention layers).

The port of examples/serve_lm.py: ``get_config(arch, smoke=True)``,
``models.init_params`` from a ``torch.Generator`` seeded 0 on the device
(f32, as the reference's), ``ServeEngine(...).generate``. The model runs in
plain torch on either device; no TPU kernel is on this path, in the
reference or here. Runs on the card by default; --device cpu runs it on the
CPU:

    PYTHONPATH=src python examples/torch_serve_lm.py --arch gemma2-9b --steps 24
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine


def pick_device(ap: argparse.ArgumentParser, name: str) -> torch.device:
    """The asked device; ``ap.error`` (exit 2) for a card that is not there."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is visible; pass --device cpu to run on the CPU")
    return device


def prompts_for(cfg, batch: int, prompt_len: int, device) -> torch.Tensor:
    """The reference's seeded prompt batch, int32 on ``device``."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    return torch.from_numpy(toks).to(device)


@torch.no_grad()
def generate(params, cfg, prompts: torch.Tensor, steps: int) -> torch.Tensor:
    """(B, steps) greedy tokens from an engine sized for prompt + steps."""
    engine = ServeEngine(params, cfg, max_len=prompts.shape[1] + steps)
    return engine.generate(prompts, steps=steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = pick_device(ap, args.device)

    cfg = get_config(args.arch, smoke=True)  # CPU-scale weights
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    out = generate(params, cfg, prompts_for(cfg, args.batch, args.prompt_len, device),
                   args.steps)
    print(f"arch={cfg.name}  batch={args.batch}  "
          f"prompt={args.prompt_len}  generated={out.shape[1]} tokens")
    for row in out.cpu().numpy()[:2]:
        print("  tokens:", row[:16].tolist(), "...")
    assert out.shape == (args.batch, args.steps)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
