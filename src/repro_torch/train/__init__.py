"""Training (port of ``repro.train``): AdamW with f32 moments, warmup and
global-norm clipping, updating params in place; the cross-entropy loss and
the remat'd training step with microbatch accumulation."""
from repro_torch.train.optim import AdamWConfig, OptState, adamw_init, adamw_update, zero1_shardings
from repro_torch.train.step import cross_entropy_loss, make_train_step, train_step

__all__ = [
    "AdamWConfig",
    "OptState",
    "adamw_init",
    "adamw_update",
    "zero1_shardings",
    "cross_entropy_loss",
    "train_step",
    "make_train_step",
]
