"""GPipe-style pipeline parallelism over a mesh axis (port of
``repro/dist/pipeline.py``).

``pipeline_forward`` runs a stack of identical layers whose weights are
sharded one stage a shard over ``axis``, streaming microbatches through the
ring: at step t, stage 0 takes microbatch t while stage s works on the
activation it received from stage s-1, and every stage passes its output on
with one ``mesh.ppermute``. After ``n_microbatches + n_stages - 1`` steps
every microbatch has crossed every stage: the classic fill/drain schedule.
The outputs live on the last stage; a ``mesh.psum`` of them replicates them.
Each process runs its local stages (``repro_torch.compat``).
"""
from __future__ import annotations

import torch


def pipeline_forward(layer, weights: torch.Tensor, x: torch.Tensor, mesh,
                     axis: str = "pipe") -> torch.Tensor:
    """Apply ``n_stages`` layers to microbatched ``x`` through the pipeline.

    layer:    ``(w, h) -> h``, one stage's computation.
    weights:  (n_stages, ...) stage weights (or this process's local stack).
    x:        (n_microbatches, ...) microbatches, on every process.
    Returns the (n_microbatches, ...) outputs, equal to applying the stages
    one after another.
    """
    n_stages = mesh.shape[axis]
    first, count = mesh.local_shards(axis)
    w_loc = mesh.local(weights, axis)
    n_mb = x.shape[0]
    buf = torch.zeros((count,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    outs = torch.zeros_like(x)
    for t in range(n_mb + n_stages - 1):
        step = []
        for i in range(count):
            inp = x[min(t, n_mb - 1)] if first + i == 0 else buf[i]
            step.append(layer(w_loc[i], inp))
        out = torch.stack(step)
        mb = t - (n_stages - 1)  # the microbatch draining at the last stage
        if mb >= 0 and first + count == n_stages:
            outs[mb] = out[-1]
        buf = mesh.ppermute(out, 1, axis)
    # the outputs live on the last stage only; a psum replicates them
    last = torch.zeros((count,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    if first + count == n_stages:
        last[-1] = outs
    return mesh.psum(last, axis)[0]
