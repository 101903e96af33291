"""Shared inputs for the LM substrate's parity tests (``test_torch_models*``,
``test_torch_serve_engine``): seeded numpy params and batches that go into
the reference and, through ``repro_torch.convert``, into the port."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.models.model import _is_template_leaf, model_template


def np_params(cfg, seed: int, dtype=np.float32) -> dict:
    """The config's param tree as seeded numpy arrays: matrices normal x
    0.02; norms, biases and other 1-D or "norm"-role leaves normal x 0.1 (not
    zero, as ``init_params`` leaves them, so every leaf is exercised)."""
    rng = np.random.default_rng(seed)

    def leaf(spec):
        shape, role = spec
        scale = 0.1 if role == "norm" or len(shape) == 1 else 0.02
        return (rng.standard_normal(shape) * scale).astype(dtype)

    def walk(tree):
        if _is_template_leaf(tree):
            return leaf(tree)
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return [walk(v) for v in tree]

    return walk(model_template(cfg))


def np_batch(cfg, rng, b: int, t: int) -> dict:
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal((b, t, cfg.frontend_dim)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    return out


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_port(tree):
    return convert.params_from_numpy(tree, device="cpu")


def to_np(x) -> np.ndarray:
    """A JAX array or a torch tensor as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


def max_err(got, want) -> tuple:
    """(max |got - want|, max |want|)."""
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max()), float(np.abs(w).max())


def assert_close(got, want, rtol: float, what: str = "") -> float:
    """|got - want| <= rtol x max |want| everywhere; returns the ratio of the
    worst error to that bound."""
    err, scale = max_err(got, want)
    bound = rtol * max(scale, 1e-30)
    assert err <= bound, f"{what}: max |diff| {err:.3e} > {rtol:g} x scale {scale:.3e}"
    return err / bound


@contextlib.contextmanager
def one_rank_mesh(tmp_path, shape=(1, 1)):
    """A data x model mesh of ``shape`` (one shard) over a one-rank gloo
    group in this process, through a ``file://`` rendezvous under
    ``tmp_path``; the group is destroyed on leaving."""
    from repro_torch.launch.mesh import make_test_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        yield make_test_mesh(shape)
    finally:
        dist.destroy_process_group()
