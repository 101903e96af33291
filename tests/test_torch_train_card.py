"""The training path on the card against the same path on the CPU, every
architecture at its smoke config (``cuda``-marked: skips without a card).

This file imports no JAX, so it runs on a card machine with ``--noconftest
-m cuda``. Activations are f32 (``model.COMPUTE_DTYPE``), every param leaf
is drawn from a seeded generator (``init_params`` leaves "norm"-role
matrices at zero). Bounds as in ``tests/test_torch_train.py``: grads per
leaf within a relative Frobenius distance of 1e-5, a step's update within
2e-3.
"""
import pytest
import torch

import repro_torch.models as tm
import repro_torch.models.model as tmm
from repro_torch import _tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.train import AdamWConfig, adamw_init, train_step
from repro_torch.train.step import loss_and_grads

GRAD_RTOL_F32 = 1e-5
UPDATE_RTOL = 2e-3


@pytest.fixture
def cuda():
    """The card, for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    n = float(want.norm())
    return float((got - want).norm()) / n if n else float(got.abs().max())


def _inputs(cfg, g):
    """Params with every leaf drawn (normal x 0.02, 1-D leaves x 0.1) and a
    2 x T batch with labels, on the CPU."""
    params = _tree.tree_map(
        lambda p: torch.randn(p.shape, generator=g) * (0.1 if p.ndim == 1 else 0.02),
        tm.init_params(cfg, g, device="cpu"))
    t = cfg.num_patches + 8 if cfg.frontend == "vision" else 16
    if cfg.frontend == "audio":
        batch = {"frames": torch.randn((2, t, cfg.frontend_dim), generator=g)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, t), generator=g,
                                         dtype=torch.int32)}
        if cfg.frontend == "vision":
            batch["patches"] = torch.randn((2, cfg.num_patches, cfg.frontend_dim), generator=g)
    batch["labels"] = torch.randint(0, cfg.vocab_size, (2, t), generator=g, dtype=torch.int32)
    return params, batch


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_on_the_card_matches_the_cpu(cuda, arch, monkeypatch):
    monkeypatch.setattr(tmm, "COMPUTE_DTYPE", torch.float32)
    cfg = get_config(arch, smoke=True)
    params, batch = _inputs(cfg, torch.Generator().manual_seed(0))
    on = lambda tree: _tree.tree_map(lambda x: x.to(cuda), tree)  # noqa: E731
    _, host_g = loss_and_grads(params, batch, cfg, tm.NO_SHARDING)
    _, card_g = loss_and_grads(on(params), on(batch), cfg, tm.NO_SHARDING)
    for (path, a), b in zip(_tree.leaves_with_path(card_g), _tree.leaves(host_g)):
        assert a.device.type == cuda.type
        assert _rel(a, b) <= GRAD_RTOL_F32, (path, _rel(a, b))
    cfg_opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    host = _tree.tree_map(torch.clone, params)
    host, _, hm = train_step(host, adamw_init(host), batch, cfg, tm.NO_SHARDING, cfg_opt)
    card = on(params)
    card, state, cm = train_step(card, adamw_init(card), on(batch), cfg, tm.NO_SHARDING, cfg_opt)
    assert int(state.step) == 1 and state.step.device.type == cuda.type
    assert abs(float(cm["loss"]) - float(hm["loss"])) <= 1e-5 * abs(float(hm["loss"]))
    for p0, a, b in zip(_tree.leaves(params), _tree.leaves(card), _tree.leaves(host)):
        assert _rel(a.cpu() - p0, b - p0) <= UPDATE_RTOL
