"""The training path on the card against the same path on the CPU, every
architecture at its smoke config (``cuda``-marked: skips without a card).

This file imports no JAX, so it runs on a card machine with ``--noconftest
-m cuda``. Activations are f32 (``model.COMPUTE_DTYPE``), every param leaf
is drawn from a seeded generator (``init_params`` leaves "norm"-role
matrices at zero). Bounds as in ``tests/test_torch_train.py``: grads per
leaf within a relative Frobenius distance of 1e-5, a step's update within
2e-3. ``test_mesh_step_on_the_card_matches_no_sharding`` runs the data x
model mesh path at world size 1 under NCCL (a ``(1, 1)`` mesh, a
``file://`` rendezvous): forward and a train step with placed params and
ZeRO-1 moments against ``NO_SHARDING``, bitwise or within 1e-6 relative.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist

import repro_torch.models as tm
import repro_torch.models.model as tmm
from repro_torch import _tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.compat import whole
from repro_torch.launch.mesh import make_test_mesh, rules_for_mesh
from repro_torch.serve import ServeEngine
from repro_torch.train import AdamWConfig, adamw_init, train_step, zero1_shardings
from repro_torch.train.step import loss_and_grads

GRAD_RTOL_F32 = 1e-5
UPDATE_RTOL = 2e-3
MESH_RTOL = 1e-6


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


def _mesh_rel(got, want) -> float:
    got, want = whole(got).double().cpu(), want.double().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("llama3.2-1b", "qwen3-moe-30b-a3b"))
def test_mesh_step_on_the_card_matches_no_sharding(cuda, arch, tmp_path, monkeypatch):
    """chip_smoke phase 19 (a)/(b) at the smoke config: a (1, 1) mesh over NCCL."""
    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    cfg = get_config(arch, smoke=True)
    params, batch = _inputs(cfg, torch.Generator().manual_seed(1))
    # a fresh copy each time: the step writes the params it is given
    on = lambda tree: _tree.tree_map(lambda x: x.to(cuda, copy=True), tree)  # noqa: E731
    batch = on(batch)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh((1, 1))
        rules = rules_for_mesh(mesh)
        specs = tm.param_shardings(cfg, rules)
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        with torch.no_grad():
            want, _ = tm.forward(on(params), inputs, cfg, tm.NO_SHARDING, remat=False)
            got, _ = tm.forward(tm.place(on(params), specs, mesh), inputs, cfg, rules, mesh=mesh,
                                remat=False)
        assert _mesh_rel(got, want) <= MESH_RTOL
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
        plain = on(params)
        plain, _, pm = train_step(plain, adamw_init(plain), batch, cfg, tm.NO_SHARDING, opt_cfg)
        zero1 = zero1_shardings(specs, rules.dp_axes, mesh.shape, tm.param_specs(cfg, rules))
        placed = tm.place(on(params), specs, mesh)
        placed, state, mm = train_step(placed, adamw_init(placed, mesh, zero1), batch, cfg, rules,
                                       opt_cfg, mesh=mesh)
        assert abs(float(mm["loss"]) - float(pm["loss"])) <= MESH_RTOL * abs(float(pm["loss"]))
        for (path, a), b in zip(_tree.leaves_with_path(placed), _tree.leaves(plain)):
            assert a.device.type == cuda.type and _mesh_rel(a, b) <= MESH_RTOL, path
        if cfg.causal:
            prompts = batch["tokens"][:, :8]
            bf = _tree.tree_map(lambda x: x.to(torch.bfloat16), on(params))
            dec = dataclasses.replace(rules, decode=True)
            eng = ServeEngine(tm.place(bf, tm.param_shardings(cfg, dec), mesh), cfg, rules=dec,
                              mesh=mesh, max_len=16)
            assert torch.equal(eng.generate(prompts, 6),
                               ServeEngine(bf, cfg, max_len=16).generate(prompts, 6))
    finally:
        dist.destroy_process_group()
