"""The port's 2-D data x model mesh on 8 gloo ranks (``make_test_mesh((2,
4))``), against the port's ``NO_SHARDING`` path and against the reference's
own 8-device tests (``tests/test_distributed.py``).

One spawn of 8 ranks (``torch.multiprocessing.start_processes``, spawn)
meets through a ``file://`` rendezvous in a temporary directory (no port,
no collision between test workers) and runs every case; each rank saves
what it computed (DTensors taken whole), and the test process compares.
The spawn has its own join deadline and fails rather than hangs. The
reference runs once, in one subprocess that forces 8 host devices, the
bodies of ``test_tp_train_step_matches_single_device``,
``test_moe_shard_map_matches_local`` and
``test_elastic_checkpoint_reshard`` on the same numpy-seeded params and
batches (``torch_lm_common.np_params``, carried across by ``convert``); it
runs beside the spawn.

Bounds: the reference's own. The llama3.2-1b smoke train step (bf16
activations, ``AdamWConfig()``) against ``NO_SHARDING`` and against the
reference's sharded step: loss rtol 2e-2, every leaf rtol 2e-2 / atol
2e-3. That step moves a leaf by about lr = 3e-6, so it cannot see a wrong
gradient: every architecture's step also runs with f32 activations and
``AdamWConfig(lr=1e-3, warmup_steps=1)``, its loss, every grad and the
step's update held to ``NO_SHARDING``'s as ``tests/test_torch_train.py``
holds them to the reference's (``GRAD_RTOL_F32`` a leaf, relative
Frobenius; ``UPDATE_RTOL`` a leaf; the loss and ``grad_norm`` at 1e-5).
The MoE archs there run at a capacity that drops no token on either path
(``NO_DROP``, else per-shard capacity keeps other tokens). Their mesh path
gathers the FSDP'd expert weights in bf16 (the reference's ``_fsdp_gather``)
and reduce-scatters those weights' grads in bf16: the expert weights start
at bf16 values on both paths (the same forward), their grads and
``grad_norm`` are held to ``GRAD_RTOL_EXPERT`` (worst seen 2.5e-3), their
updates to ``UPDATE_RTOL_EXPERT`` (worst seen 2.9e-2: a first Adam step is
about sign(g), and the bf16 sum flips elements whose shards' shares nearly
cancel); every other leaf of the MoE archs meets the dense bounds (worst
grad 5.9e-7). ``Replicate()`` in place of ``Partial()`` in the MoE's
``in_grad_placements`` fails those bounds. The
qwen3-moe-30b-a3b smoke forward through the ``local_map`` expert path
against the local path: mean |diff| < 0.05; against the reference's
``shard_map`` forward (the same per-shard capacities): mean |diff| <
``MOE_MEAN`` and max |diff| < ``MOE_MAX``, bf16 logits on both sides. A
decode step with ``decode=True`` rules and caches at ``cache_shardings``
against ``NO_SHARDING`` in f32: 1e-5 relative to the largest logit (the
layer tests' bound). The same decode at a batch of 1 with ``long_context``
rules (the caches' sequence over both axes, the batch kept whole: 'data'
does not split it), logits and caches at that bound. Three microbatches
of a batch of 6 placed over 'data' (2 shards of 3 rows): the f32 loss and
grads against ``NO_SHARDING``'s with 3 microbatches at 1e-5 and
``GRAD_RTOL_F32``, the bf16 step at the reference's bars. The elastic
restore: saved from ``(4, 2)`` at ``("data", "model")``, restored onto
``(2, 4)`` at ``("model", "data")``: bitwise, at the asked placements, and
the checkpoint's files byte for byte the reference's.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

from repro_torch.configs import ARCH_IDS

from torch_lm_common import np_batch, np_params

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
JOIN_S = 600
LOSS_RTOL, LEAF_RTOL, LEAF_ATOL = 2e-2, 2e-2, 2e-3  # tests/test_distributed.py:70-75
GRAD_RTOL_F32, UPDATE_RTOL = 1e-5, 2e-3  # tests/test_torch_train.py
GRAD_RTOL_EXPERT = 8e-3  # a grad rounded to bf16 (2^-8 an element, relative)
UPDATE_RTOL_EXPERT = 0.1
EXPERT_WEIGHTS = ("w1", "w2", "w3")
NO_DROP = 4.0  # experts / experts_per_token of the smoke MoE configs: capacity > tokens
MOE_LOCAL_MEAN = 0.05  # tests/test_distributed.py:112
FORWARD_TOL = 0.03  # tests/test_torch_models.py's LOGIT_TOL, bf16 logits
# port against the reference's shard_map, bf16 logits (measured: mean 6.4e-4, max 1.8e-2)
MOE_MEAN, MOE_MAX = 2e-3, FORWARD_TOL
DECODE_RTOL = 1e-5  # tests/test_torch_models_layers.py, f32
DECODE_ARCHS = ("llama3.2-1b", "gemma2-9b", "recurrentgemma-9b", "mamba2-2.7b")
MOE_ARCHS = ("qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b")
LONG_ARCHS = ("llama3.2-1b", "gemma2-9b", "recurrentgemma-9b")  # batch-1 long-context decode


def _inputs() -> dict:
    """Seeded numpy params and batches for every case, as both sides take them."""
    from repro_torch.configs import get_config

    out = {}
    for i, arch in enumerate(ARCH_IDS):
        cfg = get_config(arch, smoke=True)
        rng = np.random.default_rng(100 + i)
        t = cfg.num_patches + 16 if cfg.frontend == "vision" else 32
        batch = np_batch(cfg, rng, 4, t)
        batch["labels"] = rng.integers(0, cfg.vocab_size, (4, t)).astype(np.int32)
        out[arch] = {"params": np_params(cfg, seed=i), "batch": batch}
    cfg = get_config("llama3.2-1b", smoke=True)
    rng = np.random.default_rng(200)
    out["microbatch"] = {"tokens": rng.integers(0, cfg.vocab_size, (6, 32)).astype(np.int32),
                         "labels": rng.integers(0, cfg.vocab_size, (6, 32)).astype(np.int32)}
    return out


# --------------------------------------------------------------------------
# the reference: tests/test_distributed.py's bodies on these inputs
# --------------------------------------------------------------------------

REFERENCE = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.ckpt import restore, save
from repro.compat import use_mesh
from repro.configs import get_config
from repro.launch.mesh import make_test_mesh, rules_for_mesh
from repro.models import NO_SHARDING, forward, param_shardings
from repro.train import AdamWConfig, OptState, adamw_init, make_train_step

out_path, inputs_path, ckpt_dir = sys.argv[1:4]
with open(inputs_path, "rb") as f:
    inputs = pickle.load(f)
res = {}


def tree(params):
    return jax.tree.map(jnp.asarray, params)


# test_tp_train_step_matches_single_device (:47)
cfg = get_config("llama3.2-1b", smoke=True)
params = tree(inputs["llama3.2-1b"]["params"])
opt = adamw_init(params)
b = inputs["llama3.2-1b"]["batch"]
batch = {"tokens": jnp.asarray(b["tokens"]), "labels": jnp.asarray(b["labels"])}
p1, _, m1 = make_train_step(cfg, NO_SHARDING, AdamWConfig())(params, opt, batch)
mesh = make_test_mesh((2, 4))
rules = rules_for_mesh(mesh)
p_sh = jax.tree.map(lambda s: NamedSharding(mesh, s), param_shardings(cfg, rules),
                    is_leaf=lambda x: isinstance(x, P))
o_sh = OptState(mu=p_sh, nu=p_sh, step=NamedSharding(mesh, P()))
rep = NamedSharding(mesh, P())
m_sh = {"grad_norm": rep, "lr": rep, "loss": rep}
with use_mesh(mesh):
    p2, _, m2 = jax.jit(make_train_step(cfg, rules, AdamWConfig(), mesh=mesh),
                        out_shardings=(p_sh, o_sh, m_sh))(params, opt, batch)
np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=2e-2)
for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=2e-2, atol=2e-3)
res["llama"] = {"loss": float(m2["loss"]), "grad_norm": float(m2["grad_norm"]),
                "params": [np.asarray(x, np.float32) for x in jax.tree.leaves(p2)]}

# test_moe_shard_map_matches_local (:92)
cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
params = tree(inputs["qwen3-moe-30b-a3b"]["params"])
batch = {"tokens": jnp.asarray(inputs["qwen3-moe-30b-a3b"]["batch"]["tokens"])}
l1, _ = forward(params, batch, cfg, NO_SHARDING, remat=False)
rules = rules_for_mesh(mesh)
with use_mesh(mesh):
    l2 = jax.jit(lambda p, b: forward(p, b, cfg, rules, mesh=mesh, remat=False)[0])(params, batch)
err = float(jnp.mean(jnp.abs(l1.astype(jnp.float32) - l2.astype(jnp.float32))))
assert err < 0.05, err
res["moe"] = {"local": np.asarray(l1, np.float32), "mesh": np.asarray(l2, np.float32)}

# test_elastic_checkpoint_reshard (:146)
tree_e = {"w": jnp.arange(64, dtype=jnp.float32).reshape(8, 8),
          "b": jnp.ones((8,), jnp.float32)}
mesh_a = make_test_mesh((4, 2))
sh_a = {"w": NamedSharding(mesh_a, P("data", "model")), "b": NamedSharding(mesh_a, P("data"))}
placed = jax.tree.map(jax.device_put, tree_e, sh_a)
save(ckpt_dir, 3, placed)
mesh_b = make_test_mesh((2, 4))
sh_b = {"w": NamedSharding(mesh_b, P("model", "data")), "b": NamedSharding(mesh_b, P("model"))}
restored, _ = restore(ckpt_dir, 3, tree_e, shardings=sh_b)
for k in tree_e:
    np.testing.assert_array_equal(np.asarray(restored[k]), np.asarray(tree_e[k]))
    assert restored[k].sharding == sh_b[k]
with open(out_path, "wb") as f:
    pickle.dump(res, f)
"""


# --------------------------------------------------------------------------
# the port: one spawn of 8 gloo ranks
# --------------------------------------------------------------------------


def _whole(tree):
    from repro_torch import _tree
    from repro_torch.compat import whole

    return [whole(x).detach().float().clone() for x in _tree.leaves(tree)]


def _port(tree):
    from repro_torch import convert

    return convert.params_from_numpy(tree, device="cpu")


def _batch(arrays: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


@dataclasses.dataclass
class _Ctx:
    mesh: object
    rules: object
    inputs: dict


def _expert_path(path) -> bool:
    return "moe" in path and path[-1] in EXPERT_WEIGHTS


def _setup(cx, arch, rules=None, bf16_experts=False):
    """(cfg, params, specs, the params placed on the mesh); with
    ``bf16_experts`` the MoE expert weights rounded to bf16 values (f32)."""
    import repro_torch.models as tm
    from repro_torch import _tree
    from repro_torch.configs import get_config

    def port():
        tree = _port(cx.inputs[arch]["params"])
        for path, leaf in _tree.leaves_with_path(tree):
            if bf16_experts and _expert_path(path):
                leaf.copy_(leaf.to(torch.bfloat16).float())
        return tree

    cfg = get_config(arch, smoke=True)
    params = port()
    specs = tm.param_shardings(cfg, rules or cx.rules)
    # placed from a second copy: a step writes the params it is given
    return cfg, params, specs, tm.place(port(), specs, cx.mesh)


def _case_hooks(cx) -> dict:
    """Each activation hook's placements on the 2 x 4 mesh."""
    mesh, rules = cx.mesh, cx.rules
    dec = dataclasses.replace(rules, decode=True)
    x3 = mesh.distribute(torch.zeros(4, 32, 8), (None,) * 3)
    x4 = mesh.distribute(torch.zeros(4, 32, 4, 8), (None,) * 4)
    x1 = mesh.distribute(torch.zeros(4, 1, 8), (None,) * 3)
    got = {"residual": rules.residual(x3), "residual_t1": rules.residual(x1),
           "attn_heads": rules.attn_activations(x4, 4), "attn_seq": rules.attn_activations(x4, 6),
           "attn_kv": rules.attn_kv(x4, 4), "attn_decode": dec.attn_activations(x4, 4),
           "kv_cache": dec.kv_cache_constraint(x4), "logits": rules.logits(x3)}
    return {k: tuple(v.placements) for k, v in got.items()}


def _case_train(cx, arch, opt_cfg, f32=False) -> dict:
    """One train step on the mesh (ZeRO-1 moments) and with NO_SHARDING; in
    f32 the step's two halves (``loss_and_grads``, ``adamw_update``) called
    one by one, its grads kept."""
    import functools

    import repro_torch.models as tm
    import repro_torch.models.model as tmm
    import repro_torch.models.moe as moe_mod
    from repro_torch import _tree
    from repro_torch.train import adamw_init, adamw_update, make_train_step, zero1_shardings
    from repro_torch.train.step import loss_and_grads

    old, old_moe = tmm.COMPUTE_DTYPE, moe_mod.moe_layer
    tmm.COMPUTE_DTYPE = torch.float32 if f32 else old
    if f32:
        moe_mod.moe_layer = functools.partial(old_moe, capacity_factor=NO_DROP)
    try:
        cfg, params, specs, placed = _setup(cx, arch, bf16_experts=f32)
        batch = _batch(cx.inputs[arch]["batch"])
        zero1 = zero1_shardings(specs, cx.rules.dp_axes, cx.mesh.shape,
                                tm.param_specs(cfg, cx.rules))
        opt = adamw_init(placed, cx.mesh, zero1)
        moments = [tuple(m.placements) for m in _tree.leaves(opt.mu)]
        want = [cx.mesh.placements(z) for z in _spec_list(zero1, params)]
        p0 = _whole(params)
        out = {}
        if f32:
            l2, g2 = loss_and_grads(placed, batch, cfg, cx.rules, mesh=cx.mesh)
            l1, g1 = loss_and_grads(params, batch, cfg, tm.NO_SHARDING)
            out["grads"] = (_whole(g1), _whole(g2))
            out["experts"] = [_expert_path(path) for path, _ in _tree.leaves_with_path(g1)]
            p2, o2, m2 = adamw_update(g2, opt, placed, opt_cfg)
            p1, _, m1 = adamw_update(g1, adamw_init(params), params, opt_cfg)
            m1["loss"], m2["loss"] = l1, l2
        else:
            p2, o2, m2 = make_train_step(cfg, cx.rules, opt_cfg, mesh=cx.mesh)(placed, opt,
                                                                                batch)
            p1, _, m1 = make_train_step(cfg, tm.NO_SHARDING, opt_cfg)(params,
                                                                       adamw_init(params), batch)
        return {**out, "loss": (float(m1["loss"]), float(m2["loss"])),
                "grad_norm": (float(m1["grad_norm"]), float(m2["grad_norm"])),
                "plain": _whole(p1), "mesh": _whole(p2), "start": p0,
                "moments": moments == want and moments == [tuple(v.placements)
                                                          for v in _tree.leaves(o2.nu)]}
    finally:
        tmm.COMPUTE_DTYPE, moe_mod.moe_layer = old, old_moe


def _spec_list(specs, like) -> list:
    from repro_torch import _tree

    out = []
    _tree.map_specs(lambda spec, _: out.append(spec), specs, like)
    return out


def _case_forward(cx, arch) -> dict:
    import repro_torch.models as tm

    cfg, params, _, placed = _setup(cx, arch)
    inputs = {k: v for k, v in _batch(cx.inputs[arch]["batch"]).items() if k != "labels"}
    with torch.no_grad():
        want, _ = tm.forward(params, inputs, cfg, tm.NO_SHARDING, remat=False)
        got, _ = tm.forward(placed, inputs, cfg, cx.rules, mesh=cx.mesh, remat=False)
    return {"plain": want.float(), "mesh": _whole([got])[0], "placements": tuple(got.placements)}


def _case_decode(cx, arch, rows=None, long_context=False) -> dict:
    """Prefill on the mesh, the caches taken to cache_shardings, 3 decode
    steps (and the engine's greedy tokens), f32 activations, against
    NO_SHARDING; ``rows`` of the batch (a batch of 1 is not split over
    'data') with ``long_context`` rules (the caches' sequence over every
    axis), the caches after the steps kept."""
    import repro_torch.models as tm
    import repro_torch.models.model as tmm
    from repro_torch import _tree
    from repro_torch.serve import ServeEngine, prefill_to_cache

    old = tmm.COMPUTE_DTYPE
    tmm.COMPUTE_DTYPE = torch.float32
    try:
        rules = dataclasses.replace(cx.rules, decode=True, long_context=long_context)
        cfg, params, _, placed = _setup(cx, arch, rules)
        toks = _batch(cx.inputs[arch]["batch"])["tokens"][:rows, :12]
        max_len = 24 if long_context else 20  # the sequence splits over 8 shards
        out = {"plain": [], "mesh": [], "cache_placements": []}
        for label, p, r, mesh in (("plain", params, tm.NO_SHARDING, None),
                                  ("mesh", placed, rules, cx.mesh)):
            with torch.no_grad():
                _, caches = tm.forward(p, {"tokens": toks}, cfg, r, mesh=mesh,
                                       return_caches=True, remat=False, max_len=max_len)
                caches = prefill_to_cache(caches, cfg, toks.shape[1], max_len)
                if mesh is not None:
                    specs = tm.cache_shardings(cfg, r, toks.shape[0], max_len,
                                               long_context=long_context)
                    caches = tm.place(caches, specs, mesh)
                    want = [mesh.placements(s) for s in _spec_list(specs, caches)]
                    out["cache_placements"] = [tuple(c.placements)
                                               for c in _tree.leaves(caches)] == want
                tok = toks[:, -1:]
                for i in range(3):
                    logits, caches = tm.decode_step(p, caches, tok, toks.shape[1] + i, cfg, r,
                                                    mesh=mesh, max_len=max_len)
                    out[label].append(_whole([logits])[0])
                    tok = torch.argmax(out[label][-1], dim=-1).to(torch.int32)
                out[f"{label}_caches"] = _whole(caches)
        if arch == "llama3.2-1b" and rows is None:
            engines = (ServeEngine(params, cfg, max_len=max_len),
                       ServeEngine(placed, cfg, rules=rules, mesh=cx.mesh, max_len=max_len))
            out["tokens"] = tuple(e.generate(toks, 6) for e in engines)
            # sampled: one generator state on every rank, as on the plain path
            out["sampled"] = tuple(
                e.generate(toks, 6, temperature=0.8, generator=torch.Generator().manual_seed(7))
                for e in engines)
        return out
    finally:
        tmm.COMPUTE_DTYPE = old


def _case_microbatch(cx) -> dict:
    """3 microbatches of a batch of 6 placed over 'data' (2 shards of 3
    rows, which DTensor cannot reshape into 3 x 2; each microbatch then
    has one row a shard), on the mesh and with
    NO_SHARDING: the loss and grads with f32 activations, and the bf16
    step's loss and params (``AdamWConfig()``)."""
    import repro_torch.models as tm
    import repro_torch.models.model as tmm
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step, zero1_shardings
    from repro_torch.train.step import loss_and_grads

    batch = _batch(cx.inputs["microbatch"])
    sharded = tm.place_batch(batch, cx.rules, cx.mesh)
    out = {"sharded": tuple(sharded["tokens"].placements)}
    old = tmm.COMPUTE_DTYPE
    tmm.COMPUTE_DTYPE = torch.float32
    try:
        cfg, params, _, placed = _setup(cx, "llama3.2-1b")
        l2, g2 = loss_and_grads(placed, sharded, cfg, cx.rules, mesh=cx.mesh, num_microbatches=3)
        l1, g1 = loss_and_grads(params, batch, cfg, tm.NO_SHARDING, num_microbatches=3)
        out["f32"] = {"loss": (float(l1), float(l2)), "grads": (_whole(g1), _whole(g2))}
    finally:
        tmm.COMPUTE_DTYPE = old
    cfg, params, specs, placed = _setup(cx, "llama3.2-1b")
    zero1 = zero1_shardings(specs, cx.rules.dp_axes, cx.mesh.shape, tm.param_specs(cfg, cx.rules))
    p2, _, m2 = make_train_step(cfg, cx.rules, AdamWConfig(), mesh=cx.mesh, num_microbatches=3)(
        placed, adamw_init(placed, cx.mesh, zero1), sharded)
    p1, _, m1 = make_train_step(cfg, tm.NO_SHARDING, AdamWConfig(), num_microbatches=3)(
        params, adamw_init(params), batch)
    out["bf16"] = {"loss": (float(m1["loss"]), float(m2["loss"])), "plain": _whole(p1),
                   "mesh": _whole(p2)}
    return out


def _case_elastic(root: Path) -> dict:
    """The reference's elastic test: save from (4, 2), restore onto (2, 4)."""
    from repro_torch import _tree
    from repro_torch.ckpt import restore, save
    from repro_torch.compat import NamedSharding
    from repro_torch.launch.mesh import make_test_mesh

    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.ones((8,), dtype=torch.float32)}
    mesh_a = make_test_mesh((4, 2))
    sh_a = {"w": ("data", "model"), "b": ("data",)}
    placed = _tree.map_specs(lambda spec, x: mesh_a.distribute(x, spec), sh_a, tree)
    save(str(root / "port_ckpt"), 3, placed)
    mesh_b = make_test_mesh((2, 4))
    sh_b = {"w": NamedSharding(mesh_b, ("model", "data")), "b": NamedSharding(mesh_b, ("model",))}
    restored, _ = restore(str(root / "port_ckpt"), 3, tree, shardings=sh_b)
    return {"values": {k: torch.equal(restored[k].full_tensor(), tree[k]) for k in tree},
            "placements": {k: (tuple(restored[k].placements), sh_b[k].placements) for k in tree},
            "source": {k: tuple(placed[k].placements) for k in tree}}


def _case_errors(cx) -> dict:
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime.validate import SpgemmConfigError

    out = {}
    for name, call in (("world size", lambda: make_test_mesh((4, 4))),
                       ("out of order", lambda: cx.mesh.placements((("model", "data"),))),
                       ("plain activation", lambda: cx.rules.residual(torch.zeros(4, 8, 2)))):
        try:
            call()
            out[name] = "no error"
        except SpgemmConfigError as e:
            out[name] = type(e).__name__
    return out


def _worker(rank: int, init_file: str, result_dir: str, inputs_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                           world_size=WORLD)
    try:
        from repro_torch.launch.mesh import make_test_mesh, rules_for_mesh
        from repro_torch.train import AdamWConfig

        with open(inputs_path, "rb") as f:
            inputs = pickle.load(f)
        mesh = make_test_mesh((2, 4))
        cx = _Ctx(mesh, rules_for_mesh(mesh), inputs)
        out = {"hooks": _case_hooks(cx), "errors": _case_errors(cx),
               "train": _case_train(cx, "llama3.2-1b", AdamWConfig()),
               "train_f32": {arch: _case_train(cx, arch, AdamWConfig(lr=1e-3, warmup_steps=1),
                                               f32=True) for arch in ARCH_IDS},
               "forward": {arch: _case_forward(cx, arch) for arch in ARCH_IDS},
               "decode": {arch: _case_decode(cx, arch) for arch in DECODE_ARCHS},
               "long_decode": {arch: _case_decode(cx, arch, rows=1, long_context=True)
                               for arch in LONG_ARCHS},
               "microbatch": _case_microbatch(cx),
               "elastic": _case_elastic(Path(result_dir))}
        torch.save(out, os.path.join(result_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(every rank's results, the reference's results, the directory)."""
    root = tmp_path_factory.mktemp("mesh_pg")
    inputs_path = root / "inputs.pkl"
    with open(inputs_path, "wb") as f:
        pickle.dump(_inputs(), f)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(root / "ref.pkl"),
         str(inputs_path), str(root / "ref_ckpt")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        procs = torch_mp.start_processes(
            _worker, args=(str(root / "rendezvous"), str(root), str(inputs_path)),
            nprocs=WORLD, join=False, start_method="spawn")
        deadline = time.monotonic() + JOIN_S
        try:
            while not procs.join(timeout=1):
                if time.monotonic() > deadline:
                    pytest.fail(f"the gloo ranks did not finish in {JOIN_S} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
        _, err = ref.communicate(timeout=max(deadline - time.monotonic(), 60))
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-4000:]
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    with open(root / "ref.pkl", "rb") as f:
        reference = pickle.load(f)
    return ranks, reference, root


def _close_leaves(got, want, rtol, atol):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                   rtol=rtol, atol=atol, err_msg=f"leaf {i}")


def test_every_rank_holds_the_same_whole_results(runs):
    ranks, _, _ = runs
    for r in ranks[1:]:
        for arch in ARCH_IDS:
            got, want = r["train_f32"][arch], ranks[0]["train_f32"][arch]
            assert got["loss"] == want["loss"] and got["grad_norm"] == want["grad_norm"]
            assert all(torch.equal(a, b) for a, b in zip(got["mesh"], want["mesh"]))
            assert torch.equal(r["forward"][arch]["mesh"], ranks[0]["forward"][arch]["mesh"])


def test_hooks_place_activations_at_the_reference_specs(runs):
    from torch.distributed.tensor import Replicate, Shard

    got = runs[0][0]["hooks"]
    s = Shard
    assert got == {"residual": (s(0), s(1)), "residual_t1": (s(0), Replicate()),
                   "attn_heads": (s(0), s(2)), "attn_seq": (s(0), s(1)),
                   "attn_kv": (s(0), s(2)), "attn_decode": (s(0), Replicate()),
                   "kv_cache": (s(0), s(1)), "logits": (s(0), s(2))}


def test_typed_errors_on_the_mesh(runs):
    assert runs[0][0]["errors"] == {"world size": "SpgemmConfigError",
                                    "out of order": "SpgemmConfigError",
                                    "plain activation": "SpgemmConfigError"}


def test_llama_train_step_matches_no_sharding(runs):
    """tests/test_distributed.py:47's bar, port against port."""
    got = runs[0][0]["train"]
    np.testing.assert_allclose(got["loss"][1], got["loss"][0], rtol=LOSS_RTOL)
    _close_leaves(got["mesh"], got["plain"], LEAF_RTOL, LEAF_ATOL)


def test_llama_train_step_matches_the_references_sharded_step(runs):
    got, ref = runs[0][0]["train"], runs[1]["llama"]
    np.testing.assert_allclose(got["loss"][1], ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"][1], ref["grad_norm"], rtol=LOSS_RTOL)
    assert len(got["mesh"]) == len(ref["params"])
    _close_leaves(got["mesh"], ref["params"], LEAF_RTOL, LEAF_ATOL)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative Frobenius distance of ``a`` from ``b``."""
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def test_llama_f32_update_on_the_mesh_matches_no_sharding(runs):
    got = runs[0][0]["train_f32"]["llama3.2-1b"]
    assert got["loss"][1] == pytest.approx(got["loss"][0], rel=1e-5)
    upd_mesh = torch.cat([(a - p).reshape(-1) for a, p in zip(got["mesh"], got["start"])])
    upd_plain = torch.cat([(b - p).reshape(-1) for b, p in zip(got["plain"], got["start"])])
    rel = _rel(upd_mesh, upd_plain)
    assert rel <= UPDATE_RTOL, rel


def test_moments_are_placed_by_zero1_shardings(runs):
    for arch in ARCH_IDS:
        assert runs[0][0]["train_f32"][arch]["moments"], arch
    assert runs[0][0]["train"]["moments"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_architecture_trains_on_the_mesh(runs, arch):
    """Every architecture's step on the 2 x 4 mesh in f32 against
    NO_SHARDING's: the loss and grad_norm at 1e-5, every grad within
    GRAD_RTOL_F32 (the MoE's expert weights, through local_map's bf16 gather,
    GRAD_RTOL_EXPERT), every leaf's update within UPDATE_RTOL (the expert
    weights' UPDATE_RTOL_EXPERT)."""
    got = runs[0][0]["train_f32"][arch]
    assert got["loss"][1] == pytest.approx(got["loss"][0], rel=1e-5)
    rtol = GRAD_RTOL_EXPERT if any(got["experts"]) else GRAD_RTOL_F32
    assert got["grad_norm"][1] == pytest.approx(got["grad_norm"][0], rel=rtol)
    plain, mesh = got["grads"]
    worst = max((_rel(a, b) / (GRAD_RTOL_EXPERT if e else GRAD_RTOL_F32), i)
                for i, (a, b, e) in enumerate(zip(mesh, plain, got["experts"])))
    assert worst[0] <= 1, worst
    worst = max((_rel(a - p, b - p) / (UPDATE_RTOL_EXPERT if e else UPDATE_RTOL), i)
                for i, (a, b, p, e) in enumerate(zip(got["mesh"], got["plain"], got["start"],
                                                     got["experts"])))
    assert worst[0] <= 1, worst


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_architecture_forward_on_the_mesh(runs, arch):
    got = runs[0][0]["forward"][arch]
    diff = (got["mesh"] - got["plain"]).abs()
    if arch in MOE_ARCHS:  # capacity is per shard: tests/test_distributed.py:110's bound
        assert float(diff.mean()) < MOE_LOCAL_MEAN
    else:
        assert float(diff.max()) <= FORWARD_TOL, float(diff.max())


def test_moe_forward_matches_the_references_shard_map(runs):
    got, ref = runs[0][0]["forward"]["qwen3-moe-30b-a3b"], runs[1]["moe"]
    assert float((got["plain"] - torch.from_numpy(ref["local"])).abs().max()) <= FORWARD_TOL
    diff = (got["mesh"] - torch.from_numpy(ref["mesh"])).abs()
    assert float(diff.mean()) < MOE_MEAN and float(diff.max()) < MOE_MAX, (
        float(diff.mean()), float(diff.max()))


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_step_on_the_mesh_matches_no_sharding(runs, arch):
    got = runs[0][0]["decode"][arch]
    assert got["cache_placements"]
    for a, b in zip(got["mesh"], got["plain"]):
        assert float((a - b).abs().max()) <= DECODE_RTOL * float(b.abs().max())


@pytest.mark.parametrize("arch", LONG_ARCHS)
def test_batch_1_long_context_decode_on_the_mesh_matches_no_sharding(runs, arch):
    """A decode batch of 1, which the 'data' axis does not split (the
    reference's long_500k cell), with the caches' sequence over both axes:
    the activations keep the batch whole (``sharding.even_spec``); logits
    and caches within DECODE_RTOL of NO_SHARDING's."""
    got = runs[0][0]["long_decode"][arch]
    assert got["cache_placements"]
    for a, b in zip(got["mesh"], got["plain"]):
        assert a.shape[0] == 1
        assert float((a - b).abs().max()) <= DECODE_RTOL * float(b.abs().max())
    for a, b in zip(got["mesh_caches"], got["plain_caches"]):
        assert float((a - b).abs().max()) <= DECODE_RTOL * max(float(b.abs().max()), 1e-30)


def test_microbatches_split_a_data_sharded_batch(runs):
    """3 microbatches of a batch of 6 placed over 'data': the f32 loss and
    grads are NO_SHARDING's with 3 microbatches (1e-5, GRAD_RTOL_F32 a
    leaf); the bf16 step's loss and params meet the reference's bars."""
    from torch.distributed.tensor import Replicate, Shard

    got = runs[0][0]["microbatch"]
    assert got["sharded"] == (Shard(0), Replicate())
    f32 = got["f32"]
    assert f32["loss"][1] == pytest.approx(f32["loss"][0], rel=1e-5)
    worst = max(_rel(a, b) for a, b in zip(f32["grads"][1], f32["grads"][0]))
    assert worst <= GRAD_RTOL_F32, worst
    bf16 = got["bf16"]
    np.testing.assert_allclose(bf16["loss"][1], bf16["loss"][0], rtol=LOSS_RTOL)
    _close_leaves(bf16["mesh"], bf16["plain"], LEAF_RTOL, LEAF_ATOL)


def test_serve_engine_on_the_mesh_gives_the_plain_tokens(runs):
    """Greedy and sampled (temperature 0.8, one generator seed): the plain
    engine's tokens, the same on every rank."""
    for key in ("tokens", "sampled"):
        plain, mesh = runs[0][0]["decode"]["llama3.2-1b"][key]
        assert mesh.dtype == torch.int32 and torch.equal(mesh, plain), key
        assert all(torch.equal(r["decode"]["llama3.2-1b"][key][1], mesh) for r in runs[0])


def test_elastic_restore_onto_another_mesh(runs):
    from torch.distributed.tensor import Replicate, Shard

    got = runs[0][0]["elastic"]
    assert got["values"] == {"w": True, "b": True}
    assert got["source"] == {"w": (Shard(0), Shard(1)), "b": (Shard(0), Replicate())}
    assert got["placements"] == {"w": ((Shard(1), Shard(0)),) * 2,
                                 "b": ((Replicate(), Shard(0)),) * 2}


def test_elastic_checkpoint_files_are_the_references(runs):
    _, _, root = runs
    port, ref = root / "port_ckpt" / "step_00000003", root / "ref_ckpt" / "step_00000003"
    names = sorted(p.name for p in ref.iterdir())
    assert names == sorted(p.name for p in port.iterdir())
    for name in names:
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
