"""Carrying state between the JAX package and repro_torch, and the boundary
between them.

A plan built by the reference replays in the port and a plan built by the
port replays in the reference, both within rtol/atol 1e-5 of the other
package's own replay. The port must import neither ``jax`` nor ``repro``.
"""
import ast
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.sparse import generators as jgen
from repro_torch import convert
from repro_torch.core import executor as texec

jsp = importlib.import_module("repro.core.spgemm")
tsp = importlib.import_module("repro_torch.core.spgemm")

ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = ROOT / "src" / "repro_torch"
PLAN_FIELDS = ("indptr", "indices", "seg_ids", "a_slot_s", "b_slot_s")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_csr_to_port(j):
    return convert.csr_from_numpy(np.asarray(j.indptr), np.asarray(j.indices),
                                  np.asarray(j.values), j.shape, device="cpu")


def _operands():
    r, a, p = jgen.galerkin_triple(10, 10, 4)
    return a, p


@pytest.mark.parametrize("backend", ["xla", "pallas", "pallas_lp"])
def test_reference_plan_replays_in_the_port(backend):
    ja, jp = _operands()
    jres = jsp.spgemm(ja, jp, method="sparse", plan_cache=False)
    plan = convert.plan_from_numpy(*(np.asarray(getattr(jres.plan, f)) for f in PLAN_FIELDS),
                                   shape=jres.plan.shape, device="cpu")
    ex = texec.ReuseExecutor(plan, backend=backend)
    rng = np.random.default_rng(0)
    av = rng.standard_normal(ja.nnz_cap).astype(np.float32)
    want = np.asarray(jsp.numeric_reuse(jres.plan, jnp.asarray(av), jp.values))
    got = ex.apply(torch.from_numpy(av), _jax_csr_to_port(jp).values)
    np.testing.assert_allclose(want, got.numpy(), rtol=1e-5, atol=1e-5)


def test_port_plan_replays_in_the_reference():
    ja, jp = _operands()
    ta, tp = _jax_csr_to_port(ja), _jax_csr_to_port(jp)
    tres = tsp.spgemm(ta, tp, method="sparse", plan_cache=False)
    arrays = convert.plan_to_numpy(tres.plan)
    jplan = jsp.SpgemmPlan(*(jnp.asarray(arrays[f]) for f in PLAN_FIELDS),
                           shape=arrays["shape"])
    rng = np.random.default_rng(1)
    av = rng.standard_normal(ja.nnz_cap).astype(np.float32)
    want = tsp.numeric_reuse(tres.plan, torch.from_numpy(av), tp.values)
    got = np.asarray(jsp.numeric_reuse(jplan, jnp.asarray(av), jp.values))
    np.testing.assert_allclose(want.numpy(), got, rtol=1e-5, atol=1e-5)
    # and the reference built the very same plan itself
    jres = jsp.spgemm(ja, jp, method="sparse", plan_cache=False)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jres.plan, f)), arrays[f])


def test_csr_round_trip_and_bf16_bits():
    j = jgen.random_csr(20, 30, 3.0, 2)
    vals_bf16 = np.asarray(j.values.astype(jnp.bfloat16))
    t = convert.csr_from_numpy(np.asarray(j.indptr), np.asarray(j.indices), vals_bf16,
                               j.shape, device="cpu")
    assert t.values.dtype == torch.bfloat16
    assert t.values.view(torch.int16).numpy().tobytes() == vals_bf16.tobytes()
    back = convert.csr_to_numpy(t)
    np.testing.assert_array_equal(back["indptr"], np.asarray(j.indptr))
    np.testing.assert_array_equal(back["indices"], np.asarray(j.indices))
    np.testing.assert_array_equal(back["values"], vals_bf16.astype(np.float32))
    assert back["shape"] == tuple(j.shape)
    f32 = convert.tensor_from_numpy(np.asarray(j.values), device="cpu")
    assert convert.tensor_to_numpy(f32).tobytes() == np.asarray(j.values).tobytes()


def test_ell_round_trip_carries_the_reference_arrays():
    from repro.sparse.formats import csr_to_ell as j_csr_to_ell
    from repro_torch.sparse.formats import csr_to_ell as t_csr_to_ell

    j = jgen.random_csr(15, 40, 4.0, 3)
    je = j_csr_to_ell(j)
    te = convert.ell_from_numpy(je.indices, je.values, je.row_nnz, je.shape, device="cpu")
    mine = t_csr_to_ell(_jax_csr_to_port(j))
    for field in ("indices", "values", "row_nnz"):
        assert torch.equal(getattr(te, field), getattr(mine, field)), field
    back = convert.ell_to_numpy(te)
    for field in ("indices", "values", "row_nnz"):
        np.testing.assert_array_equal(back[field], np.asarray(getattr(je, field)))
    assert back["shape"] == tuple(je.shape) == te.shape
    bf16 = convert.ell_from_numpy(je.indices, np.asarray(je.values.astype(jnp.bfloat16)),
                                  je.row_nnz, je.shape, device="cpu")
    assert bf16.values.dtype == torch.bfloat16


def test_bitmask_round_trip_keeps_every_bit():
    """uint32 words of the reference <-> int32 words of the port, bit 31
    included; the port's symbolic kernel reads the reference's words."""
    from repro.core.compression import bitmask_rows as j_bitmask_rows
    from repro.kernels.ref import spgemm_symbolic_ref
    from repro.sparse.formats import csr_to_ell as j_csr_to_ell
    from repro_torch.core.compression import bitmask_rows as t_bitmask_rows
    from repro_torch.kernels.spgemm_symbolic import spgemm_symbolic

    ja, jb = jgen.random_csr(20, 30, 3.0, 4), jgen.random_csr(30, 100, 8.0, 5)
    words = np.asarray(j_bitmask_rows(jb))
    assert (words >= 2**31).any()  # the sign bit of an int32 word is in use
    t = convert.bitmask_from_numpy(words, device="cpu")
    assert t.dtype == torch.int32 and torch.equal(t, t_bitmask_rows(_jax_csr_to_port(jb)))
    back = convert.bitmask_to_numpy(t)
    assert back.dtype == np.uint32 and back.tobytes() == words.tobytes()
    je = j_csr_to_ell(ja)
    sizes = spgemm_symbolic(torch.from_numpy(np.array(je.indices)),
                            torch.from_numpy(np.array(je.row_nnz)), t)
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(
        spgemm_symbolic_ref(je.indices, je.row_nnz, jnp.asarray(words))))


def _port_files():
    return sorted(PORT_DIR.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(roots)


def test_importing_every_port_module_never_loads_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
    assert "repro_torch.core.executor" in modules and "repro_torch.convert" in modules
    assert {"repro_torch.train.step", "repro_torch.train.optim", "repro_torch.data.pipeline",
            "repro_torch.ckpt.checkpoint", "repro_torch.launch.train"} <= set(modules)
    code = ("import importlib, sys\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr


# --------------------------------------------------------------------------
# the LM substrate's params and caches
# --------------------------------------------------------------------------

def _lm_archs():
    from repro.configs import ARCH_IDS
    return ARCH_IDS


def _leaf_bits(tree):
    import jax
    return [(np.asarray(x).dtype, np.asarray(x).shape, np.asarray(x).tobytes())
            for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", _lm_archs())
def test_params_round_trip_bitwise(arch, dtype):
    """Every architecture's smoke params (the reference's init_params, as
    numpy) cross into the port and back bit for bit, tree and all."""
    import jax
    from repro.configs import get_config
    from repro.models import init_params

    tree = jax.tree.map(np.asarray, init_params(get_config(arch, smoke=True),
                                                jax.random.PRNGKey(0),
                                                dtype=getattr(jnp, dtype)))
    port = convert.params_from_numpy(tree, device="cpu")
    leaves = jax.tree.leaves(port)
    assert all(isinstance(x, torch.Tensor) and x.dtype == getattr(torch, dtype) for x in leaves)
    assert jax.tree.structure(port) == jax.tree.structure(tree)
    back = convert.params_to_numpy(port, bfloat16=jnp.bfloat16)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert _leaf_bits(back) == _leaf_bits(tree)
    if dtype == "bfloat16":  # without a bf16 dtype: float32, exactly
        plain = jax.tree.leaves(convert.params_to_numpy(port))
        assert all(x.dtype == np.float32 for x in plain)
        np.testing.assert_array_equal(plain[-1], np.asarray(jax.tree.leaves(tree)[-1], np.float32))


@pytest.mark.parametrize("arch", [a for a in _lm_archs() if a != "hubert-xlarge"])
def test_caches_round_trip_bitwise(arch):
    """Decode caches (AttnCache, RGLRUCache, SSMCache: bf16 K/V and conv
    windows, f32 states) cross as the port's NamedTuples and back."""
    import jax
    from repro.configs import get_config
    from repro.models import init_cache
    from repro_torch.models.layers import AttnCache
    from repro_torch.models.rglru import RGLRUCache
    from repro_torch.models.ssm import SSMCache

    rng = np.random.default_rng(3)
    tmpl = init_cache(get_config(arch, smoke=True), 2, 24)
    tree = jax.tree.map(lambda x: np.asarray(jnp.asarray(rng.standard_normal(x.shape),
                                                         x.dtype)), tmpl)
    port = convert.caches_from_numpy(tree, device="cpu")
    kinds = {AttnCache, RGLRUCache, SSMCache}
    assert all(type(c) in kinds for c in port["blocks"] + port["tail"])
    assert [type(c).__name__ for c in port["blocks"] + port["tail"]] == \
        [type(c).__name__ for c in tree["blocks"] + tree["tail"]]
    back = convert.caches_to_numpy(port, bfloat16=jnp.bfloat16)
    assert _leaf_bits(back) == _leaf_bits(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_opt_state_round_trip_bitwise(dtype):
    """The reference's AdamW state (f32 moments shaped like f32 or bf16
    params, an int32 step) crosses into the port's OptState and back bit for
    bit, and a port state restores the reference's field for field."""
    import jax
    from repro.configs import get_config
    from repro.models import init_params
    from repro.train import adamw_init
    from repro_torch.train import OptState

    params = init_params(get_config("gemma2-9b", smoke=True), jax.random.PRNGKey(0),
                         dtype=getattr(jnp, dtype))
    rng = np.random.default_rng(4)
    state = adamw_init(params)
    state = state._replace(mu=jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                                           state.mu), step=jnp.int32(11))
    tree = jax.tree.map(np.asarray, state)
    port = convert.opt_state_from_numpy(tree, device="cpu")
    assert isinstance(port, OptState) and port._fields == type(state)._fields
    assert port.step.dtype == torch.int32 and port.step.shape == () and int(port.step) == 11
    assert all(x.dtype == torch.float32 for x in jax.tree.leaves((port.mu, port.nu)))
    back = convert.opt_state_to_numpy(port, bfloat16=jnp.bfloat16)
    assert _leaf_bits(back) == _leaf_bits(tree)
    pp = convert.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    assert all(x.dtype == getattr(torch, dtype) for x in jax.tree.leaves(pp))
    assert _leaf_bits(convert.params_to_numpy(pp, bfloat16=jnp.bfloat16)) == _leaf_bits(params)
