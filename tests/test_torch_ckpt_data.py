"""The LM substrate's data pipeline, checkpoints and training launcher
(``repro_torch.data``, ``repro_torch.ckpt``, ``repro_torch.launch.train``)
against the reference's.

Tokens and labels are bitwise the reference's. A checkpoint written by
either package has the same file names, manifest and .npy bytes, and
restores in the other bit for bit; for bf16 leaves the port restores the
reference's files (the reference cannot restore them itself: numpy reads
its ``<V2`` leaves back as void, which JAX refuses; ROADMAP Queue 3). The
launcher, run twice on the CPU, resumes and ends where a straight run ends.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro import data as jdata
from repro.train import optim as joptim
from repro_torch import _tree, convert
from repro_torch.ckpt import latest_step, restore, save
from repro_torch.compat import NamedSharding
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset, TokenFileDataset, make_labels
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import rules_for_mesh
from repro_torch.models import NO_SHARDING, init_params, param_shardings
from repro_torch.runtime.validate import SpgemmConfigError
from repro_torch.train import AdamWConfig, OptState, adamw_init, make_train_step

from torch.distributed.tensor import DTensor

from torch_lm_common import np_params, one_rank_mesh, to_jax, to_port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,index,procs", [(0, 0, 0, 1), (0, 5, 0, 1), (7, 3, 1, 2),
                                                   (7, 3, 3, 4), (123, 10_000, 0, 2)])
def test_synthetic_tokens_are_the_references_bitwise(seed, step, index, procs):
    kw = dict(vocab_size=1000, seq_len=24, global_batch=8, seed=seed, process_index=index,
              num_processes=procs)
    want = jdata.SyntheticLMDataset(**kw).get_batch(step)
    got = SyntheticLMDataset(**kw, device="cpu").get_batch(step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_dataset_defaults_to_the_card():
    assert SyntheticLMDataset(vocab_size=10, seq_len=4, global_batch=2).device == "cuda"


def test_token_file_batches_are_the_references_bitwise(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 50_000, 33 * 40, dtype=np.int32).tofile(path)
    for procs in (1, 2):
        for index in range(procs):
            kw = dict(seq_len=32, global_batch=4, process_index=index, num_processes=procs)
            ref, port = jdata.TokenFileDataset(str(path), **kw), TokenFileDataset(
                str(path), **kw, device="cpu")
            assert port.num_rows == ref.num_rows == 40
            for step in (0, 1, 9, 37):
                want, got = ref.get_batch(step), port.get_batch(step)
                for k in ("tokens", "labels"):
                    assert got[k].dtype == torch.int32
                    np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_make_labels_are_the_references_bitwise():
    frames = (np.random.default_rng(1).standard_normal((3, 50, 16)) * 3).astype(np.float32)
    want = jdata.make_labels({"frames": frames})["labels"]
    got = make_labels({"frames": torch.from_numpy(frames)})
    assert got["labels"].dtype == torch.int32 and got["labels"].device.type == "cpu"
    np.testing.assert_array_equal(got["labels"].numpy(), want)
    assert 0 <= int(got["labels"].min()) and int(got["labels"].max()) < 504
    batch = {"tokens": torch.zeros(1, 2, dtype=torch.int32), "labels": torch.ones(1, 2)}
    assert make_labels(batch) is batch


def test_data_determinism_and_sharding():
    """The reference's scenario (tests/test_train.py) on the port."""
    d1 = SyntheticLMDataset(vocab_size=100, seq_len=16, global_batch=8, device="cpu")
    d2 = SyntheticLMDataset(vocab_size=100, seq_len=16, global_batch=8, device="cpu")
    assert torch.equal(d1.get_batch(5)["tokens"], d2.get_batch(5)["tokens"])
    parts = [
        SyntheticLMDataset(vocab_size=100, seq_len=16, global_batch=8, process_index=i,
                           num_processes=2, device="cpu").get_batch(3)
        for i in range(2)
    ]
    full = d1.get_batch(3)
    assert torch.equal(torch.cat([p["tokens"] for p in parts]), full["tokens"])


# --------------------------------------------------------------------------
# checkpoints: the reference's layout, both ways
# --------------------------------------------------------------------------


def _state(seed=0, dtype="float32", arch="gemma2-9b"):
    """(params, OptState) as numpy: a smoke tree (lists, dicts, a NamedTuple,
    a 0-d step) with seeded moments."""
    params = np_params(get_config(arch, smoke=True), seed=seed)
    if dtype == "bfloat16":
        params = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), params)
    rng = np.random.default_rng(seed + 1)
    mom = lambda: jax.tree.map(  # noqa: E731
        lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
    return params, joptim.OptState(mu=mom(), nu=mom(), step=np.int32(7))


def _as_ref(params, opt):
    return to_jax(params), joptim.OptState(to_jax(opt.mu), to_jax(opt.nu), jnp.int32(opt.step))


def _as_port(params, opt):
    return to_port(params), convert.opt_state_from_numpy(opt, device="cpu")


def _bits(x) -> tuple:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        x = x.view(np.int16)
    return x.shape, x.tobytes()


def _files(path) -> dict:
    return {name: open(os.path.join(path, name), "rb").read() for name in os.listdir(path)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_writes_the_references_files(tmp_path, dtype):
    """The same tree saved by both packages: the same file names, manifest
    and .npy bytes (bf16 leaves as numpy writes ml_dtypes' bfloat16)."""
    params, opt = _state(dtype=dtype)
    ref = jckpt.save(str(tmp_path / "ref"), 3, _as_ref(params, opt), extra={"arch": "x"})
    port = save(str(tmp_path / "port"), 3, _as_port(params, opt), extra={"arch": "x"})
    assert os.path.basename(ref) == os.path.basename(port) == "step_00000003"
    want, got = _files(ref), _files(port)
    assert sorted(got) == sorted(want)
    assert "1__step.npy" in got and "0__blocks__0__attn__wq.npy" in got
    assert json.loads(got["manifest.json"]) == json.loads(want["manifest.json"])
    assert got == want
    if dtype == "bfloat16":
        assert any(e["dtype"] == "bfloat16"
                   for e in json.loads(got["manifest.json"])["leaves"])


def test_checkpoints_cross_restore_bitwise_f32(tmp_path):
    params, opt = _state()
    ref_tree, port_tree = _as_ref(params, opt), _as_port(params, opt)
    jckpt.save(str(tmp_path / "ref"), 5, ref_tree, extra={"arch": "gemma2"})
    save(str(tmp_path / "port"), 5, port_tree, extra={"arch": "gemma2"})
    like = _tree.tree_map(torch.zeros_like, port_tree)
    (p, o), manifest = restore(str(tmp_path / "ref"), 5, like)
    assert manifest["extra"] == {"arch": "gemma2"} and isinstance(o, OptState)
    assert [_bits(x) for x in _tree.leaves((p, o))] == [_bits(x) for x in jax.tree.leaves(ref_tree)]
    assert o.step.dtype == torch.int32 and o.step.shape == ()
    (jp, jo), _ = jckpt.restore(str(tmp_path / "port"), 5, ref_tree)
    assert [_bits(x) for x in jax.tree.leaves((jp, jo))] == \
        [_bits(x) for x in jax.tree.leaves(ref_tree)]


def test_port_restores_reference_bf16_checkpoints(tmp_path):
    """bf16 params written by the reference restore in the port as bf16, bit
    for bit, and port-written ones restore in the port too. The reference
    cannot read either back (ROADMAP Queue 3)."""
    params, opt = _state(dtype="bfloat16")
    ref_tree = _as_ref(params, opt)
    jckpt.save(str(tmp_path), 2, ref_tree)
    like = _tree.tree_map(torch.zeros_like, _as_port(params, opt))
    tree, _ = restore(str(tmp_path), 2, like)
    assert all(x.dtype == torch.bfloat16 for x in _tree.leaves(tree[0]))
    assert [_bits(x) for x in _tree.leaves(tree)] == [_bits(x) for x in jax.tree.leaves(ref_tree)]
    save(str(tmp_path / "port"), 2, tree)
    again, _ = restore(str(tmp_path / "port"), 2, like)
    assert [_bits(x) for x in _tree.leaves(again)] == [_bits(x) for x in _tree.leaves(tree)]
    with pytest.raises(TypeError, match="V2"):
        jckpt.restore(str(tmp_path), 2, ref_tree)


def test_restore_places_leaves_and_refuses_spec_shardings(tmp_path):
    """Devices and NamedShardings on a mesh place leaves; a bare spec (no
    mesh) is refused."""
    cfg = get_config("llama3.2-1b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    save(str(tmp_path), 1, params)
    devices = _tree.tree_map(lambda _: torch.device("cpu"), params)
    got, _ = restore(str(tmp_path), 1, params, shardings=devices)
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(got), _tree.leaves(params)))
    with pytest.raises(SpgemmConfigError, match="NamedSharding"):
        restore(str(tmp_path), 1, params, shardings=param_shardings(cfg, NO_SHARDING))
    with pytest.raises(KeyError, match="missing leaf"):
        restore(str(tmp_path), 1, {"other": params["embed"]})
    with one_rank_mesh(tmp_path) as mesh:
        specs = param_shardings(cfg, rules_for_mesh(mesh))
        named = _tree.map_specs(lambda spec, _: NamedSharding(mesh, spec), specs, params)
        got, _ = restore(str(tmp_path), 1, params, shardings=named)
        for (path, a), b in zip(_tree.leaves_with_path(got), _tree.leaves(params)):
            assert isinstance(a, DTensor) and torch.equal(a.full_tensor(), b), path
        assert [tuple(a.placements) for a in _tree.leaves(got)] == [
            tuple(n.placements) for n in _tree.leaves(named)]
        save(str(tmp_path / "placed"), 2, got)
        again, _ = restore(str(tmp_path / "placed"), 2, params)
        assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(again), _tree.leaves(params)))


def _setup(seed=0):
    cfg = get_config("llama3.2-1b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    opt = adamw_init(params)
    data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                              device="cpu")
    return cfg, params, opt, data


def test_checkpoint_roundtrip(tmp_path):
    """The reference's scenario (tests/test_train.py) on the port."""
    cfg, params, opt, data = _setup()
    d = str(tmp_path)
    save(d, 7, (params, opt), extra={"arch": "llama"})
    assert latest_step(d) == 7
    (p2, o2), manifest = restore(d, 7, (params, opt))
    assert manifest["extra"]["arch"] == "llama"
    for a, b in zip(_tree.leaves(params), _tree.leaves(p2)):
        assert torch.equal(a, b)


def test_checkpoint_resume_exact(tmp_path):
    """Train 4 steps straight vs 2 steps + save/restore + 2 steps: identical
    final params (fault-tolerant restart is bit-exact)."""
    d = str(tmp_path)
    cfg, params, opt, data = _setup()
    step = make_train_step(cfg, NO_SHARDING, AdamWConfig(lr=1e-3))
    clone = lambda tree: _tree.tree_map(torch.clone, tree)  # noqa: E731

    pa, oa = clone(params), clone(opt)
    for s in range(4):
        pa, oa, _ = step(pa, oa, data.get_batch(s))

    pb, ob = clone(params), clone(opt)
    for s in range(2):
        pb, ob, _ = step(pb, ob, data.get_batch(s))
    save(d, 2, (pb, ob))
    (pb, ob), _ = restore(d, 2, _tree.tree_map(torch.zeros_like, (pb, ob)))
    for s in range(2, 4):  # data skip-ahead: same batches as the straight run
        pb, ob, _ = step(pb, ob, data.get_batch(s))

    for a, b in zip(_tree.leaves(pa), _tree.leaves(pb)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert int(ob.step) == int(oa.step) == 4


def test_atomic_checkpoint_overwrite(tmp_path):
    cfg, params, opt, _ = _setup()
    d = str(tmp_path)
    save(d, 1, params)
    save(d, 1, params)  # overwrite same step: must not corrupt
    restored, _ = restore(d, 1, params)
    for a, b in zip(_tree.leaves(params), _tree.leaves(restored)):
        assert torch.equal(a, b)
    assert not [n for n in os.listdir(d) if n.startswith(".tmp_")]


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------


def _launch(ckpt_dir, steps, every, capsys) -> str:
    launcher.main(["--arch", "llama3.2-1b", "--smoke", "--steps", str(steps), "--batch", "4",
                   "--seq", "32", "--ckpt-every", str(every), "--ckpt-dir", str(ckpt_dir),
                   "--log-every", "2", "--device", "cpu"])
    return capsys.readouterr().out


def test_launcher_resumes_where_a_straight_run_ends(tmp_path, capsys):
    """6 steps straight against 4 steps, then a second run to 6 that resumes
    from the step-4 checkpoint: the same params and state (atol 1e-6)."""
    out = _launch(tmp_path / "straight", 6, 3, capsys)
    assert "resumed" not in out and out.rstrip().endswith("done") and "step 6: loss=" in out
    out = _launch(tmp_path / "split", 4, 2, capsys)
    assert latest_step(str(tmp_path / "split")) == 4
    out = _launch(tmp_path / "split", 6, 2, capsys)
    assert "resumed from step 4" in out and out.rstrip().endswith("done")
    assert "step 2: loss=" not in out and "step 6: loss=" in out
    cfg = get_config("llama3.2-1b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    like = (params, adamw_init(params))
    (pa, oa), ma = restore(str(tmp_path / "straight"), 6, like)
    (pb, ob), mb = restore(str(tmp_path / "split"), 6, like)
    assert ma["extra"] == mb["extra"] == {"arch": "llama3.2-1b"}
    assert int(oa.step) == int(ob.step) == 6
    for a, b in zip(_tree.leaves((pa, oa)), _tree.leaves((pb, ob))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_launcher_fails_without_a_card_unless_asked_for_the_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        launcher.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1"])
    assert exc.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
