"""Checkpoints of trees of tensors (port of ``repro/ckpt/checkpoint.py``).

Layout, the reference's to the byte, so that a checkpoint written by either
package restores in the other: <dir>/step_<n:08d>/manifest.json + one .npy
per tree leaf, named by its tree path (dict key, list or tuple index,
NamedTuple field, joined by "__"; dict keys in sorted order). The manifest
records step, each leaf's key, shape and dtype, and ``extra``. A bf16 leaf
is written as the reference's numpy writes an ``ml_dtypes.bfloat16`` array
(a 2-byte void ``<V2`` .npy) under the dtype name "bfloat16", and read back
as bf16 through that name.

Writes are atomic (tmp dir + rename) so a mid-write failure never corrupts
the latest checkpoint — the fault-tolerance contract of runtime/.

``restore`` puts each leaf on the device of ``tree_like``'s leaf, or on the
``torch.device`` a matching tree names. Spec shardings (placing leaves on a
data x model mesh, the reference's elastic re-shard) need the 2-D mesh,
which the port does not have yet: they raise ``SpgemmConfigError``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.models.sharding import MESH_ITEM
from repro_torch.runtime.validate import SpgemmConfigError

_BF16 = "bfloat16"
_BF16_DESCR = "<V2"  # how numpy's .npy header names an ml_dtypes.bfloat16 array


def _leaf_key(path: tuple) -> str:
    return "__".join(path) or "root"


def _save_leaf(fname: str, t: torch.Tensor) -> tuple:
    """Write one leaf as .npy; returns (shape, dtype name)."""
    t = t.detach().to("cpu").contiguous()
    shape = tuple(t.shape)
    if t.dtype == torch.bfloat16:
        with open(fname, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": shape})
            f.write(t.view(torch.int16).numpy().tobytes())
        return shape, _BF16
    arr = t.numpy()
    np.save(fname, arr)
    return shape, str(arr.dtype)


def _load_leaf(fname: str, dtype: str) -> torch.Tensor:
    arr = np.load(fname)
    if dtype == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Write tree ``tree`` at ``step``. Returns the checkpoint path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for path, leaf in _tree.leaves_with_path(tree):
        key = _leaf_key(path)
        shape, dtype = _save_leaf(os.path.join(tmp, key + ".npy"), leaf)
        manifest["leaves"].append({"key": key, "shape": list(shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(m.group(1))
        for d in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", d))
    ]
    return max(steps) if steps else None


def _placement(shardings, path: tuple, like: torch.Tensor):
    """The device a leaf goes to: ``like``'s, or the ``torch.device`` (or
    device string) that ``shardings`` holds at ``path``."""
    if shardings is None:
        return like.device
    node = shardings
    for key in path:
        node = (node[key] if isinstance(node, dict) else getattr(node, key)
                if hasattr(node, "_fields") else node[int(key)])
    if isinstance(node, (torch.device, str)):
        return torch.device(node)
    raise SpgemmConfigError(
        f"restoring onto the sharding {node!r} needs the data x model mesh, which the port "
        f"does not have yet ({MESH_ITEM}); pass devices or shardings=None")


def restore(ckpt_dir: str, step: int, tree_like, shardings=None):
    """Rebuild a ``tree_like``-structured tree from disk.

    Each leaf keeps the dtype it was saved with and goes to the device of
    ``tree_like``'s leaf, or to the device that ``shardings``, a matching
    tree of ``torch.device``s, names for it. Returns (tree, manifest)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}

    out = []
    for lpath, like in _tree.leaves_with_path(tree_like):
        key = _leaf_key(lpath)
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key}")
        device = _placement(shardings, lpath, like)
        out.append(_load_leaf(os.path.join(path, key + ".npy"), by_key[key]["dtype"]).to(device))
    return _tree.unflatten(tree_like, out), manifest
