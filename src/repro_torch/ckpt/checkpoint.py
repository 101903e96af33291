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

``restore`` puts each leaf on the device of ``tree_like``'s leaf, on the
``torch.device`` a matching tree names, or, the reference's elastic
re-shard, on the data x model mesh a matching tree of
``compat.NamedSharding``s names, at its spec, whatever mesh the checkpoint
was saved from: each rank reads the whole leaf and keeps its slice. A bare
spec (no mesh) raises ``SpgemmConfigError``.

``save`` of a tree of DTensors gathers each leaf whole (a collective every
rank of the mesh calls); rank 0 writes, and every rank leaves once the
checkpoint is in place.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import _tree
from repro_torch.compat import NamedSharding, whole
from repro_torch.runtime.validate import SpgemmConfigError

_BF16 = "bfloat16"
_BF16_DESCR = "<V2"  # how numpy's .npy header names an ml_dtypes.bfloat16 array


def _leaf_key(path: tuple) -> str:
    return "__".join(path) or "root"


def _save_leaf(fname: str, t: torch.Tensor) -> tuple:
    """Write one leaf (a DTensor gathered whole) as .npy; returns (shape,
    dtype name)."""
    t = whole(t).detach().to("cpu").contiguous()
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
    leaves = _tree.leaves_with_path(tree)
    if any(isinstance(leaf, DTensor) for _, leaf in leaves):
        if dist.get_rank() == 0:
            _write(ckpt_dir, final, step, leaves, extra)
        else:
            for _, leaf in leaves:  # rank 0's gathers, leaf by leaf
                whole(leaf)
        dist.barrier()
        return final
    _write(ckpt_dir, final, step, leaves, extra)
    return final


def _write(ckpt_dir: str, final: str, step: int, leaves: list, extra) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for path, leaf in leaves:
        key = _leaf_key(path)
        shape, dtype = _save_leaf(os.path.join(tmp, key + ".npy"), leaf)
        manifest["leaves"].append({"key": key, "shape": list(shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(m.group(1))
        for d in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", d))
    ]
    return max(steps) if steps else None


def _place(shardings, path: tuple, like: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``leaf`` where it goes: ``like``'s device, or what ``shardings`` holds
    at ``path``: a ``torch.device`` (or device string), or a
    ``compat.NamedSharding``."""
    if shardings is None:
        return leaf.to(like.device)
    node = shardings
    for key in path:
        node = (node[key] if isinstance(node, dict) else getattr(node, key)
                if hasattr(node, "_fields") else node[int(key)])
    if isinstance(node, (torch.device, str)):
        return leaf.to(node)
    if isinstance(node, NamedSharding):
        return node.mesh.distribute(leaf, node.spec)
    raise SpgemmConfigError(
        f"cannot restore onto {node!r}: pass a torch.device, a compat.NamedSharding (a spec "
        f"on a data x model mesh), or shardings=None")


def restore(ckpt_dir: str, step: int, tree_like, shardings=None):
    """Rebuild a ``tree_like``-structured tree from disk.

    Each leaf keeps the dtype it was saved with and goes to the device of
    ``tree_like``'s leaf, or where ``shardings``, a matching tree of
    ``torch.device``s or ``compat.NamedSharding``s, names for it (the
    elastic restore onto a mesh). Returns (tree, manifest)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}

    out = []
    for lpath, like in _tree.leaves_with_path(tree_like):
        key = _leaf_key(lpath)
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key}")
        leaf = _load_leaf(os.path.join(path, key + ".npy"), by_key[key]["dtype"])
        out.append(_place(shardings, lpath, like, leaf))
    return _tree.unflatten(tree_like, out), manifest
