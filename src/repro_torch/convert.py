"""Carry the reference's state across: numpy arrays in, port objects out.

Callers hand over the JAX objects' arrays as numpy arrays (``np.asarray``
on the JAX side), so this module needs nothing of JAX. A plan built by the
reference replays in the port, and a port plan handed back through
``plan_to_numpy`` replays in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.spgemm import SpgemmPlan
from repro_torch.sparse.formats import CSR

_PLAN_FIELDS = ("indptr", "indices", "seg_ids", "a_slot_s", "b_slot_s")


def tensor_from_numpy(x, device="cuda") -> torch.Tensor:
    """numpy -> tensor on ``device``. bfloat16 arrays (``ml_dtypes``, as JAX
    returns them) are carried bit for bit through a uint16 view."""
    x = np.array(x)  # a writable copy: JAX hands out read-only buffers
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy on the host. bfloat16 becomes float32 (exactly),
    since numpy has no bfloat16 of its own."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def csr_from_numpy(indptr, indices, values, shape, device="cuda") -> CSR:
    """A port CSR from a reference CSR's arrays (int32 indices)."""
    return CSR(indptr=tensor_from_numpy(np.asarray(indptr, np.int32), device),
               indices=tensor_from_numpy(np.asarray(indices, np.int32), device),
               values=tensor_from_numpy(values, device),
               shape=(int(shape[0]), int(shape[1])))


def plan_from_numpy(indptr, indices, seg_ids, a_slot_s, b_slot_s, shape,
                    device="cuda") -> SpgemmPlan:
    """A port SpgemmPlan from a reference plan's five int32 arrays."""
    arrays = [tensor_from_numpy(np.asarray(x, np.int32), device)
              for x in (indptr, indices, seg_ids, a_slot_s, b_slot_s)]
    return SpgemmPlan(*arrays, shape=(int(shape[0]), int(shape[1])))


def csr_to_numpy(c: CSR) -> dict:
    """A port CSR as numpy arrays: indptr, indices, values, shape."""
    return {"indptr": tensor_to_numpy(c.indptr),
            "indices": tensor_to_numpy(c.indices),
            "values": tensor_to_numpy(c.values), "shape": tuple(c.shape)}


def plan_to_numpy(plan: SpgemmPlan) -> dict:
    """A port plan as numpy arrays, keyed by the reference's field names."""
    out = {name: tensor_to_numpy(getattr(plan, name)) for name in _PLAN_FIELDS}
    out["shape"] = tuple(plan.shape)
    return out
